"""100 minus the device's busy share (the union of kernel, memcpy and memset
intervals) over the traced calls' window, in percent."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
