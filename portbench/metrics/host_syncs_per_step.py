"""Host syncs per Krylov step: the port's ``host/sync`` count over its
``krylov/step`` count (``utils.timing.counters`` of the port, which counts
whether or not a profiler records). The counts run from the process's
start: the warm-up pass, the profiler's warm-up pass and the traced pass
solve the same pool, so the ratio is the traced calls'. None where the
port keeps no such counts."""


def read(run):
    if run.trace is None:
        return None
    from optimal_control_paradiag_torch.utils import timing

    counts = getattr(timing, "counters", None)
    if not counts or not counts.get("krylov/step"):
        return None
    return counts["host/sync"] / counts["krylov/step"]
