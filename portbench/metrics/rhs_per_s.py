"""Right-hand sides solved over the whole window, per second of it (a
batch call counts its lanes); host clock, closed loop."""


def read(run):
    return run.rhs / run.window_s if run.window_s > 0 else None
