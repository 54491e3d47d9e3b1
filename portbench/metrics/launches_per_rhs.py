"""Kernel events in the trace per right-hand side traced."""

from portbench import trace


def read(run):
    if run.events is None or run.rhs == 0:
        return None
    return len(trace.kernels(run.events)) / run.rhs
