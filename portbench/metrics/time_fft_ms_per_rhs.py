"""Device ms of cuFFT's kernels (the time transforms) per right-hand side
traced."""

import re

from portbench import trace

PATTERN = re.compile(r"fft", re.I)


def read(run):
    if run.events is None or run.rhs == 0:
        return None
    us = [e["dur"] for e in trace.kernels(run.events) if PATTERN.search(e["name"])]
    return sum(us) / 1e3 / run.rhs if us else None
