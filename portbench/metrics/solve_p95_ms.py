"""The 95th percentile of the host-clock time of every call in the window,
from the call to the device synchronize after it (one call: one solve, or
one batch)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3 if run.latencies_s else None
