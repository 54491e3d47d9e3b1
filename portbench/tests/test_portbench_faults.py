"""A run with the timed path broken underneath comes out not correct (on the CPU, at a tiny grid)."""

import pytest
import torch

from portbench import cell as cellmod
from portbench_helpers import CELLS, tiny

torch.set_num_threads(1)


def unchanged(fn):
    """The solve returns its starting state (zero) unchanged."""
    return lambda b: (torch.zeros_like(b), None)


def slice_lost(fn):
    """One time slice of the state is never written."""
    def run(b):
        x, rec = fn(b)
        x = x.clone()
        x[..., 0, x.shape[-2] // 2, :] = 0.0
        return x, rec
    return run


def stale(fn):
    """Each call answers with the previous call's answer."""
    last = []

    def run(b):
        x, rec = fn(b)
        last.append(x)
        return (last[-2] if len(last) > 1 else x), rec
    return run


def half_batch(fn):
    """The second half of the batch left out: its lanes get the mean of the first half's."""
    def run(b):
        x, rec = fn(b[: b.shape[0] // 2])
        return torch.cat([x, x.mean(0, keepdim=True).expand_as(x)]), rec
    return run


FAULTS = [(c, f) for c in CELLS for f in (unchanged, slice_lost, stale)] + [("heat1d_headline.batch8", half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = cellmod.run_cell(tiny(name), 2**31 + 21, 0.2, False, device="cpu", wrap=fault)
    assert not out["correct"] and out["failed"] > 0
    assert out["check"]["rel_residual"]["value"] > out["check"]["rel_residual"]["limit"]
