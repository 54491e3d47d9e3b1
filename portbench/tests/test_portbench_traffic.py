"""The generator: the same pool for the same seed, another for another seed, and the same work for every seed."""

import math

import numpy as np
import pytest

from portbench import traffic as gen
from portbench_helpers import CELLS, tiny

BIG = 2**31 + 12345


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_bits_other_seed_other_data(name):
    cell = tiny(name)
    problem, pc, tr = cell.config["problem"], cell.config["problem_config"], cell.traffic
    n_sets = int(tr["batch"]) * int(tr["pool"])
    for i in range(n_sets):
        a = gen.member(problem, pc, tr["dtype"], BIG, i)
        b = gen.member(problem, pc, tr["dtype"], BIG, i)
        assert set(a) == set(gen.fields(problem))
        assert all(np.array_equal(a[k], b[k]) for k in a)
        c = gen.member(problem, pc, tr["dtype"], BIG + 1, i)
        assert gen.fixed(i) == (i == 0) == all(np.array_equal(a[k], c[k]) for k in a)
        for k, v in a.items():
            assert v.dtype == np.float64 and np.array_equal(v, v.astype(tr["dtype"]).astype(np.float64))
            assert np.isfinite(v).all()


@pytest.mark.parametrize("problem", ["wave", "heat"])
@pytest.mark.parametrize("dim", [1, 2])
def test_every_seed_gets_the_same_modes_scaled(problem, dim):
    """Member i is the family's manufactured data at mode 1 + i % MODES, scaled
    as a whole by a factor in [1/2, 2]: every seed does the same work."""
    pc = {"N_x": 16, "N_t": 8, "T": 2.0, "gamma": 0.5, "dim": dim, "scaled": True, "mass": "lumped"}
    for seed in (3, BIG):
        for i in range(2 * gen.MODES):
            base = gen.manufactured(problem, pc, gen.mode(i))
            m = gen.member(problem, pc, "float64", seed, i)
            ratios = set()
            for k, v in m.items():
                if not base[k].any():
                    assert not v.any()
                    continue
                j = np.argmax(np.abs(base[k]))
                ratio = v.flat[j] / base[k].flat[j]
                assert 0.5 <= ratio <= 2.0 and (ratio == 1.0) == (i == 0)
                np.testing.assert_allclose(v, ratio * base[k], rtol=1e-12, atol=1e-12 * np.abs(v).max())
                ratios.add(round(ratio, 12))
            assert len(ratios) == 1


@pytest.mark.parametrize("problem", ["wave", "heat"])
def test_the_mode_is_the_spatial_shape(problem):
    """Every field of the family at mode k is a time profile times sin(k pi x)."""
    pc = {"N_x": 32, "N_t": 8, "T": 2.0, "gamma": 1.0, "dim": 1, "scaled": True, "mass": "consistent"}
    x = np.arange(1, 32) / 32
    for k in range(1, gen.MODES + 1):
        for name, v in gen.manufactured(problem, pc, k).items():
            shape = np.sin(k * math.pi * x)
            prof = v @ shape / (shape @ shape)
            np.testing.assert_allclose(v, np.multiply.outer(prof, shape), atol=1e-12 * max(1.0, np.abs(v).max()))


def test_manufactured_member_is_the_ports_data():
    """Member 0 is what the port's own problem builds from its formulas."""
    import torch

    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, WaveControlProblem

    for name, cls in (("wave1d_headline.direct", WaveControlProblem), ("heat1d_headline.batch8", HeatControlProblem)):
        cell = tiny(name, N_x=32, N_t=16)
        pc = cell.config["problem_config"]
        prob = cls(ProblemConfig(**pc, dtype=torch.float64), device="cpu")
        mine = gen.member(cell.config["problem"], pc, "float64", 3, 0)
        for k, v in mine.items():
            np.testing.assert_allclose(v, prob._data[k].numpy(), rtol=1e-13, atol=1e-13)
