"""The frozen byte and operation counts against PERF.md's kernel table."""

import importlib.util
import os

import pytest

from portbench import manifest, peaks


def reader_module(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(manifest.HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_woodbury_bytes():
    wb = reader_module("woodbury_roofline_pct")
    b1, f1 = wb.launch_bytes_flops("wave", 1024, 2047, 1, 1)
    b2, _ = wb.launch_bytes_flops("heat", 1024, 2047, 1, 1)
    b8, _ = wb.launch_bytes_flops("wave", 1024, 2047, 8, 1)
    assert round(b1 / 1e6, 1) == 46.4 and round(b2 / 1e6, 1) == 46.3 and round(b8 / 1e6, 1) == 281.6
    assert peaks.bound_s(b1, f1, peaks.FP32_FLOPS_PER_S) * 1e3 == pytest.approx(0.0139, abs=5e-5)  # bytes bound


E2E = {"rhs_per_s", "solve_p95_ms", "peak_mem_gib", "rel_residual", "setup_s"}
READERS = sorted(f[:-3] for f in os.listdir(os.path.join(manifest.HERE, "metrics")) if f.endswith(".py"))


@pytest.mark.parametrize("name", [r for r in READERS if r not in E2E])
def test_trace_readers_return_nothing_without_a_trace(name):
    from portbench.cell import Run
    from portbench_helpers import tiny

    run = Run(cell=tiny("heat1d_headline.batch8"), setup_s=1.0)
    assert manifest.load_reader(name)(run) is None
