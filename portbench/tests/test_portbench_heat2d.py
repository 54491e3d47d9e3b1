"""The 2D heat cell (``heat2d_lumped.batch8``) and its two roofline readers
on the CPU: their byte and operation counts, None where they have nothing
to read, a share from a made-up trace, and the cell built from its files
run end to end at a tiny grid."""

import json
import os
import shutil

import pytest
import torch

from portbench import cell as cellmod, manifest, peaks
from portbench.cell import Run
from portbench_helpers import tiny

torch.set_num_threads(1)

CELL = "heat2d_lumped.batch8"
NEW = ("b2_2d_roofline_pct", "dst2d_gemm_roofline_pct")


def reader_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(manifest.HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel(name, dur_us, ts=0.0):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur_us}


def test_b2_bytes_and_bound_at_the_cell_shape():
    nbytes, flops = reader_module("woodbury_roofline_pct").launch_bytes_flops("heat", 64, 255**2, 8, 1)
    assert round(nbytes / 1e6, 1) == 576.6 and round(flops / 1e9, 2) == 2.95
    assert peaks.bound_s(nbytes, flops, peaks.FP32_FLOPS_PER_S) * 1e3 == pytest.approx(0.1721, abs=5e-5)  # bytes
    assert flops / peaks.FP32_FLOPS_PER_S * 1e3 == pytest.approx(0.0441, abs=5e-5)


def test_dst_operations_and_bound_at_the_cell_shape():
    mod = reader_module("dst2d_gemm_roofline_pct")
    assert mod.PASSES == 4
    flops = mod.call_flops(256, 64, 8)
    assert round(flops / 1e9, 1) == 135.8
    assert flops / peaks.FP32_FLOPS_PER_S * 1e3 == pytest.approx(2.027, abs=5e-4)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("cell", [CELL, "heat1d_headline.batch8", "wave1d_headline.direct"])
def test_none_without_a_trace(name, cell):
    assert manifest.load_reader(name)(Run(cell=tiny(cell), setup_s=1.0)) is None


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("cell", ["heat1d_headline.batch8", "wave1d_headline.direct"])
def test_none_on_a_1d_cell(name, cell):
    """A 1D trace holding the very kernels each reader reads."""
    events = [kernel("void heat_slab_kernel<float, 32>", 300.0), kernel("sm80_xmma_gemm_f32f32", 700.0)]
    run = Run(cell=tiny(cell), setup_s=1.0, calls=16, rhs=128, events=events)
    assert manifest.load_reader(name)(run) is None


def _run_2d(events, calls=16):
    cell = manifest.load_cell(CELL, trace=True)
    return Run(cell=cell, setup_s=1.0, calls=calls, rhs=calls * 8, events=events)


def test_b2_share_of_a_made_up_trace():
    """Two launches at twice the bound each (0.3443 ms): 50 %; kernels of
    other names are left out."""
    nbytes, flops = reader_module("woodbury_roofline_pct").launch_bytes_flops("heat", 64, 255**2, 8, 1)
    us = 2 * peaks.bound_s(nbytes, flops, peaks.FP32_FLOPS_PER_S) * 1e6
    events = [kernel("void heat_slab_kernel<float, 32>", us), kernel("heat_streaming_kernel", us),
              kernel("sm80_xmma_gemm_f32f32", 1000.0), kernel("time_pack_split_kernel", 50.0)]
    assert manifest.load_reader("b2_2d_roofline_pct")(_run_2d(events)) == pytest.approx(50.0)
    assert manifest.load_reader("b2_2d_roofline_pct")(_run_2d(events[2:])) is None


def test_dst_share_of_a_made_up_trace():
    """16 calls' GEMMs (cuBLAS and CUTLASS names) summing to 1.25 x their
    bound: 80 %; cuFFT, copies and B2 are left out."""
    bound_us = 16 * reader_module("dst2d_gemm_roofline_pct").call_flops(256, 64, 8) / peaks.FP32_FLOPS_PER_S * 1e6
    events = [kernel("sm80_xmma_gemm_f32f32_f32f32_f32_nn", 0.75 * bound_us),
              kernel("void cutlass::Kernel2<cutlass_80_simt_sgemm>", 0.5 * bound_us),
              kernel("void vector_fft_64u", 500.0), kernel("direct_copy_kernel_cuda", 900.0),
              kernel("void heat_slab_kernel<float, 32>", 300.0)]
    assert manifest.load_reader("dst2d_gemm_roofline_pct")(_run_2d(events)) == pytest.approx(80.0)
    assert manifest.load_reader("dst2d_gemm_roofline_pct")(_run_2d(events[2:])) is None


def test_the_new_cell_reads_its_metrics():
    bench = manifest.benchmark()
    per_layer = {m["name"] for m in manifest.cell_metrics(bench, CELL, "per_layer")}
    assert per_layer == {"device_idle_pct", "launches_per_rhs", *NEW}
    e2e = {m["name"] for m in manifest.cell_metrics(bench, CELL, "end_to_end")}
    assert e2e == {"rhs_per_s", "solve_p95_ms", "peak_mem_gib", "rel_residual", "setup_s"}
    for name in NEW:  # on no other cell
        assert [w["name"] for w in bench["workloads"] if name in {m["name"] for m in
                manifest.cell_metrics(bench, w["name"], "per_layer")}] == [CELL]
    cfg = manifest.load_json(os.path.join(manifest.HERE, "configs", "heat2d_lumped.json"))
    assert cfg["problem_config"] == {"N_x": 256, "N_t": 64, "T": 2.0, "gamma": 1.0, "dim": 2, "scaled": True,
                                     "mass": "lumped"}
    assert cfg["reduced"] == [] and cfg["assumed"] == {}
    readings = manifest.load_json(os.path.join(manifest.HERE, "workloads", CELL + ".json"))["readings"]
    limit = manifest.load_cell(CELL, trace=False).limits["rel_residual"]
    assert readings["program_largest"] < limit < min(readings["control_smallest"], readings["zero_answer"])


def test_the_cell_built_from_its_files_runs_on_the_cpu(tmp_path):
    """The cell's configuration, traffic, limits and manifest entries as
    committed, the grid cut to 16 x 8: the harness runs it with no code
    edit, every data set of the pool answered within the cell's limit."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    path = root / "portbench" / "configs" / "heat2d_lumped.json"
    cfg = json.loads(path.read_text())
    cfg["problem_config"].update(N_x=16, N_t=8)
    path.write_text(json.dumps(cfg))
    cell = manifest.load_cell(CELL, trace=False, root=str(root))
    assert cell.config["problem_config"]["dim"] == 2 and int(cell.traffic["batch"]) == 8
    out = cellmod.run_cell(cell, 2**31 + 1807, 0.3, False, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["check"]["answered"]["value"] == out["check"]["answered"]["limit"] == 32
    assert set(out["metrics"]) == {"rhs_per_s", "solve_p95_ms", "rel_residual", "setup_s"}  # no card: no peak
    assert out["metrics"]["rel_residual"]["value"] <= out["check"]["rel_residual"]["value"] <= cell.limits["rel_residual"]
    traced = manifest.load_cell(CELL, trace=True, root=str(root))
    assert {m.name for m in traced.metrics} == {"device_idle_pct", "launches_per_rhs", *NEW}
