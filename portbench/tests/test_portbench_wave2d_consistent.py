"""The 2D consistent-mass wave cell (``wave2d_consistent.batch8_f64``) and
its two readers on the CPU. The tests parametrized over
``portbench_helpers.CELLS`` (manifest, traffic, fault, control, whole
run) are called here on this cell, which that list does not name; then
what is the cell's own: its files and metrics, its limit between its
readings, the surrogate in the program's place, the committed files run
at a cut grid, B1's bytes and operations at the cell's shape, each
reader None where it has nothing to read, and a share from a made-up
trace."""

import json
import os
import shutil

import pytest
import torch

from portbench import cell as cellmod, manifest, peaks
from portbench.cell import Run
from portbench.reference import solve as rs
from portbench_helpers import CELLS, tiny

import test_portbench_control
import test_portbench_faults
import test_portbench_manifest
import test_portbench_run
import test_portbench_traffic

torch.set_num_threads(1)

CELL = "wave2d_consistent.batch8_f64"
NEW = ("b1_tensor_pc_roofline_pct", "tensor_pc_applies_per_call")
OTHERS = [c for c in CELLS if c != CELL]
WITH_CELL = [*OTHERS, CELL]  # BENCHMARK.json's cells, in its order
GRID = (64, 32)  # (N_x, N_t), as the control's tests cut a 2D cell


def reader_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(manifest.HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel(name, dur_us, ts=0.0):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur_us}


def small():
    return tiny(CELL, *GRID)


# ------------------------------------------------------------ the cell's files


def test_the_cell_and_its_files():
    bench = manifest.benchmark()
    entry = [w for w in bench["workloads"] if w["name"] == CELL]
    assert entry == [{"name": CELL, "config": "wave2d_consistent", "traffic": "batch8_f64", "chips": 1,
                      "why": entry[0]["why"]}]
    cfg = manifest.load_json(os.path.join(manifest.HERE, "configs", "wave2d_consistent.json"))
    assert cfg["problem"] == "wave" and cfg["reduced"] == []
    assert cfg["problem_config"] == {"N_x": 192, "N_t": 128, "T": 2.0, "gamma": 1.0, "dim": 2, "scaled": True,
                                     "mass": "consistent"}
    assert cfg["assumed"]["targets_per_call"] == 8
    [conf] = [c for c in bench["configs"] if c["name"] == "wave2d_consistent"]
    assert conf["source"] == cfg["source"] and len(conf["source"]) <= 200 and conf["reduced"] == []
    cell = manifest.load_cell(CELL, trace=False)
    assert cell.traffic == {"dtype": "float64", "dst_precision": "highest", "dst_method": "auto",
                            "solver": {"method": "woodbury", "use_pallas": True, "refine": 0, "polish": 0},
                            "batch": 8, "trace_passes": 1, "pool": 4}
    assert not rs.diagonalizable(cell.config["problem_config"]) and rs.control_precision(cell.traffic) == "float32"


def test_the_cell_reads_its_metrics_and_no_other_does():
    bench = manifest.benchmark()
    per_layer = {m["name"] for m in manifest.cell_metrics(bench, CELL, "per_layer")}
    assert per_layer == {"device_idle_pct", "launches_per_rhs", *NEW}
    e2e = {m["name"] for m in manifest.cell_metrics(bench, CELL, "end_to_end")}
    assert e2e == {"rhs_per_s", "solve_p95_ms", "peak_mem_gib", "rel_residual", "setup_s"}
    for name in NEW:
        assert [w["name"] for w in bench["workloads"] if name in {m["name"] for m in
                manifest.cell_metrics(bench, w["name"], "per_layer")}] == [CELL]
    [b1, applies] = [m for m in bench["per_layer"] if m["name"] in NEW]
    assert (b1["layer"], b1["source"], b1["better"], b1["moves"]) == ("fused kernels", "device_trace", "higher", "rhs_per_s")
    assert (applies["layer"], applies["source"], applies["better"]) == ("krylov", "program_counter", "lower")


def test_the_limit_lies_between_its_readings():
    readings = manifest.load_json(os.path.join(manifest.HERE, "workloads", CELL + ".json"))["readings"]
    limit = manifest.load_cell(CELL, trace=False).limits["rel_residual"]
    assert readings["program_seeds"] >= 12 and readings["control_seeds"] >= 3 and readings["control"] == "float32"
    upper = min(readings["control_smallest"], readings["surrogate_smallest"], readings["zero_answer"])
    assert readings["program_largest"] < limit < upper


# ------------------------------------------------- the tests over every cell


@pytest.mark.parametrize("check", [test_portbench_manifest.test_every_named_file_is_found,
                                   test_portbench_manifest.test_per_layer_moves_a_metric_each_of_its_cells_reports],
                         ids=lambda f: f.__name__)
def test_the_manifest_checks_hold_with_the_cell(check, monkeypatch):
    monkeypatch.setattr(test_portbench_manifest, "CELLS", WITH_CELL)
    check(manifest.benchmark())


@pytest.mark.parametrize("fault", [test_portbench_faults.unchanged, test_portbench_faults.slice_lost,
                                   test_portbench_faults.stale], ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(fault):
    test_portbench_faults.test_a_broken_timed_path_is_not_correct(CELL, fault)


def test_same_seed_same_bits_other_seed_other_data():
    test_portbench_traffic.test_same_seed_same_bits_other_seed_other_data(CELL)


def test_a_whole_run_on_the_cpu():
    test_portbench_run.test_a_whole_run_on_the_cpu(CELL)


def test_the_control_is_not_correct_and_the_program_is():
    test_portbench_control.test_the_control_is_not_correct_and_the_program_is(CELL)


# ------------------------------------------------------------- runs at 64 x 32


def test_the_surrogate_is_not_correct():
    """The surrogate's float64 sine solve alone, in the program's place:
    not correct (the reference's control is held so by
    ``test_portbench_control`` over every cell)."""
    cell = small()
    problem, pc = cell.config["problem"], cell.config["problem_config"]
    wrap = lambda fn: (lambda b: (rs.surrogate_solve(problem, pc, b), None))
    out = cellmod.run_cell(cell, 2**31 + 2401, 0.1, False, device="cpu", wrap=wrap)
    assert not out["correct"]
    assert out["check"]["rel_residual"]["value"] > 100 * cell.limits["rel_residual"]


def test_the_cell_built_from_its_files_runs_on_the_cpu(tmp_path):
    """The cell's configuration, traffic, limits and manifest entries as
    committed, the grid cut to 16 x 8: the harness runs it with no code
    edit, every data set answered within the limit, and the applies reader
    reads the port's counters after it (a traced run needs the card)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    path = root / "portbench" / "configs" / "wave2d_consistent.json"
    cfg = json.loads(path.read_text())
    cfg["problem_config"].update(N_x=16, N_t=8)
    path.write_text(json.dumps(cfg))
    traced = manifest.load_cell(CELL, trace=True, root=str(root))
    assert {m.name for m in traced.metrics} == {"device_idle_pct", "launches_per_rhs", *NEW}
    cell = manifest.load_cell(CELL, trace=False, root=str(root))
    out = cellmod.run_cell(cell, 2**31 + 2403, 0.3, False, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["check"]["answered"]["value"] == 32
    run = Run(cell=traced, setup_s=1.0, trace={"window_s": 1.0}, events=[])
    readers = {m.name: m.read for m in traced.metrics}
    assert readers["tensor_pc_applies_per_call"](run) >= 2
    assert readers["b1_tensor_pc_roofline_pct"](run) is None  # no launch in an empty trace


# ------------------------------------------------------------------ the readers


def test_b1_bytes_and_bound_at_the_cell_shape():
    mod = reader_module("b1_tensor_pc_roofline_pct")
    nbytes, flops = mod.launch_bytes_flops(192, 128, 8)
    assert round(nbytes / 1e9, 3) == 1.277 and round(flops / 1e9, 2) == 1.52
    assert peaks.bound_s(nbytes, flops, mod.FP64_FLOPS_PER_S) * 1e3 == pytest.approx(0.3811, abs=5e-5)  # bytes
    assert flops / mod.FP64_FLOPS_PER_S * 1e3 == pytest.approx(0.0446, abs=5e-5)
    wb = reader_module("woodbury_roofline_pct")
    assert (nbytes, flops) == wb.launch_bytes_flops("wave", 128, 191**2, 8, 0, 8)


def _run(cell, events=None, calls=4, trace=True):
    return Run(cell=cell, setup_s=1.0, calls=calls, rhs=calls * 8, events=events,
               trace={"window_s": 1.0} if trace else None)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("cell", [CELL, *OTHERS])
def test_none_without_a_trace(name, cell):
    assert manifest.load_reader(name)(Run(cell=tiny(cell), setup_s=1.0)) is None


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("cell", OTHERS)
def test_none_on_another_cell(name, cell, monkeypatch):
    """A trace of another cell holding B1's launches, with the port's
    counters set as the new cell's would be."""
    from optimal_control_paradiag_torch.utils import timing

    monkeypatch.setitem(timing.counters, "pc.tensor_mass.applies", 30)
    monkeypatch.setitem(timing.counters, "solve.tensor_gmres", 6)
    events = [kernel("void woodbury_slab_kernel<double, 32>", 800.0)]
    assert manifest.load_reader(name)(_run(tiny(cell), events)) is None


def test_b1_share_of_a_made_up_trace():
    """Two launches at twice the bound each: 50 %; kernels of other names
    are left out; a trace without B1 (the eager route) reads None."""
    mod = reader_module("b1_tensor_pc_roofline_pct")
    us = 2 * peaks.bound_s(*mod.launch_bytes_flops(192, 128, 8), mod.FP64_FLOPS_PER_S) * 1e6
    events = [kernel("void woodbury_slab_kernel<double, 32>", us), kernel("woodbury_streaming_kernel", us),
              kernel("sm90_xmma_gemm_f64f64", 1000.0), kernel("time_pack_split_kernel", 50.0)]
    cell = manifest.load_cell(CELL, trace=True)
    assert manifest.load_reader(NEW[0])(_run(cell, events)) == pytest.approx(50.0)
    assert manifest.load_reader(NEW[0])(_run(cell, events[2:])) is None


def test_applies_reader_reads_the_port_counters(monkeypatch):
    from optimal_control_paradiag_torch.utils import timing

    cell = manifest.load_cell(CELL, trace=True)
    read = manifest.load_reader(NEW[1])
    monkeypatch.setitem(timing.counters, "pc.tensor_mass.applies", 0)
    monkeypatch.setitem(timing.counters, "solve.tensor_gmres", 0)
    assert read(_run(cell)) is None  # a program without the counts (the parent)
    monkeypatch.setitem(timing.counters, "pc.tensor_mass.applies", 27)
    monkeypatch.setitem(timing.counters, "solve.tensor_gmres", 6)
    assert read(_run(cell)) == pytest.approx(4.5)
    assert read(_run(cell, trace=False)) is None
