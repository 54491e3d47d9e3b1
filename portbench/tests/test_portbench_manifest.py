"""BENCHMARK.json against the contract's shape, and every file it names found by name."""

import json
import os
import re
import shutil

import pytest
import torch

from portbench import cell as cellmod, manifest
from portbench_helpers import CELLS

torch.set_num_threads(1)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark()


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in bench["configs"]] + [e["name"] for e in bench["workloads"]] + [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert TEXT.match(w["why"]) and NAME.match(w["traffic"]) and w["chips"] == 1
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and TEXT.match(c["source"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_end_to_end_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert list(e2e) == ["rhs_per_s", "solve_p95_ms", "peak_mem_gib", "rel_residual", "setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25


def test_every_named_file_is_found(bench):
    for c in bench["configs"]:
        cfg = manifest.load_json(os.path.join(manifest.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert [w["name"] for w in bench["workloads"]] == CELLS
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        for trace in (False, True):
            cell = manifest.load_cell(w["name"], trace=trace)
            assert cell.chips == 1 and callable(cell.metrics[0].read)
            assert cell.limits["rel_residual"] > 0


def test_per_layer_moves_a_metric_each_of_its_cells_reports(bench):
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] == "rhs_per_s"
        assert TEXT.match(m["layer"]) and layers.setdefault(m["name"], m["layer"]) == m["layer"]
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            assert m["moves"] in {e["name"] for e in manifest.cell_metrics(bench, w, "end_to_end")}
    # each cell reports setup_s, another end-to-end metric and a per-layer one
    for w in CELLS:
        e2e = {e["name"] for e in manifest.cell_metrics(bench, w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(bench, w, "per_layer")


def test_a_cell_added_by_files_and_one_manifest_entry_runs(tmp_path):
    """A new configuration file, a new cell's limits and one manifest entry:
    the harness runs it with no code edit (here on the CPU, at a tiny grid)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.benchmark()
    here = root / "portbench"
    cfg = manifest.load_json(str(here / "configs" / "wave1d_headline.json"))
    cfg.update(name="wave1d_small", problem_config=dict(cfg["problem_config"], N_x=32, N_t=16))
    (here / "configs" / "wave1d_small.json").write_text(json.dumps(cfg))
    (here / "workloads" / "wave1d_small.batch8.json").write_text(json.dumps({"limits": {"rel_residual": 1e-3}}))
    bench["configs"].append({"name": "wave1d_small", "source": cfg["source"], "file": "portbench/configs/wave1d_small.json",
                             "reduced": ["N_x", "N_t"], "why": "a test"})
    bench["workloads"].append({"name": "wave1d_small.batch8", "config": "wave1d_small", "traffic": "batch8",
                               "chips": 1, "why": "the batch traffic on the wave family"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.load_cell("wave1d_small.batch8", trace=False, root=str(root))
    out = cellmod.run_cell(cell, 2**31 + 11, 0.3, False, device="cpu")
    assert out["correct"] and out["check"]["answered"]["value"] == 32
    assert set(out["metrics"]) == {"rhs_per_s", "solve_p95_ms", "rel_residual", "setup_s"}  # no card: no peak
