"""The control of ``correct``: the reference's solve one precision below the traffic's,
put in the program's place, comes out not correct, while the program passes (CPU, a small grid);
and ``control.py``'s lines: a surrogate's beside a GMRES control, nothing more beside the others."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import cell as cellmod, manifest
from portbench.reference import solve as rs
from portbench_helpers import CELLS, tiny

torch.set_num_threads(1)

GRIDS = {1: (128, 64), 2: (64, 32)}  # (N_x, N_t); a 2D grid has (N_x - 1)^2 nodes


def control_in_place(cell):
    problem, pc = cell.config["problem"], cell.config["problem_config"]
    precision = rs.control_precision(cell.traffic)
    return lambda fn: (lambda b: (rs.solve(problem, pc, b.to(torch.float64), precision), None))


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_and_the_program_is(name):
    cell = tiny(name, *GRIDS[tiny(name).config["problem_config"]["dim"]])
    seed = 2**31 + 99
    program = cellmod.run_cell(cell, seed, 0.1, False, device="cpu")
    control = cellmod.run_cell(cell, seed, 0.1, False, device="cpu", wrap=control_in_place(cell))
    assert program["correct"] and not control["correct"]
    assert control["check"]["rel_residual"]["value"] > 3 * program["check"]["rel_residual"]["value"]


def test_control_py_prints_a_surrogate_line_beside_a_gmres_control_only(tmp_path):
    """``control.py`` on the CPU in a checkout of the benchmark's files: a
    committed sine-diagonalizable cell at a cut grid prints a program and a
    control line of today's keys; a 2D consistent wave cell added by files
    prints a surrogate line too, with the control's GMRES steps."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "portbench"
    bench = manifest.benchmark()
    path = here / "configs" / "heat1d_headline.json"
    cfg = json.loads(path.read_text())
    cfg["problem_config"].update(N_x=64, N_t=32)
    path.write_text(json.dumps(cfg))
    wave = manifest.load_json(str(here / "configs" / "wave1d_headline.json"))
    wave.update(name="wave2d_small", problem_config=dict(wave["problem_config"], N_x=16, N_t=8, dim=2))
    (here / "configs" / "wave2d_small.json").write_text(json.dumps(wave))
    (here / "workloads" / "wave2d_small.batch8.json").write_text(json.dumps({"limits": {"rel_residual": 1e-3}}))
    bench["configs"].append({"name": "wave2d_small", "source": wave["source"], "file": "portbench/configs/wave2d_small.json",
                             "reduced": ["N_x", "N_t", "dim"], "why": "a test"})
    bench["workloads"].append({"name": "wave2d_small.batch8", "config": "wave2d_small", "traffic": "batch8",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=manifest.ROOT, OMP_NUM_THREADS="1")

    def lines(workload):
        out = subprocess.run([sys.executable, "portbench/control.py", "--workload", workload, "--seeds", "7",
                              "--control-seeds", "8", "--device", "cpu"], cwd=root, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        return [json.loads(line) for line in out.stdout.splitlines()]

    program, control = lines("heat1d_headline.batch8")
    assert program["side"] == "program" and control["side"] == "control"
    assert set(control) == {"side", "precision", "cell", "seed", "rel_residual", "answered", "solve_s"}
    program, control, surrogate = lines("wave2d_small.batch8")
    assert [program["side"], control["side"], surrogate["side"]] == ["program", "control", "surrogate"]
    assert control["precision"] == "tf32" and surrogate["precision"] == "float64"
    assert set(surrogate) == set(control) == {"side", "precision", "cell", "seed", "rel_residual", "answered", "solve_s",
                                              "iterations", "peak_bytes"}
    assert len(control["iterations"]) == 32 and all(1 <= s <= rs.LOW_STEPS for s in control["iterations"])
    assert surrogate["iterations"] == [] and surrogate["answered"] == control["answered"] == program["answered"] == 32
    assert min(control["rel_residual"], surrogate["rel_residual"]) > 3 * program["rel_residual"]
