"""run.py without a card; what a run imports; whole runs on the CPU at a tiny grid."""

import subprocess
import sys

import pytest
import torch

from portbench import cell as cellmod, manifest
from portbench_helpers import CELLS, tiny

torch.set_num_threads(1)

FORBIDDEN = {"jax", "jaxlib", "flax", "optimal_control_paradiag_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted(sys.modules)))"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_nothing_a_run_imports_is_jax_or_the_jax_package():
    code = ("import runpy, torch; from portbench import cell, control, manifest, trace, traffic\n"
            "from portbench.reference import model, solve\n"
            "import optimal_control_paradiag_torch.paradiag.cuda_woodbury, optimal_control_paradiag_torch.paradiag.cuda_heat\n"
            "import optimal_control_paradiag_torch.ops.bf16x3\n"
            "for n in " + repr(CELLS) + ": [m.read for m in manifest.load_cell(n, True).metrics + manifest.load_cell(n, False).metrics]\n"
            "runpy.run_path('portbench/run.py', run_name='not_main')")
    loaded = _modules(code)
    assert "optimal_control_paradiag_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_either_package():
    loaded = _modules("from portbench.reference import model, solve")
    assert not loaded & (FORBIDDEN | {"optimal_control_paradiag_torch"})


@pytest.mark.parametrize("name", CELLS)
def test_a_whole_run_on_the_cpu(name):
    cell = tiny(name)
    out = cellmod.run_cell(cell, 2**31 + 3, 0.3, False, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"
    assert out["check"]["answered"]["value"] == out["check"]["answered"]["limit"] == int(cell.traffic["batch"]) * int(cell.traffic["pool"])
    m = out["metrics"]
    names = {e["name"] for e in manifest.cell_metrics(manifest.benchmark(), name, "end_to_end")}
    assert set(m) == names - {"peak_mem_gib"}  # the CPU has no device peak
    assert all(v["value"] > 0 for v in m.values())
    assert m["rel_residual"]["value"] <= out["check"]["rel_residual"]["value"] <= cell.limits["rel_residual"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_run_py_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import json

    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "12345",
                          "--seconds", "2", "--trace", str(trace)], cwd=manifest.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    names = {m["name"] for m in manifest.cell_metrics(manifest.benchmark(), CELLS[0], "per_layer" if trace else "end_to_end")}
    assert set(line["metrics"]) == names
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]
