"""``utils/compilation_cache.py``: the build directory of the port's compiled
artifacts (the nvcc kernels and the g++ host runtime), named by
``PARADIAG_COMPILE_CACHE`` as the JAX package's persistent compilation
cache is; ``off`` still builds, privately and without reuse."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from optimal_control_paradiag_torch.utils import compilation_cache as cc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(cc, "_chosen", None)


def test_default_is_the_package_build_directory(monkeypatch):
    monkeypatch.delenv(cc.ENV, raising=False)
    assert cc.build_dir() == cc.DEFAULT_DIR
    assert cc.DEFAULT_DIR.endswith(os.path.join("optimal_control_paradiag_torch", "csrc", "_build"))


def test_environment_names_the_directory(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV, str(tmp_path / "cache"))
    assert cc.build_dir() == str(tmp_path / "cache") and (tmp_path / "cache").is_dir()
    assert cc.enable_persistent_cache() == str(tmp_path / "cache")
    assert cc.enable_persistent_cache(str(tmp_path / "other")) == str(tmp_path / "other")
    assert cc.build_dir() == str(tmp_path / "other")


def test_off_builds_privately(monkeypatch):
    monkeypatch.setenv(cc.ENV, "off")
    assert cc.enable_persistent_cache() is None
    d = cc.build_dir()
    assert os.path.isdir(d) and d != cc.DEFAULT_DIR and os.path.basename(d).startswith("paradiag_build_")


def test_off_still_builds_the_native_runtime(tmp_path):
    """A process with the cache off builds the g++ host runtime into its
    private directory, loads it, and leaves nothing in the shared one."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing")
    code = (
        "import os, sys; sys.path.insert(0, sys.argv[1])\n"
        "from optimal_control_paradiag_torch import native\n"
        "from optimal_control_paradiag_torch.utils import compilation_cache as cc\n"
        "pts, tris = native.unit_square_mesh(4)\n"
        "path = native._build()\n"
        "assert native.available(), 'native runtime did not load'\n"
        "assert os.path.dirname(path) == cc.build_dir() != cc.DEFAULT_DIR, path\n"
        "print(path)\n"
    )
    env = dict(os.environ, **{cc.ENV: "off"})
    out = subprocess.run([sys.executable, "-c", code, REPO], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    built = out.stdout.strip().splitlines()[-1]
    assert not os.path.exists(built)  # the private directory went with its process


def test_cli_enables_the_cache(monkeypatch, tmp_path):
    from optimal_control_paradiag_torch import run as t_run

    monkeypatch.setenv(cc.ENV, str(tmp_path / "cli_cache"))
    rec = t_run.main(["--platform", "cpu", "--nx", "8", "--nt", "8", "--out", str(tmp_path / "out")])
    assert rec["converged"]
    assert cc._chosen == str(tmp_path / "cli_cache")
