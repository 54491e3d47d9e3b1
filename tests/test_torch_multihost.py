"""The port's multi-process launch path (``parallel/multihost.py``), the
counterpart of ``tests/test_multihost.py``: two CPU processes join one
gloo group through torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``: the ``env://`` rendezvous) and drive a tiny
sharded solve; both print the same converged digest, which matches the
single-process solve. The workers import only the port.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.parallel import multihost

torch.set_num_threads(1)

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import torch
torch.set_num_threads(1)
from optimal_control_paradiag_torch.parallel import multihost

# torchrun's environment: the env:// rendezvous, gloo because we ask for the CPU
assert multihost.initialize(device="cpu", timeout_s=60)
info = multihost.process_summary()
assert info["process_count"] == 2 and info["global_devices"] == 2, info

from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.parallel.solve import gather, make_sharded_solver

layout = multihost.pod_layout(n_space=2)  # a (1, 2) grid over both processes
prob = WaveControlProblem(ProblemConfig(N_x=17, N_t=8), device="cpu")
run, sharding = make_sharded_solver(prob, SolverConfig(rtol=1e-10), layout)
x, res = run(sharding.shard(prob.rhs))
x = gather(layout, x, 8, 16)
# every process prints the same converged answer digest
print("DIGEST", int(res.iterations), f"{float(torch.linalg.norm(x.reshape(-1))):.12e}")
torch.distributed.destroy_process_group()
"""


def test_two_process_cpu_distributed(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = multihost.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.pop(multihost.INIT_ENV, None)
        env.update(REPO_ROOT=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)
    digests = [line for out in outs for line in out.splitlines() if line.startswith("DIGEST")]
    assert len(digests) == 2
    assert digests[0] == digests[1], digests
    iters, norm = int(digests[0].split()[1]), float(digests[0].split()[2])
    assert 0 < iters <= 12
    ref = WaveControlProblem(ProblemConfig(N_x=17, N_t=8), device="cpu").solve(SolverConfig(rtol=1e-10))
    assert int(ref.result.iterations) == iters
    want = float(torch.linalg.norm(torch.stack([ref.u, ref.p]).reshape(-1)))
    assert abs(norm - want) <= 1e-10 * want


def test_launch_cpu_group_reports_a_failed_rank(tmp_path):
    """A rank that fails makes the launcher raise with its exit codes and
    the lowest failing rank's log; a group that hangs is killed at the
    time limit instead of hanging the caller."""
    bad = tmp_path / "bad.py"
    bad.write_text("import os, sys\nsys.exit(3 if os.environ['RANK'] == '1' else 0)\n")
    with pytest.raises(RuntimeError, match=r"exited \{1: 3\}"):
        multihost.launch_cpu_group([str(bad)], 2, timeout_s=60)
    hang = tmp_path / "hang.py"
    hang.write_text("import time\ntime.sleep(60)\n")
    with pytest.raises(RuntimeError, match="did not finish within 1"):
        multihost.launch_cpu_group([str(hang)], 2, timeout_s=1.0)


def test_initialize_without_a_rendezvous_is_a_no_op(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", multihost.INIT_ENV):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.process_summary() == {"process_index": 0, "process_count": 1, "local_devices": 1,
                                           "global_devices": 1, "backend": None}


def test_the_card_is_never_replaced_by_the_cpu(monkeypatch):
    """Asking for the card where there is none raises; nothing falls back
    to a gloo group on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("tcp://localhost:1", 1, 0, device="cuda")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13])
def test_blocks_follow_array_split(n):
    from optimal_control_paradiag_torch.parallel.sharding import blocks

    for length in (0, 1, 7, 12, 16):
        want = [(int(a[0]), int(a[-1]) + 1) if len(a) else None for a in np.array_split(np.arange(length), n)]
        got = blocks(length, n)
        assert [g if g[0] < g[1] else None for g in got] == want
        assert got[-1][1] == length
