"""Process-group set-up and a CPU launcher for sharded runs.

The counterpart of ``optimal_control_paradiag_tpu/parallel/multihost.py``.
The JAX package joins processes with ``jax.distributed``; here
:func:`initialize` maps onto ``torch.distributed.init_process_group``, with
NCCL for the card and gloo only when the caller asks for the CPU. Under
``torchrun`` it reads the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); with one process and no
rendezvous it does nothing, as the JAX helper does. One process drives one
device, so the ('time', 'space') grid spans processes:

    from optimal_control_paradiag_torch.parallel import multihost
    multihost.initialize()                    # under torchrun, on the cards
    layout = multihost.pod_layout(n_space=1)  # time axis over every rank
    run, sharding = make_sharded_solver(problem, solver, layout)

:func:`launch_cpu_group` starts a gloo group of processes on this host with
a file rendezvous, each running the same command; the CLI (``--mesh`` with
``--platform cpu``) and the tests use it where the JAX package uses its
virtual CPU devices. It never starts a rank on the card: the card's ranks
come from ``torchrun``, one per card.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from optimal_control_paradiag_torch.utils.constants import resolve_device

# The rendezvous of a launch_cpu_group child.
INIT_ENV = "PARADIAG_DIST_INIT"


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device="cuda",
    timeout_s: float = 300.0,
) -> bool:
    """Join the default process group; returns whether one is up.

    ``device`` picks the backend: 'cuda' (the default) NCCL, with this
    process on card ``LOCAL_RANK``; 'cpu' gloo. An NCCL set-up that fails
    raises: nothing falls back to gloo. ``init_method``, ``world_size`` and
    ``rank`` default to the environment (``PARADIAG_DIST_INIT`` from
    :func:`launch_cpu_group`, else torchrun's ``env://``). With one process
    and no rendezvous given this is a no-op; an explicit ``init_method``
    makes a group of one (the card's 1x1 grid). ``timeout_s`` bounds the
    rendezvous and every collective, so a lost rank fails the run instead of
    hanging it."""
    if dist.is_initialized():
        return True
    env = os.environ
    init_method = init_method or env.get(INIT_ENV)
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if init_method is None:
        if world_size == 1 and "MASTER_ADDR" not in env:
            return False
        init_method = "env://"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def free_port() -> int:
    """A TCP port on localhost that is free now (for a ``tcp://localhost``
    rendezvous of this host's processes)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def group_of_one(device="cuda", init_method: Optional[str] = None, timeout_s: float = 300.0):
    """A process group of this process alone (for a 1x1 grid, whose layout
    still issues every collective), torn down on exit. ``init_method``
    defaults to a free ``tcp://localhost`` port."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process")
    initialize(init_method or f"tcp://localhost:{free_port()}", 1, 0, device=device, timeout_s=timeout_s)
    try:
        yield
    finally:
        dist.destroy_process_group()


def pod_layout(n_space: int = 1):
    """A ('time', 'space') layout over every rank of the default group."""
    from optimal_control_paradiag_torch.parallel.sharding import make_layout

    total = dist.get_world_size() if dist.is_initialized() else 1
    if total % n_space:
        raise ValueError(f"n_space={n_space} must divide device count {total}")
    return make_layout(total // n_space, n_space)


def process_summary() -> dict:
    """Rank and size of the default group (one device per process)."""
    up = dist.is_initialized()
    count = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
        "backend": dist.get_backend() if up else None,
    }


def launch_cpu_group(
    argv: Sequence[str],
    world_size: int,
    *,
    timeout_s: float = 600.0,
    env: Optional[Dict[str, str]] = None,
) -> List[subprocess.CompletedProcess]:
    """Run ``python *argv`` as ranks ``0..world_size-1`` of a gloo group on
    this host and wait for all of them. Each child finds its rendezvous (a
    fresh ``file://`` store) and its rank in its environment, which
    :func:`initialize` reads; it must ask for the CPU itself
    (``initialize(device='cpu')``). Raises
    ``RuntimeError`` with the failing rank's stderr when a rank fails, and
    kills every rank when ``timeout_s`` passes. Returns the completed
    processes, rank order."""
    with tempfile.TemporaryDirectory(prefix="paradiag_rdv_") as tmp:
        base = dict(os.environ if env is None else env)
        base.update({
            INIT_ENV: "file://" + os.path.join(tmp, "store"),
            "WORLD_SIZE": str(world_size),
            "OMP_NUM_THREADS": base.get("OMP_NUM_THREADS", "1"),
        })
        procs = []
        logs = []
        try:
            for r in range(world_size):
                child = dict(base, RANK=str(r), LOCAL_RANK=str(r))
                out = open(os.path.join(tmp, f"out{r}"), "w+")
                err = open(os.path.join(tmp, f"err{r}"), "w+")
                logs.append((out, err))
                procs.append(subprocess.Popen([sys.executable, *argv], env=child, stdout=out, stderr=err))
            deadline = time.monotonic() + timeout_s
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
        else:
            timed_out = False
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        done = []
        for r, (p, (out, err)) in enumerate(zip(procs, logs)):
            out.seek(0)
            err.seek(0)
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out.read(), err.read()))
            out.close()
            err.close()
        if timed_out:
            tails = "\n".join(f"rank {r}: {c.stderr[-1500:]}" for r, c in enumerate(done) if c.stderr)
            raise RuntimeError(f"CPU group of {world_size} ranks did not finish within {timeout_s} s\n{tails}")
        failed = [c for c in done if c.returncode != 0]
        if failed:
            # the lowest failing rank's log; ranks that lost a peer fail too
            codes = {r: c.returncode for r, c in enumerate(done) if c.returncode != 0}
            raise RuntimeError(f"CPU group ranks exited {codes}; rank {min(codes)}:\n{failed[0].stderr[-4000:]}")
        return done
