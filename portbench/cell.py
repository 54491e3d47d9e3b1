"""One run of one cell: set-up, the measured window or the traced calls, and the check.

The timed path is the port's entry that the traffic names, driven in a
closed loop: one call in flight, each call (one right-hand side, or one
batch of them) ended by a device synchronize, the pool of inputs cycled
so that no call finds its input in the 50 MB L2 from the call before.
After the window the answers are judged by the plain float64 reference
(``reference/model.py``): every data set of the pool, every lane, by its
last answer from the window. A configuration with a ``"mesh"``
(``mesh.py``) runs the port on the space its own assembly builds from the
benchmark's mesh, once a run, and the reference on the same points and
triangles.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import manifest, mesh as meshes, trace as tracing, traffic as gen
from portbench.reference import model as ref


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers (``metrics/<name>.py``) read it."""

    cell: manifest.Cell
    setup_s: float
    calls: int = 0  # calls measured (the window's, or the traced ones)
    rhs: int = 0  # right-hand sides of those calls
    window_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    iterations: List[float] = dataclasses.field(default_factory=list)  # Krylov iterations per right-hand side
    peak_bytes: Optional[int] = None
    check: Dict[str, dict] = dataclasses.field(default_factory=dict)
    judged: Dict[str, list] = dataclasses.field(default_factory=dict)  # cell.judge's
    trace: Optional[dict] = None  # trace.summary of the traced calls
    events: Optional[list] = None  # their device events


def mesh_space(cell: manifest.Cell, device: torch.device):
    """The port's space of the cell's mesh in the traffic's dtype, assembled
    by the port (``fem.general.make_general_space``) from the benchmark's
    points and triangles; None on a grid."""
    spec = meshes.spec(cell.config)
    if spec is None:
        return None
    from optimal_control_paradiag_torch.fem.general import make_general_space

    m = meshes.build(spec)
    return make_general_space(m.points, m.triangles, getattr(torch, cell.traffic["dtype"]), device=device)


def problem(cell: manifest.Cell, device: torch.device, data: dict, space=None):
    """The port's problem of the cell's family, grid and traffic precision,
    on ``data``; a wave problem shares ``space`` where one is given, and a
    mesh cell's has to be (``mesh_space``, built once by the caller)."""
    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, WaveControlProblem

    if space is None and meshes.spec(cell.config) is not None:
        raise ValueError("a mesh cell's problem takes the space that mesh_space built")
    tr = cell.traffic
    cfg = ProblemConfig(**cell.config["problem_config"], dtype=getattr(torch, tr["dtype"]),
                        dst_precision=tr["dst_precision"], dst_method=tr["dst_method"])
    if cell.config["problem"] == "wave":
        return WaveControlProblem(cfg, device=device, data=data, space=space)
    return HeatControlProblem(cfg, device=device, data=data)


def member(cell: manifest.Cell, seed: int, index: int) -> dict:
    """Data set ``index`` of the pool of ``seed`` (``traffic.member``)."""
    return gen.member(cell.config["problem"], cell.config["problem_config"], cell.traffic["dtype"], seed, index,
                      meshes.spec(cell.config))


def entry(cell: manifest.Cell, device: torch.device, space=None):
    """The timed entry ``fn(b) -> (x, record)`` that the traffic names (on
    ``space``: a mesh cell's ``mesh_space``, None on a grid)."""
    from optimal_control_paradiag_torch import SolverConfig

    tr = cell.traffic
    # the entry holds no data: any data set serves to build the problem
    prob = problem(cell, device, member(cell, 0, 0), space)
    solver = SolverConfig(**tr["solver"])
    if cell.config["problem"] == "wave":
        return prob.make_batched_solver_fn(solver) if int(tr["batch"]) > 1 else prob.make_solver_fn(solver)
    return prob._make_solver(solver)  # the dispatch of HeatControlProblem.solve


def inputs(cell: manifest.Cell, seed: int, device: torch.device, space=None) -> list:
    """The pool of ``seed``: each b built by the port from a data set given
    through ``data=`` (on ``space``, as ``entry``); a batch's lanes stacked."""
    batch, pool = int(cell.traffic["batch"]), int(cell.traffic["pool"])
    first = problem(cell, device, member(cell, seed, 0), space)
    rhs = [first.rhs] + [problem(cell, device, member(cell, seed, i), first.space).rhs for i in range(1, batch * pool)]
    if batch == 1:
        return rhs
    return [torch.stack(rhs[j * batch:(j + 1) * batch]) for j in range(pool)]


def reference_mesh(cell: manifest.Cell, device: torch.device):
    """The reference's element matrices of the cell's mesh, worked out from
    the benchmark's points and triangles; None on a grid."""
    spec = meshes.spec(cell.config)
    if spec is None:
        return None
    m = meshes.build(spec)
    return ref.Elements(m.points, m.triangles, m.interior, device=device)


def judge(cell: manifest.Cell, seed: int, answers: list, device: torch.device) -> Dict[str, list]:
    """The float64 relative residual of every data set's answer (inf where
    it got none, or one that is not finite), and which data sets are the
    fixed one (``traffic.fixed``)."""
    family, pc = cell.config["problem"], cell.config["problem_config"]
    batch = int(cell.traffic["batch"])
    mesh = reference_mesh(cell, device)
    rel = [math.inf] * (batch * len(answers))
    for j, x in enumerate(answers):
        for lane in range(batch if x is not None else 0):
            i = j * batch + lane
            data = {k: torch.from_numpy(v).to(device) for k, v in member(cell, seed, i).items()}
            r = ref.rel_residual(family, pc, data, x[lane] if batch > 1 else x, mesh)
            rel[i] = math.inf if math.isnan(r) else r
    return {"rel_residual": rel, "fixed": [gen.fixed(i) for i in range(len(rel))]}


def check(cell: manifest.Cell, judged: Dict[str, list]) -> Dict[str, dict]:
    """The numbers ``correct`` compares, each with its limit: the largest
    relative residual over every data set and lane, and how many got an
    answer."""
    rel = judged["rel_residual"]
    return {
        "rel_residual": {"value": max(rel), "limit": float(cell.limits["rel_residual"])},
        "answered": {"value": sum(r != math.inf for r in rel), "limit": len(rel)},
    }


def passed(check: Dict[str, dict]) -> bool:
    return check["rel_residual"]["value"] <= check["rel_residual"]["limit"] and \
        check["answered"]["value"] >= check["answered"]["limit"]


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, wrap: Optional[Callable] = None) -> dict:
    """One run; returns the result line's object. ``t_start``: the process's
    start on ``time.perf_counter``'s clock (set-up is measured from it).
    ``wrap`` (tests only) replaces the entry by ``wrap(fn)``. The line's
    ``setup_phases`` gives the seconds from process start at which set-up's
    parts ended (the run's start, the entry, the pool, the warm-up)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = {"start": time.perf_counter() - t_start}  # set-up's parts, seconds from process start
    sp = mesh_space(cell, device)
    fn = entry(cell, device, sp)
    phases["entry"] = time.perf_counter() - t_start
    if wrap is not None:
        fn = wrap(fn)
    pool_in = inputs(cell, seed, device, sp)
    phases["pool"] = time.perf_counter() - t_start
    pool, batch = len(pool_in), int(cell.traffic["batch"])
    answers: list = [None] * pool
    measured = [0] * pool  # measured calls on each pool entry

    def call(k: int, run: Optional[Run]):
        j = k % pool
        t0 = time.perf_counter()
        x, rec = fn(pool_in[j])
        sync()
        t1 = time.perf_counter()
        answers[j] = x
        if run is not None:
            measured[j] += 1
            run.latencies_s.append(t1 - t0)
            if rec is not None and hasattr(rec, "iterations"):
                run.iterations.extend(float(i) for i in torch.as_tensor(rec.iterations).reshape(-1))
        return t1

    for k in range(pool):  # warm-up: every input shape once, so nothing builds in the window
        call(k, None)
    run = Run(cell=cell, setup_s=time.perf_counter() - t_start)
    phases["warm_up"] = run.setup_s

    if not trace:
        t0 = time.perf_counter()
        deadline, k, t1 = t0 + seconds, 0, t0
        while t1 < deadline:
            t1 = call(k, run)
            k += 1
        run.calls, run.window_s = k, t1 - t0
    else:
        run.calls = int(cell.traffic["trace_passes"]) * pool  # after one pass that warms the profiler
        tmp = tempfile.mkdtemp(prefix="portbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            act = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
            sched = torch.profiler.schedule(wait=0, warmup=pool, active=run.calls, repeat=1)
            with torch.profiler.profile(activities=act, schedule=sched,
                                        on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
                for k in range(pool + run.calls):
                    call(k, run if k >= pool else None)
                    prof.step()
            events = tracing.load(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        run.trace = tracing.summary(events)
        run.events = tracing.device_events(events)
        run.window_s = run.trace["window_s"]
    run.rhs = run.calls * batch
    if cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))

    # the program's state goes before the reference runs; its answers stay
    del fn, pool_in, sp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run.judged = judge(cell, seed, answers, device)
    del answers
    run.check = check(cell, run.judged)
    ok = passed(run.check)
    limit = run.check["rel_residual"]["limit"]
    wrong = [r > limit for r in run.judged["rel_residual"]]
    failed = sum(measured[i // batch] for i, w in enumerate(wrong) if w)  # right-hand sides answered wrong

    metrics = {}
    for m in cell.metrics:
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": ok, "attempted": run.rhs, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"]}
    out["setup_phases"] = phases
    out["check"] = run.check
    return out
