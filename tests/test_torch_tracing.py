"""The port's spans and counters (``utils/timing.py``) on the CPU, at small
sizes: each solve path emits its spans under ``torch.profiler`` (CPU
activity), nested as the layers call each other; none is emitted while no
profiler records, or through a schedule's warm-up; GMRES reads the device
on the host ``iterations + 2`` times in one restart cycle; the launch and
Krylov counts land in ``timing.counters``."""

import json
import os
import pathlib

import pytest
import torch

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.utils import timing

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parent.parent / "optimal_control_paradiag_torch"


def _spans(prof_dir, run, schedule=None, steps=1):
    """``run(step)`` under a CPU ``torch.profiler`` for ``steps`` steps; the
    trace's program spans (``user_annotation`` events named with a '/'),
    each with ``parent``: the name of the innermost span around it."""
    path = os.path.join(prof_dir, "trace.json")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], schedule=schedule,
                                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for step in range(steps):
            run(step)
            if schedule is not None:
                prof.step()
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation" and "/" in e["name"]),
                   key=lambda e: (e["ts"], -e["dur"]))
    for e in spans:
        around = [p for p in spans if p is not e and p["tid"] == e["tid"]
                  and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        e["parent"] = min(around, key=lambda p: p["dur"])["name"] if around else None
    return spans


def _names(spans):
    return [e["name"] for e in spans]


def _parents(spans, name):
    return {e["parent"] for e in spans if e["name"] == name}


@pytest.mark.parametrize("family", ["wave", "heat"])
def test_woodbury_solve_spans(tmp_path, family):
    """The direct solve through the fused kernel's CPU twin: one entry span
    around a forward and an inverse DST, the two time transforms and one
    fused-kernel call."""
    Prob = WaveControlProblem if family == "wave" else HeatControlProblem
    prob = Prob(ProblemConfig(N_x=16, N_t=8), device="cpu")
    solver = SolverConfig(method="woodbury", use_pallas=True)
    prob.solve(solver)  # built outside the trace
    spans = _spans(str(tmp_path), lambda _: prob.solve(solver))
    entry, fused = f"entry/{family}.woodbury", "fused/b1" if family == "wave" else "fused/b2"
    assert sorted(_names(spans)) == sorted([entry, "transforms/dst", "transforms/dst", "transforms/time_fwd",
                                            "transforms/time_inv", fused])
    for name in ("transforms/dst", "transforms/time_fwd", "transforms/time_inv", fused):
        assert _parents(spans, name) == {entry}
    assert _parents(spans, entry) == {None}


def test_gmres_spans_and_host_syncs(tmp_path):
    """Float64 GMRES with the fulldiag ParaDiag preconditioner, one restart
    cycle: entry > krylov/step > pc/apply > transforms/*, a host/sync in
    each step and two more in the restart spans (iterations + 2), and the
    counters moved by the same counts, the half-spectrum apply's by
    ``iterations + 1``."""
    prob = WaveControlProblem(ProblemConfig(N_x=16, N_t=8, dtype=torch.float64), device="cpu")
    solver = SolverConfig(rtol=1e-8, pc_variant="fulldiag")
    prob.solve(solver)
    before = dict(timing.counters)
    out = {}
    spans = _spans(str(tmp_path), lambda _: out.setdefault("sol", prob.solve(solver)))
    its = int(out["sol"].result.iterations)
    assert bool(out["sol"].result.converged) and 0 < its < solver.restart  # one cycle
    names = _names(spans)
    assert names.count("entry/wave.gmres") == 1
    assert names.count("krylov/step") == its
    assert names.count("krylov/restart") == 2  # the starting residual; the update
    assert names.count("host/sync") == its + 2
    assert names.count("pc/apply") == its + 1  # each step, and the starting residual
    assert _parents(spans, "krylov/step") == _parents(spans, "krylov/restart") == {"entry/wave.gmres"}
    assert _parents(spans, "pc/apply") == {"krylov/step", "krylov/restart"}
    assert _parents(spans, "host/sync") == {"krylov/step", "krylov/restart"}
    assert _parents(spans, "transforms/dst") == _parents(spans, "transforms/time_fwd") == {"pc/apply"}
    assert _parents(spans, "transforms/time_inv") == {"pc/apply"}
    assert names.count("transforms/dst") == 2 * (its + 1)
    assert timing.counters["krylov/step"] - before.get("krylov/step", 0) == its
    assert timing.counters["host/sync"] - before.get("host/sync", 0) == its + 2
    assert timing.counters["pc.fulldiag.half_spectrum"] - before.get("pc.fulldiag.half_spectrum", 0) == its + 1


def test_minres_spans(tmp_path):
    """MINRES: one krylov/step per iteration, each ending in its host/sync,
    and the first stopping test one more."""
    prob = WaveControlProblem(ProblemConfig(N_x=16, N_t=8, dtype=torch.float64), device="cpu")
    solver = SolverConfig(method="minres", rtol=1e-10)
    out = {}
    spans = _spans(str(tmp_path), lambda _: out.setdefault("sol", prob.solve(solver)))
    its = int(out["sol"].result.iterations)
    names = _names(spans)
    assert its > 0 and names.count("krylov/step") == its and names.count("host/sync") == its + 1
    assert _parents(spans, "krylov/step") == {"entry/wave.minres"}
    assert _parents(spans, "host/sync") == {"entry/wave.minres", "krylov/step"}


def test_no_spans_while_the_profiler_waits_or_warms_up(tmp_path):
    """Under a schedule of one waiting, one warm-up and one active step, only
    the active step's solve leaves spans; the stage timer's range is a span
    too."""
    prob = WaveControlProblem(ProblemConfig(N_x=16, N_t=8), device="cpu")
    solver = SolverConfig(method="woodbury", use_pallas=True)
    timer = timing.StageTimer()

    def step(i):
        with timer.stage(f"stage/{i}"):
            prob.solve(solver)

    spans = _spans(str(tmp_path), step, schedule=torch.profiler.schedule(wait=1, warmup=1, active=1, repeat=1),
                   steps=3)
    names = _names(spans)
    assert names.count("entry/wave.woodbury") == 1 and "stage/2" in names
    assert "stage/0" not in names and "stage/1" not in names
    assert _parents(spans, "entry/wave.woodbury") == {"stage/2"}


def test_span_is_one_shared_null_context_when_off():
    assert not torch._C._autograd._profiler_enabled()
    assert timing.span("a/b") is timing.span("c/d")
    with timing.span("a/b") as inside:
        assert inside is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = timing.span("a/b")
        assert on is not timing.span("a/b") and isinstance(on, torch.profiler.record_function)


def test_record_function_only_in_the_timing_module():
    """Every span of the port goes through ``utils/timing.span``."""
    users = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py") if "record_function" in p.read_text())
    assert users == ["utils/timing.py"]
