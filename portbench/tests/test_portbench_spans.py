"""``portbench/spans.py`` on hand-built Chrome-trace fixtures: the
correlation join through the runtime and the driver API, the *within* rule
where spans nest and where a launch is on another thread, idle time inside
a span, the clock check, and each reading."""

import json

import pytest

from portbench import spans, trace

MAIN, OTHER, STREAM = (1, 1), (1, 2), (0, 7)


def span(name, ts, dur, thread=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": thread[0], "tid": thread[1], "ts": ts, "dur": dur,
            "args": {}}


def launch(corr, ts, cat="cuda_runtime", thread=MAIN):
    name = "cudaLaunchKernel" if cat == "cuda_runtime" else "cuLaunchKernel"
    return {"ph": "X", "cat": cat, "name": name, "pid": thread[0], "tid": thread[1], "ts": ts, "dur": 0.5,
            "args": {"correlation": corr}}


def kernel(corr, ts, dur, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": STREAM[0], "tid": STREAM[1], "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def direct_call():
    """One direct solve: entry > dst, time_fwd (its cuFFT kernel launched
    through the driver API), fused/b1, time_inv, dst; then one kernel
    launched outside every span, and a profiler step range."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#3", "pid": 1, "tid": 1, "ts": -5, "dur": 200},
        span("entry/wave.woodbury", 0, 100),
        span("transforms/dst", 10, 20), launch(1, 12), kernel(1, 20, 15, "gemm"),
        span("transforms/time_fwd", 30, 10), launch(2, 32, "cuda_driver"), kernel(2, 36, 5, "fft"),
        span("fused/b1", 40, 10), launch(3, 42), kernel(3, 42.5, 6, "woodbury_slab_kernel"),
        span("transforms/time_inv", 50, 10), launch(4, 52), kernel(4, 53, 4, "copy", "gpu_memcpy"),
        span("transforms/dst", 60, 20), launch(5, 62), kernel(5, 63, 15, "gemm"),
        launch(6, 105), kernel(6, 106, 1, "elementwise"),
    ]


def krylov_steps():
    """Two GMRES steps of 100 us, each with 40 us of device work and a
    host/sync at its end; a pc/apply around a dst in the first."""
    ev = [span("entry/wave.gmres", 190, 230)]
    for i, t0 in enumerate((200, 310)):
        ev += [span("krylov/step", t0, 100), span("host/sync", t0 + 80, 20),
               launch(10 + i, t0 + 5), kernel(10 + i, t0 + 10, 40, "bmm")]
    ev += [span("pc/apply", 220, 30), span("transforms/dst", 222, 18), launch(20, 225), kernel(20, 260, 1, "gemm")]
    ev += [span("krylov/restart", 411, 8), span("host/sync", 412, 6)]
    return ev


def split(events):
    return spans.host_events(events), trace.device_events(events)


def test_join_runtime_and_driver_launches():
    j = spans.joined(*split(direct_call()))
    assert len(j.launch) == 6  # every device event, both launch APIs
    names = {d["name"]: j.launch[id(d)]["cat"] for d in j.device}
    assert names["fft"] == "cuda_driver" and names["gemm"] == "cuda_runtime"
    assert [s["name"] for s in j.spans][0] == "entry/wave.woodbury"  # the profiler's step range is no span


def test_within_nested_spans_and_threads():
    ev = krylov_steps() + [span("transforms/dst", 500, 50, OTHER), launch(30, 510, thread=MAIN),
                           kernel(30, 520, 2, "gemm"), launch(31, 520, thread=OTHER), kernel(31, 530, 3, "gemm")]
    j = spans.joined(*split(ev))
    # the dst kernel launched inside pc/apply > transforms/dst lies within both and within krylov/step
    assert {d["args"]["correlation"] for d in j.within(("transforms/dst",))} == {20, 31}
    assert {d["args"]["correlation"] for d in j.within(("pc/apply",))} == {20}
    assert {d["args"]["correlation"] for d in j.within(("krylov/",))} == {10, 11, 20}
    # a launch on the main thread while the other thread's span is open is not within it
    assert 30 not in {d["args"]["correlation"] for d in j.within(("transforms/dst",))}
    assert j.device_ms_within(("entry/",)) == pytest.approx((40 + 40 + 1) / 1e3)


def test_idle_inside_a_span():
    j = spans.joined(*split(krylov_steps()))
    # step 1: 100 us less [210, 250] and [260, 261]; step 2: 100 less [320, 360]
    assert spans.krylov_idle_ms_per_step(j) == pytest.approx((59 + 60) / 2 / 1e3)
    idle = spans.idle_by_span(j)
    # the gaps between busy intervals: 250-260 and 261-320 (step 1 to 300, the entry to 310, step 2 after)
    assert idle["krylov/step"] == pytest.approx((10 + 19 + 10) / 1e3)
    assert idle["host/sync"] == pytest.approx(20 / 1e3)
    assert idle["entry/wave.gmres"] == pytest.approx(10 / 1e3)


def test_clock_check():
    ev = direct_call()
    for e in ev:
        if e.get("cat") in trace.DEVICE_CATS and e["args"]["correlation"] in (1, 3):
            e["ts"] = 0.0  # before its launch: 2 of 6
    j = spans.joined(*split(ev))
    assert j is None
    assert spans.dst_span_ms_per_rhs(j, 1) is None and spans.time_transform_ms_per_rhs(j, 1) is None
    assert spans.host_syncs_per_step(j) is None and spans.krylov_idle_ms_per_step(j) is None
    assert spans.entry_lead_ms(j) is None
    assert spans.joined([], trace.device_events(ev)) is None  # no program spans: the parent commit


def test_readers_on_a_direct_call():
    j = spans.joined(*split(direct_call()))
    assert spans.dst_span_ms_per_rhs(j, 1) == pytest.approx(30 / 1e3)
    assert spans.time_transform_ms_per_rhs(j, 1) == pytest.approx(9 / 1e3)
    assert spans.dst_span_ms_per_rhs(j, 2) == pytest.approx(15 / 1e3)
    assert spans.entry_lead_ms(j) == pytest.approx(20 / 1e3)
    assert spans.host_syncs_per_step(j) is None and spans.krylov_idle_ms_per_step(j) is None
    by_span = spans.device_ms_by_span(j)
    assert by_span["transforms/dst"] == pytest.approx(30 / 1e3) and by_span[spans.NO_SPAN] == pytest.approx(1e-3)
    idle = spans.idle_by_span(j)
    assert idle["fused/b1"] == pytest.approx((1.5 + 1.5) / 1e3)
    assert idle[spans.NO_SPAN] == pytest.approx(6 / 1e3)
    assert idle["entry/wave.woodbury"] == pytest.approx(20 / 1e3)


def test_readers_on_krylov_steps():
    j = spans.joined(*split(krylov_steps()))
    assert spans.host_syncs_per_step(j) == 1.5  # 2 in the steps, 1 in the restart
    assert spans.entry_lead_ms(j) == pytest.approx(20 / 1e3)
    cov = spans.coverage(j)
    assert cov["entry_share"] == 1.0 and cov["krylov_share"] == 1.0 and cov["kernels_joined_share"] == 1.0


def test_report_of_a_saved_trace(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": direct_call() + krylov_steps()}))
    assert spans.main([str(path), "--rhs", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["joined"] and out["spans"]["transforms/dst"] == 3 and out["host_syncs_per_step"] == 1.5
    assert out["coverage"]["kernels_joined_share"] == 1.0


def test_host_syncs_per_step_reads_the_port_counters(monkeypatch):
    """The ``host_syncs_per_step`` metric of a traced run: the port's counts;
    None before a trace, and where the port keeps no counts (the parent
    commit)."""
    from optimal_control_paradiag_torch.utils import timing
    from portbench import manifest
    from portbench.cell import Run
    from portbench_helpers import tiny

    read = manifest.load_reader("host_syncs_per_step")
    run = Run(cell=tiny("wave1d_headline.gmres_f64"), setup_s=1.0)
    monkeypatch.setattr(timing, "counters", timing.collections.Counter({"krylov/step": 50, "host/sync": 66}))
    assert read(run) is None
    run.trace = {"window_s": 1.0, "busy_s": 0.5}
    assert read(run) == pytest.approx(1.32)
    monkeypatch.delattr(timing, "counters")
    assert read(run) is None
