"""The program's spans in a traced run, joined to the device's events.

The port opens a span (a ``user_annotation`` event of ``torch.profiler``'s
Chrome trace, on the clock of the CUPTI kernel, memcpy and runtime events)
at each layer boundary and at each host sync (``utils/timing.py`` of the
port). Here:

- :func:`host_events` keeps what a traced run needs of the host side: the
  spans and the launch events (``cuda_runtime``, and ``cuda_driver``:
  cuFFT, and a kernel launched through the driver API, come through it);
- :func:`joined` joins each device event (``trace.DEVICE_CATS``) to its
  launch by ``args.correlation``. A device event lies *within* a span if its
  launch starts inside the span, on the span's thread. Where more than 1 %
  of the joined device events start before their launch does, the host and
  device clocks disagree and :func:`joined` returns None, so every reading
  below is None too;
- the readings: device time within the sine transforms' spans and within
  the time transforms' per right-hand side, host syncs per Krylov step,
  device idle time inside the Krylov steps, the lead from an entry span's
  start to its first device event; and, for PERF.md, :func:`coverage` and
  the idle time by innermost span (:func:`idle_by_span`).

``python3 -m portbench.spans <trace.json> --rhs <n>`` prints them all for a
saved trace of ``n`` right-hand sides.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import trace

SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CLOCK_SKEW_LIMIT = 0.01  # the share of device events allowed to start before their launch

DST = ("transforms/dst",)
TIME = ("transforms/time_fwd", "transforms/time_inv")
ENTRY = ("entry/",)
KRYLOV = ("krylov/",)


def is_span(e: dict) -> bool:
    """A span of the program: its names hold a '/' (the profiler's own
    ``ProfilerStep#n`` ranges hold none)."""
    return e.get("cat") == SPAN_CAT and "/" in e.get("name", "")


def host_events(events: Iterable[dict]) -> list:
    """The program's spans and the launch events of a loaded trace
    (``trace.load``)."""
    return [e for e in events if is_span(e) or e.get("cat") in LAUNCH_CATS]


def matches(name: str, keys: Sequence[str]) -> bool:
    """``name`` is one of ``keys``, or starts with a key that ends in '/'."""
    return any(name == k or (k.endswith("/") and name.startswith(k)) for k in keys)


def _correlation(e: dict) -> Optional[int]:
    c = (e.get("args") or {}).get("correlation")
    return c if isinstance(c, int) and c > 0 else None


def _thread(e: dict) -> Tuple:
    return e.get("pid"), e.get("tid")


@dataclasses.dataclass
class Joined:
    spans: List[dict]  # the program's spans, by start
    device: List[dict]  # every device event, by start
    launch: Dict[int, dict]  # id() of a joined device event -> its launch event

    def count(self, keys: Sequence[str]) -> int:
        return sum(matches(s["name"], keys) for s in self.spans)

    def _intervals(self, keys: Sequence[str]) -> Dict[Tuple, List[Tuple[float, float]]]:
        """Per thread, the union of the intervals of the spans ``keys`` names."""
        per = collections.defaultdict(list)
        for s in self.spans:
            if matches(s["name"], keys):
                per[_thread(s)].append((s["ts"], s["ts"] + s["dur"]))
        return {t: _union(iv) for t, iv in per.items()}

    def within(self, keys: Sequence[str]) -> List[dict]:
        """The device events whose launch starts inside a span ``keys``
        names, on that span's thread."""
        iv = self._intervals(keys)
        starts = {t: [a for a, _ in u] for t, u in iv.items()}
        out = []
        for d in self.device:
            la = self.launch.get(id(d))
            if la is None or _thread(la) not in iv:
                continue
            u, t = iv[_thread(la)], la["ts"]
            i = bisect.bisect_right(starts[_thread(la)], t) - 1
            if i >= 0 and u[i][0] <= t <= u[i][1]:
                out.append(d)
        return out

    def device_ms_within(self, keys: Sequence[str]) -> float:
        return sum(d["dur"] for d in self.within(keys)) / 1e3


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(busy: List[Tuple[float, float]], starts: List[float], a: float, b: float) -> float:
    """The part of [a, b] the sorted disjoint intervals ``busy`` cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(busy) and busy[i][0] < b:
        got += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return got


def joined(host: Optional[list], device: Optional[list]) -> Optional[Joined]:
    """The spans and device events of a traced run, each device event joined
    to its launch; None without spans or device events, or where the clocks
    disagree (more than :data:`CLOCK_SKEW_LIMIT` of the joined events start
    before their launch)."""
    if not host or not device:
        return None
    spans = sorted((e for e in host if is_span(e)), key=lambda e: (e["ts"], -e["dur"]))
    launches = {}
    for e in host:
        c = _correlation(e) if e.get("cat") in LAUNCH_CATS else None
        if c is not None:
            launches[c] = e
    dev = sorted((e for e in device if e.get("cat") in trace.DEVICE_CATS), key=lambda e: e["ts"])
    launch = {}
    for d in dev:
        la = launches.get(_correlation(d))
        if la is not None:
            launch[id(d)] = la
    if not spans or not launch:
        return None
    early = sum(d["ts"] < launch[id(d)]["ts"] for d in dev if id(d) in launch)
    if early > CLOCK_SKEW_LIMIT * len(launch):
        return None
    return Joined(spans=spans, device=dev, launch=launch)


# ------------------------------------------------------------------ readings


def dst_span_ms_per_rhs(j: Optional[Joined], rhs: int) -> Optional[float]:
    """Device ms within ``transforms/dst`` spans per right-hand side."""
    if j is None or rhs <= 0 or not j.count(DST):
        return None
    return j.device_ms_within(DST) / rhs


def time_transform_ms_per_rhs(j: Optional[Joined], rhs: int) -> Optional[float]:
    """Device ms within ``transforms/time_fwd`` or ``transforms/time_inv``
    spans per right-hand side."""
    if j is None or rhs <= 0 or not j.count(TIME):
        return None
    return j.device_ms_within(TIME) / rhs


def host_syncs_per_step(j: Optional[Joined]) -> Optional[float]:
    """``host/sync`` spans over ``krylov/step`` spans."""
    steps = j.count(("krylov/step",)) if j is not None else 0
    return j.count(("host/sync",)) / steps if steps else None


def krylov_idle_ms_per_step(j: Optional[Joined]) -> Optional[float]:
    """Summed over the ``krylov/step`` spans: the span's length less the part
    of it the union of the device's intervals covers; per step, in ms."""
    if j is None:
        return None
    steps = [s for s in j.spans if s["name"] == "krylov/step"]
    if not steps:
        return None
    busy = _union([(d["ts"], d["ts"] + d["dur"]) for d in j.device])
    starts = [a for a, _ in busy]
    idle = sum(s["dur"] - _covered(busy, starts, s["ts"], s["ts"] + s["dur"]) for s in steps)
    return idle / 1e3 / len(steps)


def entry_lead_ms(j: Optional[Joined]) -> Optional[float]:
    """The mean over ``entry/*`` spans of the start of the first device event
    within the span less the span's start, ms; spans with no device event
    within them are left out."""
    if j is None:
        return None
    first: Dict[int, float] = {}
    entries = [s for s in j.spans if matches(s["name"], ENTRY)]
    for d in j.device:
        la = j.launch.get(id(d))
        if la is None:
            continue
        for k, s in enumerate(entries):
            if _thread(s) == _thread(la) and s["ts"] <= la["ts"] <= s["ts"] + s["dur"]:
                first[k] = min(first.get(k, d["ts"]), d["ts"])
    if not first:
        return None
    return sum(first[k] - entries[k]["ts"] for k in first) / len(first) / 1e3


# ------------------------------------------------------------------ coverage


def coverage(j: Joined) -> dict:
    """Shares for PERF.md: device time within ``entry/*`` and within
    ``krylov/*`` spans, and the kernel events joined to their launch."""
    total = sum(d["dur"] for d in j.device)
    kernels = [d for d in j.device if d.get("cat") == "kernel"]
    return {
        "device_ms": total / 1e3,
        "entry_share": sum(d["dur"] for d in j.within(ENTRY)) / total if total else None,
        "krylov_share": sum(d["dur"] for d in j.within(KRYLOV)) / total if total else None,
        "kernels_joined_share": sum(id(d) in j.launch for d in kernels) / len(kernels) if kernels else None,
    }


NO_SPAN = "(no span)"


class _Sweep:
    """The innermost span open at each instant, for instants taken in
    increasing order, on one thread (where spans nest)."""

    def __init__(self, spans: List[dict]):
        self.spans = spans
        # a span opens after any that closes at its start, outer before inner
        self.marks = sorted([(s["ts"], 1, -s["dur"], k) for k, s in enumerate(spans)]
                            + [(s["ts"] + s["dur"], 0, 0, k) for k, s in enumerate(spans)])
        self.m, self.stack = 0, []

    def at(self, t: float) -> str:
        """The innermost span open at ``t``; moves the sweep to ``t``."""
        while self.m < len(self.marks) and self.marks[self.m][0] <= t:
            _, opens, _, k = self.marks[self.m]
            if opens:
                self.stack.append(k)
            elif k in self.stack:
                self.stack.remove(k)
            self.m += 1
        return self.spans[self.stack[-1]]["name"] if self.stack else NO_SPAN

    def next_mark(self, default: float) -> float:
        return min(default, self.marks[self.m][0]) if self.m < len(self.marks) else default


def _main_thread(j: Joined) -> Tuple:
    return collections.Counter(_thread(s) for s in j.spans).most_common(1)[0][0]


def idle_by_span(j: Joined) -> Dict[str, float]:
    """The device's idle time between its first and last event, split by the
    innermost span open on the host at each instant (on the thread with the
    most spans; :data:`NO_SPAN` where none is), ms."""
    main = _main_thread(j)
    sweep = _Sweep([s for s in j.spans if _thread(s) == main])
    busy = _union([(d["ts"], d["ts"] + d["dur"]) for d in j.device])
    out: Dict[str, float] = collections.defaultdict(float)
    for a, b in ((x[1], y[0]) for x, y in zip(busy, busy[1:]) if y[0] > x[1]):
        t = a
        while t < b:
            name = sweep.at(t)
            nxt = sweep.next_mark(b)
            out[name] += nxt - t
            t = nxt
    return {k: v / 1e3 for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def device_ms_by_span(j: Joined) -> Dict[str, float]:
    """Device time by the innermost span around each device event's launch
    (on the thread with the most spans; :data:`NO_SPAN` for events whose
    launch lies in none, or on another thread, or that found no launch), ms."""
    main = _main_thread(j)
    sweep = _Sweep([s for s in j.spans if _thread(s) == main])
    out: Dict[str, float] = collections.defaultdict(float)
    launched = sorted(((j.launch.get(id(d)), d) for d in j.device),
                      key=lambda ld: ld[0]["ts"] if ld[0] is not None else float("inf"))
    for la, d in launched:
        name = sweep.at(la["ts"]) if la is not None and _thread(la) == main else NO_SPAN
        out[name] += d["dur"]
    return {k: v / 1e3 for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def report(events: list, rhs: int) -> dict:
    """Every reading of a loaded trace (``trace.load``) of ``rhs``
    right-hand sides."""
    j = joined(host_events(events), trace.device_events(events))
    if j is None:
        return {"joined": False}
    return {
        "joined": True,
        "dst_span_ms_per_rhs": dst_span_ms_per_rhs(j, rhs),
        "time_transform_ms_per_rhs": time_transform_ms_per_rhs(j, rhs),
        "host_syncs_per_step": host_syncs_per_step(j),
        "krylov_idle_ms_per_step": krylov_idle_ms_per_step(j),
        "entry_lead_ms": entry_lead_ms(j),
        "spans": dict(collections.Counter(s["name"] for s in j.spans)),
        "coverage": coverage(j),
        "idle_ms_by_innermost_span": idle_by_span(j),
        "device_ms_by_innermost_span": device_ms_by_span(j),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the program's spans in a saved torch.profiler trace")
    ap.add_argument("trace")
    ap.add_argument("--rhs", type=int, required=True, help="right-hand sides solved in the traced window")
    args = ap.parse_args(argv)
    print(json.dumps(report(trace.load(args.trace), args.rhs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
