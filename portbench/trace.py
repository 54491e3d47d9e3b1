"""Reading a Chrome trace of ``torch.profiler`` (a copy of ``chip_smoke.py``'s ``trace_summary``).

:func:`summary` gives the traced window (first to last event), the device's
busy share (the union of kernel, memcpy and memset intervals), the device
ops with the most total time, and the longest idle gaps between device
work, each with the host op (``cpu_op`` or ``cuda_runtime``) that overlaps
it most. The per-layer metrics read :func:`device_events` and the summary.
"""

from __future__ import annotations

import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list:
    """The complete ('X') events of a Chrome trace."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def device_events(events: list) -> list:
    return sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])


def kernels(events: list) -> list:
    return [e for e in events if e.get("cat") == "kernel"]


def summary(events: list, top: int = 10) -> dict:
    """Times in seconds; raises when the trace holds no kernel (the
    profiler did not trace the card)."""
    dev = device_events(events)
    if not kernels(dev):
        raise RuntimeError("the trace holds no GPU kernel event: the profiler did not trace the card")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy = []  # union of the device intervals
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    per_op = collections.defaultdict(float)
    for e in dev:
        per_op[e["name"]] += e["dur"]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")]

    gaps = []
    inner = [(x[1], y[0]) for x, y in zip(busy, busy[1:])]
    for a, b in sorted(inner, key=lambda ab: ab[0] - ab[1])[:top]:
        # the host op that overlaps the gap most; none: Python no traced op covers
        over = [(min(b, e["ts"] + e["dur"]) - max(a, e["ts"]), -e["dur"], e.get("name")) for e in host
                if e["ts"] < b and e["ts"] + e["dur"] > a]
        name = max(over)[2] if over else "untraced host time"
        gaps.append([name[:160], (b - a) / 1e6])
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(y - x for x, y in busy) / 1e6,
        "device_ops": [[k[:160], v / 1e6] for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": gaps,
    }
