"""Wall-clock stage timers (the structured replacement for the reference's
``time.time()`` prints, ``Control_Wave_PC.py:196-199, 565-569``) and a
``torch.profiler`` hook.

The counterpart of ``optimal_control_paradiag_tpu/utils/timing.py``. PyTorch
returns from a CUDA operation before the card has run it, as JAX dispatch
does, so a stage fences on its result: ``torch.cuda.synchronize`` of the
fence's device (JAX: ``block_until_ready``). A CPU tensor needs no fence.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def _fence(target) -> None:
    """Wait for the card's work behind the tensor ``target``."""
    if isinstance(target, torch.Tensor) and target.is_cuda:
        torch.cuda.synchronize(target.device)


class StageTimer:
    """Collects named stage durations, summed per name into ``records`` (a
    new dict, or the caller's); device work is fenced on the supplied
    tensor (``fence=`` or ``out["fence"]`` inside the stage)."""

    def __init__(self, records: Optional[Dict[str, float]] = None):
        self.records: Dict[str, float] = {} if records is None else records

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        """Time the block as stage ``name``; under :func:`profile_trace` the
        block is also a range of that name in the trace."""
        t0 = time.perf_counter()
        out = {}
        try:
            with torch.profiler.record_function(name):
                yield out
                _fence(out.get("fence", fence))
        finally:
            self.records[name] = self.records.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        width = max((len(k) for k in self.records), default=0)
        return "\n".join(f"{k:<{width}}  {v * 1000:10.3f} ms" for k, v in self.records.items())


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Wrap a region in a ``torch.profiler`` trace when ``logdir`` is given,
    and write it to ``<logdir>/trace.json`` (Chrome trace format). The card
    is traced (CUPTI) when this process has initialised CUDA, i.e. when the
    traced work runs there; otherwise the CPU alone."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
