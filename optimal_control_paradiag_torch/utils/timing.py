"""The port's measurement: spans, counters, wall-clock stage timers (the
structured replacement for the reference's ``time.time()`` prints,
``Control_Wave_PC.py:196-199, 565-569``) and a ``torch.profiler`` hook.

The counterpart of ``optimal_control_paradiag_tpu/utils/timing.py``. PyTorch
returns from a CUDA operation before the card has run it, as JAX dispatch
does, so a stage fences on its result: ``torch.cuda.synchronize`` of the
fence's device (JAX: ``block_until_ready``). A CPU tensor needs no fence.

Spans. :func:`span` is the port's one profiler range: a
``torch.profiler.record_function`` while a ``torch.profiler`` records (a
schedule's ``active`` steps, the CLI's ``--profile``), else one shared null
context, so a span costs a flag read when nothing traces. A span is a
``user_annotation`` event of the trace, on the clock of the card's kernel,
memcpy and runtime events. The port opens them at its layer boundaries:

- ``entry/wave.<method>``, ``entry/heat.<method>``: each call of a solve
  function the models build (``method``: woodbury, gmres, minres,
  spectral, eig_richardson, direct);
- ``krylov/step``: one Arnoldi step of GMRES through its host Givens
  updates, one MINRES iteration; ``krylov/restart``: GMRES's restart
  residual and solution update;
- ``pc/apply``: one preconditioner apply;
- ``transforms/dst``: one sine transform (forward or inverse), and
  inside it on a 2D space ``transforms/dst.x`` and ``transforms/dst.y``,
  its pass over each grid axis; ``transforms/time_fwd``,
  ``transforms/time_inv``: the time half of a spectral transform pair;
- ``fused/b1``, ``fused/b2``, ``fused/b3``: a call of a fused kernel's
  wrapper (the kernel on the card, its twin on the CPU);
- ``host/sync``: each place a solve waits on the device from the host.

Counters. :data:`counters` counts whether or not a profiler records:
``b1.launches``, ``b2.launches`` and ``b2.launches.<kind>``,
``b3.launches``, ``b3.launches.wgmma``, ``b3.split.launches``,
``time_pack.pack.launches``, ``time_pack.split.launches``,
``time_pack.merge.launches``, ``time_pack.unpack.launches`` and
``cgs2.launches`` (the kernels' launches; CGS2's are four a real Arnoldi
step on the card, three passes and the scale), ``pc.fulldiag.half_spectrum`` (each unsharded
'fulldiag' ParaDiag apply, which runs on the real half spectrum),
``pc.tensor_mass.applies`` (each apply of the tensor-mass surrogate's
solve, the preconditioner of the 2D consistent mass's tensor GMRES) and
``solve.tensor_gmres`` (each call of that solve), and,
through :func:`counted_span`, ``krylov/step`` and ``host/sync`` (host syncs
per Krylov step is their ratio) and the 2D sine transform's
``transforms/dst.x`` and ``transforms/dst.y``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import time
from typing import Callable, Dict, Optional

import torch

counters: collections.Counter = collections.Counter()

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """The profiler range ``name`` while a ``torch.profiler`` records, else
    one shared null context (the same object on every call)."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def counted_span(name: str):
    """:func:`span` ``name``, counted in ``counters[name]`` whether or not a
    profiler records."""
    counters[name] += 1
    return span(name)


def spanned(name: str, fn: Callable) -> Callable:
    """``fn`` with each call inside :func:`span` ``name``."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return call


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
        block is also a span of that name in the trace."""
        t0 = time.perf_counter()
        out = {}
        try:
            with span(name):
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
