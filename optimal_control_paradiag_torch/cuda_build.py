"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain ``extern "C"`` launcher. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library, cached in
the build directory (``utils.compilation_cache.build_dir``: ``csrc/_build/``
unless ``PARADIAG_COMPILE_CACHE`` says otherwise) by a hash of the source
and the flags, and loaded with
``ctypes``. Nothing here runs at import: the first call that launches a
kernel builds it, so the package imports on machines without ``nvcc``.
A failed build raises; there is no fallback. :func:`launch_fused_solve`
checks a fused solve's tensors before their pointers reach a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from optimal_control_paradiag_torch.utils.compilation_cache import build_dir

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    seconds: float  # compile time of this process's build; 0.0 when cached
    log: str  # nvcc / ptxas output of the build (registers, spills)


_cache: Dict[str, BuiltLibrary] = {}
_locks: Dict[str, threading.Lock] = {}
_lock = threading.Lock()  # guards _locks; each source builds under its own lock


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def load_library(source: str) -> BuiltLibrary:
    """Compile (or reuse) ``csrc/<source>`` and load it. Different sources
    may build at once, from different threads."""
    with _lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _cache:
            return _cache[source]
        src = os.path.join(_CSRC, source)
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        build = build_dir()
        stem = os.path.splitext(source)[0]
        path = os.path.join(build, f"{stem}-{digest}.so")
        log_path = path[:-3] + ".log"
        seconds = 0.0
        if not os.path.exists(path):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True,
                text=True,
                timeout=600,
            )
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
            with open(log_path, "w") as fh:
                fh.write(proc.stdout + proc.stderr)
            os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as fh:
                log = fh.read()
        built = BuiltLibrary(lib=ctypes.CDLL(path), seconds=seconds, log=log)
        _cache[source] = built
        return built


def declare(lib: ctypes.CDLL, signatures: dict, error_string: str) -> ctypes.CDLL:
    """``lib`` with each launcher of ``signatures`` (name: ctypes argtypes)
    returning a C int, and its function ``error_string`` (code -> text) as
    ``lib.error_string``."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    getattr(lib, error_string).argtypes = [ctypes.c_int]
    getattr(lib, error_string).restype = ctypes.c_char_p
    lib.error_string = getattr(lib, error_string)
    return lib


def check(lib: ctypes.CDLL, what: str, err: int) -> None:
    """Raise where a launcher of ``lib`` (:func:`declare`) returned an error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.error_string(err).decode()} ({err})")


def device_and_stream(t: torch.Tensor) -> Tuple[int, int]:
    """A CUDA tensor's device index and the raw handle of that device's
    current stream (``torch.cuda.current_stream(...).cuda_stream`` would
    build a Stream object on every call, the larger part of a wrapper's
    host time)."""
    index = t.get_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


# The lanes of a batched launch ride the grid's y axis (gridDim.y <= 65535).
MAX_BATCH = 65535


def launch_fused_solve(name: str, fns, error_string, b_hat, consts, shapes, refine: int, extra=()):
    """Check the arguments of a fused half-spectrum solve and launch it.

    ``b_hat`` must be a contiguous, resolved (2, K, n) or (B, 2, K, n)
    complex CUDA tensor, 1 <= B <= :data:`MAX_BATCH` (the lanes ride the
    grid's y axis and share the constants); each constant (a field of the
    ``consts`` dataclass named in ``shapes``, in the kernel's argument order)
    contiguous, of the matching real dtype, on the same device and of its
    shape, with K, n taken from the first constant; ``refine`` a
    non-negative int. ``fns`` maps the real dtype to the ctypes launcher,
    ``error_string`` turns its return code into text; ``extra`` ints (a
    kernel's schedule) follow ``refine`` in the launcher's arguments.
    Returns x, of b_hat's shape: one launch for the whole batch; a refused
    or failed launch raises."""
    real = {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(b_hat.dtype)
    K, n = getattr(consts, next(iter(shapes))).shape
    lane_shape = tuple(b_hat.shape[-3:])
    batched = b_hat.dim() == 4
    if (real is None or lane_shape != (2, K, n) or b_hat.dim() not in (3, 4) or not b_hat.is_contiguous()
            or b_hat.is_conj()):
        raise ValueError(
            f"b_hat must be a contiguous, resolved (2, {K}, {n}) or (B, 2, {K}, {n}) complex tensor; "
            f"got {tuple(b_hat.shape)} {b_hat.dtype}"
        )
    batch = b_hat.shape[0] if batched else 1
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a batched launch takes 1 to {MAX_BATCH} lanes (the grid's y axis); got B = {batch}")
    ptrs = []
    for field, shape in shapes.items():
        t = getattr(consts, field)
        if t.dtype != real or t.device != b_hat.device or not t.is_contiguous():
            raise ValueError(f"constant {field} must be contiguous {real} on {b_hat.device}")
        if tuple(t.shape) != tuple(K if d == "K" else n if d == "n" else d for d in shape):
            raise ValueError("packed constants have inconsistent shapes")
        ptrs.append(t.data_ptr())
    if not isinstance(refine, int) or refine < 0:
        raise ValueError(f"refine must be a non-negative int, got {refine!r}")
    x = torch.empty_like(b_hat)
    device = b_hat.device.index if b_hat.device.index is not None else torch.cuda.current_device()
    err = fns[real](
        b_hat.data_ptr(), x.data_ptr(), *ptrs, K, n, batch, refine, *extra, device,
        torch.cuda.current_stream(b_hat.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(err).decode()} ({err})")
    return x
