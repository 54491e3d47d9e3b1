"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain ``extern "C"`` launcher. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library, cached under
``csrc/_build/`` by a hash of the source and the flags, and loaded with
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
from typing import Dict

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(_CSRC, "_build")
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
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def load_library(source: str) -> BuiltLibrary:
    """Compile (or reuse) ``csrc/<source>`` and load it."""
    with _lock:
        if source in _cache:
            return _cache[source]
        src = os.path.join(_CSRC, source)
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        os.makedirs(_BUILD, exist_ok=True)
        stem = os.path.splitext(source)[0]
        path = os.path.join(_BUILD, f"{stem}-{digest}.so")
        log_path = path[:-3] + ".log"
        seconds = 0.0
        if not os.path.exists(path):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
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


def launch_fused_solve(name: str, fns, error_string, b_hat, consts, shapes, refine: int):
    """Check the arguments of a fused half-spectrum solve and launch it.

    ``b_hat`` must be a contiguous, resolved (2, K, n) complex CUDA tensor,
    each constant (a field of the ``consts`` dataclass named in ``shapes``,
    in the kernel's argument order) contiguous, of the matching real dtype,
    on the same device and of its shape, with K, n taken from the first
    constant; ``refine`` a non-negative int. ``fns`` maps the real dtype to
    the ctypes launcher, ``error_string`` turns its return code into text.
    Returns x, the (2, K, n) output; a refused or failed launch raises."""
    real = {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(b_hat.dtype)
    K, n = getattr(consts, next(iter(shapes))).shape
    if real is None or b_hat.shape != (2, K, n) or not b_hat.is_contiguous() or b_hat.is_conj():
        raise ValueError(
            f"b_hat must be a contiguous, resolved (2, {K}, {n}) complex tensor; "
            f"got {tuple(b_hat.shape)} {b_hat.dtype}"
        )
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
        b_hat.data_ptr(), x.data_ptr(), *ptrs, K, n, refine, device,
        torch.cuda.current_stream(b_hat.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(err).decode()} ({err})")
    return x
