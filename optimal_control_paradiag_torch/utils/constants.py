"""Host constants and their transfer to a device.

Setup-time constants are computed in float64 numpy and cast ONCE to the
working dtype, then shipped as bytes of that exact dtype. Torch promotes a
float64 tensor times a float32 tensor to float64 (JAX's weak-typed Python
floats would not), so every constant a float32 solve touches must already be
float32: this module is the one place that cast happens.
"""

from __future__ import annotations

import numpy as np
import torch

_NP_OF_TORCH = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch (or numpy) dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NP_OF_TORCH[dtype])
    return np.dtype(dtype)


def complex_dtype(rdtype) -> torch.dtype:
    """The complex dtype that matches a real one."""
    return torch.complex64 if rdtype == torch.float32 else torch.complex128


def host_const(x, dtype) -> np.ndarray:
    """Cast a setup-time constant to ``dtype`` (torch or numpy) on the host."""
    return np.asarray(x, dtype=np_dtype(dtype))


def host_f64(t) -> np.ndarray:
    """A tensor (on any device) or array as a float64 host numpy array: the
    input of the float64 residual oracles and error metrics."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def host_array(t) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array of its own
    dtype: what the writers and checkpoints save."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def to_device(x, dtype, device) -> torch.Tensor:
    """Cast ``x`` to ``dtype`` in numpy, then copy it to ``device`` (always
    a copy: the tensor never shares memory with ``x``)."""
    return torch.from_numpy(np.array(x, dtype=np_dtype(dtype), order="C")).to(device)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no CUDA
    card is present. The port never moves to the CPU on its own: a CPU run
    is one the caller asked for with ``device='cpu'``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
