"""Persistent cache of the port's compiled artifacts.

The counterpart of ``optimal_control_paradiag_tpu/utils/compilation_cache.py``.
The JAX package points XLA's persistent compilation cache at a directory;
the port compiles no XLA programs, and its compiled artifacts are the
hand-written CUDA kernels (``nvcc``, ``cuda_build.py``) and the native host
runtime (``g++``, ``native/__init__.py``). Both build into
:func:`build_dir`, each library under a name that carries a hash of its
source and flags, so a later process reuses it.

``PARADIAG_COMPILE_CACHE`` (or :func:`enable_persistent_cache`'s ``path``)
names that directory; the default is ``csrc/_build/`` inside the package
(git-ignored). ``off`` still builds, but into a private temporary directory
of this process, removed at exit: nothing is reused across processes.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional

ENV = "PARADIAG_COMPILE_CACHE"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "_build")

_chosen: Optional[str] = None  # set by enable_persistent_cache
_private: Optional[str] = None  # this process's directory under 'off'


def _private_dir() -> str:
    global _private
    if _private is None:
        _private = tempfile.mkdtemp(prefix="paradiag_build_")
        atexit.register(shutil.rmtree, _private, True)
    return _private


def _resolve(path: Optional[str]) -> Optional[str]:
    """The cache directory ``path`` names (the environment's when None),
    or None for 'off'."""
    path = path or os.environ.get(ENV)
    if path == "off":
        return None
    return os.path.abspath(path) if path else DEFAULT_DIR


def enable_persistent_cache(path: Optional[str] = None) -> Optional[str]:
    """Build and reuse the compiled artifacts in ``path`` (default:
    ``PARADIAG_COMPILE_CACHE``, else ``csrc/_build/``); ``'off'`` builds
    into a private temporary directory instead. Returns the directory used,
    None when the cache is off. The CLI calls it at start-up, where the JAX
    CLI enables its cache."""
    global _chosen
    resolved = _resolve(path)
    _chosen = _private_dir() if resolved is None else resolved
    os.makedirs(_chosen, exist_ok=True)
    return resolved


def build_dir() -> str:
    """Where a build goes now: the directory :func:`enable_persistent_cache`
    chose, else the one ``PARADIAG_COMPILE_CACHE`` names (a private
    temporary one for 'off'); created if missing."""
    target = _chosen
    if target is None:
        resolved = _resolve(None)
        target = _private_dir() if resolved is None else resolved
    os.makedirs(target, exist_ok=True)
    return target
