"""Native (C++) host components, built lazily with g++ and loaded via ctypes.

The port's copy of ``parameter_server_tpu/native/__init__.py``.  Its
sources are copies of the JAX package's: ``src/keymap.cc``, the persistent
key -> slot map behind :class:`~parameter_server_tpu_torch.utils.keys.
Localizer`, and the socket van's two wire cores, ``src/epollvan.cc`` (one
event-loop thread) and ``src/tcpvan.cc`` (a thread per connection), loaded
by :mod:`~parameter_server_tpu_torch.core.tcp_van`, and ``src/textparse.cc``,
the libsvm / Criteo parsers behind :mod:`~parameter_server_tpu_torch.data.text`.
The ABI is plain ``extern "C"`` + ctypes.

:func:`load` compiles ``src/<name>.cc`` on first use — never at import —
into ``parameter_server_tpu_torch/build/native/``; the library's file name
carries a hash of the source, the compiler and the flags, so an edited
source rebuilds and a stale library is never loaded.  It returns the loaded
CDLL, or ``None`` when no toolchain is available: callers degrade to their
numpy fallbacks, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_LIB_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build", "native")
_CXX = os.environ.get("PS_CXX", "g++")
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall"]

_lock = threading.Lock()
_cache: dict[str, Optional[ctypes.CDLL]] = {}


class NativeCompileError(RuntimeError):
    pass


def library_path(name: str) -> str:
    """Where the build of ``src/<name>.cc`` with the current compiler and
    flags lives."""
    src = os.path.join(_SRC_DIR, f"{name}.cc")
    if not os.path.exists(src):
        raise NativeCompileError(f"no native source {src}")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join([_CXX, *_FLAGS]).encode())
    return os.path.join(_LIB_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    src = os.path.join(_SRC_DIR, f"{name}.cc")
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(_LIB_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    cmd = [_CXX, *_FLAGS, src, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)  # OSError: no g++
    if proc.returncode != 0:
        raise NativeCompileError(
            f"native build failed: {' '.join(cmd)}\n{proc.stderr[-2000:]}"
        )
    os.replace(tmp, out)  # atomic vs concurrent builds in other processes
    return out


def load(name: str, *, required: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library ``name``.

    Returns None if the toolchain is missing/broken unless ``required``.
    Disable entirely with ``PS_NO_NATIVE=1`` (forces the numpy fallbacks).
    """
    with _lock:
        if name in _cache and not required:
            return _cache[name]
        if name in _cache and _cache[name] is not None:
            return _cache[name]
        if os.environ.get("PS_NO_NATIVE") and not required:
            _cache[name] = None
            return None
        try:
            path = _build(name)
            lib = ctypes.CDLL(path)
        except (NativeCompileError, OSError):
            if required:
                raise
            _cache[name] = None
            return None
        _cache[name] = lib
        return lib
