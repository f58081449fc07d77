"""Build and load the CUDA row kernels (``csrc/scatter_kernels.cu``).

The source has a plain C interface, so it is compiled by ``nvcc`` straight
into a shared library and loaded with ctypes: no PyTorch headers, a build of
seconds.  The build happens at first use, never at import, into
``parameter_server_tpu_torch/build/``; the library's file name carries a hash
of the source and the flags, so an edited source rebuilds and a stale library
is never loaded.  Only sources inside this package are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "scatter_kernels.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no multiply-add contraction: the apply rule rounds each operation as
    # the plain PyTorch version (kv/optim.py) does
    "-fmad=false",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: wall seconds the last build took (0.0 when an existing library was loaded)
build_seconds = 0.0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "ps_gather": [_P, _P, _P, _I64, _I64, _I64, _P],
    "ps_scatter_set": [_P, _P, _P, _I64, _I64, _I64, _P],
    "ps_scatter_add": [_P, _P, _P, _I64, _I64, _I64, _P],
    "ps_apply": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64]
    + [_F] * 10
    + [_P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA row "
        "kernels are built from source at first use"
    )


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libps_scatter_{digest.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: concurrent builds (several
    # processes sharing a checkout) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
