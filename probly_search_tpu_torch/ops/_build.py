"""Build the port's CUDA sources at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The library is
named by a hash of its sources and flags and kept under ``build/torch_kernels/``
beside the package, so an unchanged tree reuses it and an edited one rebuilds.
``--use_fast_math`` is deliberately absent: division must stay IEEE-rounded,
as XLA computes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libprobly_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_query_full.argtypes = [
        i, p, ctypes.c_longlong, p, p, p, p, p, p,
        i, i, i, i, i, i, f, f, i, p, p, p,
    ]
    lib.fused_query_full.restype = i
    lib.fused_query_lanes.argtypes = [
        i, p, ctypes.c_longlong, p, p, p, p, p, p,
        i, i, i, i, i, f, f, i, p, p, p,
    ]
    lib.fused_query_lanes.restype = i
    lib.fused_query_error_string.argtypes = [i]
    lib.fused_query_error_string.restype = ctypes.c_char_p
    lib.fused_query_max_smem.argtypes = [i]
    lib.fused_query_max_smem.restype = i
    return lib


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            srcs = [str(s) for s in sorted(CSRC.glob("*.cu"))]
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *srcs]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
                )
            os.replace(tmp, so)
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib
