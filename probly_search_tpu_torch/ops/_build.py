"""Build the port's CUDA sources at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds): one ``nvcc -c`` per
source, all started together, then one link.  The library is
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    lib.fused_z2o.argtypes = [
        i, p, ctypes.c_longlong, p, p, p, p, p, p, p,
        i, i, i, i, i, p, p, p,
    ]
    lib.fused_z2o.restype = i
    lib.fused_z2o_smem_bytes.argtypes = [i, i, i]
    lib.fused_z2o_smem_bytes.restype = ctypes.c_longlong
    lib.merge_topk.argtypes = [i, p, p, i, i, i, i, i, i, p, p, p, p]
    lib.merge_topk.restype = i
    lib.merge_topk_workspace.argtypes = [i, i, i]
    lib.merge_topk_workspace.restype = ctypes.c_longlong
    lib.probe_add.argtypes = [i, p, p, i, p]
    lib.probe_add.restype = i
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
            tag = f"{so.stem}.{os.getpid()}"
            nvcc = _nvcc()
            jobs = []
            for src in sorted(CSRC.glob("*.cu")):
                obj = BUILD_DIR / f"{tag}.{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
                )))
            for cmd, _obj, proc in jobs:
                err = proc.communicate()[1]
                _check(cmd, proc.returncode, err)
            tmp = so.with_name(f"{tag}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _c, o, _p in jobs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            _check(cmd, res.returncode, res.stderr)
            for _cmd, obj, _proc in jobs:
                obj.unlink()
            os.replace(tmp, so)
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib


def _check(cmd, returncode: int, stderr: str) -> None:
    if returncode:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stderr}")
