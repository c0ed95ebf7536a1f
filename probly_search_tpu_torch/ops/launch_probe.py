"""Launch probe (P1): ``x + 1`` over a small f32 array in one kernel launch.

Counterpart of ``pallas_add`` in ``benchmarks/profile_launch.py``, the JAX
repo's probe of the fixed cost of one kernel launch.  On a CUDA tensor
``probe_add`` launches the hand-written kernel of ``csrc/launch_probe.cu``
(one 16-B word a thread; a scalar kernel for a pointer that is not 16-B
aligned); on a CPU tensor it runs ``probe_add_reference``, the plain torch
version.  ``launches`` counts kernel launches (through ``counts.add``),
never the CPU path.  The kernel launches on the current device, so the
wrapper selects the tensor's card for the call only (``torch.cuda.device``)
and leaves the caller's as it was.

The wrapper keeps its host cost small: the library's entry point is looked
up once, the stream is read as a raw handle, and it checks only what the
kernel needs (f32, contiguous, fewer than 2^31 elements).
"""

from __future__ import annotations

import torch

from . import _build, counts

launches = {"probe_add": 0}

# The probe's shape in the JAX benchmark.
SHAPE = (8, 512)

_lib = None


def probe_add_reference(x):
    """Plain torch version: ``x + 1.0``."""
    return x + 1.0


def probe_add(x):
    """``x + 1`` by one launch of the probe kernel (CUDA) or in plain torch
    (CPU).  ``x`` is a contiguous f32 tensor of fewer than 2^31 elements."""
    global _lib
    dev = x.device
    if dev.type == "cpu":
        return probe_add_reference(x)
    if dev.type != "cuda":
        raise ValueError(f"probe_add runs on cpu or cuda, not {dev}")
    index = torch.cuda.current_device()
    if dev.index is not None and dev.index != index:
        with torch.cuda.device(dev.index):  # the kernel launches on the current device
            return probe_add(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"probe_add takes a contiguous float32 tensor, got {x.dtype}")
    n = x.numel()
    if n >= 2**31:
        raise ValueError(f"probe_add takes fewer than 2^31 elements, got {n}")
    if _lib is None:
        _lib = _build.load()
    out = torch.empty_like(x)
    err = _lib.probe_add(x.data_ptr(), out.data_ptr(), n, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"probe_add launch failed: {_lib.fused_query_error_string(err).decode()}")
    counts.add(((launches, "probe_add", 1),))
    return out
