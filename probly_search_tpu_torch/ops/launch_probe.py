"""Launch probe (P1): ``x + 1`` over a small f32 array in one kernel launch.

Counterpart of ``pallas_add`` in ``benchmarks/profile_launch.py``, the JAX
repo's probe of the fixed cost of one kernel launch.  On a CUDA tensor
``probe_add`` launches the hand-written kernel of ``csrc/launch_probe.cu``
(one block); on a CPU tensor it runs ``probe_add_reference``, the plain
torch version.  ``launches`` counts kernel launches, never the CPU path.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_query import _check

launches = {"probe_add": 0}

# The probe's shape in the JAX benchmark.
SHAPE = (8, 512)


def probe_add_reference(x):
    """Plain torch version: ``x + 1.0``."""
    return x + 1.0


def probe_add(x):
    """``x + 1`` by one launch of the probe kernel (CUDA) or in plain torch
    (CPU).  ``x`` is a contiguous f32 tensor of at most 2^31 - 1 elements."""
    if x.device.type == "cpu":
        return probe_add_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe_add runs on cpu or cuda, not {x.device}")
    _check("x", x, torch.float32, None, x.device)
    if x.numel() >= 2**31:
        raise ValueError(f"probe_add takes fewer than 2^31 elements, got {x.numel()}")
    lib = _build.load()
    out = torch.empty_like(x)
    index = torch.cuda.current_device() if x.device.index is None else x.device.index
    err = lib.probe_add(
        index, x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"probe_add launch failed: {lib.fused_query_error_string(err).decode()}")
    launches["probe_add"] += 1
    return out
