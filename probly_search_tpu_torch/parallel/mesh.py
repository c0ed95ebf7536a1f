"""A ("data", "docs") grid of torch devices, driven from one process.

Counterpart of ``probly_search_tpu/parallel/mesh.py``.  The JAX engine is
single-controller: one process drives every device of its mesh through one
program.  The port keeps that model, so a mesh here is only a grid of
``torch.device``s; no ``torch.distributed`` process group is involved.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: a [data, docs] numpy object array of ``torch.device``.
    One device may fill several cells (several doc shards on one card, or
    the CPU test meshes); those cells share it."""

    axis_names = ("data", "docs")

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]), "docs": int(devices.shape[1])}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices():
    """Every visible CUDA device, each once; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh needs a CUDA device when no devices are given; none is available "
            "(pass devices=['cpu'] * n for a CPU mesh)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    data: int = 1,
    docs: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("data", "docs") mesh.

    ``devices`` defaults to every visible CUDA device; it may name one
    device more than once (``["cuda:0"] * 4``: four doc shards on one card).
    ``docs`` defaults to the devices left after the data axis."""
    devices = [_device(d) for d in (devices if devices is not None else visible_devices())]
    n = len(devices)
    if docs is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        docs = n // data
    if data * docs != n:
        raise ValueError(f"mesh {data}x{docs} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, docs))
