"""Tracing and profiling.

Counterpart of ``probly_search_tpu/utils/profiling.py``: phase-scoped wall
timers feeding the metrics registry, and a wrapper over ``torch.profiler``
that writes a Chrome / Perfetto trace of the host and CUDA activity.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

from .metrics import metrics


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Wall-clock a named phase (tokenize/plan/dispatch/drain/...) into the
    ``phase/<name>`` histogram."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metrics.observe(f"phase/{name}", time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (CPU, plus CUDA where
    a card is present) into ``log_dir/trace.json`` (open it in Perfetto or
    chrome://tracing).

    Usage:
        with device_trace("traces/window"):
            index.query_batch(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Decorator: time every call of fn into the metrics registry."""

    def deco(fn):
        def wrapped(*a, **kw):
            with phase(name):
                return fn(*a, **kw)

        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped

    return deco
