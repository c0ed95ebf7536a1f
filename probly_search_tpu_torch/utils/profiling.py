"""Tracing and profiling.

Counterpart of ``probly_search_tpu/utils/profiling.py``: a wrapper over
``torch.profiler`` that writes a Chrome / Perfetto trace of the host and
CUDA activity.  The program's spans (``utils.metrics``: ``query/plan``,
``plan/terms``, ``query/dispatch``, ...) open ranges of their names while
it records, so they show beside the kernels.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator


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

