"""Kernel and program launch counters that several threads move at once.

Every wrapper keeps its counters as plain dicts (``fused_query.launches``,
``fused_merge.path_calls``, ...) and moves them only through ``add``, under
one lock, so launches from concurrent threads lose no increment.

Capturing a step into a CUDA graph runs nothing, yet its wrappers count
their launches as they record them.  While a thread captures
(``diverted``), that thread's counts, and only that thread's, go into the
capture's delta instead; every other thread goes on counting into the
counters.  A graph adds its delta back (``add``) on each replay.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_lock = threading.Lock()
_local = threading.local()


def add(delta) -> None:
    """Add ``delta``, ``[(counters, key, n), ...]``, to the counters, or to
    the calling thread's capture delta while it captures."""
    sink = getattr(_local, "sink", None)
    if sink is not None:
        for counts, key, n in delta:
            entry = sink.setdefault((id(counts), key), [counts, key, 0])
            entry[2] += n
        return
    with _lock:
        for counts, key, n in delta:
            counts[key] = counts.get(key, 0) + n


@contextmanager
def diverted():
    """Within the block, the calling thread's counts go into the yielded
    list (its delta, ``[(counters, key, n), ...]``, filled at exit) and not
    into the counters."""
    outer = getattr(_local, "sink", None)
    sink: dict = {}
    delta: list = []
    _local.sink = sink
    try:
        yield delta
    finally:
        _local.sink = outer
        delta.extend(tuple(entry) for entry in sink.values() if entry[2])
