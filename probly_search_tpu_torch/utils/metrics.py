"""Metrics / observability.

The reference has none (SURVEY §5: no logging crate, no timers).  New
subsystem: cheap process-local counters, gauges and timed spans with a
snapshot API, plus index-level stats (docs, terms, postings, deleted
ratio, HBM bytes).

A span (``Registry.timer``) sums, by name, its count and wall time, its
self time (the wall time less that of the spans opened inside it on the
same thread), the work items its caller credits to it, and, over the spans
that ask for it (``time_cpu``), the thread's CPU time and the wall time it
held no CPU.  Only those read the thread's CPU clock, a system call: 2-3 us
a read on an H100 host, against ~2 us for a whole span without it, and
with two reads in every span type-ahead serving there lost a third of its
queries per second.  While a ``torch.profiler`` records, a span also opens
a ``record_function`` range of its name, so the program's spans sit on the
kernels' clock in a device trace; otherwise it opens none.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_wall_ns = time.perf_counter_ns


@dataclass(slots=True)
class Histogram:
    """The sums of one span name, in microseconds."""

    total: int = 0
    sum_us: float = 0.0
    self_us: float = 0.0
    cpu_us: float = 0.0
    offcpu_us: float = 0.0
    items: int = 0

    @property
    def mean_us(self) -> float:
        return self.sum_us / self.total if self.total else 0.0


class _Thread(threading.local):
    span = None  # the innermost span open on the thread


class _Span:
    """One timed span of ``Registry.timer``."""

    __slots__ = ("_reg", "_name", "items", "_child_ns", "_range", "_parent", "_c0", "_t0")

    def __enter__(self) -> "_Span":
        if _profiler_enabled():  # record_function costs ~17 us with no profiler
            self._range = record_function(self._name)
            self._range.__enter__()
        thread = self._reg._thread
        self._parent = thread.span
        thread.span = self
        self._t0 = _wall_ns()
        return self

    def __exit__(self, et, ev, tb) -> None:
        cpu = None if self._c0 is None else time.thread_time_ns() - self._c0
        wall = _wall_ns() - self._t0
        reg = self._reg
        reg._thread.span = parent = self._parent
        if parent is not None:
            parent._child_ns += wall
        with reg._lock:
            h = reg.histograms[self._name]
            h.total += 1
            h.sum_us += wall / 1e3
            h.self_us += (wall - self._child_ns) / 1e3
            if cpu is not None:
                h.cpu_us += cpu / 1e3
                h.offcpu_us += (wall - cpu) / 1e3
            h.items += self.items
        if self._range is not None:
            self._range.__exit__(et, ev, tb)


class Registry:
    """Process-local metric registry (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._thread = _Thread()
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = defaultdict(Histogram)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def timer(self, name: str, items: int = 0) -> _Span:
        """A span of ``name`` over the ``with`` block, crediting it with
        ``items`` units of work."""
        span = _Span()
        span._reg = self
        span._name = name
        span.items = items
        span._child_ns = 0
        span._range = span._c0 = None
        return span

    def add_items(self, n: int) -> None:
        """Credit ``n`` units of work to the innermost span open on the
        calling thread (for a count known only inside the span, or a span
        opened through a wrapper that passes its name alone)."""
        self._thread.span.items += n

    def time_cpu(self) -> None:
        """Sum the calling thread's CPU time from now to the end of the
        innermost span open on it into that span's ``cpu_us``, and the
        span's wall time less it into ``offcpu_us``."""
        self._thread.span._c0 = time.thread_time_ns()

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {
                    k: {
                        "count": h.total,
                        "mean_us": h.mean_us,
                        "self_us": h.self_us,
                        "cpu_us": h.cpu_us,
                        "offcpu_us": h.offcpu_us,
                        "items": h.items,
                    }
                    for k, h in self.histograms.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


metrics = Registry()  # the default process-wide registry


def index_stats(index) -> Dict[str, float]:
    """Index-level gauges: docs, terms, postings, deleted ratio, HBM bytes."""
    index._flush_pending()
    n_postings = sum(seg.num_postings for seg in index._segments)
    n_terms = sum(seg.num_terms for seg in index._segments)
    n_slots = index._next_slot
    live = len(index._docs)
    F = index.num_fields
    # Posting record array (device layout, index/device.py): doc slot +
    # per-field tf + per-field length + liveness row, padded to the
    # sublane multiple of 4.
    rec_rows = -(-(1 + 2 * F) // 4) * 4
    hbm = rec_rows * 4 * n_postings
    return {
        "docs_live": float(live),
        "doc_slots": float(n_slots),
        "terms": float(n_terms),
        "postings": float(n_postings),
        "segments": float(len(index._segments)),
        "deleted_ratio": float(n_slots - live) / n_slots if n_slots else 0.0,
        "device_bytes": float(hbm),
    }
