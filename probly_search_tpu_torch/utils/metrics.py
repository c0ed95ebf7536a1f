"""Metrics / observability.

The reference has none (SURVEY §5: no logging crate, no timers).  New
subsystem: cheap process-local counters, gauges and latency histograms with
a snapshot API, plus index-level stats (docs, terms, postings, deleted
ratio, HBM bytes).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List


_BUCKET_BOUNDS_US = [
    10, 20, 50, 100, 200, 500,
    1_000, 2_000, 5_000, 10_000, 20_000, 50_000,
    100_000, 200_000, 500_000, 1_000_000, 5_000_000,
]


@dataclass
class Histogram:
    """Fixed-bucket latency histogram (microseconds)."""

    counts: List[int] = field(default_factory=lambda: [0] * (len(_BUCKET_BOUNDS_US) + 1))
    total: int = 0
    sum_us: float = 0.0

    def observe_us(self, us: float) -> None:
        self.counts[bisect.bisect_left(_BUCKET_BOUNDS_US, us)] += 1
        self.total += 1
        self.sum_us += us

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket upper bounds."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return float(
                    _BUCKET_BOUNDS_US[i] if i < len(_BUCKET_BOUNDS_US) else _BUCKET_BOUNDS_US[-1]
                )
        return float(_BUCKET_BOUNDS_US[-1])

    @property
    def mean_us(self) -> float:
        return self.sum_us / self.total if self.total else 0.0


class Registry:
    """Process-local metric registry (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = defaultdict(Histogram)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self.histograms[name].observe_us(seconds * 1e6)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {
                    k: {
                        "count": h.total,
                        "mean_us": h.mean_us,
                        "p50_us": h.quantile(0.5),
                        "p99_us": h.quantile(0.99),
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
