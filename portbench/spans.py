"""What the readers of the program's span sums share (``utils.metrics``:
each span name's ``count`` and ``mean_us``, and its ``self_us``, ``cpu_us``,
``offcpu_us`` and ``items`` sums, in ``ctx["timers"]``).

A span the window opened none of reads 0.0.  A reader returns None when no
window was drained, or when the program's registry keeps no self time (a
program older than these sums), so the metric is left out of the line."""

from __future__ import annotations

from typing import Optional


def _per_window(ctx) -> Optional[float]:
    """1 / windows drained, or None when the program's sums cannot be read."""
    if not ctx["windows"] or not any("self_us" in h for h in ctx["timers"].values()):
        return None
    return 1.0 / ctx["windows"]


def span_ms(ctx, name: str, part: str = "total") -> Optional[float]:
    """Host ms a window of the span ``name``: its wall time (``total``), or
    its ``self_us``, ``cpu_us`` or ``offcpu_us`` sum."""
    per = _per_window(ctx)
    if per is None:
        return None
    h = ctx["timers"].get(name)
    if not h:
        return 0.0
    us = h["count"] * h["mean_us"] if part == "total" else h[part]
    return us / 1e3 * per


def span_count(ctx, name: str, key: str = "count") -> Optional[float]:
    """The span ``name``'s count (or its ``items``) a window."""
    per = _per_window(ctx)
    if per is None:
        return None
    return ctx["timers"].get(name, {}).get(key, 0) * per
