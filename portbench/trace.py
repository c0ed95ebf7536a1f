"""The device trace of the measured window (``torch.profiler`` with CPU and
CUDA activity), reduced to what the per-layer metrics and the breakdown
read:

  busy       union of the intervals in which any operation (kernel, copy,
             set) ran on the card, inside the window
  kernels    union of the kernel intervals only, and each kernel name's
             summed time
  idle gaps  the stretches of the window with nothing on the card, each
             labelled by the innermost host span open at its middle on
             every thread (the harness's ``harness/submit`` and
             ``harness/drain``, and the program's timers, e.g.
             ``query/plan``), summed by label

The program's timers are marked for the profiler by wrapping its metrics
registry's ``timer`` for the traced run only (``mark_program_timers``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "harness/window"


class Names:
    """The names of the host spans the traced run opens (the harness's and
    the program's timers), so their events are told from the profiler's
    own whatever the torch version."""

    def __init__(self):
        self.names = {WINDOW, "harness/submit", "harness/drain"}

    def annotate(self, name: str):
        from torch.profiler import record_function

        self.names.add(name)
        return record_function(name)


def _kind(ev, names) -> str:
    """The event's activity: one of ``_DEVICE_KINDS``, "span" (a host span
    of ``names``) or "other"."""
    on_device = str(ev.device_type()).endswith("CUDA")
    name = ev.name()
    if name in names:
        return "span" if not on_device else "other"  # a span's device-side mirror
    at = getattr(ev, "activity_type", None)
    if at is not None:
        kind = at()
        return kind if kind in _DEVICE_KINDS else "other"
    if not on_device:
        return "other"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _ns(ev):
    if hasattr(ev, "start_ns"):
        return ev.start_ns(), ev.end_ns() if hasattr(ev, "end_ns") else ev.start_ns() + ev.duration_ns()
    s = ev.start_us() * 1000
    return s, s + ev.duration_us() * 1000


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@contextlib.contextmanager
def mark_program_timers(registry, names: Names):
    """Within the block, every ``registry.timer(name)`` also opens a
    profiler range of that name."""
    inner = registry.timer

    @contextlib.contextmanager
    def timer(name):
        with names.annotate(name), inner(name):
            yield

    registry.timer = timer
    try:
        yield
    finally:
        del registry.timer  # the class's method again


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of (starts, ends): (merged starts, merged ends)."""
    if len(starts) == 0:
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], run_end[np.append(idx[1:] - 1, len(s) - 1)]


def _segments(spans):
    """Nested spans of one thread -> non-overlapping segments, each labelled
    by the innermost span open over it: (starts, ends, labels)."""
    if not spans:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), [""]
    seg_s, seg_e, seg_l = [], [], []
    stack: List[Tuple[int, str]] = []
    cur = 0

    def emit(upto):
        nonlocal cur
        if stack and upto > cur:
            seg_s.append(cur)
            seg_e.append(upto)
            seg_l.append(stack[-1][1])
        cur = upto

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return np.asarray(seg_s, np.int64), np.asarray(seg_e, np.int64), seg_l or [""]


def reduce(prof, span_names: Names, top: int = 10) -> Dict:
    """The window: the ``harness/window`` span of the trace."""
    dev_s, dev_e, is_kernel, names = [], [], [], []
    spans: Dict[int, List[Tuple[int, int, str]]] = {}
    t0_ns = t1_ns = None
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev, span_names.names)
        if kind in _DEVICE_KINDS:
            a, b = _ns(ev)
            dev_s.append(a)
            dev_e.append(b)
            is_kernel.append(kind == "kernel")
            names.append(ev.name())
        elif kind == "span":
            a, b = _ns(ev)
            if ev.name() == WINDOW:
                t0_ns, t1_ns = a, b
                continue
            spans.setdefault(ev.start_thread_id(), []).append((a, b, ev.name()))
    if t0_ns is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    s = np.clip(np.asarray(dev_s, np.int64), t0_ns, t1_ns)
    e = np.clip(np.asarray(dev_e, np.int64), t0_ns, t1_ns)
    keep = e > s
    kern = np.asarray(is_kernel, bool) & keep
    bs, be = _union(s[keep], e[keep])
    ks, ke = _union(s[kern], e[kern])
    by_name: Dict[str, float] = {}
    for i in np.flatnonzero(kern).tolist():
        by_name[names[i]] = by_name.get(names[i], 0.0) + (e[i] - s[i]) * 1e-9

    # Idle gaps: the complement of the busy union inside the window.
    gs = np.concatenate([[t0_ns], be])
    ge = np.concatenate([bs, [t1_ns]])
    gap = ge > gs
    gs, ge = gs[gap], ge[gap]
    mids = (gs + ge) // 2
    per_thread = []
    for sp in spans.values():
        seg_s, seg_e, seg_l = _segments(sp)
        if len(seg_s) == 0:
            continue
        i = np.searchsorted(seg_s, mids, side="right") - 1
        ok = (i >= 0) & (seg_e[np.maximum(i, 0)] > mids)
        per_thread.append(np.where(ok, np.asarray(seg_l, object)[np.maximum(i, 0)], None))
    idle: Dict[str, float] = {}
    for g, dur in enumerate(((ge - gs) * 1e-9).tolist()):
        label = " + ".join(sorted(lab[g] for lab in per_thread if lab[g] is not None))
        label = label or "no host span"
        idle[label] = idle.get(label, 0.0) + dur
    window_s = (t1_ns - t0_ns) * 1e-9
    return {
        "window_s": window_s,
        "busy_s": float(np.sum(be - bs)) * 1e-9,
        "kernel_busy_s": float(np.sum(ke - ks)) * 1e-9,
        "kernel_s": by_name,
        "device_ops": sorted(by_name.items(), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(idle.items(), key=lambda x: -x[1])[:top],
        "n_device_events": int(keep.sum()),
    }
