"""The closed serving loop: windows submitted back to back, drained in pairs
one pair late on one drain thread, at most ``depth`` windows in flight (the
serving shape of the repository's original bench, without JAX).

``submit(window)`` returns a handle whose ``get_arrays()`` waits for the
window's rows.  Each window's latency runs from the start of its submit call
to the return of its ``get_arrays()``, on the host's monotonic clock.  With
``annotate`` set, submits and drains are marked for the profiler.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional


def serve(
    submit: Callable,
    next_window: Callable[[int], list],
    depth: int,
    on_drained: Callable[[int, tuple], None],
    seconds: Optional[float] = None,
    windows: Optional[int] = None,
    annotate: Optional[Callable[[str], contextlib.AbstractContextManager]] = None,
):
    """Serve until ``seconds`` have passed (no window is submitted after
    that) or ``windows`` windows were submitted; drain every window.
    Returns (window latencies in s, queries drained, wall seconds from the
    first submit to the last drain)."""
    mark = annotate or (lambda name: contextlib.nullcontext())
    lat: List[float] = []
    drained = [0]

    def drain_pair(pair):
        for wi, t_sub, h, n in pair:
            with mark("harness/drain"):
                out = h.get_arrays()
            lat.append(time.perf_counter() - t_sub)
            drained[0] += n
            on_drained(wi, out)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        futs, pending = [], []
        wi = 0
        while True:
            if windows is not None and wi >= windows:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            qs = next_window(wi)
            t_sub = time.perf_counter()
            with mark("harness/submit"):
                h = submit(qs)
            pending.append((wi, t_sub, h, len(qs)))
            wi += 1
            if len(pending) == 2:
                futs.append(pool.submit(drain_pair, pending))
                pending = []
            while len(futs) >= max(1, depth // 2):
                futs.pop(0).result()
        if pending:
            futs.append(pool.submit(drain_pair, pending))
        for f in futs:
            f.result()
    return lat, drained[0], time.perf_counter() - t0
