#!/usr/bin/env python3
"""The sharded zero-to-one planner's host time inside served windows, on one
CUDA card.

    python3 tools/sharded_plan_probe.py [--root DIR] [--in-smoke]

Imports ``probly_search_tpu_torch`` and ``chip_smoke`` (for its corpus of the
zero_to_one_50k configuration and its pipelined serving loop) from DIR
(default: this checkout), so two checkouts compare on one card in one run,
in turns (parent, change, change, parent).  Builds chip_smoke phase 4s's
snapshot (mesh (2, 2) on cuda:0, format "slots", top-10), warms it up with
2 passes of its two 16,384-query windows, then serves 8 windows a turn in
turns of two ways, each with Python's cyclic garbage collector on and off:

- queued: two windows submitted back to back, then drained;
- pipelined: chip_smoke's ``serve_pipelined`` (depth 4, drained in pairs by
  a second thread).

For each turn it reads ``plan_batch_z2o``'s host time per window (the span
of the ``sharded/plan`` timer) and the collector's time within those spans
by generation (``gc.callbacks``; a collection on either thread stops both).

``--in-smoke`` runs DIR's ``chip_smoke.main()`` up to its phase 4s and
measures there, on the index, windows and Python heap that the smoke's
earlier phases leave, instead of in a fresh process; then it exits without
running phase 4s.  Prints the card's name and power limit, then one JSON
line: the live objects the collector tracks, and per turn the plan's mean,
median and max ms and the collector's ms by generation.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time


class GcClock:
    """Seconds the cyclic collector ran, by generation, since creation."""

    def __init__(self):
        self.spent = [0.0, 0.0, 0.0]
        self.runs = [0, 0, 0]
        self._t0 = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.spent[info["generation"]] += time.perf_counter() - self._t0
            self.runs[info["generation"]] += 1
            self._t0 = None

    def close(self):
        gc.callbacks.remove(self._cb)


def measure(cs, ix, windows):
    """The turns of the module docstring on ``ix`` and ``windows`` through
    ``cs`` (DIR's chip_smoke module).  Returns the JSON record."""
    import numpy as np
    import torch

    from probly_search_tpu_torch import ShardedDeviceIndex, make_mesh

    k = 10
    tracked = len(gc.get_objects())
    sz = ShardedDeviceIndex(ix, make_mesh(2, 2, devices=["cuda:0"] * 4))
    cs.with_format(sz, "slots")
    clock = GcClock()
    spans = []
    plan = sz.plan_batch_z2o

    def timed_plan(*args, **kw):
        gc0 = list(clock.spent)
        t = time.perf_counter()
        out = plan(*args, **kw)
        spans.append((time.perf_counter() - t, [a - b for a, b in zip(clock.spent, gc0)]))
        return out

    sz.plan_batch_z2o = timed_plan

    def submit(i):
        return sz.query_batch_z2o(windows[i % 2], top_k=k)

    def queued(n=8):
        for i in range(0, n, 2):
            pair = [submit(i), submit(i + 1)]
            for h in pair:
                h.get_arrays()
        torch.cuda.synchronize()

    ways = {"queued": queued, "pipelined": lambda: cs.serve_pipelined(submit)}
    for i in range(4):  # warm-up: 2 passes (first launches, the class graphs if any)
        submit(i).get_arrays()
    torch.cuda.synchronize()
    turns = []
    try:
        for collector in ("on", "off", "off", "on"):
            for way in ("queued", "pipelined"):
                (gc.enable if collector == "on" else gc.disable)()
                spans.clear()
                runs0 = list(clock.runs)
                ways[way]()
                gc.enable()
                ms = [1e3 * s for s, _g in spans]
                turns.append({
                    "way": way, "collector": collector, "windows": len(ms),
                    "plan_ms_mean": float(np.mean(ms)), "plan_ms_median": float(np.median(ms)),
                    "plan_ms_max": float(np.max(ms)),
                    "gc_ms_in_plan_by_gen": [1e3 * sum(g[i] for _s, g in spans) / len(ms)
                                             for i in range(3)],
                    "gc_runs_by_gen": [a - b for a, b in zip(clock.runs, runs0)],
                })
    finally:
        gc.enable()
        clock.close()
    return {"gc_tracked_objects": tracked, "turns": turns}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--in-smoke", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sharded_plan_probe: no CUDA device is available")
    import chip_smoke as cs

    assert cs.__file__.startswith(root), cs.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    class Done(Exception):
        pass

    record = {"root": root, "in_smoke": args.in_smoke}
    if args.in_smoke:
        def at_4s(ix, _dix, windows, _card):
            record.update(measure(cs, ix, windows))
            raise Done

        cs.phase_sharded_z2o = at_4s
        try:
            cs.main()
        except Done:
            pass
    else:
        keys, cols, windows = cs.z2o_50k()
        ix = cs.Index(2)
        ix.add_documents_columnar(keys, cols)
        record.update(measure(cs, ix, windows))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
