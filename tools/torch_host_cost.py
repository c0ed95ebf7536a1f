#!/usr/bin/env python3
"""Host cost per call of the port's kernel wrappers (K3, K4, K5) and of the
launch probe (P1), on one CUDA card.

    python3 tools/torch_host_cost.py [--root DIR] [--calls N] [--rounds R]

Imports ``probly_search_tpu_torch`` from DIR (default: this checkout), so two
checkouts can be compared on one card in one run, in turns
(parent, change, change, parent).  For each of R rounds it enqueues N calls
without synchronising and reads the host clock (the enqueue cost: what a
call holds the host), then synchronises (host clock to drained).  K5 runs on
B = 2 rows of 3,072 unsorted lanes, k = 10 (a small term-range class); K3
(phase "lanes") on 4 rows of 24 chunks of 1,024 lanes; K4 on 16 rows of 2
chunks of 1,024 lanes, 2 fields, k = 10 (tests/torch_util.py's seeded
tables); P1 on its f32[8, 512].  For P1 and ``torch.add`` also the time a
launch in a CUDA graph of 16 calls (CUDA events, L2 warm) and the device
time of one call (captured in a CUDA graph, replayed after a write of 4x
the L2).  Prints the card's name and power limit, then one JSON line of
medians in microseconds per call.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from probly_search_tpu_torch import bm25
    from probly_search_tpu_torch.ops import fused_merge as fm
    from probly_search_tpu_torch.ops import fused_query as fq
    from probly_search_tpu_torch.ops import fused_z2o as fz
    from probly_search_tpu_torch.ops import launch_probe as lp
    from tests.torch_util import make_rec, make_tables, make_z2o_tables, to_torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_host_cost: no CUDA device is available")
    assert fm.__file__.startswith(root), fm.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(0)
    L = 3072
    key = ((rng.integers(0, L // 8, (2, L)) << 4) | rng.integers(0, 4, (2, L))).astype(np.int32)
    key[rng.random((2, L)) < 0.15] = 2**31 - 1
    key = torch.from_numpy(key).cuda()
    score = torch.from_numpy(rng.uniform(0.5, 2.0, (2, L)).astype(np.float32)).cuda()
    x = torch.zeros(lp.SHAPE, device="cuda")
    C = 1024
    rec1, starts, lens = make_rec(rng, F=1, n_docs=3000, n_terms=400, C=C)
    rec1 = fq.padded_rows(rec1, "cuda")
    lanes_t = to_torch(make_tables(rng, starts, lens, 4, 24, C=C), "cuda")
    scal = torch.tensor([6.5, 1.5], dtype=torch.float32, device="cuda")
    rec2, starts, lens = make_rec(rng, F=2, n_docs=3000, n_terms=400, C=C)
    rec2 = fq.padded_rows(rec2, "cuda")
    z2o_t = to_torch(make_z2o_tables(rng, starts, lens, 16, 2, C=C), "cuda")
    takes_bits = "key_bits" in inspect.signature(fz.fused_z2o_topk).parameters
    extra = {"key_bits": 17} if takes_bits else {}  # make_rec's 3,000 docs
    scorer = bm25.new()
    calls = {
        "lanes": lambda: fq.fused_query_topk(scorer, rec1, *lanes_t, scal, chunk=C, k=10,
                                             qterm_bits=4, num_fields=1, phase="lanes"),
        "z2o": lambda: fz.fused_z2o_topk(rec2, *z2o_t, chunk=C, k=10, num_fields=2, **extra),
        "merge": lambda: fm.merge_scores_topk_fused(key, score, 10, 4),
        "probe": lambda: lp.probe_add(x),
        "torch_add": lambda: torch.add(x, 1.0),
    }
    out = {"root": root}
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        enq, total = [], []
        for _ in range(args.rounds):
            t = time.perf_counter()
            for _ in range(args.calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enq.append(1e6 * (t1 - t) / args.calls)
            total.append(1e6 * (t2 - t) / args.calls)
        out[f"{name}_enqueue_us"] = float(np.median(enq))
        out[f"{name}_drained_us"] = float(np.median(total))
    for name in ("probe", "torch_add"):
        fn = calls[name]
        out[f"{name}_graph16_us"] = graph_us(fn, 16, args.rounds * 10) / 16
        out[f"{name}_device_us"] = cold_us(fn, args.rounds * 10)
    print(json.dumps(out))


def _capture(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return g


def _replay_us(g, reps, flush=None):
    import torch

    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(1e3 * a.elapsed_time(b))
    return float(np.median(times))


def graph_us(fn, n, reps):
    """Median CUDA-event time of one replay of ``n`` calls of ``fn``
    captured as one CUDA graph, L2 warm."""
    g = _capture(fn, n)
    g.replay()
    return _replay_us(g, reps)


def cold_us(fn, reps):
    """Device time of one call of ``fn`` captured in a CUDA graph, its
    replay timed after a write of four times the L2 (as chip_smoke.py)."""
    import torch

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    flush = torch.empty(l2, dtype=torch.int32, device="cuda")
    g = _capture(fn, 1)
    g.replay()
    return _replay_us(g, reps, flush)


if __name__ == "__main__":
    main()
