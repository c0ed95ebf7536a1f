#!/usr/bin/env python3
"""GPU smoke run of the torch port (probly_search_tpu_torch) on one CUDA card,
and, where four are visible, of the doc-sharded engine over four cards.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  1. environment: torch / CUDA versions, the card's name and power limit,
     and the kernel build from probly_search_tpu_torch/csrc;
  2. each BM25 kernel against its plain torch version on seeded chunk
     tables (C = 1024, B = 1024; phase "full" at NC 2..16, phase "lanes" at
     NC 24 and 32; k 10 and 128; phase "full" also at k 5,000 and k = L,
     past its shared-memory top-k buffer), with bit-equal repeat runs and
     CUDA-event times (phase "lanes" also its device time: one call
     captured in a CUDA graph, the replay timed with the L2 cold);
  2z. the zero-to-one kernel (K4) the same way: C = 1024, B = 1024,
     NC 2, 3, 4, 6, 8, F 1, 2, 4, k 10 and 128, CUDA-event and device
     times; then its edges (tests/torch_util.z2o_edge: k = L = 8,192 with
     four fields, one live lane, a row of dead docs, alive docs with only
     tf 0, equal contributions, doc slots near 2^26, C = 128 over 64
     chunks), each with its kernels per call from a CUDA graph capture
     (exactly 1);
  2m. the standalone merge kernel (K5) against its plain version on seeded
     rows: run 0 (full sort) at B 1 and 2, L 2,048 .. 2^23 (3,072, 24,576
     and 3 * 2^20 not powers of two); run 1,024 at B 24, L 24,576 and
     32,768, excl on and off; k 10 and 128; duplicate keys, pads, dead docs
     and equal totals; then the edges of K5's two paths (L = 1, the block
     cap and one past it, 32,768 and one past it, all totals equal, all
     pads, one live lane, k above the live docs, keys near 2^31 - 1 with
     key_bits 31); each shape's path, and on the edges and the long rows
     the kernel launches per call (a CUDA graph capture of one call),
     asserted equal to the path's count;
  2p. the launch probe (P1) against x + 1, bit-equal, over chains of 1, 4
     and 16 launches: per-launch time from the host clock and CUDA events,
     launched one by one and as one captured CUDA graph a chain, beside
     torch.add chains run the same two ways; and the device time of one
     call of each (captured in a CUDA graph, replayed with the L2 cold);
  3. the BM25 main path at real size: top-10 over the 1,000,000-doc bench
     corpus (bench.py's generator), two 16,384-query windows, 8 windows
     served through DeviceIndex.query_batch_async with a depth-4 pipeline
     and paired late drains; launch counts, ms/window, QPS, recall@10
     against the f64 oracle on 256 queries, host phases (query/prune
     included: block-max pruning is on by default), and every class of the
     first (pruned) window held kernel against plain on its real tables
     (K1; K3 and K5 on the wide classes; K1's and K3's device times beside
     their CUDA-event times);
  3g. the graph path over that index: a second DeviceIndex loads
     benchmarks/bench_templates.json and prewarms (one CUDA graph per
     template; seconds and memory reserved); 8 pipelined windows served
     on phase 3's index (class graphs), graph, graph, class graphs
     (ms/window, p50, host phases, replays, launches); the graph path's
     slots equal to the class graphs' path's, no
     refreeze, recall@10 1.0; the window's replay time with the L2 cold and
     warm; each path's kernels per window under torch.profiler beside the
     launch tally and the captured step's kernel nodes; a pair of windows
     drained jointly (fetch_windows_jointly) against two drained apart;
  3c. a user's one-phase scorer (TfBoost, tests/torch_util.py) on that
     index: one window of 256 queries through staged lanes + K5, served
     cold, warm, eagerly and warm again (ms, query/dispatch, captures,
     replays, keys, pool bytes; the warm window bit-equal to the eager
     step on its words), f32 rows against the f64 host oracle;
  3r. term-range jobs on that index: phase 3's first window with every 64th
     query's first term cut to its first four characters (a prefix of 100
     terms) and the last three queries replaced by t0, t00 and t1, served
     cold (class graphs captured), warm, eagerly (the same class steps,
     EagerClasses) and warm again: ms submit to drained, query/dispatch,
     captures and replays, keys, pool bytes, the warm window bit-equal to
     the eager step on its words; classes by route, K5 launches;
     the distribution of K5's L over the range classes, K5 calls by path and
     K5's kernel launches per warm window (torch.profiler); recall@10 of
     every range query against the f64 vectorized BM25 host path, the 16
     smallest also against Index.query, 0 host rows; K5 held
     against plain on every range class and on the heavy-cache classes of
     t0, t00 and t1 (with their kernel launches per call, asserted);
  3p. block-max pruning on that index (benchmarks/prune_probe.py's mixes,
     rebuilt here: single, skewed and headline, rng seed 7, one 16,384-query
     window each, top-10): two DeviceIndexes, pruning on and off, served in
     alternating turns; chunks pruned a window against the total, slots
     bit-equal on and off, ms a window and p50 (medians of 3 turns of 4
     queued windows), query/prune host ms cold and warm and the bounds'
     build, device busy share of one window on and off (torch.profiler),
     recall@10 of the pruned rows against the f64 oracle on 256 queries;
     pruning must fire on single (on skewed the rare term's own bound
     exceeds every achievable threshold at this size: nothing can prune);
  3l. the dispatch modes on that index (after 3p), flipped on its
     DeviceIndex's config between turns: (a) light classes
     (light_chunk_size 256) on and off, composed (templates off: class
     graphs), in alternating turns: classes and lanes by chunk width, ms a
     window and p50 (medians of 3 turns of 4 queued windows), device busy of one
     window (torch.profiler), K1's device time summed over the window's
     classes on and off (one captured call a class, L2 cold), slots
     bit-equal on and off, recall@10 of the light rows against the f64
     oracle on 256 queries; (b) a light template frozen, saved (entries of
     width 256), loaded into a fresh DeviceIndex and prewarmed: 8 pipelined
     windows on its CUDA graph beside 3g's graph path in turns, slots equal
     to (a)'s rows, 0 refreezes, replays counted; (c) per-class dispatch
     and per-dispatch windows on phase 3's two windows beside the composed
     window, each on the class graphs and on the same class steps run
     eagerly, in turns (4 queued windows a turn: ms a window, query/dispatch
     per window, cold and warm, launches, captures, replays, keys, pool
     bytes), f32 scores and slots bit-equal, a warm window of each mode
     bit-equal to the eager step on its words; (d) K1 at chunk 256 against
     plain on every light class of the first window (max error, CUDA-event
     and device times, bound);
  3m. (after 3l; with one card visible it logs that it did not run and
     how many cards are visible) phase 3's index on make_mesh(1, 4) over
     four distinct cards (make_mesh(1, n) over two or three): the peer
     access of each pair of cards; the snapshot's build seconds and bytes
     on each card; a warm-up of 2 passes (sharded/dispatch cold and warm;
     captures, replays, keys and pool bytes per card); 8 pipelined windows
     a turn on 3s's one-card 4-shard engine, the cards, the cards, one
     card (ms/window, QPS, p50, sharded/* host phases, launches, launches
     per card: each card's equal to the one-card engine's per shard); the
     gather of one window timed on the row's first card (the copies from
     the other cards alone, and the gather and merge); both windows in f32
     and slots20, the head-term window and 3r's range window (cold and
     warm, no range query on the host) bit-equal to the one-card engine's
     (arrays and packed rows); recall@10 against the f64 oracle; K1, K3 +
     K5 and K5 held against plain on each shard's card; device busy per
     card (torch.profiler, by device index); a DeviceIndex on the last
     card prewarmed from the bench manifest, its template-graph rows
     bit-equal to 3g's on cuda:0; then a mutation (1,000 documents added,
     100 removed), the old snapshot freed on every card with the collector
     off, and the new one's rows against the f64 oracle;
  3t. (after 3m) phase 3's index served from several threads at once, each
     thread submitting and draining its own windows (phase 3's two windows
     and the two reversed): (a) a fresh DeviceIndex (composed windows), 4
     threads x 2 windows, the first sights capturing class graphs; (b) 3g's
     template graph, 4 threads x 2 windows on the shared stream, then on a
     CUDA stream a thread; (c) a fresh DeviceIndex of a loaded template,
     prewarm on a thread while 2 threads serve (windows before the graph on
     class graphs, after it on the graph); QPS with 1, 2 and 4 submitting
     threads on 3g's graph, query/plan and query/pack host ms, device busy
     and idle share (torch.profiler), for information; (f) 3s's sharded
     engine and (g) 3m's over the cards (with one card: "not run"), 2
     threads x 2 windows, shared stream and a stream a thread; (d) a writer
     (3 rounds of 300 adds and 30 removes, each followed by
     ix.device_index()) while 2 readers serve each window on the newest
     snapshot, then the replaced snapshots freed with the collector off and
     the last one's rows against the f64 oracle; (e) Index.query_batch at
     IndexConfig.low_latency() (2,048-query windows, depth 4) from 2
     threads against one 16,384-query window.  Every window's packed rows
     byte-equal to the same window served alone (serially, on the same
     engine); in every turn the launches counted across the threads equal
     to the serial windows' sum, per kernel and per card;
  3z. one 16,384-query zero-to-one window over that 1M-doc corpus: each
     class's route; served cold, warm, eagerly and warm again (ms,
     z2o/dispatch, captures, keys, pool bytes, the warm window bit-equal to
     the eager step); the rows held against the f64 oracle on 64 queries;
  3s. the doc-sharded engine (parallel/) on that index: 4 doc shards on one
     card (make_mesh(1, 4, devices=["cuda:0"] * 4)), every window on the
     card's class graphs (one graph a class shape for the group of the 4
     shards); the sharded snapshot's build seconds and bytes on the card;
     a warm-up of 2 passes (sharded/dispatch per window: the first two
     capture; captures, replays, keys and pool bytes per device); 8
     pipelined windows of phase 3 (depth 4, paired late drains) in turns
     single-device, sharded class graphs, sharded eager (the same group
     steps run eagerly: EagerClasses per device), eager, graphs,
     single-device (ms/window, QPS, p50, the sharded/* host phases,
     launches, equal in every sharded turn); a window's served rows
     bit-equal to the eager cells (no caches) on the same words; both
     windows in f32 against the single-device engine by the testing rule,
     the served slots20 slots equal to them, recall@10 against the f64
     oracle on 256 queries; a head-term window (the 16 most frequent
     terms: classes past 16,384 lanes a shard, K3 + K5) against the
     single-device engine; 3r's range window cold, warm, eager and warm
     again (ms, sharded/dispatch, launches equal), bit-equal to the eager
     cells, its range queries against 3r's f64 vectorized host rows, 0
     host rows; 3p's single mix with the trim on and off (chunks trimmed
     a window, slots bit-equal); every class of shard 0 of the first
     window, of the head window and of the range window, and the widest
     class of each other shard, held kernel against plain at that shard's
     key_bits (K1; K3 + K5; the range classes' K5); device busy of one
     sharded window on the class graphs, one eager and one single-device
     window under torch.profiler;
  4. the zero-to-one main path at the repo's zero_to_one_50k configuration
     (benchmarks/zero_to_one_50k.py: 50,000 docs, a 3-token title and an
     8-token body, Zipf(1.05) over 4,000 terms, seed 7; 2-term queries with
     the top 50 ranks excluded; 16,384-query windows, top-10, "slots"):
     8 windows through z2o_query_batch_async with a depth-4 pipeline and
     paired late drains (z2o/dispatch of the warm-up's windows, cold and
     warm; captures, replays, keys, pool bytes); launch counts of the kernel
     and the torch programs, ms/window, QPS; a window bit-equal to the eager
     step on its words; class graphs against eager in turns (8 pipelined
     windows a turn); recall@10 against the f64 oracle on 256 queries, every
     kernel class of one window held kernel against plain on its real
     tables (CUDA-event and device times), and a torch.profiler breakdown
     of one window;
  4s. that configuration on the doc-sharded engine, mesh (2, 2) on one card
     (the data axis splits each window; both rows share the card's class
     graphs): a warm-up of 2 passes (sharded/dispatch per window, cold and
     warm; captures, replays, keys, pool bytes), two 16,384-query windows
     timed, class graphs and eager in turns (8 pipelined windows a turn:
     ms/window, sharded/dispatch, launches equal), a window bit-equal to
     the eager cells on the same words, the planner alone with Python's
     garbage collector on and off, device busy of one window on each
     path (torch.profiler), slots equal to the single-device engine's,
     tie-aware recall@10 against the f64 oracle on 256 queries, and K4
     held against plain on every K4 class of shard 0 at that shard's
     key_bits;
  4m. (with fewer than four cards visible it logs that it did not run and
     how many are visible) that configuration on make_mesh(2, 2) over four
     distinct cards against 4s's mesh on one card, as 3m: build, warm-up,
     turns, launches per card, the gather, both windows and 256 queries in
     f32 bit-equal (arrays and packed rows), tie-aware recall@10, busy per
     card, and K4 held against plain on each card (the widest K4 class of
     each cell);
  4t. z2o 50k from 4 threads x 2 windows ("slots"; K4 and lockstep
     classes) on a fresh DeviceIndex (first sights capturing), then on the
     shared stream and on a stream a thread: slots and packed rows equal to
     phase 4's serial windows, launches equal to their sum; then
     z2o_query_batch at the low_latency() windows (2,048 at depth 4, f32)
     from 2 threads against one 16,384-query window.
Every window without a frozen template's CUDA graph replays cached class
graphs (index/device.py ClassGraphs; the sharded engine's, one cache a
device, parallel/dist_query.py); "eager" turns swap in
tests/torch_util.EagerClasses, which runs the same class steps eagerly, as
a baseline: the kernels line's launches count the graph runs only.
The line before the last is the kernels' JSON record (K1 a second time at
chunk 256, its launches those of 3l's light windows; 3m's and 4m's
launches, per card, are on lines of their own); the last line is
{"ok": true, "device": {...}}.  Needs a CUDA device: without one it exits
with an error before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench import make_corpus, make_queries  # noqa: E402
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25, zero_to_one  # noqa: E402
from probly_search_tpu_torch import ShardedDeviceIndex, make_mesh  # noqa: E402
from probly_search_tpu_torch.index.prune import prune_plan_sharded_cached  # noqa: E402
from probly_search_tpu_torch.index import device as pdev  # noqa: E402
from probly_search_tpu_torch.ops import _build  # noqa: E402
from probly_search_tpu_torch.ops import fused_merge as fm  # noqa: E402
from probly_search_tpu_torch.ops import fused_query as fq  # noqa: E402
from probly_search_tpu_torch.ops import fused_z2o as fz  # noqa: E402
from probly_search_tpu_torch.ops import launch_probe as lp  # noqa: E402
from probly_search_tpu_torch.ops import z2o_device as pz  # noqa: E402
from probly_search_tpu_torch.ops.fused_query import padded_rows  # noqa: E402
from probly_search_tpu_torch.testing import ATOL, RTOL, assert_topk_agree  # noqa: E402
from tests.torch_util import (  # noqa: E402
    Z2O_EDGES, Z2O_ROW0_EDGES, EagerClasses, TfBoost, merge_edge_rows, z2o_edge,
)

SEED = 0
C = 1024
QB = 4  # qterm bits
FULL_NC = (2, 3, 4, 6, 8, 12, 16)
LANES_NC = (24, 32)
TOP_KS = (10, 128)
Z2O_NC = (2, 3, 4, 6, 8)
Z2O_F = (1, 2, 4)
MERGE_L_FULL = (2048, 3072, 16384, 24576, 1 << 20, 3 << 20, 1 << 23)
MERGE_L_RUNS = (24576, 32768)
# K5's edge shapes (kind of row as tests/torch_util.merge_edge_rows, B, L,
# key_bits); "block" is the block path's cap.
MERGE_EDGES = (
    ("random", 1, 1, 31), ("random", 2, "block", 31), ("random", 2, "block+1", 31),
    ("random", 1, 32768, 31), ("random", 1, 32769, 24),
    ("ties", 2, 24576, 31), ("ties", 1, 1 << 20, 24), ("pads", 2, 3072, 31),
    ("pads", 1, 1 << 20, 31), ("one", 2, 65536, 31), ("few", 1, 1 << 20, 24),
    ("high", 2, 16384, 31), ("high", 1, 32768, 31), ("high", 1, 1 << 20, 31),
)
# K1 past its shared-memory top-k buffer (fused_query.MAX_K): (NC, k).
FULL_LARGE_K = ((8, 5000), (16, 16384))
PROBE_CHAINS = (1, 4, 16)
# The BM25 window's host phases (metrics timers query/<name>), in order.
HOST_PHASES = ("plan", "prune", "pack", "h2d", "dispatch", "fetch", "drain")
# The sharded window's host phases (metrics timers sharded/<name>).
SHARDED_PHASES = ("plan", "prune", "pack", "dispatch", "fetch", "drain")
INT32_MAX = 2**31 - 1
SYN_KEY_BITS = fm.key_bits_for(20_000, QB)  # synthetic_rec's docs
SYN_Z2O_KEY_BITS = fm.key_bits_for(20_000, fz.DOC_SHIFT)
N_DOCS = 1_000_000
# The wrappers' launches per card (K1 / K3, K5, K4); both resets clear them.
CARD_COUNTS = (fq.device_launches, fm.device_launches, fz.device_launches)
WINDOW = 16384
TOK = pdev.whitespace_tokenizer
KERNELS = {
    "full": (
        "fused_query_full",
        "probly_search_tpu_torch/csrc/fused_query.cu",
        "probly_search_tpu/ops/pallas_query.py:268 (fused_query_topk phase full; "
        "_query_kernel :42, merge_body ops/pallas_merge.py:252)",
    ),
    "lanes": (
        "fused_query_lanes",
        "probly_search_tpu_torch/csrc/fused_query.cu",
        "probly_search_tpu/ops/pallas_query.py:216 (fused_query_topk phase lanes)",
    ),
    "fused_z2o": (
        "fused_z2o",
        "probly_search_tpu_torch/csrc/fused_z2o.cu",
        "probly_search_tpu/ops/pallas_z2o.py:393 (fused_z2o_topk; pallas_call :444, "
        "_z2o_kernel :180)",
    ),
    "merge_topk": (
        "merge_topk",
        "probly_search_tpu_torch/csrc/fused_merge.cu",
        "probly_search_tpu/ops/pallas_merge.py:387 (merge_scores_topk_pallas; pallas_call "
        ":412, merge_body :252)",
    ),
    "probe_add": (
        "probe_add",
        "probly_search_tpu_torch/csrc/launch_probe.cu",
        "benchmarks/profile_launch.py:29 (pallas_add; pallas_call :30)",
    ),
}
# Least time bounds: NVIDIA's H100 SXM data sheet (80 GB HBM3 at 3.35 TB/s,
# 67 TFLOP/s f32 outside the tensor cores), at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_cards() -> None:
    """Wait for every visible card (``torch.cuda.synchronize()`` waits for
    the current one only)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def capture_on_current(g):
    """``torch.cuda.graph`` on a side stream of the current card: torch's
    shared default capture stream lives on the card that was current when
    it was first made."""
    return torch.cuda.graph(g, stream=torch.cuda.Stream(), capture_error_mode="relaxed")


def cuda_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def replay_ms(g, reps: int = 20) -> float:
    """Device time of one replay of CUDA graph ``g`` with a cold L2: before
    each replay a write of four times the card's L2 evicts what earlier
    replays left there; the replay alone is timed with CUDA events (median
    of ``reps``).  The write is queued first, so the host's launch of the
    replay hides behind it."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    flush = torch.empty(l2, dtype=torch.int32, device="cuda")
    g.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del flush
    return float(np.median(times))


def capture(fn):
    """``fn`` (run once eagerly first) captured into a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with capture_on_current(g):
        fn()
    return g


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` with a cold L2: the call captured
    into a CUDA graph, its replay timed by ``replay_ms``."""
    g = capture(fn)
    ms = replay_ms(g, reps)
    g.reset()
    return ms


# --------------------------------------------------------------------- #
# phase 2: seeded tables                                                 #
# --------------------------------------------------------------------- #


def synthetic_rec(rng, n_docs=20_000, n_terms=6000, F=1):
    """Posting records int32[R, P + C] of F fields (the DeviceIndex layout):
    ascending doc runs per term, tf 1..3 (0..3 with several fields), doc
    lengths 3..12 (f32 bits), 2% latently dead docs.  Few docs, so chunks
    of one row often share docs."""
    doc_alive = (rng.random(n_docs) > 0.02).astype(np.int32)
    doc_len = rng.integers(3, 13, (n_docs, F)).astype(np.float32)
    lens = np.minimum(rng.zipf(1.3, n_terms) * 40, 6000)
    docs = [np.sort(rng.choice(n_docs, size=int(n), replace=False)) for n in lens]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    post_doc = np.concatenate(docs).astype(np.int32)
    P = len(post_doc)
    R = 4 if F == 1 else -(-(2 + 2 * F) // 8) * 8
    rec = np.zeros((R, P + C), np.int32)
    rec[0] = -1
    rec[0, :P] = post_doc
    rec[1 : 1 + F, :P] = rng.integers(1 if F == 1 else 0, 4, (F, P))
    rec[1 + F : 1 + 2 * F, :P] = doc_len[post_doc].view(np.int32).T
    rec[1 + 2 * F, :P] = doc_alive[post_doc]
    return rec, starts.astype(np.int64), lens.astype(np.int64)


def synthetic_tables(rng, starts, lens, B, NC):
    """Chunk tables [B, NC] over ``synthetic_rec``: each live chunk is a
    slice of one term's run, with leading pads (alignment skip) and trailing
    pads; 15% dead chunks and every 97th row empty."""
    t = rng.integers(0, len(starts), (B, NC))
    o = (rng.random((B, NC)) * lens[t]).astype(np.int64)
    col = starts[t] + o
    c_start = col // 128 * 128
    c_skip = col - c_start
    room = np.minimum(lens[t] - o, C - c_skip)
    c_len = np.maximum(1, (rng.random((B, NC)) * room).astype(np.int64) + 1)
    c_len = np.minimum(c_len, room)
    dead = rng.random((B, NC)) < 0.15
    dead[::97] = True
    c_start[dead] = 0
    c_skip[dead] = 0
    c_len[dead] = 0
    c_qterm = rng.integers(0, 4, (B, NC))
    c_scale = rng.uniform(0.5, 5.0, (B, NC)).astype(np.float32)
    return (dev(c_start), dev(c_skip), dev(c_len), dev(c_qterm), dev(c_scale, torch.float32))


def dev(a, dt=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)


def synthetic_z2o_tables(rng, starts, lens, B, NC):
    """``synthetic_tables`` for K4: (c_start, c_skip, c_len, c_qterm,
    c_score, c_rank, qlen).  Entry scores come from four values, so equal
    scores share a rank (the per-row dense descending rank)."""
    c_start, c_skip, c_len, c_qterm, _scale = synthetic_tables(rng, starts, lens, B, NC)
    score = rng.choice(np.array([1.0, 0.8, 0.75, 0.5], np.float32), (B, NC))
    rank = np.stack([np.searchsorted(np.unique(-row), -row) for row in score])
    qlen = rng.integers(1, 5, B)
    return (c_start, c_skip, c_len, c_qterm, dev(score, torch.float32), dev(rank),
            dev(qlen, torch.float32))


def bound(payload_lanes: int, rows_read: int, table_bytes: int, out_bytes: int, ops: int):
    """(bound_ms, bound_by): the least time for the work on the card — the
    larger of the bytes the function must move (each payload lane's record
    rows read once, the tables read once, the results written once) over
    the memory rate and its f32 operations over the f32 rate."""
    t_bytes = (payload_lanes * rows_read * 4 + table_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_full(scorer, rec, tables, scalars, k, label, key_bits=31, chunk=C):
    kw = dict(chunk=chunk, k=k, qterm_bits=QB, num_fields=1, key_bits=key_bits)
    ks, kd = fq.fused_query_topk(scorer, rec, *tables, scalars, **kw)
    ks2, kd2 = fq.fused_query_topk(scorer, rec, *tables, scalars, **kw)
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2), f"{label}: repeat runs differ"
    ps, pd = fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **kw)
    err = assert_topk_agree(ks.cpu(), kd.cpu(), ps.cpu(), pd.cpu())
    ms = cuda_ms(lambda: fq.fused_query_topk(scorer, rec, *tables, scalars, **kw))
    plain_ms = cuda_ms(lambda: fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **kw))
    return err, ms, plain_ms


def check_lanes(scorer, rec, tables, scalars, k, label, key_bits=31):
    kw = dict(chunk=C, k=k, qterm_bits=QB, num_fields=1, phase="lanes")
    ls, lk = fq.fused_query_topk(scorer, rec, *tables, scalars, **kw)
    ls2, lk2 = fq.fused_query_topk(scorer, rec, *tables, scalars, **kw)
    assert torch.equal(ls, ls2) and torch.equal(lk, lk2), f"{label}: repeat runs differ"
    ps, pk = fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **kw)
    assert torch.equal(lk, pk), f"{label}: lane keys differ"
    fin = torch.isfinite(ps)
    assert torch.equal(fin, torch.isfinite(ls)), f"{label}: -inf lanes differ"
    torch.testing.assert_close(ls[fin], ps[fin], rtol=RTOL, atol=ATOL)
    err = float((ls[fin] - ps[fin]).abs().max()) if bool(fin.any()) else 0.0
    # merged top-k through K5, against the plain full phase
    ms_, md_ = fm.merge_scores_topk_fused(lk, ls, k, QB, run=C, excl=True, max_seg=lk.shape[1] // C,
                                          key_bits=key_bits)
    fs, fd = fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **{**kw, "phase": "full"})
    err = max(err, assert_topk_agree(ms_.cpu(), md_.cpu(), fs.cpu(), fd.cpu()))
    ms = cuda_ms(lambda: fq.fused_query_topk(scorer, rec, *tables, scalars, **kw))
    dev_ms = graph_ms(lambda: fq.fused_query_topk(scorer, rec, *tables, scalars, **kw))
    plain_ms = cuda_ms(lambda: fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **kw))
    log(f"{label}: K3 device time {dev_ms:.4f} ms (CUDA graph replay, L2 cold), CUDA events {ms:.4f} ms")
    return err, ms, plain_ms


def bm25_bound(tables, k, phase, F=1, chunk=C):
    """``bound`` of one K1 / K3 call on these tables: each payload lane
    reads 2 + 2F record rows and does 10F + 2 f32 operations."""
    c_start, c_len = tables[0], tables[2]
    B, NC = c_start.shape
    payload = int(c_len.sum())
    out = B * k * 8 if phase == "full" else B * NC * chunk * 8
    return bound(payload, 2 + 2 * F, B * NC * 20 + 16 * F, out, payload * (10 * F + 2))


def merge_bound(key, k):
    """``bound`` of one K5 call: each input lane (key and score, 8 B) read
    once, the [B, k] result written once; operations L * log2(L) compares
    of a comparison sort plus the max and the sum per lane."""
    B, L = key.shape
    return bound(0, 0, B * L * 8, B * k * 8, B * (L * max(1, (L - 1).bit_length()) + 2 * L))


K5_KERNELS = ("merge_block_kernel", "radix_")


def kernels_per_call(fn):
    """Kernels one call of ``fn`` launches: the call captured into a CUDA
    graph, whose kernel nodes the driver counts (cuGraphGetNodes,
    cuGraphNodeGetType).  torch.profiler miscounted these launches, which
    come from the port's own library: 17 of a radix call's 19 kernels on
    t0, and once none in a session."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with capture_on_current(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    g.reset()
    return kernels


def merge_path(key, k):
    B, L = key.shape
    return fm.merge_plan(B, L, k, fm.device_smem(torch.cuda.current_device()))


def path_kernels(path, key_bits):
    """Kernels one K5 call launches: the block path one; the radix path a
    histogram, a scan and a scatter per 8-bit pass, then the totals, 7 count
    rounds, the collection and the ordering."""
    return 1 if path == "block" else 3 * -(-key_bits // 8) + 10


def check_merge(key, score, k, label, run=0, excl=False, max_seg=0, quiet=False,
                key_bits=fm.KEY_BITS, expect=True, launches=False):
    """K5 against its plain version: repeat runs bit-equal, top-k within the
    tolerance; CUDA-event times and the bound (``launches``: also kernel
    launches per call from torch.profiler).  Returns (err, ms, plain_ms,
    bound_ms, bound_by)."""
    kw = dict(run=run, excl=excl, max_seg=max_seg, key_bits=key_bits)
    ks, kd = fm.merge_scores_topk_fused(key, score, k, QB, **kw)
    ks2, kd2 = fm.merge_scores_topk_fused(key, score, k, QB, **kw)
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2), f"{label}: repeat runs differ"
    ps, pd = fm.merge_scores_topk_fused_reference(key, score, k, QB, **kw)
    err = assert_topk_agree(ks.cpu(), kd.cpu(), ps.cpu(), pd.cpu())
    assert bool((kd >= 0).any()) == expect, f"{label}: result {'missing' if expect else 'unexpected'}"
    ms = cuda_ms(lambda: fm.merge_scores_topk_fused(key, score, k, QB, **kw))
    plain_ms = cuda_ms(lambda: fm.merge_scores_topk_fused_reference(key, score, k, QB, **kw))
    bound_ms, by = merge_bound(key, k)
    if not quiet:
        path = merge_path(key, k).path
        extra = ""
        if launches:
            n = kernels_per_call(lambda: fm.merge_scores_topk_fused(key, score, k, QB, **kw))
            want = path_kernels(path, key_bits)
            assert n == want, f"{label}: {n} kernels per call on the {path} path, expected {want}"
            extra = f", {n} kernel launches per call (CUDA graph)"
        log(f"{label}: ok, path {path}, max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}){extra}")
    return err, ms, plain_ms, bound_ms, by


def merge_rows_full(rng, B, L):
    """run = 0 rows (a range class's lanes): unsorted keys over L / 8 docs
    and 4 query terms, so (doc, qterm) keys repeat; 15% INT32_MAX pads;
    scores from four values, so equal doc totals happen."""
    docs = rng.integers(0, max(L // 8, 1), (B, L))
    key = ((docs << QB) | rng.integers(0, 4, (B, L))).astype(np.int32)
    key[rng.random((B, L)) < 0.15] = INT32_MAX
    score = rng.choice(np.array([0.5, 1.0, 1.5, 2.25], np.float32), (B, L))
    return dev(key), dev(score, torch.float32)


def merge_rows_runs(rng, B, L, excl, run=C, n_docs=20_000):
    """run > 0 rows (phase "lanes" output): ascending runs of ``run`` lanes
    with -1 leading and INT32_MAX trailing pads, docs repeating across runs,
    10% of the docs dead (-inf on all their lanes), scores from four values
    (clamped at 0 with ``excl``, as the BM25 caller does)."""
    key = np.full((B, L), INT32_MAX, np.int32)
    score = rng.choice(np.array([0.5, 1.0, 1.5, -0.75], np.float32), (B, L))
    if excl:
        score = np.maximum(score, 0.0).astype(np.float32)
    for r in range(B):
        for c in range(L // run):
            skip = int(rng.integers(0, 129))
            n = int(rng.integers(0, run - skip + 1))
            docs = np.sort(rng.choice(n_docs, size=n, replace=False))
            key[r, c * run : c * run + skip] = -1
            key[r, c * run + skip : c * run + skip + n] = (docs << QB) | int(rng.integers(0, 4))
        live = (key[r] >= 0) & (key[r] != INT32_MAX)
        dead = np.isin(key[r] >> QB, rng.choice(n_docs, size=n_docs // 10, replace=False))
        score[r, live & dead] = -np.inf
        score[r, ~live] = 0.0
    return dev(key), dev(score, torch.float32)


def edge_len(L):
    """Lane counts at the K5 paths' edge: the block path's cap (one CTA's
    lanes) and one past it."""
    if isinstance(L, int):
        return L
    return fm.TILE_LANES + 1 if L.endswith("+1") else fm.TILE_LANES


def phase_merge_kernels():
    rng = np.random.default_rng(SEED + 2)
    err_max = 0.0
    for L in MERGE_L_FULL:
        for B in (1, 2):
            key, score = merge_rows_full(rng, B, L)
            for k in TOP_KS:
                err = check_merge(key, score, k, f"merge run=0 B={B} L={L} k={k}",
                                  launches=L >= 1 << 20)[0]
                err_max = max(err_max, err)
            del key, score
    for L in MERGE_L_RUNS:
        for excl in (False, True):
            key, score = merge_rows_runs(rng, 24, L, excl)
            for k in TOP_KS:
                label = f"merge run={C} B=24 L={L} excl={int(excl)} k={k}"
                err = check_merge(key, score, k, label, run=C, excl=excl, max_seg=L // C)[0]
                err_max = max(err_max, err)
    for kind, B, L, key_bits in MERGE_EDGES:
        L = edge_len(L)
        key, score = merge_edge_rows(rng, kind, B, L)
        key, score = dev(key), dev(score, torch.float32)
        for k in sorted({min(k, L) for k in TOP_KS}):
            label = f"merge edge {kind} B={B} L={L} key_bits={key_bits} k={k}"
            err = check_merge(key, score, k, label, key_bits=key_bits, expect=kind != "pads",
                              launches=True)[0]
            err_max = max(err_max, err)
        del key, score
    torch.cuda.synchronize()
    return err_max


def phase_probe():
    """P1 against x + 1 (bit-equal), then the probe's own run: chains of 1, 4
    and 16 launches, per-launch time from the host clock and CUDA events.
    Returns (launches, [kernel ms, plain ms, bound ms, bound_by], library ms)."""
    x = torch.randn(lp.SHAPE, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))

    def chain(fn, n):
        y = x
        for _ in range(n):
            y = fn(y)
        return y

    for n in PROBE_CHAINS:
        got, want = chain(lp.probe_add, n), chain(lp.probe_add_reference, n)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"probe chain {n}: kernel and x + 1 differ"
    reps = 200
    lp.launches["probe_add"] = 0
    per = {}
    for n in PROBE_CHAINS:
        for name, fn in (("kernel", lp.probe_add), ("plain", lp.probe_add_reference),
                         ("library", lambda y: torch.add(y, 1.0))):
            chain(fn, n)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                chain(fn, n)
            torch.cuda.synchronize()
            host_us = 1e6 * (time.perf_counter() - t) / (reps * n)
            ev_ms = cuda_ms(lambda fn=fn, n=n: chain(fn, n), reps=reps) / n
            per[name, n] = ev_ms
            log(f"probe chain of {n:2d} {name:7s}: {host_us:.3f} us/launch host clock, "
                f"{1e3 * ev_ms:.3f} us/launch CUDA events")
    launches = lp.launches["probe_add"]
    # The same chains, each captured as one CUDA graph: a replay launches
    # the chain's kernels with one host enqueue for the whole chain.
    for n in PROBE_CHAINS:
        for name, fn in (("kernel", lp.probe_add), ("library", lambda y: torch.add(y, 1.0))):
            g = capture(lambda fn=fn, n=n: chain(fn, n))
            g.replay()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                g.replay()
            torch.cuda.synchronize()
            host_us = 1e6 * (time.perf_counter() - t) / (reps * n)
            ev_us = 1e3 * cuda_ms(g.replay, reps=reps) / n
            g.reset()
            log(f"probe chain of {n:2d} {name:7s} as one CUDA graph: {host_us:.3f} us/launch host "
                f"clock, {ev_us:.3f} us/launch CUDA events")
    # Device time: one call captured in a CUDA graph, its replay timed after
    # a write of 4x the L2 (as K1's, K3's and K4's).
    dev_us = {name: 1e3 * graph_ms(lambda fn=fn: fn(x), reps=reps)
              for name, fn in (("kernel", lp.probe_add), ("library", lambda y: torch.add(y, 1.0)))}
    log(f"probe device time, one call captured in a CUDA graph, replayed with the L2 cold: "
        f"P1 {dev_us['kernel']:.3f} us, torch.add {dev_us['library']:.3f} us")
    lp.launches["probe_add"] = launches  # the captures launched nothing
    n = PROBE_CHAINS[-1]
    bound_ms, by = bound(0, 0, x.numel() * 4, x.numel() * 4, x.numel())
    return launches, [per["kernel", n], per["plain", n], bound_ms, by], per["library", n]


def phase_kernels(scorer):
    rng = np.random.default_rng(SEED)
    rec_np, starts, lens = synthetic_rec(rng)
    rec = padded_rows(rec_np, "cuda")  # the DeviceIndex layout
    scalars = torch.tensor([7.5, 1.0], dtype=torch.float32, device="cuda")
    errs = {"full": 0.0, "lanes": 0.0}
    for phase, ncs in (("full", FULL_NC), ("lanes", LANES_NC)):
        for NC in ncs:
            tables = synthetic_tables(rng, starts, lens, 1024, NC)
            for k in TOP_KS:
                label = f"{phase} NC={NC} k={k}"
                check = check_full if phase == "full" else check_lanes
                err, ms, plain_ms = check(scorer, rec, tables, scalars, k, label, SYN_KEY_BITS)
                torch.cuda.synchronize()
                errs[phase] = max(errs[phase], err)
                bound_ms, _by = bm25_bound(tables, k, phase)
                log(f"kernel {label:22s} B=1024 L={NC * C:6d}: ok, max_abs_err {err:.3g}, "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    for NC, k in FULL_LARGE_K:  # the top-k words in device scratch
        tables = synthetic_tables(rng, starts, lens, 64, NC)
        label = f"full NC={NC} k={k}"
        err, ms, plain_ms = check_full(scorer, rec, tables, scalars, k, label, SYN_KEY_BITS)
        errs["full"] = max(errs["full"], err)
        log(f"kernel {label:22s} B=64 L={NC * C:6d}: ok, max_abs_err {err:.3g}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return errs


def z2o_bound(args, k, F):
    """``bound`` of one K4 call: each payload lane reads 2 + 2F record rows
    and does 6F f32 operations (the contribution and the per-doc sum)."""
    c_start, c_len = args[1], args[3]
    B, NC = c_start.shape
    payload = int(c_len.sum())
    return bound(payload, 2 + 2 * F, B * NC * 24 + B * 4, B * k * 8, payload * 6 * F)


def check_z2o(args, chunk, k, F, label, key_bits=31, exact=None):
    """K4 against its plain version on ``args`` = (rec, c_start, c_skip,
    c_len, c_qterm, c_score, c_rank, qlen): repeat runs bit-equal, top-k
    within the tolerance (the rows ``exact`` selects: bit-equal); CUDA-event
    times of both and the kernel's device time (CUDA graph replay, L2
    cold)."""
    kw = dict(chunk=chunk, k=k, num_fields=F, key_bits=key_bits)
    ks, kd = fz.fused_z2o_topk(*args, **kw)
    ks2, kd2 = fz.fused_z2o_topk(*args, **kw)
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2), f"{label}: repeat runs differ"
    ps, pd = fz.fused_z2o_topk_reference(*args, chunk=chunk, k=k, num_fields=F)
    err = assert_topk_agree(ks.cpu(), kd.cpu(), ps.cpu(), pd.cpu())
    if exact is not None:
        assert torch.equal(ks[exact], ps[exact]) and torch.equal(kd[exact], pd[exact]), (
            f"{label}: not bit-equal to plain")
    ms = cuda_ms(lambda: fz.fused_z2o_topk(*args, **kw))
    dev_ms = graph_ms(lambda: fz.fused_z2o_topk(*args, **kw))
    plain_ms = cuda_ms(lambda: fz.fused_z2o_topk_reference(*args, chunk=chunk, k=k, num_fields=F))
    return err, ms, plain_ms, dev_ms


def phase_z2o_kernels():
    rng = np.random.default_rng(SEED + 1)
    err_max = 0.0
    log(f"K4 dynamic shared memory a block may use: {fz.device_avail(0)} B")
    for F in Z2O_F:
        rec_np, starts, lens = synthetic_rec(rng, F=F)
        rec = padded_rows(rec_np, "cuda")
        for NC in Z2O_NC:
            args = (rec, *synthetic_z2o_tables(rng, starts, lens, 1024, NC))
            for k in TOP_KS:
                label = f"z2o F={F} NC={NC} k={k}"
                err, ms, plain_ms, dev_ms = check_z2o(args, C, k, F, label, SYN_Z2O_KEY_BITS)
                torch.cuda.synchronize()
                err_max = max(err_max, err)
                bound_ms, _by = z2o_bound(args, k, F)
                log(f"kernel {label:22s} B=1024 L={NC * C:6d}: ok, max_abs_err {err:.3g}, "
                    f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms")
    for kind in Z2O_EDGES:  # K4's edges
        rec_np, tables, Cz, F, k, slots = z2o_edge(kind, SEED)
        args = (padded_rows(rec_np, "cuda"), *(dev(t, torch.float32 if t.dtype == np.float32 else torch.int32)
                                                for t in tables))
        label = f"z2o edge {kind} C={Cz} NC={tables[0].shape[1]} F={F} k={k}"
        # bit-equal where the sums are exact: every row of "ties", the edge row 0
        exact = slice(None) if kind == "ties" else 0 if kind in Z2O_ROW0_EDGES else None
        err, ms, plain_ms, dev_ms = check_z2o(args, Cz, k, F, label,
                                              fm.key_bits_for(slots, fz.DOC_SHIFT), exact)
        n = kernels_per_call(lambda: fz.fused_z2o_topk(*args, chunk=Cz, k=k, num_fields=F,
                                                        key_bits=fm.key_bits_for(slots, fz.DOC_SHIFT)))
        assert n == 1, f"{label}: {n} kernels per call"
        err_max = max(err_max, err)
        log(f"kernel {label}: ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms (device {dev_ms:.4f}), "
            f"plain {plain_ms:.4f} ms, 1 kernel launch per call (CUDA graph)")
    return err_max


# --------------------------------------------------------------------- #
# phase 3: main path                                                     #
# --------------------------------------------------------------------- #


def window_classes(dix, queries, scorer, k):
    """(dispatches, class_specs) the port packs for ``queries``."""
    plan, _fb = dix.plan_batch(queries, pdev.whitespace_tokenizer, scorer)
    plan = dix.prune(plan, scorer, k, [1.0] * dix.num_fields)  # as query_batch_async does
    tkey = (pdev._scorer_cache_key(scorer), k, "slots20", len(queries))
    return dix._pack_dispatches_template(len(queries), plan, tkey)


def check_window_classes(dix, dispatches, scorer, k):
    """Kernel against plain on every class of a real window (f32 scores).
    Returns per phase the largest error and [kernel ms, plain ms, bound ms,
    bound_by] summed over the classes."""
    errs = {"full": 0.0, "lanes": 0.0, "merge_topk": 0.0}
    times = {key: [0.0, 0.0, 0.0, "bytes"] for key in errs}
    scalars = torch.cat([dix.field_avg, torch.ones(1, device="cuda")])
    k1_dev = 0.0
    for idxs, jobs_flat, nc, nj, _rng, _cw in dispatches:
        jobs = torch.from_numpy(jobs_flat).cuda().reshape(jobs_flat.shape[0], nj, 3)
        tables = pdev.expand_chunks(jobs, dix.CHUNK, nc)
        phase = "full" if nc * dix.CHUNK <= pdev._FUSED_MAX_LANES else "lanes"
        kk = min(k, nc * dix.CHUNK)
        label = f"window class nc={nc} nj={nj} rows={jobs_flat.shape[0]} ({phase})"
        check = check_full if phase == "full" else check_lanes
        err, ms, plain_ms = check(scorer, dix.rec, tables, scalars, kk, label, dix._key_bits)
        bound_ms, by = bm25_bound(tables, kk, phase)
        errs[phase] = max(errs[phase], err)
        t = times[phase]
        t[0] += ms
        t[1] += plain_ms
        t[2] += bound_ms
        t[3] = by if bound_ms else t[3]
        occ = ""
        if phase == "full":
            ring, smem = fq.full_launch(nc * dix.CHUNK, dix.CHUNK, 1, kk, fq.device_smem(0)[1])
            dev_ms = graph_ms(lambda: fq.fused_query_topk(
                scorer, dix.rec, *tables, scalars, chunk=dix.CHUNK, k=kk, qterm_bits=QB,
                num_fields=1, key_bits=dix._key_bits))
            k1_dev += dev_ms
            occ = (f", device {dev_ms:.4f} ms (CUDA graph replay, L2 cold), "
                   f"{_build.load().fused_query_occupancy(0, nc * dix.CHUNK, smem)} CTAs/SM "
                   f"({smem} B shared, ring {ring})")
        log(f"{label}: ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({by}){occ}")
        if phase == "lanes":  # K5 merges the K3 lanes
            ls, lk = fq.fused_query_topk(scorer, dix.rec, *tables, scalars, chunk=dix.CHUNK,
                                         k=kk, qterm_bits=QB, num_fields=1, phase="lanes")
            add_merge(errs, times, check_merge(lk, ls, kk, f"{label} merge", run=dix.CHUNK,
                                               excl=True, max_seg=nc, key_bits=dix._key_bits,
                                               launches=True))
    log(f"K1 over the window's K1 classes: {times['full'][0]:.4f} ms CUDA events, {k1_dev:.4f} ms "
        f"device (each class one call captured in a CUDA graph, replayed with the L2 cold), bound "
        f"{times['full'][2]:.4f} ms")
    return errs, times


def add_merge(errs, times, result):
    err, ms, plain_ms, bound_ms, by = result
    errs["merge_topk"] = max(errs["merge_topk"], err)
    t = times["merge_topk"]
    t[0] += ms
    t[1] += plain_ms
    t[2] += bound_ms
    t[3] = by


def profile_windows(submit, n=4, per_card=None):
    """Windows one at a time (``submit(i)``, drain) under torch.profiler:
    wall time per window, device busy time per window (the sum of kernel
    times), kernels by device time.  ``per_card``: a dict that receives the
    busy ms per window of each card (by the events' ``device_index``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            submit(i).get_arrays()
        sync_cards()
        wall_ms = 1e3 * (time.perf_counter() - t) / n
    if per_card is not None:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                per_card[e.device_index] = (per_card.get(e.device_index, 0.0)
                                            + e.self_device_time_total / 1e3 / n)
    # Device-side events only: a torch op's own entry carries the time of the
    # kernels it launched, which appear again as events of their own.
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    if busy_ms == 0:
        log(f"one window alone: {wall_ms:.3f} ms wall; device time not measured (no device events)")
        return {}
    log(f"one window alone (profiled): {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall), idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1e3 / n:8.3f} ms/window  "
            f"calls {e.count // n:4d}/window  {e.key[:70]}")
    return {e.key: (e.count / n, e.self_device_time_total / 1e3 / n) for e in events}


def graph_stats(d):
    """The class-graph counters since the last metrics reset, and the state
    of ``d``'s cache: keys captured so far and the bytes its pool reserved."""
    c = pdev.metrics.snapshot()["counters"]
    g = d._class_graphs
    return (f"class graphs {int(c.get('class_graph_captures', 0))} captured, "
            f"{int(c.get('class_graph_replays', 0))} replayed; {len(g)} keys, pool "
            f"{g.pool_bytes} B ({g.pool_bytes / 2**20:.1f} MiB)")


def timer_ms(name):
    """Total ms of the host timer ``name`` since the last metrics reset."""
    h = pdev.metrics.histograms.get(name)
    return h.sum_us / 1e3 if h is not None else 0.0


def submit_timed(submit, name):
    """``submit()``, and the ms its ``name`` timer took."""
    t = timer_ms(name)
    h = submit()
    return h, timer_ms(name) - t


class Recorded:
    """Within the block, each window ``d`` serves records its classes (the
    ``ClassGraphs.run`` argument) in ``windows``."""

    def __init__(self, d):
        self.d, self.windows = d, []

    def __enter__(self):
        real = self.d._class_graphs.run

        def run(classes, concat=False):
            self.windows.append(list(classes))
            return real(classes, concat)

        self.d._class_graphs.run = run
        return self

    def __exit__(self, *exc):
        del self.d._class_graphs.run


def eager_step_check(d, handle, classes, label, scorer=None):
    """The served rows of one window (``handle``, recorded ``classes``)
    against the eager step called directly on the same words: BM25 classes
    through ``_window_step`` (``_class_outputs`` for a per-dispatch window,
    f32 scores and slots), z2o classes through ``_z2o_window_step``;
    bit-equal.  The launches of the eager step are taken back out."""
    saved = [dict(c) for c in pdev._launch_counters()]
    keys = [key for key, _m, _p in classes]
    key = keys[0]
    words = torch.cat([p[0] for _k, _m, p in classes]).cuda()
    extra = torch.cat([p[1] for _k, _m, p in classes]).cuda()
    if isinstance(key, pz.Z2OClassKey):
        specs = tuple((x.b_out, x.b_out, x.nj, x.num_chunks, x.fast) for x in keys)
        want = pz._z2o_window_step(
            d.rec, words, extra.view(torch.float32), chunk=key.chunk, k=key.k,
            num_fields=key.num_fields, class_specs=specs, fused_ok=key.fused_ok, fmt=key.fmt,
            key_bits=key.key_bits)
        want, got = [want], [handle._packed]
    else:
        specs = tuple((x.b_out, x.b_out, x.nj, x.num_chunks, x.use_ranges, x.chunk) for x in keys)
        aux = d._aux_rec(scorer) if any(x.use_ranges for x in keys) else None
        boost = classes[0][2][1].cuda().view(torch.float32)
        kw = dict(k=key.k, qterm_bits=key.qterm_bits, num_fields=key.num_fields,
                  class_specs=specs, key_bits=key.key_bits)
        if key.fmt == "parts":
            outs = pdev._class_outputs(scorer, d.rec, d.field_avg, boost, words, aux, **kw)
            want = [t for s_, d_ in outs for t in pdev._pad_k(s_, d_, key.k)]
            got = [t for _i, s_, d_ in handle._parts for t in (s_, d_)]
        else:
            want = [pdev._window_step(scorer, d.rec, d.field_avg, boost, words, aux,
                                      fmt=key.fmt, **kw)]
            got = [handle._packed]
    torch.cuda.synchronize()
    assert len(got) == len(want), (label, len(got), len(want))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu()), f"{label}: served rows differ from the eager step"
    for counts, was in zip(pdev._launch_counters(), saved):
        counts.clear()
        counts.update(was)
    log(f"{label}: served rows bit-equal to the eager step on the same words ({len(keys)} classes, "
        f"{len(set(keys))} keys, format {key.fmt})")


def phase_main(scorer, card):
    t0 = time.time()
    vocab, cdf, texts = make_corpus(N_DOCS, 50_000, 8)
    ix = Index(1, config=IndexConfig(result_format="slots20"))
    ix.add_documents_columnar(list(range(N_DOCS)), [texts])
    t1 = time.time()
    dix = DeviceIndex(ix, device="cuda")
    torch.cuda.synchronize()
    t2 = time.time()
    log(f"corpus + index build: {t1 - t0:.1f} s; device upload: {t2 - t1:.1f} s "
        f"({dix.num_postings} postings, rec {tuple(dix.rec.shape)})")
    queries = make_queries(vocab, cdf, 2 * WINDOW, 3)
    windows = [queries[:WINDOW], queries[WINDOW:]]
    k = 10

    pdev.metrics.reset()
    disp = []
    for _ in range(2):  # warm-up: plan pools, heavy cache, template freeze, class graphs
        for w in windows:
            h, ms = submit_timed(lambda: dix.query_batch_async(w, scorer, top_k=k), "query/dispatch")
            h.get_arrays()
            disp.append(ms)
    torch.cuda.synchronize()
    log(f"warm-up (2 passes): {time.time() - t2:.1f} s; query/dispatch per window (ms, the first "
        f"two capture) {', '.join(f'{v:.3f}' for v in disp)}; {graph_stats(dix)}")

    dispatches, specs = window_classes(dix, windows[0], scorer, k)
    for _idxs, jobs_flat, nc, nj, _rng, _cw in dispatches:
        phase = "full" if nc * dix.CHUNK <= pdev._FUSED_MAX_LANES else "lanes"
        log(f"class nc={nc:5d} nj={nj:4d} rows={jobs_flat.shape[0]:6d} phase={phase}")

    # 8 windows, depth-4 pipeline, drained in pairs one pair late.
    reset_bm25_counts()
    dt, lat_ms, out = serve_pipelined(lambda i: dix.query_batch_async(windows[i % 2], scorer, top_k=k))
    launches = {**fq.launches, **fm.launches}
    log(f"launch counts over the 8 served windows: {launches}")
    assert launches["full"] > 0 and launches["lanes"] > 0 and launches["merge_topk"] > 0, launches
    for i, (_s, slots, keys) in enumerate(out):  # drained in submission order
        assert slots.shape == (WINDOW, k) and keys.shape == (WINDOW, k)
        assert (slots >= -1).all() and (slots < dix.num_slots).all()
        np.testing.assert_array_equal(slots, out[i % 2][1])  # same window, same answer
    log(f"served 8 windows x {WINDOW} queries on {card}: {1e3 * dt / 8:.3f} ms/window, "
        f"{8 * WINDOW / dt:.1f} QPS; window latency p50 {np.median(lat_ms):.1f} ms "
        f"(host clock, pipeline of 4; for information only); {graph_stats(dix)}")

    hist = pdev.metrics.snapshot()["histograms"]
    log("host phases per window (mean ms, host clock): " + ", ".join(
        f"{name.split('/')[1]} {hist[name]['mean_us'] / 1e3:.3f}"
        for name in (f"query/{p}" for p in HOST_PHASES)
        if name in hist
    ))
    profile_windows(lambda i: dix.query_batch_async(windows[i % 2], scorer, top_k=k))

    sample = queries[:256]
    _s, s_slots, s_keys = dix.query_batch_async(sample, scorer, top_k=k).get_arrays()
    recall = bm25_recall(ix, sample, s_slots, s_keys, k)
    log(f"recall@{k} against the f64 oracle on {len(sample)} queries: {recall!r}")
    assert recall >= 0.999, recall

    errs, times = check_window_classes(dix, dispatches, scorer, k)
    return launches, errs, times, ix, dix, windows, (vocab, cdf)


_ORACLE = {}


def bm25_recall(ix, sample, slots, keys, k):
    """recall@k of device rows (``slots``, ``keys``) against the f64 oracle
    ``Index.query`` on the queries ``sample`` (each query's oracle row is
    computed once a run)."""
    hits = total = 0
    for qi, q in enumerate(sample):
        if (id(ix), q, k) not in _ORACLE:
            _ORACLE[(id(ix), q, k)] = {r.key for r in ix.query(q, bm25.new(), TOK, [1.0])[:k]}
        o_keys = _ORACLE[(id(ix), q, k)]
        d_keys = {int(x) for x, sl in zip(keys[qi], slots[qi]) if sl >= 0}
        hits += len(o_keys & d_keys)
        total += len(o_keys)
    return hits / max(total, 1)


def reset_bm25_counts():
    for counts in (fq.launches, fm.launches, fm.path_calls):
        for key in counts:
            counts[key] = 0
    for counts in (fq.chunk_launches, *CARD_COUNTS):
        counts.clear()
    pdev.metrics.reset()


def bm25_counts():
    """The BM25 wrappers' launch counts, and K5's calls by path."""
    return {**fq.launches, **fm.launches, **{f"k5_{p}": n for p, n in fm.path_calls.items()}}


def tally_kernels(counts, key_bits):
    """Kernels the wrappers launched for ``counts`` (``bm25_counts``): K1
    and K3 one a call, K5 one on the block path, ``path_kernels`` on the
    radix path."""
    return (counts["full"] + counts["lanes"] + counts["k5_block"]
            + counts["k5_radix"] * path_kernels("radix", key_bits))


PORT_KERNELS = ("fused_query_full_kernel", "fused_query_lanes_kernel", "merge_block_kernel", "radix_")
MANIFEST = os.path.join(ROOT, "benchmarks", "bench_templates.json")


def phase_graphs(ix, dix, windows, scorer, card):
    """Phase 3g: the graph path.  A second DeviceIndex over the same index
    loads the bench manifest and prewarms (one CUDA graph per template);
    8 pipelined windows are served on phase 3's index (class graphs: no
    prewarm), graph, graph, class graphs; the graph path's slots must equal
    the class graphs' path's, with no refreeze and recall@10
    1.0.  Then the window's replay timed with the L2 cold and warm, the
    profiler's kernel count per window beside the launch tally and the
    captured step's kernel nodes, and a pair of windows drained jointly
    against two drained apart.  Returns the graph path's launch counts."""
    k = 10
    tkey = (pdev._scorer_cache_key(scorer), k, "slots20", WINDOW)
    gix = DeviceIndex(ix, device="cuda")
    n_tpl = gix.load_templates(MANIFEST)
    entries = gix._comp_templates[tkey]
    own = dix._comp_templates.get(tkey)
    log(f"3g manifest {os.path.relpath(MANIFEST, ROOT)}: {n_tpl} template(s), {len(entries)} "
        f"entries, {sum(e[2] for e in entries)} rows; the eager index froze "
        + ("the same template" if own == entries else f"another template: {own}"))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved()
    pdev.metrics.reset()
    t = time.perf_counter()
    n_warm = gix.prewarm(scorer)
    torch.cuda.synchronize()
    t_pw = time.perf_counter() - t
    mem1 = torch.cuda.memory_reserved()
    ctr = pdev.metrics.snapshot()["counters"]
    log(f"3g prewarm: {n_warm} template(s) warmed, {len(gix._graphs)} CUDA graph(s) "
        f"({int(ctr.get('template_graph_captures', 0))} captured) in {t_pw:.3f} s; memory "
        f"reserved {mem0 / 2**20:.1f} MiB before, {mem1 / 2**20:.1f} MiB after")
    assert n_tpl == 1 and n_warm == 1 and list(gix._graphs) == [tkey]
    t = time.perf_counter()
    for _ in range(2):  # warm-up: the new index's plan pools
        for w in windows:
            gix.query_batch_async(w, scorer, top_k=k).get_arrays()
    torch.cuda.synchronize()
    ctr = pdev.metrics.snapshot()["counters"]
    log(f"3g warm-up (2 passes): {time.perf_counter() - t:.1f} s, "
        f"{int(ctr.get('template_graph_replays', 0))} replays, "
        f"{int(ctr.get('template_refreezes', 0))} refreezes")
    assert not ctr.get("template_refreezes") and ctr.get("template_graph_replays") == 4, ctr

    turns = []
    for turn, x in (("class graphs", dix), ("graph", gix), ("graph", gix), ("class graphs", dix)):
        reset_bm25_counts()
        dt, lat_ms, out = serve_pipelined(lambda i, x=x: x.query_batch_async(windows[i % 2], scorer, top_k=k))
        counts = bm25_counts()
        ctr = pdev.metrics.snapshot()["counters"]
        hist = pdev.metrics.snapshot()["histograms"]
        replays = int(ctr.get("template_graph_replays", 0))
        log(f"3g {turn}: 8 windows x {WINDOW} queries on {card}: {1e3 * dt / 8:.3f} ms/window, "
            f"{8 * WINDOW / dt:.1f} QPS, window latency p50 {np.median(lat_ms):.1f} ms; host phases "
            "(mean ms): " + ", ".join(
                f"{name.split('/')[1]} {hist[name]['mean_us'] / 1e3:.3f}"
                for name in (f"query/{p}" for p in HOST_PHASES)
                if name in hist)
            + f"; {replays} replays; launches {counts}")
        assert counts["full"] > 0 and counts["lanes"] > 0 and counts["merge_topk"] > 0, counts
        assert not ctr.get("template_refreezes") and replays == (8 if turn == "graph" else 0), ctr
        turns.append((turn, out, counts))
    for turn, out, _c in turns[1:]:
        for got, want in zip(out, turns[0][1]):
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
    _s, slots, keys = turns[1][1][0]  # the graph path's first window
    recall = bm25_recall(ix, windows[0][:256], slots, keys, k)
    log(f"3g the graph path's slots equal the class graphs' path's (3 turns x 8 windows); recall@{k} of its "
        f"first 256 rows against the f64 oracle: {recall!r}")
    assert recall == 1.0, recall

    g = gix._graphs[tkey]
    cold = replay_ms(g.graph)
    warm = cuda_ms(lambda: [g.graph.replay() for _ in range(10)]) / 10
    log(f"3g the window's CUDA graph replay: {cold:.4f} ms with the L2 cold, {warm:.4f} ms warm "
        "(10 replays back to back)")
    step = gix._step(scorer, k, "slots20", gix._template_specs(entries))
    nodes = kernels_per_call(lambda: step(g.words))
    for turn, x in (("class graphs", dix), ("graph", gix)):
        reset_bm25_counts()
        ev = profile_windows(lambda i, x=x: x.query_batch_async(windows[i % 2], scorer, top_k=k), n=2)
        want = tally_kernels(bm25_counts(), dix._key_bits) / 2
        port = sum(c for name, (c, _ms) in ev.items() if any(p in name for p in PORT_KERNELS))
        every = sum(c for name, (c, _ms) in ev.items() if not name.startswith(("Memcpy", "Memset")))
        busy = sum(ms for _c, ms in ev.values())
        flag = "" if (port, every) == (want, nodes) else "  MISMATCH (the profiler lost launches)"
        log(f"3g {turn} window under the profiler: busy {busy:.3f} ms (replay {cold:.4f} cold / "
            f"{warm:.4f} warm); kernels {every:g}, of the port's library {port:g}; the launch tally "
            f"{want:g} of the port's kernels, the captured step {nodes} kernels{flag}")

    joint, apart = [], []
    for _ in range(5):
        for mode, times_ in (("joint", joint), ("apart", apart)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pair = [gix.query_batch_async(w, scorer, top_k=k) for w in windows]
            if mode == "joint":
                pdev.fetch_windows_jointly(pair)
            arrays = [h.get_arrays() for h in pair]
            times_.append(1e3 * (time.perf_counter() - t))
            for got, want in zip(arrays, turns[0][1]):
                np.testing.assert_array_equal(got[1], want[1])
    log(f"3g a pair of windows submitted and drained (prefetch on, graph path): jointly "
        f"{np.median(joint):.3f} ms, apart {np.median(apart):.3f} ms (medians of 5, host clock)")
    return turns[1][2], gix


def phase_custom(ix, dix, sample):
    """Phase 3c: one window of a user's one-phase scorer (``TfBoost``,
    tests/torch_util.py: its score in torch) on the 1M-doc index, f32 rows
    against the f64 host oracle ``Index.query``: staged lanes + K5, never
    the fused kernel.  Returns K5's launches."""
    import dataclasses

    k = 10
    reset_bm25_counts()
    dix.config = dataclasses.replace(ix.config, result_format="f32")
    graphs = dix._class_graphs
    runs = {}
    try:
        for run in ("cold", "warm", "eager", "warm again"):
            dix._class_graphs = EagerClasses(dix.device) if run == "eager" else graphs
            if run == "warm":
                counts = bm25_counts()
                stats = graph_stats(dix)
            with Recorded(dix) as rec:
                t = time.perf_counter()
                h, disp = submit_timed(lambda: dix.query_batch_async(sample, TfBoost(), top_k=k),
                                       "query/dispatch")
                scores, slots, _keys = h.get_arrays()
                runs[run] = (1e3 * (time.perf_counter() - t), disp)
            if run == "warm":
                eager_step_check(dix, h, rec.windows[-1], "3c warm window", TfBoost())
    finally:
        dix.config = ix.config
        dix._class_graphs = graphs
    assert counts["merge_topk"] > 0 and counts["full"] == counts["lanes"] == 0, counts
    log(f"3c TfBoost window ({len(sample)} queries) ms submit to drained / query/dispatch ms: "
        + ", ".join(f"{run} {ms_:.3f} / {d_:.3f}" for run, (ms_, d_) in runs.items())
        + f" (eager: the same class steps run eagerly); cold window {stats}")
    ms = runs["cold"][0]
    t = time.perf_counter()
    o_s = np.full((len(sample), k), -np.inf, np.float32)
    o_d = np.full((len(sample), k), -1, np.int32)
    for qi, q in enumerate(sample):
        for r, res in enumerate(ix.query(q, TfBoost(), TOK, [1.0], top_k=k)):
            o_s[qi, r] = res.score
            o_d[qi, r] = ix._key_to_slot[res.key]
    err = assert_topk_agree(scores, slots, o_s, o_d)
    log(f"3c TfBoost window ({len(sample)} queries, cold): {ms:.3f} ms submit to drained, launches "
        f"{counts}; rows agree with the f64 host oracle (max abs err {err:.3g}, "
        f"{time.perf_counter() - t:.1f} s)")
    return counts["merge_topk"]


def prune_mixes(vocab, cdf, n=WINDOW):
    """``benchmarks/prune_probe.py``'s three mixes over the bench corpus, one
    window of ``n`` queries each (rng seed 7): ``single``, 1-term Zipf
    queries from rank 100 up; ``skewed``, a term of rank 100-2,000 with one
    of rank 20,000-50,000; ``headline``, bench.py's 3-term mix with seed 9."""
    rng = np.random.default_rng(7)

    def zipf_ids(n, lo_rank=100, hi=None):
        lo = cdf[lo_rank - 1]
        hiv = cdf[hi - 1] if hi else 1.0
        return np.minimum(np.searchsorted(cdf, lo + rng.random(n) * (hiv - lo)), len(vocab) - 1)

    single = [vocab[i] for i in zipf_ids(n)]
    skewed = [
        f"{vocab[c]} {vocab[r]}"
        for c, r in zip(zipf_ids(n, 100, 2000), rng.integers(20_000, 50_000, n))
    ]
    return {"single": single, "skewed": skewed, "headline": make_queries(vocab, cdf, n, 3, seed=9)}


def serve_queued(d, queries, scorer, k, n=4):
    """``n`` windows submitted back to back, then drained in order.  Returns
    (ms a window, [latency ms submit to drained], the first window's
    arrays)."""
    t0 = time.perf_counter()
    handles = [(time.perf_counter(), d.query_batch_async(queries, scorer, top_k=k)) for _ in range(n)]
    lat, first = [], None
    for t_submit, h in handles:
        arrays = h.get_arrays()
        lat.append(1e3 * (time.perf_counter() - t_submit))
        first = first or arrays
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n, lat, first


def phase_prune(ix, vocab, cdf, card):
    """Phase 3p: block-max pruning on the 1M-doc index, nothing cut, over
    ``prune_mixes``.  Two fresh DeviceIndexes serve in alternating turns,
    one with ``prune_blocks`` on and one with it off (each freezes its own
    template; both are cleared between mixes).  Per mix: chunks pruned a
    window against the total, slots of the two equal, ms a window and p50
    latency as medians of 3 turns of 4 queued windows, ``query/prune`` host
    ms cold and warm (and the bounds' build, ``query/prune_bounds``, in
    the cold window), the device busy share of one window on and off
    (torch.profiler), recall@10 of the pruned rows against the f64 oracle
    on 256 queries.  Returns the launch counts of its served windows."""
    k = 10
    scorer = bm25.new()
    cfg = ix.config
    t = time.perf_counter()
    d_on, d_off = DeviceIndex(ix, device="cuda"), DeviceIndex(ix, device="cuda")
    log(f"3p two DeviceIndexes (pruning on / off): {time.perf_counter() - t:.1f} s")
    launches = dict.fromkeys(("full", "lanes", "merge_topk"), 0)

    def serve(d, on, q, n=4):
        cfg.prune_blocks = on
        reset_bm25_counts()
        out = serve_queued(d, q, scorer, k, n)
        snap = pdev.metrics.snapshot()
        for key in launches:
            launches[key] += bm25_counts()[key]
        return out, snap

    try:
        for name, q in prune_mixes(vocab, cdf).items():
            for d in (d_on, d_off):
                d._comp_templates.clear()
            (cold_ms, _l, on0), snap = serve(d_on, True, q, n=1)
            hist, ctr = snap["histograms"], snap["counters"]
            bounds = hist.get("query/prune_bounds", {"count": 0, "mean_us": 0.0})
            cold = (f"cold window {cold_ms:.3f} ms: plan {hist['query/plan']['mean_us'] / 1e3:.3f}, "
                    f"of it bounds {bounds['count'] * bounds['mean_us'] / 1e3:.3f} ms "
                    f"({bounds['count']} builds), prune {hist['query/prune']['mean_us'] / 1e3:.3f} "
                    f"({int(ctr.get('prune/cache_fills', 0))} memo fills)")
            (_ms, _l, off0), _snap = serve(d_off, False, q, n=1)
            for a, b in zip(on0[1:], off0[1:]):  # slots20: slots and keys
                np.testing.assert_array_equal(a, b, err_msg=f"3p {name}: pruned and unpruned rows differ")
            plan, _fb = d_off.plan_batch(q, TOK, scorer)
            total = int(plan.nchunks.sum())
            ms = {True: [], False: []}
            p50 = {True: [], False: []}
            phases = {True: [], False: []}
            warm_prune, pruned, refreezes = [], [], 0
            for turn in range(4):  # the first pair settles the templates
                for on, d in ((True, d_on), (False, d_off)):
                    (w_ms, lat, arrays), snap = serve(d, on, q)
                    np.testing.assert_array_equal(arrays[1], on0[1])
                    if turn == 0:
                        continue
                    refreezes += snap["counters"].get("template_refreezes", 0)
                    phases[on].append({p: snap["histograms"][f"query/{p}"]["mean_us"] / 1e3
                                       for p in HOST_PHASES if f"query/{p}" in snap["histograms"]})
                    ms[on].append(w_ms)
                    p50[on].append(float(np.median(lat)))
                    if on:
                        warm_prune.append(snap["histograms"]["query/prune"]["mean_us"] / 1e3)
                        pruned.append(snap["counters"].get("prune/pruned_chunks", 0) / 4)
            log(f"3p {name}: chunks pruned a window {pruned[-1]:g} of {total} "
                f"({100 * pruned[-1] / total:.2f}%); slots bit-equal on / off; {cold}")
            log(f"3p {name}: on {np.median(ms[True]):.3f} ms/window (turns "
                f"{', '.join(f'{v:.3f}' for v in ms[True])}), p50 {np.median(p50[True]):.1f} ms; off "
                f"{np.median(ms[False]):.3f} ms/window ({', '.join(f'{v:.3f}' for v in ms[False])}), "
                f"p50 {np.median(p50[False]):.1f} ms (3 turns of 4 queued windows, host clock, "
                f"{card}); query/prune warm {np.median(warm_prune):.3f} ms a window; "
                f"refreezes in the timed turns {int(refreezes)}")
            for on in (True, False):
                log(f"3p {name} {'on' if on else 'off'} host phases (mean ms a window, median of the "
                    "turns): " + ", ".join(f"{p} {np.median([t[p] for t in phases[on]]):.3f}"
                                           for p in phases[on][0]))
            for on, d in ((True, d_on), (False, d_off)):
                cfg.prune_blocks = on
                log(f"3p {name} pruning {'on' if on else 'off'}, profiled:")
                profile_windows(lambda i, d=d: d.query_batch_async(q, scorer, top_k=k), n=2)
            cfg.prune_blocks = True
            _s, slots, keys = d_on.query_batch_async(q[:256], scorer, top_k=k).get_arrays()
            np.testing.assert_array_equal(slots, on0[1][:256])
            recall = bm25_recall(ix, q[:256], slots, keys, k)
            log(f"3p {name}: recall@{k} of the pruned rows against the f64 oracle on 256 queries: "
                f"{recall!r}")
            assert recall >= 0.999, recall
            if name == "single":
                assert pruned[-1] > 0, f"3p {name}: nothing pruned"
    finally:
        cfg.prune_blocks = True
    log(f"3p launches over its served windows: {launches}")
    return launches


# --------------------------------------------------------------------- #
# phase 3l: the dispatch modes                                           #
# --------------------------------------------------------------------- #

LIGHT_CW = 256  # IndexConfig.light_chunk_size of phase 3l


def composed_classes(dix, queries, scorer, k):
    """The composed window's dispatches (templates off) under ``dix.config``,
    in the layout ``query_batch_async`` gives them (``composed_class_specs``),
    each with the rows it computes."""
    plan, _fb = dix.plan_batch(queries, TOK, scorer)
    plan = dix.prune(plan, scorer, k, [1.0] * dix.num_fields)
    disp = dix.pack_dispatches(len(queries), plan)
    specs = pdev.composed_class_specs(disp)
    return [(d, spec[1]) for d, spec in zip(disp, specs)]


def k1_classes(dix, classes, scorer, k, width=None, check=False):
    """K1 on each full-phase class of ``classes`` (``composed_classes``; of
    chunk width ``width`` only, if given) at the rows the window computes:
    device time (one call captured in a CUDA graph, replayed with the L2
    cold), bound, and with ``check`` also K1 against plain (max error,
    CUDA-event and plain times).  Returns the sums and the largest error."""
    scalars = torch.cat([dix.field_avg, torch.ones(1, device="cuda")])
    tot = {"n": 0, "err": 0.0, "ms": 0.0, "plain_ms": 0.0, "dev_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes"}
    for (_idxs, jobs_flat, nc, nj, _rng, cw), b_out in classes:
        if nc * cw > pdev._FUSED_MAX_LANES or (width and cw != width):
            continue
        kk = min(k, nc * cw)
        jobs = torch.from_numpy(jobs_flat[:b_out]).cuda().reshape(b_out, nj, 3)
        tables = pdev.expand_chunks(jobs, cw, nc)
        kw = dict(chunk=cw, k=kk, qterm_bits=QB, num_fields=1, key_bits=dix._key_bits)
        dev_ms = graph_ms(lambda: fq.fused_query_topk(scorer, dix.rec, *tables, scalars, **kw))
        bound_ms, tot["bound_by"] = bm25_bound(tables, kk, "full", chunk=cw)
        line = f"3l K1 class cw={cw} nc={nc} nj={nj} rows={b_out}: device {dev_ms:.4f} ms"
        if check:
            err, ms, plain_ms = check_full(scorer, dix.rec, tables, scalars, kk, line,
                                           dix._key_bits, chunk=cw)
            tot["err"] = max(tot["err"], err)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            line += f", CUDA events {ms:.4f} ms, plain {plain_ms:.4f} ms, max_abs_err {err:.3g}"
        log(f"{line}, bound {bound_ms:.4f} ms ({tot['bound_by']})")
        tot["n"] += 1
        tot["dev_ms"] += dev_ms
        tot["bound_ms"] += bound_ms
    return tot


def class_census(classes):
    """Per chunk width: (classes, real rows, lanes the window computes)."""
    out = {}
    for (idxs, _j, nc, _nj, _rng, cw), b_out in classes:
        c = out.setdefault(cw, [0, 0, 0])
        c[0] += 1
        c[1] += len(idxs)
        c[2] += b_out * nc * cw
    return out


def phase_light(ix, dix, gix, windows, scorer, card):
    """Phase 3l: the dispatch modes on phase 3's index, options flipped on
    ``dix.config`` between turns.  (a) light classes on and off, composed
    (templates off: class graphs), in alternating turns; (b) a light template
    frozen, saved, loaded into a fresh DeviceIndex and prewarmed, served on
    the graph path beside 3g's graph path (``gix``); (c) per-class dispatch
    and per-dispatch windows beside the composed window, on the class graphs
    and eagerly; (d) K1
    against plain on every light class of the first window.  Returns
    (K1's launches at chunk 256 on (a) and (b), (d)'s record)."""
    k = 10
    base = ix.config  # phase 3's: templates, pruning, slots20
    off = dataclasses.replace(base, template_compositions=False, light_chunk_size=0)
    on = dataclasses.replace(off, light_chunk_size=LIGHT_CW)
    q = windows[0]
    light_launches = [0]

    def count_light():
        light_launches[0] += fq.chunk_launches.get(f"full@{LIGHT_CW}", 0)

    # (a) light classes on against off
    classes = {}
    for name, cfg in (("off", off), ("on", on)):
        dix.config = cfg
        classes[name] = composed_classes(dix, q, scorer, k)
        census = class_census(classes[name])
        log(f"3l (a) light {name}: {len(classes[name])} classes; by chunk width (classes, rows, "
            f"lanes computed): {census}; lanes a window {sum(c[2] for c in census.values())}")
    assert LIGHT_CW in class_census(classes["on"]), "3l: no light class in the window"
    ms = {True: [], False: []}
    p50 = {True: [], False: []}
    first = {}
    for turn in range(4):  # the first pair warms up
        for light in (True, False):
            dix.config = on if light else off
            reset_bm25_counts()
            w_ms, lat, arrays = serve_queued(dix, q, scorer, k)
            if light:
                count_light()
            first.setdefault(light, arrays)
            np.testing.assert_array_equal(arrays[1], first[True][1],
                                          err_msg="3l (a): light on and off rows differ")
            if turn:
                ms[light].append(w_ms)
                p50[light].append(float(np.median(lat)))
    for light in (True, False):
        log(f"3l (a) light {'on' if light else 'off'}: {np.median(ms[light]):.3f} ms/window (turns "
            f"{', '.join(f'{v:.3f}' for v in ms[light])}), p50 {np.median(p50[light]):.1f} ms (3 turns "
            f"of 4 queued windows, host clock, {card}); slots bit-equal on / off")
    for light in (True, False):
        dix.config = on if light else off
        log(f"3l (a) light {'on' if light else 'off'}, profiled:")
        reset_bm25_counts()
        profile_windows(lambda i: dix.query_batch_async(q, scorer, top_k=k), n=2)
        if light:
            count_light()
    k1 = {}
    for name in ("off", "on"):
        dix.config = on if name == "on" else off
        k1[name] = k1_classes(dix, classes[name], scorer, k)
    log(f"3l (a) K1 over the window's K1 classes, device (each class one call captured in a CUDA "
        f"graph, replayed with the L2 cold): light on {k1['on']['dev_ms']:.4f} ms in {k1['on']['n']} "
        f"classes, off {k1['off']['dev_ms']:.4f} ms in {k1['off']['n']}; bound on "
        f"{k1['on']['bound_ms']:.4f}, off {k1['off']['bound_ms']:.4f} ms")
    dix.config = on
    _s, slots, keys = dix.query_batch_async(q[:256], scorer, top_k=k).get_arrays()
    recall = bm25_recall(ix, q[:256], slots, keys, k)
    log(f"3l (a) recall@{k} of the light rows against the f64 oracle on 256 queries: {recall!r}")
    assert recall >= 0.999, recall

    # (b) a light template on the graph path
    light_tpl = dataclasses.replace(base, light_chunk_size=LIGHT_CW)
    dix.config = light_tpl
    dix._comp_templates.clear()
    for _ in range(2):
        for w in windows:
            dix.query_batch_async(w, scorer, top_k=k).get_arrays()
    path = os.path.join(ROOT, "build", "templates", "light.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert dix.save_templates(path) == 1
    with open(path) as f:
        (entries,) = json.load(f).values()
    widths = sorted({e[3] for e in entries})
    log(f"3l (b) light template: {len(entries)} entries, widths {widths}, "
        f"{sum(e[2] for e in entries)} rows: {entries}")
    assert LIGHT_CW in widths, "3l (b): the manifest holds no light entry"
    lgx = DeviceIndex(ix, device="cuda")
    lgx.config = light_tpl
    assert lgx.load_templates(path) == 1
    pdev.metrics.reset()
    t = time.perf_counter()
    assert lgx.prewarm(scorer) == 1
    torch.cuda.synchronize()
    log(f"3l (b) load + prewarm: {time.perf_counter() - t:.3f} s, {len(lgx._graphs)} CUDA graph(s)")
    for _ in range(2):  # warm-up: the new index's plan pools
        for w in windows:
            lgx.query_batch_async(w, scorer, top_k=k).get_arrays()
    turns = []
    for name, x in (("light graph", lgx), ("3g graph", gix), ("3g graph", gix), ("light graph", lgx)):
        reset_bm25_counts()
        dt, lat_ms, out = serve_pipelined(lambda i, x=x: x.query_batch_async(windows[i % 2], scorer, top_k=k))
        if x is lgx:
            count_light()
        ctr = pdev.metrics.snapshot()["counters"]
        replays = int(ctr.get("template_graph_replays", 0))
        log(f"3l (b) {name}: 8 windows x {WINDOW} queries: {1e3 * dt / 8:.3f} ms/window, p50 "
            f"{np.median(lat_ms):.1f} ms; {replays} replays, "
            f"{int(ctr.get('template_refreezes', 0))} refreezes; launches {bm25_counts()}, by chunk "
            f"{dict(fq.chunk_launches)}")
        assert replays == 8 and not ctr.get("template_refreezes"), ctr
        turns.append(out)
    for out in turns:
        np.testing.assert_array_equal(out[0][1], first[True][1],
                                      err_msg="3l (b): graph rows differ from (a)'s eager rows")
    log("3l (b) the light graph path's slots equal (a)'s eager rows (and 3g's graph path's)")

    # (c) per-class dispatch and per-dispatch windows against the composed
    # window, each on the class graphs and on the same class steps run
    # eagerly (EagerClasses), in turns
    f32 = dataclasses.replace(off, result_format="f32")
    modes = {
        "composed": f32,
        "per_class": dataclasses.replace(f32, per_class_dispatch=True),
        "per_dispatch": dataclasses.replace(f32, single_dispatch_windows=False),
    }
    graphs, eager = dix._class_graphs, EagerClasses(dix.device)
    order = [(m, p) for m in modes for p in ("graphs", "eager")]
    want, times_ = None, {(m, p): [] for m, p in order}
    for name, path in order + order[::-1]:
        dix.config = modes[name]
        dix._class_graphs = graphs if path == "graphs" else eager
        reset_bm25_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        subs = []
        with Recorded(dix) as rec:
            for w in windows + windows:
                h, d_ = submit_timed(lambda: dix.query_batch_async(w, scorer, top_k=k), "query/dispatch")
                subs.append((h, d_, rec.windows[-1]))
        t_sub = time.perf_counter() - t
        arrays = [h.get_arrays() for h, _d, _c in subs]
        times_[name, path].append(1e3 * (time.perf_counter() - t) / 4)
        hist = pdev.metrics.snapshot()["histograms"]
        log(f"3l (c) {name} {path}: {times_[name, path][-1]:.3f} ms/window (4 windows submitted, "
            f"then drained; submit {1e3 * t_sub / 4:.3f} ms/window); query/dispatch per window "
            f"{', '.join(f'{d_:.3f}' for _h, d_, _c in subs)} ms; host phases (mean ms): " + ", ".join(
                f"{p} {hist[f'query/{p}']['mean_us'] / 1e3:.3f}" for p in HOST_PHASES
                if f"query/{p}" in hist) + f"; launches {bm25_counts()}"
            + (f"; {graph_stats(dix)}" if path == "graphs" else ""))
        if path == "graphs" and len(times_[name, path]) == 1:
            eager_step_check(dix, subs[2][0], subs[2][2], f"3l (c) {name} (a warm window)", scorer)
        want = want or arrays
        for got, ref in zip(arrays, want):
            np.testing.assert_array_equal(got[0], ref[0], err_msg=f"3l (c) {name}: scores differ")
            np.testing.assert_array_equal(got[1], ref[1], err_msg=f"3l (c) {name}: slots differ")
    dix._class_graphs = graphs
    log("3l (c) per-class and per-dispatch windows, class graphs and eager: f32 scores and slots "
        "bit-equal to the composed window; ms/window " + ", ".join(
            f"{m} {p} {', '.join(f'{v:.3f}' for v in t)}" for (m, p), t in times_.items()))

    # (d) K1 against plain on every light class of the first window
    dix.config = on
    d = k1_classes(dix, classes["on"], scorer, k, width=LIGHT_CW, check=True)
    log(f"3l (d) K1 at chunk {LIGHT_CW} on the first window's {d['n']} light classes: max_abs_err "
        f"{d['err']:.3g}, CUDA events {d['ms']:.4f} ms, device {d['dev_ms']:.4f} ms, plain "
        f"{d['plain_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms ({d['bound_by']}); K1 launches at chunk "
        f"{LIGHT_CW} on (a) and (b): {light_launches[0]}")
    dix.config = base
    assert light_launches[0] > 0 and d["n"] > 0
    return light_launches[0], d


def range_window(window):
    """Phase 3's window with every 64th query's first term cut to its first
    four characters (t01234 -> t012: 100 expansions, past the default
    range_min_expansions of 64) and the last three queries replaced by t0,
    t00 and t1 (10,000, 1,000 and 10,000 expansions).  Returns the queries
    and the indices of those with a range term."""
    w = list(window)
    for i in range(0, len(w), 64):
        first, *rest = w[i].split(" ")
        w[i] = " ".join([first[:4], *rest])
    w[-3:] = ["t0", "t00", "t1"]
    return w, sorted(set(range(0, len(w), 64)) | {len(w) - 3, len(w) - 2, len(w) - 1})


# 3r's f64 vectorized host rows of its range queries, by query (3s reuses them).
RANGE_ROWS = {}


def phase_ranges(ix, dix, window, scorer, errs, times):
    """Term-range jobs at full size (phase 3r); adds K5's checks on the
    window's range classes to ``errs`` / ``times``.  The window is served
    cold (class graphs captured), warm, eagerly (``EagerClasses``) and warm
    again.  Returns K5's launches over the three graph runs (the eager run
    is the baseline, not the main path)."""
    import dataclasses

    k = 10
    w, rq = range_window(window)
    packed = []
    real_pack = dix.pack_dispatches

    def pack_spy(n, plan):
        packed.append(real_pack(n, plan))
        return packed[-1]

    reset_bm25_counts()
    dix.pack_dispatches = pack_spy
    graphs = dix._class_graphs
    ms, disp, stats, outs = {}, {}, {}, {}
    try:
        for run in ("cold", "warm", "eager", "warm again"):
            dix._class_graphs = EagerClasses(dix.device) if run == "eager" else graphs
            packed.clear()
            for key in fm.path_calls:
                fm.path_calls[key] = 0
            before = pdev.metrics.snapshot()["counters"]
            k5_before = fm.launches["merge_topk"]
            with Recorded(dix) as rec:
                t = time.perf_counter()
                h, disp[run] = submit_timed(lambda: dix.query_batch_async(w, scorer, top_k=k),
                                            "query/dispatch")
                _s, slots, _keys = h.get_arrays()
                torch.cuda.synchronize()
                ms[run] = 1e3 * (time.perf_counter() - t)
            after = pdev.metrics.snapshot()["counters"]
            stats[run] = {name: int(after.get(name, 0) - before.get(name, 0))
                          for name in ("class_graph_captures", "class_graph_replays")}
            outs[run] = slots
            if run == "eager":
                eager_k5 = fm.launches["merge_topk"] - k5_before
            if run == "warm":
                path_calls = dict(fm.path_calls)
                classes = rec.windows[-1]
                eager_step_check(dix, h, classes, "3r warm window", scorer)
    finally:
        del dix.pack_dispatches
        dix._class_graphs = graphs
    for run, out in outs.items():
        np.testing.assert_array_equal(out, outs["cold"], err_msg=f"3r {run}: rows differ")
    slots = outs["cold"]
    counts = {**fq.launches, **fm.launches}
    ctr = pdev.metrics.snapshot()["counters"]
    routes = {}
    for idxs, _jobs, nc, _nj, rng, _cw in packed[-1]:
        route = "range+K5" if rng else "K1" if nc * dix.CHUNK <= pdev._FUSED_MAX_LANES else "K3+K5"
        r = routes.setdefault(route, [0, 0])
        r[0] += 1
        r[1] += len(idxs)
    # K5's calls of the warm window: one per range class (a full sort of its
    # lanes) and one per class past the fused kernel's lanes (after K3).
    lanes = [key.num_chunks * key.chunk for key, _m, _p in classes
             if key.use_ranges or key.num_chunks * key.chunk > pdev._FUSED_MAX_LANES]
    plan, fallback = dix.plan_batch(w, TOK, scorer)
    range_host = sorted(set(fallback) & set(rq))
    log(f"3r window ({len(w)} queries, {len(rq)} with a range term), ms submit to drained / "
        f"query/dispatch ms: " + ", ".join(f"{run} {ms[run]:.3f} / {disp[run]:.3f}" for run in ms)
        + f" (eager: the same class steps run eagerly); class graphs captured / replayed by run "
        f"{ {run: (v['class_graph_captures'], v['class_graph_replays']) for run, v in stats.items()} }; "
        f"{len(graphs)} keys, pool {graphs.pool_bytes} B ({graphs.pool_bytes / 2**20:.1f} MiB)")
    log(f"3r classes of the warm window by route (dispatches, rows): {routes}; heavy-cache "
        f"hits {int(ctr.get('heavy_cache_hits', 0))}, misses {int(ctr.get('heavy_cache_misses', 0))}; "
        f"host rows {int(ctr.get('device_fallback_queries', 0))} ({len(range_host)} of range queries)")
    log(f"3r launches over the four runs: {counts}; K5's of the eager run {eager_k5} (left out of "
        f"the kernels line)")
    q = np.percentile(lanes, [0, 10, 25, 50, 75, 90, 100]).astype(int).tolist()
    log(f"3r K5 L over the warm window's {len(lanes)} calls: percentiles 0/10/25/50/75/90/100 "
        f"{q}; L <= {fm.TILE_LANES}: {sum(L <= fm.TILE_LANES for L in lanes)}, <= 32768: "
        f"{sum(fm.TILE_LANES < L <= 32768 for L in lanes)}, longer: "
        f"{sum(L > 32768 for L in lanes)}; calls by path {path_calls}")
    assert sum(path_calls.values()) == len(lanes), (path_calls, len(lanes))
    assert plan.has_range[rq].all() and plan.has_range.sum() == len(rq)
    assert not range_host and counts["merge_topk"] > 0 and routes.get("range+K5"), (range_host, counts)
    want = path_calls["block"] + path_calls["radix"] * path_kernels("radix", dix._key_bits)
    ev = profile_windows(lambda i: dix.query_batch_async(w, scorer, top_k=k), n=2)
    k5 = {name: c for name, c in ev.items() if any(x in name for x in K5_KERNELS)}
    got = sum(c for c, _ms in k5.values())
    flag = "" if got == want else "  MISMATCH (the profiler lost launches)"
    log(f"3r K5 kernel launches per warm window: {got:g} under the profiler, {want} by the "
        f"calls by path ({sum(ms_ for _c, ms_ in k5.values()):.3f} ms device; the bitonic "
        f"multi-launch merge it replaced: 538 sort_tile + 1,122 stage + 245 topk_seg + "
        f"doc_total launches){flag}")

    # The range queries as f32 rows, against the f64 vectorized host path.
    sub = [w[i] for i in rq]
    dix.config = dataclasses.replace(ix.config, result_format="f32")
    try:
        s_f, sl_f, k_f = dix.query_batch_async(sub, scorer, top_k=k).get_arrays()
    finally:
        dix.config = ix.config
    np.testing.assert_array_equal(sl_f, slots[rq])
    t = time.perf_counter()
    hits = total = 0
    rel = 0.0
    want_keys, want_rows = [], []
    for j, q in enumerate(sub):
        want = scorer.vectorized_query(ix, q, TOK, top_k=k)
        want_rows.append(want)
        got = [(int(key), float(sc)) for key, sc, sl in zip(k_f[j], s_f[j], sl_f[j]) if sl >= 0]
        assert len(got) == len(want), (q, len(got), len(want))
        want_keys.append({r.key for r in want})
        hits += sum(key in want_keys[-1] for key, _sc in got)
        total += len(want)
        for (_key, sc), r in zip(got, want):
            rel = max(rel, abs(sc - r.score) / max(abs(r.score), 1e-30))
    recall = hits / max(total, 1)
    RANGE_ROWS.update(zip(sub, want_rows))
    log(f"3r recall@{k} of the {len(sub)} range queries against the f64 vectorized host path: "
        f"{recall!r}, max score rel err {rel:.3g} ({time.perf_counter() - t:.1f} s)")
    assert recall >= 0.999 and rel <= RTOL + ATOL, (recall, rel)
    t = time.perf_counter()
    smallest = np.argsort(plan.nchunks[rq], kind="stable")[:16]
    for j in smallest:
        exact = {r.key for r in ix.query(sub[j], bm25.new(), TOK, [1.0], top_k=k)}
        assert exact == want_keys[j], sub[j]
    log(f"3r the 16 smallest range queries against Index.query: equal top-{k} keys "
        f"({time.perf_counter() - t:.1f} s)")

    # K5 against plain on every range class of the warm window, then on the
    # heavy-cache classes of t0, t00 and t1 (each a class of its own).
    aux = dix._aux_rec(scorer)
    ones = torch.ones(1, device="cuda")
    n = 0
    k5 = [0.0, 0.0, 0.0, 0.0]
    for _idxs, jobs_flat, nc, _nj, rng, _cw in packed[-1]:
        if not rng:
            continue
        key, score = pdev.staged_lanes(
            scorer, dix.rec, dix.field_avg, ones, torch.from_numpy(jobs_flat).cuda(), aux,
            chunk=dix.CHUNK, qterm_bits=QB, num_fields=1, num_chunks=nc, use_ranges=True,
        )
        res = check_merge(key, score, min(k, nc * dix.CHUNK), f"3r class nc={nc}", quiet=True,
                          key_bits=dix._key_bits)
        add_merge(errs, times, res)
        k5 = [max(k5[0], res[0])] + [a + b for a, b in zip(k5[1:], res[1:4])]
        n += 1
    log(f"3r K5 on the window's {n} range classes: max_abs_err {k5[0]:.3g}, kernel "
        f"{k5[1]:.4f} ms, plain {k5[2]:.4f} ms, bound {k5[3]:.4f} ms (bytes)")
    for q in ("t0", "t00", "t1"):
        plan_q, _fb = dix.plan_batch([q], TOK, scorer)
        (_i, jobs_flat, nc, _nj, rng, _cw), = dix.pack_dispatches(1, plan_q)
        key, score = pdev.staged_lanes(
            scorer, dix.rec, dix.field_avg, ones, torch.from_numpy(jobs_flat).cuda(), aux,
            chunk=dix.CHUNK, qterm_bits=QB, num_fields=1, num_chunks=nc, use_ranges=rng,
        )
        kq = dix.config.heavy_cache_top_k if plan_q.nchunks[0] >= dix.config.heavy_cache_min_chunks else k
        err = check_merge(key, score, kq, f"3r {q}: range class nc={nc} L={nc * dix.CHUNK} k={kq}",
                          key_bits=dix._key_bits, launches=True)[0]
        errs["merge_topk"] = max(errs["merge_topk"], err)
        del key, score
    return counts["merge_topk"] - eager_k5


# --------------------------------------------------------------------- #
# phase 3s: the doc-sharded engine                                       #
# --------------------------------------------------------------------- #


def with_format(d, fmt):
    """``d`` (a DeviceIndex or ShardedDeviceIndex) with its index's config
    but another result format."""
    d.config = dataclasses.replace(d._index.config, result_format=fmt)
    return d


def shard_chunks(words, chunk):
    """Chunks of per-shard job words int32[n, J, 3], summed over shards."""
    lens = words[:, :, 1].astype(np.int64) & pdev._MAX_JOB_LEN
    return int(np.where(lens > 0, (words[:, :, 0].astype(np.int64) % 128 + lens + chunk - 1) // chunk, 0).sum())


def sharded_plan(sdix, queries, scorer, k):
    """The window's per-shard job words as ``query_batch_async`` packs them
    (the trim applied): (planned, class_specs, buf)."""
    planned, (rows, qp, qids) = (lambda p: (p[:5], p[5]))(
        sdix.plan_batch(queries, TOK, scorer, with_rows=True)[0])
    if sdix.config.prune_blocks and "prune_sh" in qp:
        planned = prune_plan_sharded_cached(sdix, planned, rows, qp, qids, k, [1.0])
    specs, _layout, buf = sdix._pack_window(planned, len(queries))
    return planned, specs, buf


def check_sharded_classes(sdix, queries, scorer, k, errs, label, every=True, phase="3s"):
    """Kernel against plain on the window's classes as the sharded engine
    runs them, at each shard's own key_bits: every class of shard 0 (with
    ``every``) and the widest class of each shard; K1 on the full-phase
    classes, K3 + K5 on the lanes classes, K5 after the staged lanes on
    range classes.
    Folds the largest errors into ``errs``; returns the classes checked by
    kernel."""
    _planned, specs, buf = sharded_plan(sdix, queries, scorer, k)
    Cw = sdix.CHUNK
    checked = {"full": 0, "lanes": 0, "merge_topk": 0}
    offs = np.cumsum([0] + [b_pad * nj * 3 for b_pad, _bo, nj, _nc, _r in specs])
    widest = max(range(len(specs)), key=lambda i: (specs[i][3], not specs[i][4]))
    for s in range(sdix.n_shards):
        rec = sdix.rec[s]
        with torch.cuda.device(rec.device):  # the shard's card: its checks and timings
            ones = torch.ones(1, device=rec.device)
            scalars = torch.cat([sdix._field_avg[rec.device], ones])
            for ci, (b_pad, b_out, nj, nc, rng) in enumerate(specs):
                if (s or not every) and ci != widest:
                    continue
                words = buf[s, 0, offs[ci] : offs[ci + 1]].reshape(b_pad, nj * 3)[:b_out]
                jobs = torch.from_numpy(np.ascontiguousarray(words)).to(rec.device)
                kk = min(k, nc * Cw)
                kb = sdix.key_bits[s]
                name = f"{phase} {label} shard {s} ({rec.device}) class nc={nc} nj={nj} rows={b_out}"
                if rng:
                    key, score = pdev.staged_lanes(
                        scorer, rec, sdix._field_avg[rec.device], ones, jobs, sdix._aux_rec(scorer)[0][s],
                        chunk=Cw, qterm_bits=QB, num_fields=1, num_chunks=nc, use_ranges=True,
                    )
                    res = check_merge(key, score, kk, f"{name} (range)", quiet=True, key_bits=kb)
                    errs["merge_topk"] = max(errs["merge_topk"], res[0])
                    checked["merge_topk"] += 1
                    continue
                tables = pdev.expand_chunks(jobs.reshape(b_out, nj, 3), Cw, nc)
                if nc * Cw <= pdev._FUSED_MAX_LANES:
                    err, ms, plain_ms = check_full(scorer, rec, tables, scalars, kk, name, kb)
                    errs["full"] = max(errs["full"], err)
                    checked["full"] += 1
                else:
                    err, ms, plain_ms = check_lanes(scorer, rec, tables, scalars, kk, name, kb)
                    errs["lanes"] = max(errs["lanes"], err)
                    errs["merge_topk"] = max(errs["merge_topk"], err)
                    checked["lanes"] += 1
                    checked["merge_topk"] += 1
                if s == 0 and ci < 3 or ci == widest:
                    log(f"{name}: ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"key_bits {kb}")
    log(f"{phase} {label}: kernel against plain on {f'the {len(specs)} classes of shard 0 and ' if every else ''}"
        f"the widest class of each shard: {checked} (K1 / K3 + K5 / K5) calls checked, all ok")
    return checked


def sharded_host_phases():
    hist = pdev.metrics.snapshot()["histograms"]
    return ", ".join(
        f"{name.split('/')[1]} {hist[name]['mean_us'] / 1e3:.3f}"
        for name in (f"sharded/{p}" for p in SHARDED_PHASES) if name in hist
    )


def sharded_graph_stats(sdix):
    """The class-graph counters since the last metrics reset, and each
    device's cache of ``sdix``: keys captured so far and its pool's bytes."""
    c = pdev.metrics.snapshot()["counters"]
    per_dev = "; ".join(
        f"{dev}: {len(g)} keys ({g.captures} captures, {g.replays} replays so far), pool "
        f"{g.pool_bytes} B ({g.pool_bytes / 2**20:.1f} MiB)"
        for dev, g in sdix._class_graphs.items()
    )
    return (f"class graphs {int(c.get('class_graph_captures', 0))} captured, "
            f"{int(c.get('class_graph_replays', 0))} replayed; {per_dev}")


class ShardedEager:
    """Within the block, ``sdix`` runs its group steps eagerly
    (``EagerClasses`` for each device of its mesh): the eager baseline."""

    def __init__(self, sdix):
        self.sdix = sdix

    def __enter__(self):
        self.graphs = self.sdix._class_graphs
        self.sdix._class_graphs = {dev: EagerClasses(dev) for dev in self.graphs}
        return self

    def __exit__(self, *exc):
        self.sdix._class_graphs = self.graphs


def sharded_eager_check(sdix, submit, label):
    """One window served (``submit()``) against the eager cells (the
    sharded engine with no caches) called directly on the same words:
    every dispatch's packed rows bit-equal.  The launches of the eager
    step are taken back out."""
    calls = []
    for name in ("_bm25_step", "_z2o_step"):
        real = getattr(sdix, name)

        def spy(*args, _real=real, _name=name):
            rows = _real(*args)
            calls.append((_name, args, rows))
            return rows

        setattr(sdix, name, spy)
    try:
        submit().get_arrays()
    finally:
        del sdix._bm25_step, sdix._z2o_step
    saved = [dict(c) for c in pdev._launch_counters()]
    graphs, sdix._class_graphs = sdix._class_graphs, None
    try:
        for name, args, rows in calls:
            want = getattr(sdix, name)(*args)
            torch.cuda.synchronize()
            assert len(rows) == len(want), (label, name)
            for a, b in zip(rows, want):
                assert torch.equal(a.cpu(), b.cpu()), f"{label}: served rows differ from the eager step"
    finally:
        sdix._class_graphs = graphs
        for counts, was in zip(pdev._launch_counters(), saved):
            counts.clear()
            counts.update(was)
    log(f"{label}: served rows bit-equal to the eager cells on the same words ({len(calls)} "
        f"dispatches, {sum(len(r) for _n, _a, r in calls)} data rows)")


def phase_sharded(ix, dix, windows, zipf, scorer, card, errs):
    """Phase 3s: the doc-sharded engine on 4 doc shards of one card (see the
    module docstring).  Returns the launch counts of its served windows and
    the sharded snapshot."""
    k = 10
    launches = dict.fromkeys(("full", "lanes", "merge_topk"), 0)

    def tally():
        for key in launches:
            launches[key] += bm25_counts()[key]

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t = time.perf_counter()
    mesh = make_mesh(1, 4, devices=["cuda:0"] * 4)
    sdix = ShardedDeviceIndex(ix, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    mem = torch.cuda.memory_allocated() - mem0
    single = dix.rec.untyped_storage().nbytes()
    log(f"3s sharded snapshot on {mesh}: built in {build_s:.3f} s; {mem} B on the card "
        f"({mem / 2**20:.1f} MiB; the single-device rec {single} B, {mem / single:.4f}x); "
        f"local slots {sdix.local_slots}, key_bits per shard {sdix.key_bits}, rec per shard "
        f"{[tuple(r.shape) for r in sdix.rec]}")
    assert sdix.key_bits[0] <= dix._key_bits - 2
    assert list(sdix._class_graphs) == [torch.device("cuda", 0)] and len(sdix._groups[0]) == 1
    t = time.perf_counter()
    pdev.metrics.reset()
    disp = []
    for _ in range(2):  # warm-up: the plan pool, the trim's bounds, the class graphs
        for w in windows:
            h, ms = submit_timed(lambda: sdix.query_batch_async(w, scorer, top_k=k), "sharded/dispatch")
            h.get_arrays()
            disp.append(ms)
    torch.cuda.synchronize()
    log(f"3s warm-up (2 passes): {time.perf_counter() - t:.1f} s; sharded/dispatch per window (ms, "
        f"the first two capture) {', '.join(f'{v:.3f}' for v in disp)}; {sharded_graph_stats(sdix)}")

    turns = []
    ms_turn = {"graphs": [], "eager": []}
    disp_turn = {"graphs": [], "eager": []}
    counts_turn = {}
    for turn, d in (("single-device", dix), ("graphs", sdix), ("eager", sdix), ("eager", sdix),
                    ("graphs", sdix), ("single-device", dix)):
        reset_bm25_counts()
        with (ShardedEager(sdix) if turn == "eager" else contextlib.nullcontext()):
            dt, lat_ms, out = serve_pipelined(
                lambda i, d=d: d.query_batch_async(windows[i % 2], scorer, top_k=k))
        counts = bm25_counts()
        hist = pdev.metrics.snapshot()["histograms"]
        phases = sharded_host_phases() if d is sdix else ", ".join(
            f"{p} {hist[f'query/{p}']['mean_us'] / 1e3:.3f}"
            for p in HOST_PHASES if f"query/{p}" in hist)
        label = turn if d is dix else f"sharded {turn}"
        log(f"3s {label}: 8 windows x {WINDOW} queries on {card}: {1e3 * dt / 8:.3f} ms/window, "
            f"{8 * WINDOW / dt:.1f} QPS, window latency p50 {np.median(lat_ms):.1f} ms; host phases "
            f"(mean ms): {phases}; launches {counts}"
            + (f"; {sharded_graph_stats(sdix)}" if turn == "graphs" else ""))
        if d is sdix:
            assert counts["full"] > 0, counts
            assert counts_turn.setdefault("sharded", counts) == counts, (counts_turn, counts)
            ms_turn[turn].append(1e3 * dt / 8)
            disp_turn[turn].append(hist["sharded/dispatch"]["mean_us"] / 1e3)
            if turn == "graphs":  # the eager turns are the baseline, not the main path
                tally()
        turns.append((turn, out))
    for turn, out in turns[1:5]:
        for i, (_s, slots, keys) in enumerate(out):
            assert slots.shape == (WINDOW, k) and keys.shape == (WINDOW, k)
            np.testing.assert_array_equal(slots, turns[1][1][i % 2][1], err_msg=f"3s {turn}")
    log(f"3s sharded, 8 pipelined windows a turn on {card}: ms/window class graphs "
        f"{', '.join(f'{v:.3f}' for v in ms_turn['graphs'])}, eager "
        f"{', '.join(f'{v:.3f}' for v in ms_turn['eager'])}; sharded/dispatch mean ms graphs "
        f"{', '.join(f'{v:.3f}' for v in disp_turn['graphs'])}, eager "
        f"{', '.join(f'{v:.3f}' for v in disp_turn['eager'])}; slots equal, launch counts equal "
        f"in every turn")
    sharded_eager_check(sdix, lambda: sdix.query_batch_async(windows[0], scorer, top_k=k),
                        "3s window 0")
    t = time.perf_counter()
    for wi, w in enumerate(windows):
        got = with_format(sdix, "f32").query_batch_async(w, scorer, top_k=k).get_arrays()
        want = with_format(dix, "f32").query_batch_async(w, scorer, top_k=k).get_arrays()
        sdix.config = dix.config = ix.config
        err = assert_topk_agree(got[0], got[1], want[0], want[1])
        np.testing.assert_array_equal(got[1], turns[1][1][wi][1])  # slots20 served = f32 slots
        same = float((got[1] == want[1]).mean())
        log(f"3s window {wi} (f32) against the single-device engine: agree by the testing rule, "
            f"max abs err {err:.3g}, slots equal {100 * same:.4f}%; the served slots20 slots equal "
            f"the f32 slots")
    _s, slots, keys = turns[1][1][0]
    recall = bm25_recall(ix, windows[0][:256], slots[:256], keys[:256], k)
    log(f"3s recall@{k} of the sharded rows against the f64 oracle on 256 queries: {recall!r} "
        f"({time.perf_counter() - t:.1f} s)")
    assert recall >= 0.999, recall

    # The head terms: classes past 16,384 lanes a shard (K3 + K5).
    vocab, cdf = zipf
    head = [vocab[i] for i in range(8)] + [f"{vocab[i]} {vocab[i + 8]}" for i in range(8)]
    reset_bm25_counts()
    t = time.perf_counter()
    got = with_format(sdix, "f32").query_batch_async(head, scorer, top_k=k).get_arrays()
    ms = 1e3 * (time.perf_counter() - t)
    counts = bm25_counts()
    tally()
    want = with_format(dix, "f32").query_batch_async(head, scorer, top_k=k).get_arrays()
    sdix.config = dix.config = ix.config
    err = assert_topk_agree(got[0], got[1], want[0], want[1])
    log(f"3s head-term window ({len(head)} queries of the 16 most frequent terms): {ms:.3f} ms "
        f"submit to drained, launches {counts}; agrees with the single-device engine (max abs err "
        f"{err:.3g})")
    assert counts["lanes"] > 0 and counts["merge_topk"] > 0, counts

    # 3r's range window: cold (captures), warm, eager, warm again.
    w, rq = range_window(windows[0])
    reset_bm25_counts()
    runs, outs, counts = {}, {}, {}
    for run in ("cold", "warm", "eager", "warm again"):
        before = bm25_counts()
        with (ShardedEager(sdix) if run == "eager" else contextlib.nullcontext()):
            t = time.perf_counter()
            h, disp_ = submit_timed(lambda: sdix.query_batch_async(w, scorer, top_k=k), "sharded/dispatch")
            outs[run] = h.get_arrays()
            torch.cuda.synchronize()
            runs[run] = (1e3 * (time.perf_counter() - t), disp_)
        counts[run] = {key: n - before[key] for key, n in bm25_counts().items()}
        if run == "cold":
            stats = sharded_graph_stats(sdix)
    for run, out in outs.items():
        for a, b in zip(out, outs["cold"]):
            np.testing.assert_array_equal(a, b, err_msg=f"3s range window {run}: rows differ")
    assert counts["warm"] == counts["eager"] == counts["warm again"], counts
    for run in ("cold", "warm", "warm again"):  # the graph runs, not the eager baseline
        for key in launches:
            launches[key] += counts[run][key]
    planned, fallback = sdix.plan_batch(w, TOK, scorer)
    range_host = sorted(set(fallback) & set(rq))
    log(f"3s range window ({len(w)} queries, {len(rq)} with a range term) ms submit to drained / "
        f"sharded/dispatch ms: " + ", ".join(f"{run} {a:.3f} / {b:.3f}" for run, (a, b) in runs.items())
        + f" (eager: the same group steps run eagerly); host rows {len(fallback)} "
        f"({len(range_host)} of range queries); launches a window {counts['warm']} (equal warm, "
        f"eager, warm again); cold window: {stats}")
    assert planned[4][rq].all() and not range_host and counts["warm"]["merge_topk"] > 0, (
        range_host, counts)
    sharded_eager_check(sdix, lambda: sdix.query_batch_async(w, scorer, top_k=k), "3s range window")
    sub = [w[i] for i in rq]
    s_f, sl_f, k_f = with_format(sdix, "f32").query_batch_async(sub, scorer, top_k=k).get_arrays()
    sdix.config = ix.config
    hits = total = 0
    rel = 0.0
    for j, q in enumerate(sub):
        want = RANGE_ROWS[q]
        got = [(int(key), float(sc)) for key, sc, sl in zip(k_f[j], s_f[j], sl_f[j]) if sl >= 0]
        assert len(got) == len(want), (q, len(got), len(want))
        want_keys = {r.key for r in want}
        hits += sum(key in want_keys for key, _sc in got)
        total += len(want)
        for (_key, sc), r in zip(got, want):
            rel = max(rel, abs(sc - r.score) / max(abs(r.score), 1e-30))
    recall = hits / max(total, 1)
    log(f"3s recall@{k} of the {len(sub)} range queries against 3r's f64 vectorized host rows: "
        f"{recall!r}, max score rel err {rel:.3g}")
    assert recall >= 0.999 and rel <= RTOL + ATOL, (recall, rel)

    # 3p's single mix, the trim on and off (one snapshot, a per-call toggle).
    q = prune_mixes(vocab, cdf)["single"]
    cfg = ix.config
    try:
        planned = sdix.plan_batch(q, TOK, scorer)[0]
        before = shard_chunks(planned[1], sdix.CHUNK)
        trimmed_plan, _specs, _buf = sharded_plan(sdix, q, scorer, k)
        after = shard_chunks(trimmed_plan[1], sdix.CHUNK)
        ms = {True: [], False: []}
        out = {}
        for on in (True, False, True, False, True, False):
            cfg.prune_blocks = on
            reset_bm25_counts()
            w_ms, lat, arrays = serve_queued(sdix, q, scorer, k, n=2)
            tally()
            ms[on].append(w_ms)
            if on in out:
                np.testing.assert_array_equal(arrays[1], out[on][1])
            out[on] = arrays
        np.testing.assert_array_equal(out[True][1], out[False][1])
        np.testing.assert_array_equal(out[True][2], out[False][2])
    finally:
        cfg.prune_blocks = True
    log(f"3s single mix: chunks trimmed a window {before - after} of {before} over the 4 shards "
        f"({100 * (before - after) / before:.2f}%); slots bit-equal on / off; ms/window on "
        f"{', '.join(f'{v:.3f}' for v in ms[True])} (the first cold), off "
        f"{', '.join(f'{v:.3f}' for v in ms[False])} (2 queued windows a turn, host clock)")
    assert before >= after

    for label, queries, every in (("window 0", windows[0], True), ("head-term window", head, True),
                                  ("range window", w, False)):
        check_sharded_classes(sdix, queries, scorer, k, errs, label, every)

    reset_bm25_counts()
    log("3s one sharded window (class graphs), profiled:")
    ev_s = profile_windows(lambda i: sdix.query_batch_async(windows[i % 2], scorer, top_k=k), n=2)
    log("3s one sharded window (eager), profiled:")
    with ShardedEager(sdix):
        ev_e = profile_windows(lambda i: sdix.query_batch_async(windows[i % 2], scorer, top_k=k), n=2)
    log("3s one single-device window (class graphs), profiled:")
    ev_d = profile_windows(lambda i: dix.query_batch_async(windows[i % 2], scorer, top_k=k), n=2)
    log(f"3s device busy a window: sharded class graphs {sum(ms_ for _c, ms_ in ev_s.values()):.3f} "
        f"ms, sharded eager {sum(ms_ for _c, ms_ in ev_e.values()):.3f} ms, single-device "
        f"{sum(ms_ for _c, ms_ in ev_d.values()):.3f} ms; {sharded_graph_stats(sdix)}")

    log(f"3s launches over its served windows: {launches}")
    return launches, sdix


# --------------------------------------------------------------------- #
# zero-to-one                                                            #
# --------------------------------------------------------------------- #


def serve_pipelined(submit, n=8):
    """``n`` windows through ``submit(i)`` with a depth-4 pipeline, drained
    in pairs one pair late.  Returns (seconds, [latency ms], [arrays])."""
    lat_ms, out = [], []

    def drain_pair(pair):
        for t_submit, h in pair:
            out.append(h.get_arrays())
            lat_ms.append(1e3 * (time.perf_counter() - t_submit))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        futs, pending = [], []
        for i in range(n):
            pending.append((time.perf_counter(), submit(i)))
            if len(pending) == 2:
                futs.append(pool.submit(drain_pair, pending))
                pending = []
            while len(futs) >= 2:
                futs.pop(0).result()
        for f in futs:
            f.result()
    sync_cards()
    return time.perf_counter() - t0, lat_ms, out


def z2o_window_classes(dix, queries, k):
    """Per class of the z2o window ``queries``: (spec, route, jobs, qlen) on
    the card, as ``z2o_query_batch_async`` packs them."""
    _host, specs, _layout, word_parts, qlen_parts = pz.plan_window(dix, queries, TOK, k)
    fused_ok = dix.num_slots < (1 << 26)
    for spec, words, qlen in zip(specs, word_parts, qlen_parts):
        b_pad, b_out, nj, nc, fast = spec
        if not fast:
            route = "z2o_lockstep"
        elif pz.fused_route(nc, dix.CHUNK, dix.num_fields, fused_ok):
            route = "fused_z2o"
        else:
            route = "z2o_staged"
        jobs = torch.from_numpy(words).cuda().reshape(b_pad, nj, 4)[:b_out]
        yield spec, route, jobs, torch.from_numpy(qlen).cuda()[:b_out]


def check_z2o_window(dix, queries, k):
    """Every K4 class of a real window held kernel against plain on its
    tables.  Returns (largest error, kernel ms, plain ms, bound ms, bound_by)
    summed over those classes."""
    err_max, tot = 0.0, [0.0, 0.0, 0.0, "bytes"]
    dev_tot = 0.0
    F, Cw = dix.num_fields, dix.CHUNK
    for (b_pad, b_out, nj, nc, _fast), route, jobs, qlen in z2o_window_classes(dix, queries, k):
        label = f"z2o window class nc={nc} nj={nj} rows={b_out}/{b_pad}"
        if route != "fused_z2o":
            log(f"{label}: route {route} (torch program, no kernel)")
            continue
        c_start, c_skip, c_len, c_qterm, c_rank, c_score = pz.expand_chunks_z2o(jobs, Cw, nc)
        args = (dix.rec, c_start, c_skip, c_len, c_qterm, c_score, c_rank, qlen)
        kk = min(k, nc * Cw)
        err, ms, plain_ms, dev_ms = check_z2o(args, Cw, kk, F, label,
                                               fm.key_bits_for(dix.num_slots, fz.DOC_SHIFT))
        bound_ms, by = z2o_bound(args, kk, F)
        err_max = max(err_max, err)
        tot[0] += ms
        tot[1] += plain_ms
        tot[2] += bound_ms
        tot[3] = by
        dev_tot += dev_ms
        log(f"{label}: route fused_z2o, ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
    log(f"K4 over the window's classes: {tot[0]:.4f} ms CUDA events, {dev_tot:.4f} ms device "
        f"(CUDA graph replay, L2 cold), bound {tot[2]:.4f} ms")
    return err_max, tot


def z2o_oracle_check(ix, queries, scores, slots, keys, k):
    """Device rows of a z2o window against the f64 oracle ``Index.query``.

    Every returned key must carry its oracle score (relative error printed,
    bounded by the tolerance) and the rows must be as long as the oracle's.
    recall@k counts the oracle's top-k keys found; "tie-aware" also counts a
    returned key whose oracle score equals the oracle's k-th (a tie cut by
    the top-k boundary, where the oracle orders by slot in f64 and the
    device by slot in f32).  Returns (recall, tie-aware recall, max rel err)."""
    hits = hits_tie = total = 0
    rel = 0.0
    F = ix.num_fields
    for qi, q in enumerate(queries):
        full = ix.query(q, zero_to_one.new(), TOK, [1.0] * F)
        top = full[:k]
        oracle = {r.key: r.score for r in full}
        kth = top[-1].score if top else 0.0
        got = [(int(x), sl) for x, sl in zip(keys[qi], slots[qi]) if sl >= 0]
        assert len(got) == len(top), (q, len(got), len(top))
        top_keys = {r.key for r in top}
        for j, (key, _sl) in enumerate(got):
            assert key in oracle, (q, key)
            if scores is not None:
                rel = max(rel, abs(float(scores[qi, j]) - oracle[key]) / max(abs(oracle[key]), 1e-30))
            hits += key in top_keys
            hits_tie += key in top_keys or abs(oracle[key] - kth) <= ATOL + RTOL * abs(kth)
        total += len(top)
    assert rel <= RTOL + ATOL, rel
    return hits / max(total, 1), hits_tie / max(total, 1), rel


def z2o_50k():
    """The corpus and queries of benchmarks/zero_to_one_50k.py, drawn in the
    same order from the same seed (its 16,384-query window is the first of
    the two windows here)."""
    n_docs = 50_000
    rng = np.random.default_rng(7)
    vocab = np.array(["w%04d" % i for i in range(4000)])
    weights = 1.0 / np.arange(1, len(vocab) + 1) ** 1.05
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]

    def texts(n, length):
        ids = np.searchsorted(cdf, rng.random((n, length)))
        return [" ".join(row) for row in vocab[np.minimum(ids, len(vocab) - 1)]]

    titles = texts(n_docs, 3)
    bodies = texts(n_docs, 8)
    lo = cdf[49]  # the top 50 ranks excluded
    qids = np.searchsorted(cdf, lo + rng.random((2 * WINDOW, 2)) * (1.0 - lo))
    queries = [" ".join(row) for row in vocab[np.minimum(qids, len(vocab) - 1)]]
    return list(range(n_docs)), [titles, bodies], [queries[:WINDOW], queries[WINDOW:]]


def z2o_host_phases(label):
    hist = pdev.metrics.snapshot()["histograms"]
    log(f"{label}: " + ", ".join(
        f"{name} {hist[name]['mean_us'] / 1e3:.3f}"
        for name in ("z2o/plan", "z2o/pack", "z2o/h2d", "z2o/dispatch", "query/fetch", "query/drain")
        if name in hist
    ))


def reset_z2o_counts():
    for counts in (fz.launches, pz.launches):
        for key in counts:
            counts[key] = 0
    for counts in CARD_COUNTS:
        counts.clear()
    pdev.metrics.reset()


def z2o_counts():
    c = pdev.metrics.snapshot()["counters"]
    host = int(c.get("device_fallback_queries", 0) + c.get("z2o_host_vectorized_queries", 0))
    return {**fz.launches, **pz.launches, "host_rows": host}


def phase_z2o_1m(ix, dix, window):
    """One z2o window over the 1M-doc bench corpus (phase 3's index)."""
    k = 10
    for (b_pad, b_out, nj, nc, _fast), route, _jobs, _ql in z2o_window_classes(dix, window, k):
        log(f"1M z2o class nc={nc:5d} nj={nj:4d} rows={b_out:6d}/{b_pad:6d} route={route}")
    reset_z2o_counts()
    graphs = dix._class_graphs
    runs, outs = {}, {}
    try:
        for run in ("cold", "warm", "eager", "warm again"):
            dix._class_graphs = EagerClasses(dix.device) if run == "eager" else graphs
            with Recorded(dix) as rec:
                t = time.perf_counter()
                h, disp = submit_timed(lambda: pz.z2o_query_batch_async(dix, window, TOK, k, fmt="f32"),
                                       "z2o/dispatch")
                outs[run] = h.get_arrays()
                torch.cuda.synchronize()
                runs[run] = (1e3 * (time.perf_counter() - t), disp)
            if run == "cold":
                counts, stats = z2o_counts(), graph_stats(dix)
            if run == "warm":
                eager_step_check(dix, h, rec.windows[-1], "1M z2o warm window")
    finally:
        dix._class_graphs = graphs
    for run, out in outs.items():
        for a, b in zip(out, outs["cold"]):
            np.testing.assert_array_equal(a, b, err_msg=f"1M z2o {run}: rows differ")
    scores, slots, keys = outs["cold"]
    log(f"1M z2o window ({WINDOW} queries) ms submit to drained / z2o/dispatch ms: "
        + ", ".join(f"{run} {ms_:.3f} / {d_:.3f}" for run, (ms_, d_) in runs.items())
        + f" (eager: the same class steps run eagerly); cold window launches {counts}; {stats}")
    t = time.perf_counter()
    recall, recall_tie, rel = z2o_oracle_check(ix, window[:64], scores, slots, keys, k)
    log(f"1M z2o window against the f64 oracle on 64 queries: recall@{k} {recall!r} "
        f"(tie-aware {recall_tie!r}), max score rel err {rel:.3g} ({time.perf_counter() - t:.1f} s)")
    assert recall_tie >= 0.999, recall_tie


def phase_z2o_main(card):
    t0 = time.time()
    keys, cols, windows = z2o_50k()
    ix = Index(2)  # on the card (the default device)
    ix.add_documents_columnar(keys, cols)
    dix = ix.device_index()
    torch.cuda.synchronize()
    log(f"z2o 50k: corpus + index build + upload {time.time() - t0:.1f} s "
        f"({dix.num_postings} postings, rec {tuple(dix.rec.shape)})")
    k = 10

    def submit(i):
        return pz.z2o_query_batch_async(dix, windows[i % 2], TOK, k, fmt="slots")

    t1 = time.time()
    pdev.metrics.reset()
    disp = []
    for i in range(4):  # warm-up: plan pools, first launches, class graphs
        h, ms = submit_timed(lambda: submit(i), "z2o/dispatch")
        h.get_arrays()
        disp.append(ms)
    torch.cuda.synchronize()
    log(f"z2o warm-up (2 passes): {time.time() - t1:.1f} s; z2o/dispatch per window (ms, the first "
        f"two capture) {', '.join(f'{v:.3f}' for v in disp)}; {graph_stats(dix)}")
    for (b_pad, b_out, nj, nc, _fast), route, _jobs, _ql in z2o_window_classes(dix, windows[0], k):
        log(f"z2o class nc={nc:3d} nj={nj:3d} rows={b_out:6d}/{b_pad:6d} route={route}")

    reset_z2o_counts()
    dt, lat_ms, out = serve_pipelined(submit)
    counts = z2o_counts()
    log(f"z2o launch counts over the 8 served windows: {counts}")
    assert counts["fused_z2o"] > 0, counts
    for i, (s_, slots, keys_) in enumerate(out):
        assert s_ is None and slots.shape == (WINDOW, k) and keys_.shape == (WINDOW, k)
        assert (slots >= -1).all() and (slots < dix.num_slots).all()
        np.testing.assert_array_equal(slots, out[i % 2][1])
    log(f"z2o served 8 windows x {WINDOW} queries on {card}: {1e3 * dt / 8:.3f} ms/window, "
        f"{8 * WINDOW / dt:.1f} QPS; window latency p50 {np.median(lat_ms):.1f} ms "
        f"(host clock, pipeline of 4; for information only); {graph_stats(dix)}")
    z2o_host_phases("z2o host phases per window (mean ms, host clock)")
    profile_windows(submit)
    with Recorded(dix) as rec:
        h = submit(0)
        h.get_arrays()
    eager_step_check(dix, h, rec.windows[-1], "z2o 50k window")
    # The class graphs against the same class steps run eagerly, in turns.
    graphs, eager = dix._class_graphs, EagerClasses(dix.device)
    turns = {"graphs": [], "eager": []}
    try:
        for path in ("eager", "graphs", "graphs", "eager"):
            dix._class_graphs = graphs if path == "graphs" else eager
            reset_z2o_counts()
            dt_, lat_, out_ = serve_pipelined(submit)
            turns[path].append(1e3 * dt_ / 8)
            for i, (_s, sl, _k) in enumerate(out_):
                np.testing.assert_array_equal(sl, out[i][1], err_msg=f"z2o {path}: rows differ")
            z2o_host_phases(f"z2o {path} turn: {1e3 * dt_ / 8:.3f} ms/window, p50 "
                            f"{np.median(lat_):.1f} ms; host phases (mean ms)")
    finally:
        dix._class_graphs = graphs
    log(f"z2o 8 pipelined windows a turn on {card}, ms/window: class graphs "
        f"{', '.join(f'{v:.3f}' for v in turns['graphs'])}, eager "
        f"{', '.join(f'{v:.3f}' for v in turns['eager'])}; rows equal")

    sample = windows[0][:256]
    scores, slots, keys_ = pz.z2o_query_batch_async(dix, sample, TOK, k, fmt="f32").get_arrays()
    recall, recall_tie, rel = z2o_oracle_check(ix, sample, scores, slots, keys_, k)
    log(f"z2o recall@{k} against the f64 oracle on {len(sample)} queries: {recall!r} "
        f"(tie-aware {recall_tie!r}); max score rel err {rel:.3g}")
    assert recall_tie >= 0.999, recall_tie
    err, tot = check_z2o_window(dix, windows[0], k)
    return counts, err, tot, (ix, dix, windows)


def phase_sharded_z2o(ix, dix, windows, card):
    """Phase 4s: zero-to-one 50k on the doc-sharded engine, mesh (2, 2) on
    one card (see the module docstring).  Returns (K4's launches, largest
    error, the sharded snapshot)."""
    k = 10
    t = time.perf_counter()
    sz = ShardedDeviceIndex(ix, make_mesh(2, 2, devices=["cuda:0"] * 4))
    torch.cuda.synchronize()
    log(f"4s sharded z2o snapshot on {sz.mesh}: {time.perf_counter() - t:.3f} s; local slots "
        f"{sz.local_slots}, K4 key_bits per shard {sz.z2o_key_bits}")
    with_format(sz, "slots")
    pdev.metrics.reset()
    disp = []
    for _ in range(2):  # warm-up: first launches, the class graphs
        for w in windows:
            h, ms = submit_timed(lambda: sz.query_batch_z2o(w, top_k=k), "sharded/dispatch")
            h.get_arrays()
            disp.append(ms)
    torch.cuda.synchronize()
    log(f"4s warm-up (2 passes): sharded/dispatch per window (ms, the first two capture) "
        f"{', '.join(f'{v:.3f}' for v in disp)}; {sharded_graph_stats(sz)}")
    reset_z2o_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    handles = [(time.perf_counter(), sz.query_batch_z2o(w, top_k=k)) for w in windows]
    out, lat = [], []
    for t_submit, h in handles:
        out.append(h.get_arrays())
        lat.append(1e3 * (time.perf_counter() - t_submit))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = z2o_counts()
    log(f"4s z2o 2 windows x {WINDOW} queries on {card}, mesh (2, 2): {1e3 * dt / 2:.3f} ms/window, "
        f"latency {', '.join(f'{v:.1f}' for v in lat)} ms (queued, host clock); host phases (mean "
        f"ms): {sharded_host_phases()}; launches {counts}")
    assert counts["fused_z2o"] > 0 and counts["host_rows"] == 0, counts
    # Class graphs against the same group steps run eagerly, in turns.
    turns = {"graphs": [], "eager": []}
    disp_turn = {"graphs": [], "eager": []}
    for path in ("graphs", "eager", "eager", "graphs"):
        reset_z2o_counts()
        with (ShardedEager(sz) if path == "eager" else contextlib.nullcontext()):
            dt_, lat_, out_ = serve_pipelined(lambda i: sz.query_batch_z2o(windows[i % 2], top_k=k))
        moved = z2o_counts()
        assert moved == {key: 4 * n for key, n in counts.items()}, (path, moved, counts)  # 4x each
        for i, (_s, sl, _k) in enumerate(out_):
            np.testing.assert_array_equal(sl, out[i % 2][1], err_msg=f"4s {path}: rows differ")
        turns[path].append(1e3 * dt_ / 8)
        disp_turn[path].append(pdev.metrics.snapshot()["histograms"]["sharded/dispatch"]["mean_us"] / 1e3)
        log(f"4s {path} turn: {1e3 * dt_ / 8:.3f} ms/window, p50 {np.median(lat_):.1f} ms; host phases "
            f"(mean ms): {sharded_host_phases()}; launches {moved}")
    log(f"4s 8 pipelined windows a turn on {card}, ms/window: class graphs "
        f"{', '.join(f'{v:.3f}' for v in turns['graphs'])}, eager "
        f"{', '.join(f'{v:.3f}' for v in turns['eager'])}; sharded/dispatch mean ms graphs "
        f"{', '.join(f'{v:.3f}' for v in disp_turn['graphs'])}, eager "
        f"{', '.join(f'{v:.3f}' for v in disp_turn['eager'])}; rows and launch counts equal; "
        f"{sharded_graph_stats(sz)}")
    sharded_eager_check(sz, lambda: sz.query_batch_z2o(windows[0], top_k=k), "4s window 0")
    # The sharded z2o planner (not pooled, as JAX's) alone, with Python's
    # cyclic garbage collector on and off.
    plan_ms = {"on": [], "off": []}
    try:
        for state in ("on", "off", "on", "off"):
            (gc.enable if state == "on" else gc.disable)()
            for w in windows:
                t = time.perf_counter()
                sz.plan_batch_z2o(w, TOK)
                plan_ms[state].append(1e3 * (time.perf_counter() - t))
    finally:
        gc.enable()
    log(f"4s plan_batch_z2o alone, ms a window (host clock; {len(gc.get_objects())} objects "
        f"tracked by the collector): collector on "
        f"{', '.join(f'{v:.3f}' for v in plan_ms['on'])}; off "
        f"{', '.join(f'{v:.3f}' for v in plan_ms['off'])}")
    log("4s one sharded z2o window (class graphs), profiled:")
    ev_g = profile_windows(lambda i: sz.query_batch_z2o(windows[i % 2], top_k=k), n=2)
    log("4s one sharded z2o window (eager), profiled:")
    with ShardedEager(sz):
        ev_e = profile_windows(lambda i: sz.query_batch_z2o(windows[i % 2], top_k=k), n=2)
    log(f"4s device busy a window: class graphs {sum(ms_ for _c, ms_ in ev_g.values()):.3f} ms, "
        f"eager {sum(ms_ for _c, ms_ in ev_e.values()):.3f} ms")
    for w, (_s, slots, _keys) in zip(windows, out):
        want = pz.z2o_query_batch_async(dix, w, TOK, k, fmt="slots").get_arrays()
        log(f"4s window slots equal to the single-device engine's: "
            f"{100 * float((slots == want[1]).mean()):.4f}%")
    sample = windows[0][:256]
    scores, slots, keys = with_format(sz, "f32").query_batch_z2o(sample, top_k=k).get_arrays()
    want = pz.z2o_query_batch_async(dix, sample, TOK, k, fmt="f32").get_arrays()
    assert_topk_agree(scores, slots, want[0], want[1])
    recall, recall_tie, rel = z2o_oracle_check(ix, sample, scores, slots, keys, k)
    log(f"4s recall@{k} against the f64 oracle on {len(sample)} queries: {recall!r} (tie-aware "
        f"{recall_tie!r}), max score rel err {rel:.3g}; agrees with the single-device engine")
    assert recall_tie >= 0.999, recall_tie

    # K4 against plain on every K4 class of shard 0 (data row 0).
    jquery, words, qlen, max_chunks, njobs, _fb, _lock = sz.plan_batch_z2o(windows[0], TOK)
    specs, _layout, buf, qcat = sz._pack_z2o(len(windows[0]), jquery, words, max_chunks, njobs, qlen)
    err_max, n = 0.0, 0
    off = qoff = 0
    F, Cw = sz.num_fields, sz.CHUNK
    for b_pad, b_out, nj, nc in specs:
        w4 = buf[0, 0, off : off + b_pad * nj * 4].reshape(b_pad, nj, 4)[:b_out]
        ql = torch.from_numpy(np.ascontiguousarray(qcat[0, qoff : qoff + b_out])).cuda()
        off += b_pad * nj * 4
        qoff += b_pad
        if not pz.fused_route(nc, Cw, F, sz.local_slots < (1 << 26)):
            continue
        jobs = torch.from_numpy(np.ascontiguousarray(w4)).cuda()
        c_start, c_skip, c_len, c_qterm, c_rank, c_score = pz.expand_chunks_z2o(jobs, Cw, nc)
        args = (sz.rec[0], c_start, c_skip, c_len, c_qterm, c_score, c_rank, ql)
        label = f"4s shard 0 z2o class nc={nc} nj={nj} rows={b_out}/{b_pad}"
        err, ms, plain_ms, dev_ms = check_z2o(args, Cw, min(k, nc * Cw), F, label, sz.z2o_key_bits[0])
        err_max = max(err_max, err)
        n += 1
        log(f"{label}: ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, key_bits {sz.z2o_key_bits[0]}")
    assert n > 0
    return counts["fused_z2o"], err_max, sz


# --------------------------------------------------------------------- #
# phases 3m, 4m: the doc-sharded engine over distinct cards              #
# --------------------------------------------------------------------- #


def card_launches():
    """K1 / K3, K5 and K4 launches per card since the last reset:
    {card index: {kernel: n}}."""
    out = {}
    for counts in CARD_COUNTS:
        for key, n in counts.items():
            name, index = key.split("@cuda:")
            out.setdefault(int(index), {})[name] = n
    return out


def per_shard(counts, n):
    """One card's launch counts (``card_launches``) over ``n`` shards on
    it: each shard runs every class, so each count splits evenly."""
    assert all(v % n == 0 for v in counts.values()), counts
    return {key: v // n for key, v in counts.items()}


def cards_in_use(n):
    """The first ``n`` cards, their names and the pairs' peer access."""
    cards = [torch.device("cuda", i) for i in range(n)]
    peer = [[int(i == j or torch.cuda.can_device_access_peer(i, j)) for j in range(n)]
            for i in range(n)]
    names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
    return cards, f"{n} cards ({', '.join(names)}), peer access by pair {peer}"


def build_on_cards(ix, mesh, cards, label):
    """A ShardedDeviceIndex over ``mesh``: its build seconds and the bytes
    it allocated on each card."""
    sync_cards()
    mem0 = [torch.cuda.memory_allocated(c) for c in cards]
    t = time.perf_counter()
    sdix = ShardedDeviceIndex(ix, mesh)
    sync_cards()
    build_s = time.perf_counter() - t
    mem = [torch.cuda.memory_allocated(c) - m for c, m in zip(cards, mem0)]
    log(f"{label} sharded snapshot on {mesh}: built in {build_s:.3f} s; bytes on each card "
        f"{mem} ({', '.join(f'{m / 2**20:.1f}' for m in mem)} MiB)")
    assert list(sdix._class_graphs) == cards
    assert all(len(shards) == 1 for row in sdix._groups for _dev, shards in row)
    return sdix


def warm_up(sdix, submit, label):
    """Two passes of the windows (``submit(i)``, i < 4) on ``sdix``:
    sharded/dispatch per window, the first two capturing."""
    pdev.metrics.reset()
    disp = []
    t = time.perf_counter()
    for i in range(4):
        h, ms = submit_timed(lambda: submit(i), "sharded/dispatch")
        h.get_arrays()
        disp.append(ms)
    sync_cards()
    log(f"{label} warm-up (2 passes): {time.perf_counter() - t:.1f} s; sharded/dispatch per window "
        f"(ms, the first two capture) {', '.join(f'{v:.3f}' for v in disp)}; {sharded_graph_stats(sdix)}")


def serve_turns(one, cards, submit, reset, counts_of, label, card):
    """8 pipelined windows a turn (``submit(d, i)``) on the one-card
    engine ``one``, the engine over distinct cards, again, and ``one``:
    ms/window, p50, host phases, launches, launches per card (each card's
    equal to the one-card engine's per shard), slots equal to the first
    turn's in every turn.  Returns the first over-cards turn's arrays."""
    n = one.n_shards * int(one.mesh.shape["data"])
    ms_turn = {"one card": [], "cards": []}
    disp_turn = {"one card": [], "cards": []}
    ref = first = per_cell = total = None
    for turn, d in (("one card", one), ("cards", cards), ("cards", cards), ("one card", one)):
        reset()
        dt, lat_ms, out = serve_pipelined(lambda i, d=d: submit(d, i))
        counts, by_card = counts_of(), card_launches()
        hist = pdev.metrics.snapshot()["histograms"]
        ms_turn[turn].append(1e3 * dt / 8)
        disp_turn[turn].append(hist["sharded/dispatch"]["mean_us"] / 1e3)
        log(f"{label} {turn} ({d.mesh}): 8 windows x {WINDOW} queries on {card}: {1e3 * dt / 8:.3f} "
            f"ms/window, {8 * WINDOW / dt:.1f} QPS, window latency p50 {np.median(lat_ms):.1f} ms; "
            f"host phases (mean ms): {sharded_host_phases()}; launches {counts}; per card {by_card}")
        assert total in (None, counts), (total, counts)
        total = counts
        if turn == "one card":
            cell = per_shard(by_card[0], n)
            assert per_cell in (None, cell), (per_cell, cell)
            per_cell = cell
        else:
            assert by_card == dict.fromkeys(range(n), per_cell), (by_card, per_cell)
            first = first or out
        ref = ref or out
        for i, arrays in enumerate(out):
            np.testing.assert_array_equal(arrays[1], ref[i % 2][1], err_msg=f"{label} {turn}")
    log(f"{label} 8 pipelined windows a turn on {card}: ms/window one card "
        f"{', '.join(f'{v:.3f}' for v in ms_turn['one card'])}, {n} cards "
        f"{', '.join(f'{v:.3f}' for v in ms_turn['cards'])}; sharded/dispatch mean ms one card "
        f"{', '.join(f'{v:.3f}' for v in disp_turn['one card'])}, {n} cards "
        f"{', '.join(f'{v:.3f}' for v in disp_turn['cards'])}; slots equal, launches equal, each "
        f"card's launches those of a shard of the one-card engine {per_cell}")
    return first


def gather_times(sdix, submit, reps=5):
    """One window (``submit()``) with each data row's gather and merge
    timed alone, ``reps`` times on the same rows with Python's collector
    off (a collection stalls the host between the events): every card
    synchronised first, then CUDA events on the row's first card around
    the copies of the other cards' rows (made apart, for their time) and
    around the gather and merge itself.  Returns [(bytes from other cards,
    median copy ms, median gather + merge ms)], a row of each dispatch."""
    real = sdix._gather_merge
    out = []

    def timed(d, parts, k, fmt):
        dev0 = sdix.mesh.devices[d, 0]
        remote = [t for s, pair in enumerate(parts) if sdix.mesh.devices[d, s] != dev0 for t in pair]
        copy_ms, ms = [], []
        with torch.cuda.device(dev0):
            for _ in range(reps):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                sync_cards()
                ev[0].record()
                copies = [t.to(dev0, non_blocking=True) for t in remote]
                ev[1].record()
                sync_cards()
                ev[2].record()
                rows = real(d, parts, k, fmt)
                ev[3].record()
                sync_cards()
                del copies
                copy_ms.append(ev[0].elapsed_time(ev[1]))
                ms.append(ev[2].elapsed_time(ev[3]))
        nbytes = sum(t.numel() * t.element_size() for t in remote)
        out.append((nbytes, float(np.median(copy_ms)), float(np.median(ms))))
        return rows

    sdix._gather_merge = timed
    gc.disable()
    try:
        submit().get_arrays()
    finally:
        gc.enable()
        del sdix._gather_merge
    return out


def log_gather(label, times_cards, times_one):
    for (nbytes, copy_ms, ms), (_b, _c, ms1) in zip(times_cards, times_one):
        log(f"{label} gather of one row: {nbytes} B from the other cards copied in {copy_ms:.4f} ms "
            f"({nbytes / max(copy_ms, 1e-6) / 1e6:.1f} GB/s), gather + merge {ms:.4f} ms; one card: "
            f"gather + merge {ms1:.4f} ms (CUDA events on the row's first card, medians of 5)")


def peer_rates(cards, nbytes=256 << 20):
    """GB/s of one ``nbytes`` copy from each other card to ``cards[0]``
    through ``Tensor.to`` (the gather's copy), median of 3: a peer copy
    over NVLink runs at hundreds of GB/s, one staged through the host at
    tens."""
    rates = []
    dst = cards[0]
    for src in cards[1:]:
        x = torch.empty(nbytes // 4, dtype=torch.int32, device=src)
        times = []
        with torch.cuda.device(dst):
            for _ in range(4):
                sync_cards()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                y = x.to(dst, non_blocking=True)
                b.record()
                sync_cards()
                times.append(a.elapsed_time(b))
                del y
        rates.append(nbytes / float(np.median(times[1:])) / 1e6)
        del x
    return rates


def same_rows(one, cards, fmt, submit, label):
    """One window in ``fmt`` (``submit(d)``) on both engines: arrays and
    every dispatch's packed rows bit-equal.  Returns the arrays."""
    hs = [submit(with_format(d, fmt)) for d in (one, cards)]
    a1, a4 = (h.get_arrays() for h in hs)
    for x, y in zip(a1, a4):
        if x is None:
            assert y is None
            continue
        np.testing.assert_array_equal(x, y, err_msg=f"{label} ({fmt})")
    n = 0
    for rows1, rows4 in zip(hs[0]._packed, hs[1]._packed):
        for d, (p1, p4) in enumerate(zip(rows1, rows4)):
            assert p4.device == cards.mesh.devices[d, 0], (p4.device, d)
            assert torch.equal(p1.cpu(), p4.cpu()), f"{label} ({fmt}): packed rows differ"
            n += 1
    log(f"{label} ({fmt}): arrays and the {n} packed row tensors bit-equal to the one-card engine's")
    return a4


def busy_per_card(label, submits):
    """Device busy a window per card (torch.profiler, by device index) of
    each engine's window (``submits``: {name: submit(i)})."""
    parts = []
    for name, submit in submits.items():
        per_card = {}
        log(f"{label} one window ({name}), profiled:")
        profile_windows(submit, n=2, per_card=per_card)
        parts.append(f"{name}: " + ", ".join(f"cuda:{i} {ms:.3f}" for i, ms in sorted(per_card.items())))
    log(f"{label} device busy a window per card (ms): {'; '.join(parts)}")


def phase_cards(ix, gix, one, windows, zipf, scorer, card, errs):
    """Phase 3m: phase 3's index over distinct cards (see the module
    docstring).  Mutates ``ix`` at its end: run it after every phase that
    reads phase 3's index.  Returns the engine over the cards after the
    mutation (None with one card)."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"3m phase 3's index over distinct cards: not run ({n_cards} card visible)")
        return None
    n = min(n_cards, 4)
    k = 10
    cards, desc = cards_in_use(n)
    log(f"3m {n_cards} cards visible; make_mesh(1, {n}) over {desc}")
    if one.n_shards != n:
        one = ShardedDeviceIndex(ix, make_mesh(1, n, devices=["cuda:0"] * n))
    rates = peer_rates(cards)
    log(f"3m a 256 MiB copy to cuda:0 through Tensor.to (the gather's copy) from "
        + ", ".join(f"{c}: {r:.1f} GB/s" for c, r in zip(cards[1:], rates)) + " (medians of 3)")
    sm = build_on_cards(ix, make_mesh(1, n), cards, "3m")
    assert sm.key_bits == one.key_bits and torch.cuda.current_device() == 0

    def submit(d, i):
        return d.query_batch_async(windows[i % 2], scorer, top_k=k)

    warm_up(sm, lambda i: submit(sm, i), "3m")
    out = serve_turns(one, sm, submit, reset_bm25_counts, bm25_counts, "3m", card)
    log_gather("3m", gather_times(sm, lambda: submit(sm, 0)), gather_times(one, lambda: submit(one, 0)))
    q = lambda d, w: d.query_batch_async(w, scorer, top_k=k)  # noqa: E731
    for wi, w in enumerate(windows):
        for fmt in ("f32", "slots20"):
            same_rows(one, sm, fmt, lambda d: q(d, w), f"3m window {wi}")
    one.config = sm.config = ix.config
    _s, slots, keys = out[0]
    recall = bm25_recall(ix, windows[0][:256], slots[:256], keys[:256], k)
    log(f"3m recall@{k} of the rows over {n} cards against the f64 oracle on 256 queries: {recall!r}")
    assert recall >= 0.999, recall

    # The head terms (K3 + K5 on every card) and 3r's range window.
    vocab, cdf = zipf
    head = [vocab[i] for i in range(8)] + [f"{vocab[i]} {vocab[i + 8]}" for i in range(8)]
    same_rows(one, sm, "f32", lambda d: q(d, head), "3m head-term window")
    w, rq = range_window(windows[0])
    runs = []
    for run, d in (("cold", sm), ("one card", one), ("warm", sm), ("warm", sm), ("one card", one)):
        reset_bm25_counts()
        t = time.perf_counter()
        h, disp_ = submit_timed(lambda: q(with_format(d, "f32"), w), "sharded/dispatch")
        h.get_arrays()
        sync_cards()
        runs.append((run, 1e3 * (time.perf_counter() - t), disp_, card_launches()))
        del h
    assert all(c == runs[0][3] for run, _a, _b, c in runs if run != "one card"), runs
    assert runs[0][3] == dict.fromkeys(range(n), per_shard(runs[1][3][0], n)), runs
    planned, fallback = sm.plan_batch(w, TOK, scorer)
    range_host = sorted(set(fallback) & set(rq))
    assert planned[4][rq].all() and not range_host, range_host
    log(f"3m range window ({len(w)} queries, {len(rq)} with a range term) ms submit to drained / "
        f"sharded/dispatch ms, {n} cards cold, then one card and {n} cards warm in turns: "
        + "; ".join(f"{run} {a:.3f} / {b:.3f}" for run, a, b, _c in runs)
        + f"; launches per card {runs[0][3]}, one card {runs[1][3]}; host rows {len(fallback)} "
        f"({len(range_host)} of range queries); {sharded_graph_stats(sm)}")
    same_rows(one, sm, "f32", lambda d: q(d, w), "3m range window")
    one.config = sm.config = ix.config

    # Every kernel of the path against plain on each card.
    for label, queries in (("window 0", windows[0]), ("head-term window", head), ("range window", w)):
        check_sharded_classes(sm, queries, scorer, k, errs, label, every=False, phase="3m")
    busy_per_card("3m", {f"{n} cards": lambda i: submit(sm, i), "one card": lambda i: submit(one, i)})

    # The template graph on the last card against 3g's on cuda:0.
    last = DeviceIndex(ix, device=cards[-1])
    assert last.load_templates(MANIFEST) == 1 and last.prewarm(scorer) == 1
    assert torch.cuda.current_device() == 0
    pdev.metrics.reset()
    k1 = fq.device_launches.get(f"full@{cards[-1]}", 0)
    for _ in range(2):
        for wi, w_ in enumerate(windows):
            h0, hl = gix.query_batch_async(w_, scorer, top_k=k), last.query_batch_async(w_, scorer, top_k=k)
            for x, y in zip(h0.get_arrays(), hl.get_arrays()):
                if x is not None:
                    np.testing.assert_array_equal(x, y, err_msg=f"3m template window {wi}")
            assert torch.equal(h0._packed.cpu(), hl._packed.cpu()), f"3m template window {wi}"
    ctr = pdev.metrics.snapshot()["counters"]
    assert ctr.get("template_graph_replays") == 8 and not ctr.get("template_refreezes"), ctr
    k1 = fq.device_launches.get(f"full@{cards[-1]}", 0) - k1
    log(f"3m a DeviceIndex on {cards[-1]} prewarmed from {os.path.relpath(MANIFEST, ROOT)}: 4 windows "
        f"on its template graph, packed rows bit-equal to 3g's on cuda:0 (8 replays in all, "
        f"K1 launched {k1} times on {cards[-1]})")
    assert k1 > 0
    del last

    # A mutation: documents added and removed, a new snapshot over the
    # cards; the old one is freed on every card with the collector off.
    rng = np.random.default_rng(SEED + 5)
    added = [" ".join(vocab[j] for j in rng.integers(100, 2000, 8)) for _ in range(1000)]
    new_keys = list(range(N_DOCS, N_DOCS + len(added)))
    removed = list(range(7, N_DOCS, 10007))
    ix.attach_mesh(sm.mesh)
    t = time.perf_counter()
    ix.add_documents_columnar(new_keys, [added])
    for key in removed:
        ix.remove_document(key)
    sync_cards()
    before = [torch.cuda.memory_allocated(c) for c in cards]
    gc.disable()
    try:
        ref = weakref.ref(sm)
        del sm
        assert ref() is None, "the replaced snapshot is still referenced"
        freed = [b - torch.cuda.memory_allocated(c) for c, b in zip(cards, before)]
        fresh = ix.sharded_index()
        sync_cards()
    finally:
        gc.enable()
    log(f"3m mutation: {len(added)} documents added, {len(removed)} removed, a new snapshot over "
        f"{fresh.mesh} in {time.perf_counter() - t:.3f} s; the old one freed with the collector off: "
        f"{freed} B on each card")
    assert all(f > 0 for f in freed), freed
    _ORACLE.clear()  # the index changed
    sample = windows[0][:96] + [" ".join(text.split(" ")[:2]) for text in added[:32]]
    s_, slots, keys = with_format(fresh, "f32").query_batch_async(sample, scorer, top_k=k).get_arrays()
    recall = bm25_recall(ix, sample, slots, keys, k)
    valid = keys[slots >= 0].astype(np.int64)
    log(f"3m after the mutation: recall@{k} against the f64 oracle on {len(sample)} queries "
        f"{recall!r}; {int((valid >= N_DOCS).sum())} rows hold added documents, "
        f"{int(np.isin(valid, removed).sum())} removed ones")
    assert recall >= 0.999 and (valid >= N_DOCS).any() and not np.isin(valid, removed).any()
    ix.attach_mesh(None)
    return fresh


def phase_cards_z2o(ix, windows, one, card):
    """Phase 4m: zero-to-one 50k on mesh (2, 2) over four cards against the
    same mesh on one card (phase 4s's snapshot, ``one``).  Returns K4's
    largest error against plain on the cards."""
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        log(f"4m zero-to-one 50k over four cards: not run ({n_cards} card visible, needs 4)")
        return 0.0
    k = 10
    cards, desc = cards_in_use(4)
    log(f"4m make_mesh(2, 2) over {desc}")
    sm = build_on_cards(ix, make_mesh(2, 2), cards, "4m")
    for d in (one, sm):
        with_format(d, "slots")

    def submit(d, i):
        return d.query_batch_z2o(windows[i % 2], top_k=k)

    warm_up(sm, lambda i: submit(sm, i), "4m")
    serve_turns(one, sm, submit, reset_z2o_counts, z2o_counts, "4m", card)
    log_gather("4m", gather_times(sm, lambda: submit(sm, 0)), gather_times(one, lambda: submit(one, 0)))
    for wi, w in enumerate(windows):
        same_rows(one, sm, "slots", lambda d: d.query_batch_z2o(w, top_k=k), f"4m window {wi}")
    sample = windows[0][:256]
    scores, slots, keys = same_rows(one, sm, "f32", lambda d: d.query_batch_z2o(sample, top_k=k),
                                    "4m 256 queries")
    recall, recall_tie, rel = z2o_oracle_check(ix, sample, scores, slots, keys, k)
    log(f"4m recall@{k} against the f64 oracle on {len(sample)} queries: {recall!r} (tie-aware "
        f"{recall_tie!r}), max score rel err {rel:.3g}")
    assert recall_tie >= 0.999, recall_tie
    with_format(sm, "slots")
    with_format(one, "slots")
    busy_per_card("4m", {"4 cards": lambda i: submit(sm, i), "one card": lambda i: submit(one, i)})

    # K4 against plain on each card: the widest K4 class of its cell.
    jquery, words, qlen, max_chunks, njobs, _fb, _lock = sm.plan_batch_z2o(windows[0], TOK)
    specs, _layout, buf, qcat = sm._pack_z2o(len(windows[0]), jquery, words, max_chunks, njobs, qlen)
    F, Cw = sm.num_fields, sm.CHUNK
    offs = np.cumsum([0] + [b_pad * nj * 4 for b_pad, _bo, nj, _nc in specs])
    qoffs = np.cumsum([0] + [b_pad for b_pad, _bo, _nj, _nc in specs])
    fused = [ci for ci, (_bp, _bo, _nj, nc) in enumerate(specs)
             if pz.fused_route(nc, Cw, F, sm.local_slots < (1 << 26))]
    ci = max(fused, key=lambda c: specs[c][3])
    b_pad, b_out, nj, nc = specs[ci]
    err_max = 0.0
    for d in range(2):
        for s in range(2):
            rec = sm._rec_cells[d][s]
            with torch.cuda.device(rec.device):
                w4 = buf[s, d, offs[ci] : offs[ci + 1]].reshape(b_pad, nj, 4)[:b_out]
                jobs = torch.from_numpy(np.ascontiguousarray(w4)).to(rec.device)
                ql = torch.from_numpy(np.ascontiguousarray(qcat[d, qoffs[ci] : qoffs[ci] + b_out]))
                c_start, c_skip, c_len, c_qterm, c_rank, c_score = pz.expand_chunks_z2o(jobs, Cw, nc)
                args = (rec, c_start, c_skip, c_len, c_qterm, c_score, c_rank, ql.to(rec.device))
                label = f"4m row {d} shard {s} ({rec.device}) z2o class nc={nc} nj={nj} rows={b_out}"
                err, ms, plain_ms, dev_ms = check_z2o(args, Cw, min(k, nc * Cw), F, label,
                                                      sm.z2o_key_bits[s])
            err_max = max(err_max, err)
            log(f"{label}: ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                f"plain {plain_ms:.4f} ms, key_bits {sm.z2o_key_bits[s]}")
    del sm
    return err_max


# --------------------------------------------------------------------- #
# phases 3t, 4t: several threads serving one engine                      #
# --------------------------------------------------------------------- #


def launch_counts():
    return [dict(c) for c in pdev._launch_counters()]


def moved_since(before):
    """The launch counts moved since ``before`` (``launch_counts``), per
    counter: K1 / K3 by phase and chunk, K5 and its paths, K4, the z2o
    programs, then K1 / K3, K5 and K4 per card."""
    return [{key: n - was.get(key, 0) for key, n in c.items() if n != was.get(key, 0)}
            for c, was in zip(pdev._launch_counters(), before)]


def summed(moves):
    """Per counter, the sum of several runs' moved counts."""
    total = [{} for _ in pdev._launch_counters()]
    for moved in moves:
        for t, m in zip(total, moved):
            for key, n in m.items():
                t[key] = t.get(key, 0) + n
    return total


def brief(moved):
    """The kernels' counts of ``moved``, one dict."""
    return {key: n for m in moved for key, n in m.items()}


def rows_equal(a, b, label):
    """Two runs' rows (arrays, packed bytes, lists and tuples of them, or
    QueryResult lists) equal, bit for bit."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), label
        for x, y in zip(a, b):
            rows_equal(x, y, label)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, label
        np.testing.assert_array_equal(a, b, err_msg=label)
    else:
        assert a == b, label


def threaded(per_thread, serve, own_streams=False):
    """Thread t runs ``serve(job)`` for each job of ``per_thread[t]`` in
    turn (each ``serve`` submits and drains its own window), every thread at
    once, each under a CUDA stream of its own with ``own_streams``.
    Returns ([the results of each thread], the launches moved in all,
    seconds)."""
    streams = [torch.cuda.Stream() if own_streams else None for _ in per_thread]

    def worker(t):
        with torch.cuda.stream(streams[t]) if own_streams else contextlib.nullcontext():
            return [serve(job) for job in per_thread[t]]

    sync_cards()
    before = launch_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(per_thread)) as pool:
        futs = [pool.submit(worker, t) for t in range(len(per_thread))]
        results = [f.result() for f in futs]
    sync_cards()
    return results, moved_since(before), time.perf_counter() - t0


def serial_runs(jobs, serve):
    """Each distinct job of ``jobs`` served alone, one after another:
    {job: (its rows, the launches it moved)}."""
    out = {}
    for job in dict.fromkeys(jobs):
        sync_cards()
        before = launch_counts()
        rows = serve(job)
        sync_cards()
        out[job] = (rows, moved_since(before))
    return out


def check_threads(label, per_thread, results, moved, serial, extra=()):
    """Every thread's rows equal to the serial rows of the same job, and
    the launches counted across the threads equal to the sum of the serial
    jobs' (plus ``extra`` runs' moved counts), per kernel and per card."""
    for t, (jobs, rows_t) in enumerate(zip(per_thread, results)):
        for job, rows in zip(jobs, rows_t):
            rows_equal(rows, serial[job][0], f"{label}: thread {t}, job {job}")
    want = summed([serial[job][1] for jobs in per_thread for job in jobs] + list(extra))
    assert moved == want, (label, moved, want)


def packed_rows(h):
    """A drained BM25 or z2o window's slots and packed rows on the host."""
    arrays = h.get_arrays()
    return arrays[1], h._packed.cpu().numpy()


def qps_by_threads(label, submit, card, n=16):
    """``n`` windows (``submit(i)``) served by 1, 2 and 4 threads, each
    submitting and draining its share one window at a time: QPS, the mean
    query/plan and query/pack host ms, and, from a second run under
    torch.profiler, the device's busy and idle share."""
    from torch.profiler import ProfilerActivity, profile

    parts = []
    for n_threads in (1, 2, 4):
        per_thread = [list(range(t, n, n_threads)) for t in range(n_threads)]
        pdev.metrics.reset()
        _r, _m, dt = threaded(per_thread, lambda i: submit(i).get_arrays())
        hist = pdev.metrics.snapshot()["histograms"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _r, _m, dt_p = threaded(per_thread, lambda i: submit(i).get_arrays())
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        share = f"device busy {busy / n:.3f} ms a window, idle {100 * (1 - busy / (1e3 * dt_p)):.1f}%" \
            if busy else "device time not measured (no device events)"
        parts.append(f"{n_threads} thread(s) {n * WINDOW / dt:.1f} QPS ({1e3 * dt / n:.3f} ms/window), "
                     f"plan {hist['query/plan']['mean_us'] / 1e3:.3f} pack "
                     f"{hist['query/pack']['mean_us'] / 1e3:.3f} ms a window, {share}")
    log(f"{label} on {card}, {n} windows of {WINDOW} queries, each thread submitting and draining "
        "one window at a time (for information only): " + "; ".join(parts))


def phase_threads(ix, gix, one, cards_engine, windows, zipf, scorer, card):
    """Phase 3t: phase 3's index served from several threads at once (see
    the module docstring).  Mutates ``ix`` and restores its config.
    Returns the launches of the threaded turns (the serial reference runs
    left out)."""
    t_phase = time.perf_counter()
    k = 10
    variants = [windows[0], windows[1], windows[0][::-1], windows[1][::-1]]
    pairs = [[t, (t + 1) % 4] for t in range(4)]
    base = ix.config
    served = []

    def on(d):
        return lambda j: packed_rows(d.query_batch_async(variants[j], scorer, top_k=k))

    # (a) A fresh DeviceIndex (composed windows: a window's packed layout
    # depends on its queries alone): first sights capture on four threads.
    fresh = DeviceIndex(ix, device="cuda")
    fresh.config = dataclasses.replace(base, template_compositions=False, result_format="slots20")
    pdev.metrics.reset()
    results, moved, dt = threaded(pairs, on(fresh))
    ctr = pdev.metrics.snapshot()["counters"]
    serial = serial_runs(range(4), on(fresh))
    check_threads("3t (a)", pairs, results, moved, serial)
    served.append(moved)
    assert ctr.get("class_graph_captures", 0) == len(fresh._class_graphs) > 0, ctr
    log(f"3t (a) a fresh DeviceIndex, 4 threads x 2 windows (composed): {dt:.3f} s, "
        f"{int(ctr['class_graph_captures'])} class graphs captured on first sight across the "
        f"threads; each window's packed rows byte-equal to the serial window's; launches across the "
        f"threads equal to the serial windows' sum {brief(moved)}")

    # (b) gix's template graph: the shared stream, then a stream a thread.
    serial = serial_runs(range(4), on(gix))
    for own in (False, True):
        pdev.metrics.reset()
        results, moved, dt = threaded(pairs, on(gix), own_streams=own)
        ctr = pdev.metrics.snapshot()["counters"]
        check_threads("3t (b)", pairs, results, moved, serial)
        assert ctr.get("template_graph_replays") == 8 and not ctr.get("template_refreezes"), ctr
        served.append(moved)
        log(f"3t (b) 3g's template graph, 4 threads x 2 windows on "
            f"{'a stream of its own each' if own else 'the shared stream'}: {dt:.3f} s, 8 replays; "
            f"packed rows byte-equal to the serial windows'; launches equal {brief(moved)}")

    # (c) prewarm on a thread while two threads serve a fresh DeviceIndex
    # of the same template (frozen on (a)'s snapshot, so nothing refreezes).
    fresh.config = dataclasses.replace(fresh.config, template_compositions=True)
    for j in range(4):
        on(fresh)(j)
    os.makedirs(os.path.join(ROOT, "build", "templates"), exist_ok=True)
    manifest = os.path.join(ROOT, "build", "templates", "3t.json")
    assert fresh.save_templates(manifest) == 1
    del fresh
    pix = DeviceIndex(ix, device="cuda")
    pix.config = dataclasses.replace(base, result_format="slots20")
    assert pix.load_templates(manifest) == 1
    started, warmed = threading.Barrier(3), threading.Event()

    def server(t):
        rows, after = [], 0
        for r in range(100):
            rows.append(on(pix)((t + r) % 2))
            if r == 0:
                started.wait(120)
            after += warmed.is_set()
            if after == 2:
                break
        return rows

    def warmer():
        started.wait(120)
        t = time.perf_counter()
        n = pix.prewarm(scorer)
        warmed.set()
        return n, time.perf_counter() - t

    pdev.metrics.reset()
    before = launch_counts()
    with ThreadPoolExecutor(max_workers=3) as pool:
        futs = [pool.submit(server, 0), pool.submit(server, 1), pool.submit(warmer)]
        got0, got1, (n_warm, t_pw) = (f.result() for f in futs)
    sync_cards()
    moved = moved_since(before)
    ctr = pdev.metrics.snapshot()["counters"]
    per_thread = [[(0 + r) % 2 for r in range(len(got0))], [(1 + r) % 2 for r in range(len(got1))]]
    serial = serial_runs(range(2), on(pix))
    # prewarm runs its template's step once eagerly: one window's launches.
    check_threads("3t (c)", per_thread, [got0, got1], moved, serial, extra=[serial[0][1]])
    n_graph = int(ctr.get("template_graph_replays", 0))
    assert n_warm == 1 and n_graph >= 2 and ctr.get("class_graph_replays", 0) > 0, ctr
    assert not ctr.get("template_refreezes"), ctr
    served.append(moved)
    log(f"3t (c) prewarm on a thread ({t_pw:.3f} s) while 2 threads serve a fresh DeviceIndex: "
        f"{len(got0) + len(got1)} windows, {n_graph} on the template graph, the rest on class graphs "
        f"({int(ctr.get('class_graph_captures', 0))} captured); packed rows byte-equal to the serial "
        f"windows'; launches equal to theirs plus prewarm's eager run {brief(moved)}")

    qps_by_threads("3t QPS by submitting threads, 3g's template graph",
                   lambda i: gix.query_batch_async(variants[i % 4], scorer, top_k=k), card)
    del pix

    # (f) 3s's sharded engine (4 shards on cuda:0), (g) 3m's over the cards.
    def on_sharded(d):
        def serve(j):
            h = d.query_batch_async(variants[j], scorer, top_k=k)
            arrays = h.get_arrays()
            return arrays[1], [p.cpu().numpy() for p in h._packed[0]]
        return serve

    engines = [("(f) 3s's engine", one)]
    if cards_engine is not None:
        engines.append((f"(g) 3m's engine over {cards_engine.n_shards} cards", cards_engine))
    else:
        log(f"3t (g) 3m's engine over several cards: not run ({torch.cuda.device_count()} card visible)")
    for label, d in engines:
        with_format(d, "slots20")
        serial = serial_runs(range(3), on_sharded(d))
        for own in (False, True):
            results, moved, dt = threaded(pairs[:2], on_sharded(d), own_streams=own)
            check_threads(f"3t {label}", pairs[:2], results, moved, serial)
            served.append(moved)
            log(f"3t {label} on {d.mesh}, 2 threads x 2 windows on "
                f"{'a stream of its own each' if own else 'the shared stream'}: {dt:.3f} s; packed "
                f"rows byte-equal to the serial windows'; launches equal, per card {brief(moved[6:])}")

    # (d) A writer mutates ix and takes snapshots while two readers serve
    # the newest snapshot each window (composed windows).
    ix.config = dataclasses.replace(base, template_compositions=False, result_format="slots20")
    vocab, _cdf = zipf
    rng = np.random.default_rng(SEED + 9)
    snaps, stop = [ix.device_index()], threading.Event()
    next_key = max(ix._key_to_slot) + 1

    def writer():
        times = []
        try:
            for r in range(3):
                t = time.perf_counter()
                keys = list(range(next_key + 300 * r, next_key + 300 * (r + 1)))
                ix.add_documents_columnar(keys, [[" ".join(vocab[j] for j in rng.integers(100, 2000, 8))
                                                  for _ in keys]])
                for key in range(11 + r, N_DOCS, 33331)[:30]:
                    ix.remove_document(key)
                snaps.append(ix.device_index())
                times.append(time.perf_counter() - t)
        finally:
            stop.set()
        return times

    def reader(t):
        out, r = [], 0
        while not stop.is_set() or r < 2:
            si = len(snaps) - 1
            out.append((si, (t + r) % 2, on(snaps[si])((t + r) % 2)))
            r += 1
        return out

    before = launch_counts()
    with ThreadPoolExecutor(max_workers=3) as pool:
        futs = [pool.submit(writer), pool.submit(reader, 0), pool.submit(reader, 1)]
        w_times, reads0, reads1 = (f.result() for f in futs)
    sync_cards()
    moved = moved_since(before)
    reads = reads0 + reads1
    serial = {}
    for si, j, _rows in reads:
        if (si, j) not in serial:
            serial[(si, j)] = serial_runs([j], on(snaps[si]))[j]
    check_threads("3t (d)", [[(si, j) for si, j, _r in reads]], [[rows for _s, _j, rows in reads]],
                  moved, serial)
    served.append(moved)
    used = sorted({si for si, _j, _r in reads})
    log(f"3t (d) a writer: 3 rounds of 300 adds and 30 removes, each followed by ix.device_index() "
        f"({', '.join(f'{v:.3f}' for v in w_times)} s), while 2 readers served {len(reads)} windows on "
        f"snapshots {used} of {len(snaps)}; each window's packed rows byte-equal to its snapshot's "
        f"serial rows; launches equal {brief(moved)}")
    # The replaced snapshots, freed with the collector off.
    keep = ix.device_index()
    assert keep is snaps[-1]
    refs = [weakref.ref(x) for x in snaps[:-1]]
    del reads, reads0, reads1, serial, futs
    sync_cards()
    mem0 = torch.cuda.memory_allocated()
    gc.disable()
    try:
        del snaps[:-1]
        alive = sum(r() is not None for r in refs)
        sync_cards()
        freed = mem0 - torch.cuda.memory_allocated()
    finally:
        gc.enable()
    log(f"3t (d) the {len(refs)} replaced snapshots dropped with the collector off: {alive} still "
        f"referenced, {freed} B freed on the card")
    assert alive == 0 and freed > 0, (alive, freed)
    _ORACLE.clear()  # the index changed
    _s, slots, keys = keep.query_batch_async(windows[0][:256], scorer, top_k=k).get_arrays()
    recall = bm25_recall(ix, windows[0][:256], slots, keys, k)
    log(f"3t (d) the last snapshot: recall@{k} against the f64 oracle on 256 queries {recall!r}")
    assert recall >= 0.999, recall

    # (e) Index.query_batch at IndexConfig.low_latency() from two threads.
    # Composed windows, so that a window's classes (and launches) do not
    # depend on which thread froze a template first.
    preset = IndexConfig.low_latency()
    ix.config = keep.config = dataclasses.replace(
        base, serving_window=preset.serving_window, serving_depth=preset.serving_depth,
        result_format="f32", template_compositions=False)

    def blocking(j):
        return [[(r.key, r.score) for r in row]
                for row in ix.query_batch(variants[j], scorer, top_k=k)]

    results, moved, dt = threaded([[0], [1]], blocking)
    serial = serial_runs(range(2), blocking)
    check_threads("3t (e)", [[0], [1]], results, moved, serial)
    served.append(moved)
    for j in range(2):
        one_window = [[(r.key, r.score) for r in row]
                      for row in keep.query_batch_async(variants[j], scorer, top_k=k).get()]
        rows_equal(results[j][0], one_window, f"3t (e) window {j} against one window")
    log(f"3t (e) Index.query_batch at IndexConfig.low_latency() (windows of "
        f"{ix.config.serving_window} at depth {ix.config.serving_depth}) from 2 threads, "
        f"{WINDOW} queries each: {dt:.3f} s; rows equal to one {WINDOW}-query window's and to the "
        f"serial calls'; launches equal {brief(moved)}")
    ix.config = keep.config = base
    with_format(one, "slots20")

    total = brief(summed(served))
    assert all(total.get(key) for key in ("full", "lanes", "merge_topk")), total
    log(f"3t: {time.perf_counter() - t_phase:.1f} s in all")
    return total


def phase_threads_z2o(ix, dix, windows, card):
    """Phase 4t: zero-to-one 50k from several threads (see the module
    docstring).  Returns K4's launches in the threaded turns."""
    t_phase = time.perf_counter()
    k = 10
    variants = [windows[0], windows[1], windows[0][::-1], windows[1][::-1]]
    pairs = [[t, (t + 1) % 4] for t in range(4)]

    def on(d):
        return lambda j: packed_rows(pz.z2o_query_batch_async(d, variants[j], TOK, k, fmt="slots"))

    serial = serial_runs(range(4), on(dix))
    fresh = DeviceIndex(ix, device="cuda")
    pdev.metrics.reset()
    results, moved, dt = threaded(pairs, on(fresh))
    ctr = pdev.metrics.snapshot()["counters"]
    check_threads("4t fresh", pairs, results, moved, serial)
    assert moved[4].get("fused_z2o") and moved[5].get("z2o_lockstep"), moved
    log(f"4t a fresh DeviceIndex of z2o 50k, 4 threads x 2 windows: {dt:.3f} s, "
        f"{int(ctr.get('class_graph_captures', 0))} class graphs captured on first sight; slots and "
        f"packed rows equal to phase 4's serial windows; launches equal {brief(moved)}")
    served = [moved]
    for own in (False, True):
        results, moved, dt = threaded(pairs, on(fresh), own_streams=own)
        check_threads("4t", pairs, results, moved, serial)
        served.append(moved)
        log(f"4t 4 threads x 2 windows on {'a stream of its own each' if own else 'the shared stream'}: "
            f"{dt:.3f} s; slots and packed rows equal to the serial windows'; launches equal "
            f"{brief(moved)}")
    del fresh
    base = dix.config
    dix.config = dataclasses.replace(base, serving_window=2048, serving_depth=4, result_format="f32")

    def blocking(j):
        return [[(r.key, r.score) for r in row] for row in pz.z2o_query_batch(dix, variants[j], TOK, k)]

    results, moved, dt = threaded([[0], [1]], blocking)
    serial = serial_runs(range(2), blocking)
    check_threads("4t low_latency", [[0], [1]], results, moved, serial)
    served.append(moved)
    for j in range(2):
        one_window = [[(r.key, r.score) for r in row]
                      for row in pz.z2o_query_batch_async(dix, variants[j], TOK, k, fmt="f32").get()]
        rows_equal(results[j][0], one_window, f"4t low_latency window {j} against one window")
    dix.config = base
    log(f"4t z2o_query_batch at the low_latency() windows (2048 at depth 4) from 2 threads: {dt:.3f} s; "
        f"rows equal to one {WINDOW}-query window's and to the serial calls'; launches equal {brief(moved)}")
    log(f"4t: {time.perf_counter() - t_phase:.1f} s in all")
    return brief(summed(served))["fused_z2o"]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t = time.time()
    _build.load()
    log(f"kernel build + load: {time.time() - t:.1f} s ({_build.library_path().name})")
    scorer = bm25.new()
    log(f"tolerance, kernel against plain: scores rtol={RTOL} atol={ATOL}; lane keys "
        "bit-exact; top-k slots equal except neighbours within the score tolerance")

    errs = phase_kernels(scorer)
    errs["fused_z2o"] = phase_z2o_kernels()
    errs["merge_topk"] = phase_merge_kernels()
    probe_launches, probe_times, probe_library_ms = phase_probe()
    errs["probe_add"] = 0.0  # bit-equal, asserted
    launches, win_errs, times, ix, dix, windows, zipf = phase_main(scorer, card)
    log(f"K5 launches on the main path: {launches['merge_topk']}")
    graph_launches, gix = phase_graphs(ix, dix, windows, scorer, card)
    for key in ("full", "lanes", "merge_topk"):
        launches[key] += graph_launches[key]
    launches["merge_topk"] += phase_custom(ix, dix, windows[0][:256])
    launches["merge_topk"] += phase_ranges(ix, dix, windows[0], scorer, win_errs, times)
    phase_z2o_1m(ix, dix, windows[0])
    shard_launches, one_card = phase_sharded(ix, dix, windows, zipf, scorer, card, errs)
    for key in ("full", "lanes", "merge_topk"):
        launches[key] += shard_launches[key]
    prune_launches = phase_prune(ix, *zipf, card)
    for key in ("full", "lanes", "merge_topk"):
        launches[key] += prune_launches[key]
    light_launches, light = phase_light(ix, dix, gix, windows, scorer, card)
    cards_engine = phase_cards(ix, gix, one_card, windows, zipf, scorer, card, errs)
    thread_launches = phase_threads(ix, gix, one_card, cards_engine, windows, zipf, scorer, card)
    for key in ("full", "lanes", "merge_topk"):
        launches[key] += thread_launches[key]
    del dix, gix, ix, one_card, cards_engine
    z2o_counts_, z2o_err, z2o_times, z2o_run = phase_z2o_main(card)
    sz_launches, sz_err, sz = phase_sharded_z2o(*z2o_run, card)
    cards_z2o_err = phase_cards_z2o(z2o_run[0], z2o_run[2], sz, card)
    del sz
    z2o_thread_launches = phase_threads_z2o(*z2o_run, card)
    launches["fused_z2o"] = z2o_counts_["fused_z2o"] + sz_launches + z2o_thread_launches
    win_errs["fused_z2o"] = max(z2o_err, sz_err, cards_z2o_err)
    times["fused_z2o"] = z2o_times
    launches["probe_add"] = probe_launches
    win_errs["probe_add"] = 0.0
    times["probe_add"] = probe_times
    record = []
    for key, (name, source, replaces) in KERNELS.items():
        ms, plain_ms, bound_ms, bound_by = times[key]
        record.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(errs[key], win_errs[key]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes gather (or sort) + segmented
            # reduce + top-k; the probe's is x + 1
            "library_ms": probe_library_ms if key == "probe_add" else None,
        })
    name, source, replaces = KERNELS["full"]
    record.append({
        "name": f"{name} (chunk {LIGHT_CW}: light classes)",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": light_launches,
        "max_abs_err": light["err"],
        "ms": light["ms"],
        "plain_ms": light["plain_ms"],
        "bound_ms": light["bound_ms"],
        "bound_by": light["bound_by"],
        "library_ms": None,
    })
    assert "jax" not in sys.modules, "the port must not import jax"
    jax_pkg = [m for m in sys.modules if m == "probly_search_tpu" or m.startswith("probly_search_tpu.")]
    assert not jax_pkg, f"the port must not import the JAX package: {jax_pkg}"
    log(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
