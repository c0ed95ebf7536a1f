#!/usr/bin/env python3
"""GPU smoke run of the torch port (probly_search_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  1. environment: torch / CUDA versions, the card's name and power limit,
     and the kernel build from probly_search_tpu_torch/csrc;
  2. each BM25 kernel against its plain torch version on seeded chunk
     tables (C = 1024, B = 1024; phase "full" at NC 2..16, phase "lanes" at
     NC 24 and 32; k 10 and 128), with bit-equal repeat runs and CUDA-event
     times;
  2z. the zero-to-one kernel (K4) the same way: C = 1024, B = 1024,
     NC 2, 3, 4, 6, 8, F 1, 2, 4, k 10 and 128;
  2m. the standalone merge kernel (K5) against its plain version on seeded
     rows: run 0 (full sort) at B 1 and 2, L 2,048 .. 2^23 (3,072, 24,576
     and 3 * 2^20 not powers of two); run 1,024 at B 24, L 24,576 and
     32,768, excl on and off; k 10 and 128; duplicate keys, pads, dead docs
     and equal totals;
  2p. the launch probe (P1) against x + 1, bit-equal, over chains of 1, 4
     and 16 launches: per-launch time from the host clock and CUDA events;
  3. the BM25 main path at real size: top-10 over the 1,000,000-doc bench
     corpus (bench.py's generator), two 16,384-query windows, 8 windows
     served through DeviceIndex.query_batch_async with a depth-4 pipeline
     and paired late drains; launch counts, ms/window, QPS, recall@10
     against the f64 oracle on 256 queries, and every class of the first
     window held kernel against plain on its real tables (K1; K3 and K5 on
     the wide classes);
  3r. term-range jobs on that index: phase 3's first window with every 64th
     query's first term cut to its first four characters (a prefix of 100
     terms) and the last three queries replaced by t0, t00 and t1, served
     cold, then warm; classes by route, K5 launches, ms submit to drained;
     recall@10 of every range query against the f64 vectorized BM25 host
     path, the 16 smallest also against Index.query, 0 host rows; K5 held
     against plain on every range class and on the heavy-cache classes of
     t0, t00 and t1;
  3z. one 16,384-query zero-to-one window over that 1M-doc corpus: each
     class's route, and the rows held against the f64 oracle on 64 queries;
  4. the zero-to-one main path at the repo's zero_to_one_50k configuration
     (benchmarks/zero_to_one_50k.py: 50,000 docs, a 3-token title and an
     8-token body, Zipf(1.05) over 4,000 terms, seed 7; 2-term queries with
     the top 50 ranks excluded; 16,384-query windows, top-10, "slots"):
     8 windows through z2o_query_batch_async with a depth-4 pipeline and
     paired late drains; launch counts of the kernel and the torch programs,
     ms/window, QPS, recall@10 against the f64 oracle on 256 queries, every
     kernel class of one window held kernel against plain on its real
     tables, and a torch.profiler breakdown of one window.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs a CUDA device: without one it exits
with an error before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench import make_corpus, make_queries  # noqa: E402
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25, zero_to_one  # noqa: E402
from probly_search_tpu_torch.index import device as pdev  # noqa: E402
from probly_search_tpu_torch.ops import _build  # noqa: E402
from probly_search_tpu_torch.ops import fused_merge as fm  # noqa: E402
from probly_search_tpu_torch.ops import fused_query as fq  # noqa: E402
from probly_search_tpu_torch.ops import fused_z2o as fz  # noqa: E402
from probly_search_tpu_torch.ops import launch_probe as lp  # noqa: E402
from probly_search_tpu_torch.ops import z2o_device as pz  # noqa: E402
from probly_search_tpu_torch.testing import ATOL, RTOL, assert_topk_agree  # noqa: E402

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
PROBE_CHAINS = (1, 4, 16)
INT32_MAX = 2**31 - 1
N_DOCS = 1_000_000
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


def check_full(scorer, rec, tables, scalars, k, label):
    kw = dict(chunk=C, k=k, qterm_bits=QB, num_fields=1)
    ks, kd = fq.fused_query_topk(scorer, rec, *tables, scalars, **kw)
    ks2, kd2 = fq.fused_query_topk(scorer, rec, *tables, scalars, **kw)
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2), f"{label}: repeat runs differ"
    ps, pd = fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **kw)
    err = assert_topk_agree(ks.cpu(), kd.cpu(), ps.cpu(), pd.cpu())
    ms = cuda_ms(lambda: fq.fused_query_topk(scorer, rec, *tables, scalars, **kw))
    plain_ms = cuda_ms(lambda: fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **kw))
    return err, ms, plain_ms


def check_lanes(scorer, rec, tables, scalars, k, label):
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
    ms_, md_ = fm.merge_scores_topk_fused(lk, ls, k, QB, run=C, excl=True, max_seg=lk.shape[1] // C)
    fs, fd = fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **{**kw, "phase": "full"})
    err = max(err, assert_topk_agree(ms_.cpu(), md_.cpu(), fs.cpu(), fd.cpu()))
    ms = cuda_ms(lambda: fq.fused_query_topk(scorer, rec, *tables, scalars, **kw))
    plain_ms = cuda_ms(lambda: fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **kw))
    return err, ms, plain_ms


def bm25_bound(tables, k, phase, F=1):
    """``bound`` of one K1 / K3 call on these tables: each payload lane
    reads 2 + 2F record rows and does 10F + 2 f32 operations."""
    c_start, c_len = tables[0], tables[2]
    B, NC = c_start.shape
    payload = int(c_len.sum())
    out = B * k * 8 if phase == "full" else B * NC * C * 8
    return bound(payload, 2 + 2 * F, B * NC * 20 + 16 * F, out, payload * (10 * F + 2))


def merge_bound(key, k):
    """``bound`` of one K5 call: each input lane (key and score, 8 B) read
    once, the [B, k] result written once; operations L * log2(L) compares
    of a comparison sort plus the max and the sum per lane."""
    B, L = key.shape
    return bound(0, 0, B * L * 8, B * k * 8, B * (L * max(1, (L - 1).bit_length()) + 2 * L))


def check_merge(key, score, k, label, run=0, excl=False, max_seg=0, quiet=False):
    """K5 against its plain version: repeat runs bit-equal, top-k within the
    tolerance; CUDA-event times and the bound.  Returns (err, ms, plain_ms,
    bound_ms, bound_by)."""
    kw = dict(run=run, excl=excl, max_seg=max_seg)
    ks, kd = fm.merge_scores_topk_fused(key, score, k, QB, **kw)
    ks2, kd2 = fm.merge_scores_topk_fused(key, score, k, QB, **kw)
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2), f"{label}: repeat runs differ"
    ps, pd = fm.merge_scores_topk_fused_reference(key, score, k, QB, **kw)
    err = assert_topk_agree(ks.cpu(), kd.cpu(), ps.cpu(), pd.cpu())
    assert bool((kd >= 0).any()), f"{label}: no result"
    ms = cuda_ms(lambda: fm.merge_scores_topk_fused(key, score, k, QB, **kw))
    plain_ms = cuda_ms(lambda: fm.merge_scores_topk_fused_reference(key, score, k, QB, **kw))
    bound_ms, by = merge_bound(key, k)
    if not quiet:
        log(f"{label}: ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({by})")
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


def phase_merge_kernels():
    rng = np.random.default_rng(SEED + 2)
    err_max = 0.0
    for L in MERGE_L_FULL:
        for B in (1, 2):
            key, score = merge_rows_full(rng, B, L)
            for k in TOP_KS:
                err = check_merge(key, score, k, f"merge run=0 B={B} L={L} k={k}")[0]
                err_max = max(err_max, err)
            del key, score
    for L in MERGE_L_RUNS:
        for excl in (False, True):
            key, score = merge_rows_runs(rng, 24, L, excl)
            for k in TOP_KS:
                label = f"merge run={C} B=24 L={L} excl={int(excl)} k={k}"
                err = check_merge(key, score, k, label, run=C, excl=excl, max_seg=L // C)[0]
                err_max = max(err_max, err)
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
    n = PROBE_CHAINS[-1]
    bound_ms, by = bound(0, 0, x.numel() * 4, x.numel() * 4, x.numel())
    return launches, [per["kernel", n], per["plain", n], bound_ms, by], per["library", n]


def phase_kernels(scorer):
    rng = np.random.default_rng(SEED)
    rec_np, starts, lens = synthetic_rec(rng)
    rec = torch.from_numpy(rec_np).cuda()
    scalars = torch.tensor([7.5, 1.0], dtype=torch.float32, device="cuda")
    errs = {"full": 0.0, "lanes": 0.0}
    for phase, ncs in (("full", FULL_NC), ("lanes", LANES_NC)):
        for NC in ncs:
            tables = synthetic_tables(rng, starts, lens, 1024, NC)
            for k in TOP_KS:
                label = f"{phase} NC={NC} k={k}"
                check = check_full if phase == "full" else check_lanes
                err, ms, plain_ms = check(scorer, rec, tables, scalars, k, label)
                torch.cuda.synchronize()
                errs[phase] = max(errs[phase], err)
                bound_ms, _by = bm25_bound(tables, k, phase)
                log(f"kernel {label:22s} B=1024 L={NC * C:6d}: ok, max_abs_err {err:.3g}, "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return errs


def z2o_bound(args, k, F):
    """``bound`` of one K4 call: each payload lane reads 2 + 2F record rows
    and does 6F f32 operations (the contribution and the per-doc sum)."""
    c_start, c_len = args[1], args[3]
    B, NC = c_start.shape
    payload = int(c_len.sum())
    return bound(payload, 2 + 2 * F, B * NC * 24 + B * 4, B * k * 8, payload * 6 * F)


def check_z2o(args, chunk, k, F, label):
    """K4 against its plain version on ``args`` = (rec, c_start, c_skip,
    c_len, c_qterm, c_score, c_rank, qlen): repeat runs bit-equal, top-k
    within the tolerance; CUDA-event times of both."""
    kw = dict(chunk=chunk, k=k, num_fields=F)
    ks, kd = fz.fused_z2o_topk(*args, **kw)
    ks2, kd2 = fz.fused_z2o_topk(*args, **kw)
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2), f"{label}: repeat runs differ"
    ps, pd = fz.fused_z2o_topk_reference(*args, **kw)
    err = assert_topk_agree(ks.cpu(), kd.cpu(), ps.cpu(), pd.cpu())
    ms = cuda_ms(lambda: fz.fused_z2o_topk(*args, **kw))
    plain_ms = cuda_ms(lambda: fz.fused_z2o_topk_reference(*args, **kw))
    return err, ms, plain_ms


def phase_z2o_kernels():
    rng = np.random.default_rng(SEED + 1)
    err_max = 0.0
    for F in Z2O_F:
        rec_np, starts, lens = synthetic_rec(rng, F=F)
        rec = torch.from_numpy(rec_np).cuda()
        for NC in Z2O_NC:
            args = (rec, *synthetic_z2o_tables(rng, starts, lens, 1024, NC))
            for k in TOP_KS:
                label = f"z2o F={F} NC={NC} k={k}"
                err, ms, plain_ms = check_z2o(args, C, k, F, label)
                torch.cuda.synchronize()
                err_max = max(err_max, err)
                bound_ms, _by = z2o_bound(args, k, F)
                log(f"kernel {label:22s} B=1024 L={NC * C:6d}: ok, max_abs_err {err:.3g}, "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return err_max


# --------------------------------------------------------------------- #
# phase 3: main path                                                     #
# --------------------------------------------------------------------- #


def window_classes(dix, queries, scorer, k):
    """(dispatches, class_specs) the port packs for ``queries``."""
    plan, _fb = dix.plan_batch(queries, pdev.whitespace_tokenizer, scorer)
    tkey = (pdev._scorer_cache_key(scorer), k, "slots20", len(queries))
    return dix._pack_dispatches_template(len(queries), plan, tkey)


def check_window_classes(dix, dispatches, scorer, k):
    """Kernel against plain on every class of a real window (f32 scores).
    Returns per phase the largest error and [kernel ms, plain ms, bound ms,
    bound_by] summed over the classes."""
    errs = {"full": 0.0, "lanes": 0.0, "merge_topk": 0.0}
    times = {key: [0.0, 0.0, 0.0, "bytes"] for key in errs}
    scalars = torch.cat([dix.field_avg, torch.ones(1, device="cuda")])
    for idxs, jobs_flat, nc, nj, _rng in dispatches:
        jobs = torch.from_numpy(jobs_flat).cuda().reshape(jobs_flat.shape[0], nj, 3)
        tables = pdev.expand_chunks(jobs, dix.CHUNK, nc)
        phase = "full" if nc * dix.CHUNK <= pdev._FUSED_MAX_LANES else "lanes"
        kk = min(k, nc * dix.CHUNK)
        label = f"window class nc={nc} nj={nj} rows={jobs_flat.shape[0]} ({phase})"
        check = check_full if phase == "full" else check_lanes
        err, ms, plain_ms = check(scorer, dix.rec, tables, scalars, kk, label)
        bound_ms, by = bm25_bound(tables, kk, phase)
        errs[phase] = max(errs[phase], err)
        t = times[phase]
        t[0] += ms
        t[1] += plain_ms
        t[2] += bound_ms
        t[3] = by if bound_ms else t[3]
        log(f"{label}: ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({by})")
        if phase == "lanes":  # K5 merges the K3 lanes
            ls, lk = fq.fused_query_topk(scorer, dix.rec, *tables, scalars, chunk=dix.CHUNK,
                                         k=kk, qterm_bits=QB, num_fields=1, phase="lanes")
            add_merge(errs, times, check_merge(lk, ls, kk, f"{label} merge", run=dix.CHUNK,
                                               excl=True, max_seg=nc))
    return errs, times


def add_merge(errs, times, result):
    err, ms, plain_ms, bound_ms, by = result
    errs["merge_topk"] = max(errs["merge_topk"], err)
    t = times["merge_topk"]
    t[0] += ms
    t[1] += plain_ms
    t[2] += bound_ms
    t[3] = by


def profile_windows(submit, n=4):
    """Windows one at a time (``submit(i)``, drain) under torch.profiler:
    wall time per window, device busy time per window (the sum of kernel
    times), kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            submit(i).get_arrays()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / n
    # Device-side events only: a torch op's own entry carries the time of the
    # kernels it launched, which appear again as events of their own.
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    if busy_ms == 0:
        log(f"one window alone: {wall_ms:.3f} ms wall; device time not measured (no device events)")
        return
    log(f"one window alone (profiled): {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall), idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1e3 / n:8.3f} ms/window  "
            f"calls {e.count // n:4d}/window  {e.key[:70]}")


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

    for _ in range(2):  # warm-up: plan pools, heavy cache, template freeze
        for w in windows:
            dix.query_batch_async(w, scorer, top_k=k).get_arrays()
    torch.cuda.synchronize()
    log(f"warm-up (2 passes): {time.time() - t2:.1f} s")

    dispatches, specs = window_classes(dix, windows[0], scorer, k)
    for _idxs, jobs_flat, nc, nj, _rng in dispatches:
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
        "(host clock, pipeline of 4; for information only)")

    hist = pdev.metrics.snapshot()["histograms"]
    log("host phases per window (mean ms, host clock): " + ", ".join(
        f"{name.split('/')[1]} {hist[name]['mean_us'] / 1e3:.3f}"
        for name in (f"query/{p}" for p in ("plan", "pack", "h2d", "dispatch", "fetch", "drain"))
        if name in hist
    ))
    profile_windows(lambda i: dix.query_batch_async(windows[i % 2], scorer, top_k=k))

    sample = queries[:256]
    _s, s_slots, s_keys = dix.query_batch_async(sample, scorer, top_k=k).get_arrays()
    hits = total = 0
    for qi, q in enumerate(sample):
        o_keys = {r.key for r in ix.query(q, bm25.new(), pdev.whitespace_tokenizer, [1.0])[:k]}
        d_keys = {int(x) for x, sl in zip(s_keys[qi], s_slots[qi]) if sl >= 0}
        hits += len(o_keys & d_keys)
        total += len(o_keys)
    recall = hits / max(total, 1)
    log(f"recall@{k} against the f64 oracle on {len(sample)} queries: {recall!r}")
    assert recall >= 0.999, recall

    errs, times = check_window_classes(dix, dispatches, scorer, k)
    return launches, errs, times, ix, dix, windows


def reset_bm25_counts():
    for counts in (fq.launches, fm.launches):
        for key in counts:
            counts[key] = 0
    pdev.metrics.reset()


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


def phase_ranges(ix, dix, window, scorer, errs, times):
    """Term-range jobs at full size (phase 3r); adds K5's checks on the
    window's range classes to ``errs`` / ``times``.  Returns K5's launches
    over the cold and the warm window."""
    import dataclasses

    k = 10
    w, rq = range_window(window)
    shapes, packed = [], []
    real_merge, real_pack = pdev.merge_scores_topk_fused, dix.pack_dispatches

    def merge_spy(key, *a, **kw):
        shapes.append(tuple(key.shape))
        return real_merge(key, *a, **kw)

    def pack_spy(n, plan):
        packed.append(real_pack(n, plan))
        return packed[-1]

    reset_bm25_counts()
    pdev.merge_scores_topk_fused, dix.pack_dispatches = merge_spy, pack_spy
    ms = {}
    try:
        for run in ("cold", "warm"):
            packed.clear()
            t = time.perf_counter()
            _s, slots, _keys = dix.query_batch_async(w, scorer, top_k=k).get_arrays()
            torch.cuda.synchronize()
            ms[run] = 1e3 * (time.perf_counter() - t)
    finally:
        pdev.merge_scores_topk_fused = real_merge
        del dix.pack_dispatches
    counts = {**fq.launches, **fm.launches}
    ctr = pdev.metrics.snapshot()["counters"]
    routes = {}
    for idxs, _jobs, nc, _nj, rng in packed[-1]:
        route = "range+K5" if rng else "K1" if nc * dix.CHUNK <= pdev._FUSED_MAX_LANES else "K3+K5"
        r = routes.setdefault(route, [0, 0])
        r[0] += 1
        r[1] += len(idxs)
    lanes = [L for _B, L in shapes]
    plan, fallback = dix.plan_batch(w, TOK, scorer)
    range_host = sorted(set(fallback) & set(rq))
    log(f"3r window ({len(w)} queries, {len(rq)} with a range term): cold {ms['cold']:.3f} ms, "
        f"warm {ms['warm']:.3f} ms submit to drained")
    log(f"3r classes of the warm window by route (dispatches, rows): {routes}; heavy-cache "
        f"hits {int(ctr.get('heavy_cache_hits', 0))}, misses {int(ctr.get('heavy_cache_misses', 0))}; "
        f"host rows {int(ctr.get('device_fallback_queries', 0))} ({len(range_host)} of range queries)")
    log(f"3r launches over cold + warm: {counts}; K5 L from {min(lanes)} to {max(lanes)}")
    assert plan.has_range[rq].all() and plan.has_range.sum() == len(rq)
    assert not range_host and counts["merge_topk"] > 0 and routes.get("range+K5"), (range_host, counts)
    profile_windows(lambda i: dix.query_batch_async(w, scorer, top_k=k), n=2)

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
    want_keys = []
    for j, q in enumerate(sub):
        want = scorer.vectorized_query(ix, q, TOK, top_k=k)
        got = [(int(key), float(sc)) for key, sc, sl in zip(k_f[j], s_f[j], sl_f[j]) if sl >= 0]
        assert len(got) == len(want), (q, len(got), len(want))
        want_keys.append({r.key for r in want})
        hits += sum(key in want_keys[-1] for key, _sc in got)
        total += len(want)
        for (_key, sc), r in zip(got, want):
            rel = max(rel, abs(sc - r.score) / max(abs(r.score), 1e-30))
    recall = hits / max(total, 1)
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
    for _idxs, jobs_flat, nc, _nj, rng in packed[-1]:
        if not rng:
            continue
        key, score = pdev.staged_lanes(
            scorer, dix.rec, dix.field_avg, ones, torch.from_numpy(jobs_flat).cuda(), aux,
            chunk=dix.CHUNK, qterm_bits=QB, num_fields=1, num_chunks=nc, use_ranges=True,
        )
        res = check_merge(key, score, min(k, nc * dix.CHUNK), f"3r class nc={nc}", quiet=True)
        add_merge(errs, times, res)
        k5 = [max(k5[0], res[0])] + [a + b for a, b in zip(k5[1:], res[1:4])]
        n += 1
    log(f"3r K5 on the window's {n} range classes: max_abs_err {k5[0]:.3g}, kernel "
        f"{k5[1]:.4f} ms, plain {k5[2]:.4f} ms, bound {k5[3]:.4f} ms (bytes)")
    for q in ("t0", "t00", "t1"):
        plan_q, _fb = dix.plan_batch([q], TOK, scorer)
        (_i, jobs_flat, nc, _nj, rng), = dix.pack_dispatches(1, plan_q)
        key, score = pdev.staged_lanes(
            scorer, dix.rec, dix.field_avg, ones, torch.from_numpy(jobs_flat).cuda(), aux,
            chunk=dix.CHUNK, qterm_bits=QB, num_fields=1, num_chunks=nc, use_ranges=rng,
        )
        kq = dix.config.heavy_cache_top_k if plan_q.nchunks[0] >= dix.config.heavy_cache_min_chunks else k
        err = check_merge(key, score, kq, f"3r {q}: range class nc={nc} L={nc * dix.CHUNK} k={kq}")[0]
        errs["merge_topk"] = max(errs["merge_topk"], err)
        del key, score
    return counts["merge_topk"]


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
    torch.cuda.synchronize()
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
    F, Cw = dix.num_fields, dix.CHUNK
    for (b_pad, b_out, nj, nc, _fast), route, jobs, qlen in z2o_window_classes(dix, queries, k):
        label = f"z2o window class nc={nc} nj={nj} rows={b_out}/{b_pad}"
        if route != "fused_z2o":
            log(f"{label}: route {route} (torch program, no kernel)")
            continue
        c_start, c_skip, c_len, c_qterm, c_rank, c_score = pz.expand_chunks_z2o(jobs, Cw, nc)
        args = (dix.rec, c_start, c_skip, c_len, c_qterm, c_score, c_rank, qlen)
        kk = min(k, nc * Cw)
        err, ms, plain_ms = check_z2o(args, Cw, kk, F, label)
        bound_ms, by = z2o_bound(args, kk, F)
        err_max = max(err_max, err)
        tot[0] += ms
        tot[1] += plain_ms
        tot[2] += bound_ms
        tot[3] = by
        log(f"{label}: route fused_z2o, ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
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


def reset_z2o_counts():
    for counts in (fz.launches, pz.launches):
        for key in counts:
            counts[key] = 0
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
    t = time.perf_counter()
    scores, slots, keys = pz.z2o_query_batch_async(dix, window, TOK, k, fmt="f32").get_arrays()
    torch.cuda.synchronize()
    log(f"1M z2o window ({WINDOW} queries): {1e3 * (time.perf_counter() - t):.3f} ms "
        f"submit to drained, launches {z2o_counts()}")
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
    for i in range(4):  # warm-up: plan pools, first launches
        submit(i).get_arrays()
    torch.cuda.synchronize()
    log(f"z2o warm-up (2 passes): {time.time() - t1:.1f} s")
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
        "(host clock, pipeline of 4; for information only)")
    hist = pdev.metrics.snapshot()["histograms"]
    log("z2o host phases per window (mean ms, host clock): " + ", ".join(
        f"{name} {hist[name]['mean_us'] / 1e3:.3f}"
        for name in ("z2o/plan", "z2o/pack", "z2o/h2d", "z2o/dispatch", "query/fetch", "query/drain")
        if name in hist
    ))
    profile_windows(submit)

    sample = windows[0][:256]
    scores, slots, keys_ = pz.z2o_query_batch_async(dix, sample, TOK, k, fmt="f32").get_arrays()
    recall, recall_tie, rel = z2o_oracle_check(ix, sample, scores, slots, keys_, k)
    log(f"z2o recall@{k} against the f64 oracle on {len(sample)} queries: {recall!r} "
        f"(tie-aware {recall_tie!r}); max score rel err {rel:.3g}")
    assert recall_tie >= 0.999, recall_tie
    err, tot = check_z2o_window(dix, windows[0], k)
    return counts, err, tot


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
    launches, win_errs, times, ix, dix, windows = phase_main(scorer, card)
    log(f"K5 launches on the main path: {launches['merge_topk']}")
    launches["merge_topk"] += phase_ranges(ix, dix, windows[0], scorer, win_errs, times)
    phase_z2o_1m(ix, dix, windows[0])
    del ix, dix
    z2o_counts_, z2o_err, z2o_times = phase_z2o_main(card)
    launches["fused_z2o"] = z2o_counts_["fused_z2o"]
    win_errs["fused_z2o"] = z2o_err
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
