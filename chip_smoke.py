#!/usr/bin/env python3
"""GPU smoke run of the torch port (probly_search_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  1. environment: torch / CUDA versions, the card's name and power limit,
     and the kernel build from probly_search_tpu_torch/csrc;
  2. each kernel against its plain torch version on seeded chunk tables
     (C = 1024, B = 1024; phase "full" at NC 2..16, phase "lanes" at NC 24
     and 32; k 10 and 128), with bit-equal repeat runs and CUDA-event times;
  3. the main path at real size: BM25 top-10 over the 1,000,000-doc bench
     corpus (bench.py's generator), two 16,384-query windows, 8 windows
     served through DeviceIndex.query_batch_async with a depth-4 pipeline
     and paired late drains; launch counts, ms/window, QPS, recall@10
     against the f64 oracle on 256 queries, and every class of the first
     window held kernel against plain on its real tables.
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
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25  # noqa: E402
from probly_search_tpu_torch.index import device as pdev  # noqa: E402
from probly_search_tpu_torch.ops import _build  # noqa: E402
from probly_search_tpu_torch.ops import fused_query as fq  # noqa: E402
from probly_search_tpu_torch.testing import ATOL, RTOL, assert_topk_agree  # noqa: E402

SEED = 0
C = 1024
QB = 4  # qterm bits
FULL_NC = (2, 3, 4, 6, 8, 12, 16)
LANES_NC = (24, 32)
TOP_KS = (10, 128)
N_DOCS = 1_000_000
WINDOW = 16384
KERNELS = {
    "full": (
        "fused_query_full",
        "probly_search_tpu/ops/pallas_query.py:268 (fused_query_topk phase full; "
        "_query_kernel :42, merge_body ops/pallas_merge.py:252)",
    ),
    "lanes": (
        "fused_query_lanes",
        "probly_search_tpu/ops/pallas_query.py:216 (fused_query_topk phase lanes)",
    ),
}


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


def synthetic_rec(rng, n_docs=20_000, n_terms=6000):
    """Posting records int32[4, P + C] of one field: ascending doc runs per
    term, tf 1..3, doc lengths 3..12 (f32 bits), 2% latently dead docs.
    Few docs, so chunks of one row often share docs."""
    doc_alive = (rng.random(n_docs) > 0.02).astype(np.int32)
    doc_len = rng.integers(3, 13, n_docs).astype(np.float32)
    lens = np.minimum(rng.zipf(1.3, n_terms) * 40, 6000)
    docs = [np.sort(rng.choice(n_docs, size=int(n), replace=False)) for n in lens]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    post_doc = np.concatenate(docs).astype(np.int32)
    P = len(post_doc)
    rec = np.zeros((4, P + C), np.int32)
    rec[0] = -1
    rec[0, :P] = post_doc
    rec[1, :P] = rng.integers(1, 4, P)
    rec[2, :P] = doc_len[post_doc].view(np.int32)
    rec[3, :P] = doc_alive[post_doc]
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
    dev = lambda a, dt=torch.int32: torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
    return (dev(c_start), dev(c_skip), dev(c_len), dev(c_qterm), dev(c_scale, torch.float32))


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
    # merged top-k through the torch merge, against the plain full phase
    ms_, md_ = pdev.merge_scores_topk_presorted(lk, ls, k, QB, C, True)
    fs, fd = fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **{**kw, "phase": "full"})
    err = max(err, assert_topk_agree(ms_.cpu(), md_.cpu(), fs.cpu(), fd.cpu()))
    ms = cuda_ms(lambda: fq.fused_query_topk(scorer, rec, *tables, scalars, **kw))
    plain_ms = cuda_ms(lambda: fq.fused_query_topk_reference(scorer, rec, *tables, scalars, **kw))
    return err, ms, plain_ms


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
                log(f"kernel {label:22s} B=1024 L={NC * C:6d}: ok, max_abs_err {err:.3g}, "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return errs


# --------------------------------------------------------------------- #
# phase 3: main path                                                     #
# --------------------------------------------------------------------- #


def window_classes(dix, queries, scorer, k):
    """(dispatches, class_specs) the port packs for ``queries``."""
    plan, _fb = dix.plan_batch(queries, pdev.whitespace_tokenizer, scorer)
    tkey = (pdev._scorer_cache_key(scorer), k, "slots20", len(queries))
    return dix._pack_dispatches_template(len(queries), plan, tkey)


def check_window_classes(dix, dispatches, scorer, k):
    """Kernel against plain on every class of a real window (f32 scores)."""
    errs = {"full": 0.0, "lanes": 0.0}
    times = {"full": [0.0, 0.0], "lanes": [0.0, 0.0]}
    scalars = torch.cat([dix.field_avg, torch.ones(1, device="cuda")])
    for idxs, jobs_flat, nc, nj in dispatches:
        jobs = torch.from_numpy(jobs_flat).cuda().reshape(jobs_flat.shape[0], nj, 3)
        tables = pdev.expand_chunks(jobs, dix.CHUNK, nc)
        phase = "full" if nc * dix.CHUNK <= pdev._FUSED_MAX_LANES else "lanes"
        kk = min(k, nc * dix.CHUNK)
        label = f"window class nc={nc} nj={nj} rows={jobs_flat.shape[0]} ({phase})"
        check = check_full if phase == "full" else check_lanes
        err, ms, plain_ms = check(scorer, dix.rec, tables, scalars, kk, label)
        errs[phase] = max(errs[phase], err)
        times[phase][0] += ms
        times[phase][1] += plain_ms
        log(f"{label}: ok, max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return errs, times


def profile_windows(dix, windows, scorer, k, n=4):
    """Windows one at a time (submit, drain) under torch.profiler: wall
    time per window, device busy time per window, kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            dix.query_batch_async(windows[i % 2], scorer, top_k=k).get_arrays()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / n
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
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
    for _idxs, jobs_flat, nc, nj in dispatches:
        phase = "full" if nc * dix.CHUNK <= pdev._FUSED_MAX_LANES else "lanes"
        log(f"class nc={nc:5d} nj={nj:4d} rows={jobs_flat.shape[0]:6d} phase={phase}")

    # 8 windows, depth-4 pipeline, drained in pairs one pair late.
    lat_ms, out = [], []

    def drain_pair(pair):
        for t_submit, h in pair:
            out.append(h.get_arrays())
            lat_ms.append(1e3 * (time.perf_counter() - t_submit))

    for key in fq.launches:
        fq.launches[key] = 0
    pdev.metrics.reset()
    t3 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        futs, pending = [], []
        for i in range(8):
            t_submit = time.perf_counter()
            pending.append((t_submit, dix.query_batch_async(windows[i % 2], scorer, top_k=k)))
            if len(pending) == 2:
                futs.append(pool.submit(drain_pair, pending))
                pending = []
            while len(futs) >= 2:
                futs.pop(0).result()
        for f in futs:
            f.result()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t3
    launches = dict(fq.launches)
    log(f"launch counts over the 8 served windows: {launches}")
    assert launches["full"] > 0 and launches["lanes"] > 0, launches
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
    profile_windows(dix, windows, scorer, k)

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
    return launches, errs, times


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
    launches, win_errs, times = phase_main(scorer, card)
    record = []
    for phase, (name, replaces) in KERNELS.items():
        record.append({
            "name": name,
            "route": "cuda",
            "source": "probly_search_tpu_torch/csrc/fused_query.cu",
            "replaces": replaces,
            "launches": launches[phase],
            "max_abs_err": max(errs[phase], win_errs[phase]),
            "ms": times[phase][0],
            "plain_ms": times[phase][1],
        })
    assert "jax" not in sys.modules, "the port must not import jax"
    log(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
