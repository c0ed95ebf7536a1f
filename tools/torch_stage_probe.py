#!/usr/bin/env python3
"""Where the device time of the port's merge kernels goes, on one CUDA card.

    python3 tools/torch_stage_probe.py [--k1-only | --k5-only]
    python3 tools/torch_stage_probe.py --window [--root DIR] [--stages]
    python3 tools/torch_stage_probe.py --z2o-window [--root DIR] [--stages]

K1 (the fused BM25 kernel, phase "full"): its block body (``full_phase`` in
csrc/fused_query.cu, instantiated with CLOCK) reads clock64() at each stage
boundary (gather, sort, doc totals, select, write); printed as the share of
a block's cycles per stage beside the kernel's CUDA-event time, on
chip_smoke.py's seeded tables (C = 1024, B = 1024, k 10 and 128).

K5 (the standalone merge): ``merge_scores_topk_fused`` on seeded rows of the
term-range window's class sizes and of t1 / t00 / t0, under torch.profiler:
device time per kernel name and launches per call.

``--window``: K1 on the real classes of chip_smoke.py's BM25 window (the
1,000,000-doc bench corpus, the first 16,384 queries, top-10), each class
timed with CUDA events (median of 20), summed over the window; K3 on its
classes past 16,384 lanes and on chip_smoke.py's seeded lanes tables
(NC 24 and 32, B = 1,024), timed with CUDA events and as device time
(one call captured in a CUDA graph, its replay timed after a write that
evicts the L2); and K5 merging those K3 lanes.

``--z2o-window``: K4 (the fused zero-to-one kernel) on every K4 class of
chip_smoke.py's z2o 50k window (benchmarks/zero_to_one_50k.py's corpus and
first 16,384-query window, top-10), CUDA events and graph-replay device
time (L2 cold, as for K3) per class, summed over the window.

With either window the package comes from DIR (default: this checkout), so
two checkouts run in turns on one card (parent, change, change, parent),
each in its own process; the last line is one JSON object.  ``--stages``
adds the cycle shares per class (this checkout's csrc only): K1's gather /
sort / totals / select / write, K4's gather / merge / per-doc reduction /
top-k / write.

Prints the card's name and power limit first.  Builds into build/probe/.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The full phase of csrc/fused_query.cu launched with a cycle buffer: its
# blocks read clock64() at each stage boundary and write their cycles per
# stage.
CLOCKED = r"""
#include "@CSRC@/fused_query.cu"
namespace {
template <int NT, int MAXS, int MINB>
__global__ void __launch_bounds__(NT, MINB) k1_clocked(QueryArgs a, float* out_s, int32_t* out_d,
                                                       long long* clk) {
  full_phase<NT, MAXS, true>(a, out_s, out_d, clk);
}
}  // namespace
extern "C" int k1_clocked_launch(const int32_t* rec, long long rs, const int32_t* cs,
    const int32_t* ck, const int32_t* cl, const int32_t* cq, const float* sc, const float* scal,
    int B, int NC, int C, int k, int qb, float k1, float b, int excl, int key_bits, int ring,
    long long smem, float* out_s, int32_t* out_d, long long* clk, void* stream) {
  QueryArgs a = make_args(rec, rs, cs, ck, cl, cq, sc, scal, NC, C, 1, k, qb, k1, b, excl);
  a.ring = ring;
  a.key_bits = key_bits;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
#define K1C(NT, M, MB) \
  e = cudaFuncSetAttribute(k1_clocked<NT, M, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
  if (e) return (int)e; \
  k1_clocked<NT, M, MB><<<B, NT, smem, st>>>(a, out_s, out_d, clk);
  int v = 0;
  const int want = full_variant(NC * C);
#define PICK(NT, M, MB) if (v++ == want) { K1C(NT, M, MB) }
  FULL_VARIANTS(PICK)
  return (int)cudaGetLastError();
}
"""


# K4 (csrc/fused_z2o.cu) launched with a cycle buffer, the same way.
CLOCKED_Z2O = r"""
#include "@CSRC@/fused_z2o.cu"
namespace {
template <int NT, int MAXS, int MINB>
__global__ void __launch_bounds__(NT, MINB) k4_clocked(Z2oArgs a, float* out_s, int32_t* out_d,
                                                      long long* clk) {
  z2o_body<NT, MAXS, true>(a, out_s, out_d, clk);
}
}  // namespace
extern "C" int k4_clocked_launch(const int32_t* rec, long long rs, const int32_t* cs,
    const int32_t* ck, const int32_t* cl, const int32_t* cq, const float* sc, const int32_t* cr,
    const float* ql, int B, int NC, int C, int F, int k, int key_bits, long long smem, void* cand,
    float* out_s, int32_t* out_d, long long* clk, void* stream) {
  const Z2oArgs a = make_z2o_args(rec, rs, cs, ck, cl, cq, sc, cr, ql, NC, C, F, k, key_bits, cand);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  int v = 0;
  const int want = z2o_variant(NC * C);
#define K4C(NT, M, MB) \
  if (v++ == want) { \
    e = cudaFuncSetAttribute(k4_clocked<NT, M, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             (int)smem); \
    if (e) return (int)e; \
    k4_clocked<NT, M, MB><<<B, NT, smem, st>>>(a, out_s, out_d, clk); \
  }
  Z2O_VARIANTS(K4C)
  return (int)cudaGetLastError();
}
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` with a cold L2: the call captured
    into a CUDA graph, and before each replay a write of four times the
    card's L2 evicts what earlier replays left there; the replay alone is
    timed with CUDA events (median of ``reps``).  The write is queued
    first, so the host's launch of the replay hides behind it."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
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
    g.reset()
    del flush
    return float(np.median(times))


def build_clocked(kind: str = "k1"):
    """Build the clocked copy of K1 (``kind`` "k1") or K4 ("k4") from this
    checkout's csrc into build/probe/."""
    from probly_search_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    src, so = os.path.join(out, f"clocked_{kind}.cu"), os.path.join(out, f"libclocked_{kind}.so")
    text = CLOCKED if kind == "k1" else CLOCKED_Z2O
    with open(src, "w") as f:
        f.write(text.replace("@CSRC@", str(_build.CSRC)))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    p, i, fl, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    if kind == "k1":
        lib.k1_clocked_launch.argtypes = [p, ll, p, p, p, p, p, p, i, i, i, i, i, fl, fl, i, i, i,
                                          ll, p, p, p, p]
        lib.k1_clocked_launch.restype = i
    else:
        lib.k4_clocked_launch.argtypes = [p, ll, p, p, p, p, p, p, p, i, i, i, i, i, i, ll, p, p, p,
                                          p, p]
        lib.k4_clocked_launch.restype = i
    return lib


def clocked_run(lib, rec, tables, scal, NC, C, k, key_bits):
    """One clocked launch on ``tables``: (CUDA-event ms, share of a block's
    cycles per stage, mean cycles a live block)."""
    import torch

    from probly_search_tpu_torch.ops import fused_query as fq

    B = tables[0].shape[0]
    ring, smem = fq.full_launch(NC * C, C, 1, k, fq.device_smem(0)[1])
    out_s = torch.empty((B, k), dtype=torch.float32, device="cuda")
    out_d = torch.empty((B, k), dtype=torch.int32, device="cuda")
    clk = torch.zeros((B, 5), dtype=torch.int64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.k1_clocked_launch(rec.data_ptr(), rec.stride(0), *(x.data_ptr() for x in tables),
                                    scal.data_ptr(), B, NC, C, k, 4, 1.2, 0.75, 1, key_bits, ring,
                                    smem, out_s.data_ptr(), out_d.data_ptr(), clk.data_ptr(), st)
        assert err == 0, err

    ms = cuda_ms(run)
    live = clk.sum(1) > 0
    share = (clk[live].double().sum(0) / clk[live].double().sum()).tolist()
    return ms, share, clk[live].double().sum(1).mean().item()


def clocked_z2o_run(lib, args, C, F, k, key_bits):
    """One clocked K4 launch on ``args`` = (rec, c_start, c_skip, c_len,
    c_qterm, c_score, c_rank, qlen): (share of a live block's cycles per
    stage, mean cycles a live block)."""
    import torch

    from probly_search_tpu_torch.ops import fused_z2o as fz

    rec, *tables = args
    B, NC = tables[0].shape
    smem, words = fz.z2o_launch(NC * C, C, F, k, fz.device_avail(0))
    cand = torch.empty((B, words), dtype=torch.int64, device="cuda") if words else None
    out_s = torch.empty((B, k), dtype=torch.float32, device="cuda")
    out_d = torch.empty((B, k), dtype=torch.int32, device="cuda")
    clk = torch.zeros((B, 5), dtype=torch.int64, device="cuda")
    err = lib.k4_clocked_launch(rec.data_ptr(), rec.stride(0), *(x.data_ptr() for x in tables),
                                B, NC, C, F, k, key_bits, smem,
                                None if cand is None else cand.data_ptr(),
                                out_s.data_ptr(), out_d.data_ptr(), clk.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    torch.cuda.synchronize()
    live = clk.sum(1) > 0
    share = (clk[live].double().sum(0) / clk[live].double().sum()).tolist()
    return share, clk[live].double().sum(1).mean().item()


def probe_k1():
    """K1 on the seeded tables, cycles per stage."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    from probly_search_tpu_torch.ops.fused_query import padded_rows

    lib = build_clocked()
    rng = np.random.default_rng(cs.SEED)
    rec_np, starts, lens = cs.synthetic_rec(rng)
    rec = padded_rows(rec_np, "cuda")
    scal = torch.tensor([7.5, 1.0], dtype=torch.float32, device="cuda")
    print("K1, B = 1024, C = 1024: kernel ms (CUDA events), then the share of a block's cycles "
          "per stage (gather / sort / totals / select / write)")
    for NC in cs.FULL_NC:
        t = cs.synthetic_tables(rng, starts, lens, 1024, NC)
        for k in cs.TOP_KS:
            ms, share, cyc = clocked_run(lib, rec, t, scal, NC, cs.C, k, cs.SYN_KEY_BITS)
            print(f"{NC:2d} {k:4d}  {ms:.4f} ms  " + " / ".join(f"{x:.3f}" for x in share)
                  + f"  ({cyc:.0f} cycles a block)", flush=True)


def probe_window(root: str, stages: bool):
    """K1 on the real classes of the BM25 window, with the package of ``root``."""
    sys.path.insert(0, root)
    import torch

    from bench import make_corpus, make_queries
    from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25
    from probly_search_tpu_torch.index import device as pdev
    from probly_search_tpu_torch.ops import fused_merge as fm
    from probly_search_tpu_torch.ops import fused_query as fq
    from probly_search_tpu_torch.ops.fused_query import padded_rows

    assert fq.__file__.startswith(root), fq.__file__
    t = time.time()
    vocab, cdf, texts = make_corpus(1_000_000, 50_000, 8)
    ix = Index(1, config=IndexConfig(result_format="slots20"))
    ix.add_documents_columnar(list(range(1_000_000)), [texts])
    dix = DeviceIndex(ix, device="cuda")
    window = make_queries(vocab, cdf, 2 * 16384, 3)[:16384]
    scorer = bm25.new()
    dix.query_batch_async(window, scorer, top_k=10).get_arrays()  # plan pools, template
    torch.cuda.synchronize()
    print(f"index and warm-up: {time.time() - t:.1f} s", flush=True)
    plan, _fb = dix.plan_batch(window, pdev.whitespace_tokenizer, scorer)
    if hasattr(dix, "prune"):  # the window's classes as served (block-max pruning)
        plan = dix.prune(plan, scorer, 10, [1.0] * dix.num_fields)
    tkey = (pdev._scorer_cache_key(scorer), 10, "slots20", len(window))
    dispatches, _specs = dix._pack_dispatches_template(len(window), plan, tkey)
    scal = torch.cat([dix.field_avg, torch.ones(1, device="cuda")])
    key_bits = getattr(dix, "_key_bits", 31)
    extra = {"key_bits": key_bits} if "key_bits" in inspect.signature(fq.fused_query_topk).parameters else {}
    lib = build_clocked() if stages else None
    classes, k5_ms, k3 = [], 0.0, []

    def lanes(tables, C, label):
        def call():
            return fq.fused_query_topk(scorer, rec_of[label], *tables, scal, chunk=C, k=10,
                                       qterm_bits=4, num_fields=1, phase="lanes")

        B, NC = tables[0].shape
        row = {"k3": label, "rows": B, "nc": NC, "event_ms": cuda_ms(call),
               "graph_ms": graph_ms(call)}
        print(json.dumps(row), flush=True)
        k3.append(row)
        return call()

    rec_of = {"window": dix.rec}
    for _idxs, jobs_flat, nc, nj, _rng, *_cw in dispatches:  # 5-tuples before light classes
        L = nc * dix.CHUNK
        jobs = torch.from_numpy(jobs_flat).cuda().reshape(jobs_flat.shape[0], nj, 3)
        tables = pdev.expand_chunks(jobs, dix.CHUNK, nc)
        k = min(10, L)
        if L > pdev._FUSED_MAX_LANES:  # K3's lanes, merged by K5
            ls, lk = lanes(tables, dix.CHUNK, "window")
            k5_ms += cuda_ms(lambda: fm.merge_scores_topk_fused(lk, ls, k, 4, run=dix.CHUNK, excl=True,
                                                                max_seg=nc, **extra))
            continue
        ms = cuda_ms(lambda: fq.fused_query_topk(scorer, dix.rec, *tables, scal, chunk=dix.CHUNK, k=k,
                                                 qterm_bits=4, num_fields=1, **extra))
        row = {"nc": nc, "rows": int(jobs_flat.shape[0]), "ms": ms}
        if lib is not None:
            _ms, share, cyc = clocked_run(lib, dix.rec, tables, scal, nc, dix.CHUNK, k, key_bits)
            row["share"] = [round(x, 4) for x in share]
            row["cycles"] = round(cyc)
        print(json.dumps(row), flush=True)
        classes.append(row)
    # K3 on chip_smoke.py's seeded lanes tables (its phase 2).
    import chip_smoke as cs

    assert cs.__file__.startswith(root), cs.__file__
    rng = np.random.default_rng(cs.SEED)
    rec_np, starts, lens = cs.synthetic_rec(rng)
    rec_of["seeded"] = padded_rows(rec_np, "cuda")
    scal = torch.tensor([7.5, 1.0], dtype=torch.float32, device="cuda")
    for NC in cs.LANES_NC:
        lanes(cs.synthetic_tables(rng, starts, lens, 1024, NC), cs.C, "seeded")
    print(json.dumps({"root": root, "k1_window_ms": sum(c["ms"] for c in classes), "k5_lanes_ms": k5_ms,
                      "classes": [[c["nc"], c["rows"], c["ms"]] for c in classes],
                      "k3": [[c["k3"], c["nc"], c["rows"], c["event_ms"], c["graph_ms"]]
                             for c in k3]}))


def probe_z2o_window(root: str, stages: bool):
    """K4 on every K4 class of the z2o 50k window, with the package of
    ``root``."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    from probly_search_tpu_torch import Index
    from probly_search_tpu_torch.ops import fused_merge as fm
    from probly_search_tpu_torch.ops import fused_z2o as fz
    from probly_search_tpu_torch.ops import z2o_device as pz

    assert fz.__file__.startswith(root) and cs.__file__.startswith(root), (fz.__file__, cs.__file__)
    t = time.time()
    keys, cols, windows = cs.z2o_50k()
    ix = Index(2)  # on the card
    ix.add_documents_columnar(keys, cols)
    dix = ix.device_index()
    k = 10
    pz.z2o_query_batch_async(dix, windows[0], cs.TOK, k, fmt="slots").get_arrays()  # warm-up
    torch.cuda.synchronize()
    print(f"index and warm-up: {time.time() - t:.1f} s", flush=True)
    F, Cw = dix.num_fields, dix.CHUNK
    key_bits = fm.key_bits_for(dix.num_slots, 5)
    takes_bits = "key_bits" in inspect.signature(fz.fused_z2o_topk).parameters
    extra = {"key_bits": key_bits} if takes_bits else {}
    lib = build_clocked("k4") if stages else None
    classes = []
    for spec, route, jobs, qlen in cs.z2o_window_classes(dix, windows[0], k):
        _b_pad, b_out, nj, nc, _fast = spec
        if route != "fused_z2o":
            continue
        c_start, c_skip, c_len, c_qterm, c_rank, c_score = pz.expand_chunks_z2o(jobs, Cw, nc)
        args = (dix.rec, c_start, c_skip, c_len, c_qterm, c_score, c_rank, qlen)
        kk = min(k, nc * Cw)

        def call(args=args, kk=kk):
            return fz.fused_z2o_topk(*args, chunk=Cw, k=kk, num_fields=F, **extra)

        row = {"nc": nc, "nj": nj, "rows": b_out, "ms": cuda_ms(call), "graph_ms": graph_ms(call)}
        if lib is not None:
            share, cyc = clocked_z2o_run(lib, args, Cw, F, kk, key_bits)
            row["share"] = [round(x, 4) for x in share]
            row["cycles"] = round(cyc)
        print(json.dumps(row), flush=True)
        classes.append(row)
    print(json.dumps({"root": root, "k4_window_ms": sum(c["ms"] for c in classes),
                      "k4_window_graph_ms": sum(c["graph_ms"] for c in classes),
                      "classes": [[c["nc"], c["rows"], c["ms"], c["graph_ms"]] for c in classes]}))


def probe_k5():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile

    from probly_search_tpu_torch.ops import fused_merge as fm

    rng = np.random.default_rng(5)
    shapes = [(2, 3072, 10), (1, 16384, 10), (2, 24576, 10), (1, 49152, 10), (2, 65536, 10),
              (1, 131072, 10), (1, 524288, 10), (1, 6291456, 128), (1, 1 << 23, 128)]
    print("K5 by kernel (run 0, seeded rows as chip_smoke's merge_rows_full, key_bits 24), per call")
    for B, L, k in shapes:
        key, score = cs.merge_rows_full(rng, B, L)
        fm.merge_scores_topk_fused(key, score, k, cs.QB, key_bits=24)
        torch.cuda.synchronize()
        n = 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fm.merge_scores_topk_fused(key, score, k, cs.QB, key_bits=24)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        tot = sum(e.self_device_time_total for e in ev) / 1e3 / n
        parts = ", ".join(f"{kernel_name(e.key)} {e.self_device_time_total / 1e3 / n:.4f} ms x{e.count / n:g}"
                          for e in sorted(ev, key=lambda e: -e.self_device_time_total))
        print(f"B={B} L={L} k={k}: {tot:.4f} ms/call; {parts}", flush=True)
        del key, score


def kernel_name(key: str) -> str:
    """A profiler kernel name without its namespace and arguments."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k1-only", action="store_true")
    ap.add_argument("--k5-only", action="store_true")
    ap.add_argument("--window", action="store_true", help="K1 on the BM25 window's real classes")
    ap.add_argument("--z2o-window", action="store_true", help="K4 on the z2o 50k window's classes")
    ap.add_argument("--root", default=ROOT, help="checkout whose package a window runs")
    ap.add_argument("--stages", action="store_true", help="a window: also the cycles per stage")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_stage_probe: no CUDA device is available")
    print(card(), flush=True)
    if args.window:
        probe_window(os.path.abspath(args.root), args.stages)
        return
    if args.z2o_window:
        probe_z2o_window(os.path.abspath(args.root), args.stages)
        return
    if not args.k5_only:
        probe_k1()
    if not args.k1_only:
        probe_k5()


if __name__ == "__main__":
    main()
