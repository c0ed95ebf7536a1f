"""Seeded posting records and chunk tables for the torch port's kernel tests
(JAX-free, so the CUDA tests also run where JAX is not installed)."""

import numpy as np
import torch

from probly_search_tpu_torch.index.device import ClassGraphs
from probly_search_tpu_torch.models.base import BaseScoreCalculator

QB = 4  # qterm bits of the merge key


class TfBoost(BaseScoreCalculator):
    """The user scorer of tests/test_custom_device_scorer.py on the port:
    score = sum_f tf_f * boost_f per posting (its device half in torch),
    max within a term, sum across terms, as any one-phase scorer."""

    device_needs_finalize = False
    device_excludes_nonpositive = True

    def device_cache_key(self):
        return ("tfboost",)

    def score(self, before, pointer, details, node, field_data, term):
        s = float(sum(tf * b for tf, b in zip(pointer.term_frequency, field_data.fields_boost)))
        return s if s > 0 else None

    def device_term_scale(self, df, n_docs, expansion_boost):
        return np.ones(len(df), np.float32)

    def device_score_lanes(self, lanes):
        per_field = lanes.tf * lanes.fields_boost[:, None]
        return per_field.sum(dim=-2) * lanes.scale  # scale is per chunk or per lane


class EagerClasses(ClassGraphs):
    """``ClassGraphs`` with each class's step run eagerly, not captured and
    replayed: the step that a key's first sight builds is kept and run for
    every later class of that key, as a graph keeps its capture.  Set as a
    DeviceIndex's ``_class_graphs`` (or, one per device, a
    ShardedDeviceIndex's), it drives the class-graph path (keys, static
    inputs, steps, copies out) on any device, the CPU included; on the card
    it is the eager baseline the graphs are held against and timed beside.
    ``windows`` lists each run's keys."""

    def __init__(self, device) -> None:
        super().__init__(device)
        self.windows = []

    def run(self, classes, concat: bool = False):
        self.windows.append([key for key, _make, _pieces in classes])
        return super().run(classes, concat)

    def _replay(self, key, make_step, pieces):
        step = self._graphs.get(key)
        if step is None:
            step = self._graphs[key] = make_step()
        words = torch.cat([p.to(self.device, non_blocking=True) for p in pieces])
        return step(words)


def make_rec(rng, F=1, n_docs=400, n_terms=120, C=128):
    """Posting records int32[R, P + C]: ascending doc runs per term, 5% of
    docs latently dead.  Few docs, so chunks of one row share docs."""
    R = 4 if 2 + 2 * F <= 4 else -(-(2 + 2 * F) // 8) * 8
    doc_alive = (rng.random(n_docs) > 0.05).astype(np.int32)
    doc_len = rng.integers(2, 12, (n_docs, F)).astype(np.float32)
    lens = rng.integers(1, 300, n_terms)
    docs = [np.sort(rng.choice(n_docs, size=int(n), replace=False)) for n in lens]
    post_doc = np.concatenate(docs).astype(np.int32)
    P = len(post_doc)
    rec = np.zeros((R, P + C), np.int32)
    rec[0] = -1
    rec[0, :P] = post_doc
    rec[1 : 1 + F, :P] = rng.integers(0, 4, (F, P))  # tf 0 in a field happens
    rec[1 + F : 1 + 2 * F, :P] = doc_len[post_doc].view(np.int32).T
    rec[1 + 2 * F, :P] = doc_alive[post_doc]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return rec, starts, lens


def make_tables(rng, starts, lens, B, NC, C=128, max_len=None, align=128):
    """[B, NC] chunk tables: slices of one term's run each (leading and
    trailing pads, payloads of at most ``max_len`` lanes), 20% dead chunks,
    row 5 empty.  Chunk starts are multiples of ``align`` (at most C)."""
    t = rng.integers(0, len(starts), (B, NC))
    o = (rng.random((B, NC)) * lens[t]).astype(np.int64)
    col = starts[t] + o
    c_start = col // align * align
    c_skip = col - c_start
    room = np.minimum(lens[t] - o, C - c_skip)
    c_len = np.minimum(room, rng.integers(1, (max_len or C) + 1, (B, NC)))
    dead = rng.random((B, NC)) < 0.2
    dead[5 % B] = True
    for a in (c_start, c_skip, c_len):
        a[dead] = 0
    c_qterm = rng.integers(0, 3, (B, NC))
    c_scale = rng.uniform(0.5, 4.0, (B, NC)).astype(np.float32)
    return [a.astype(np.int32) for a in (c_start, c_skip, c_len, c_qterm)] + [c_scale]


def to_torch(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def score_ranks(c_score):
    """Per-row dense rank of each chunk's entry score, descending, equal
    scores equal: the fused z2o kernel's secondary key (int32[B, NC])."""
    return np.stack([np.searchsorted(np.unique(-row), -row) for row in c_score]).astype(np.int32)


def make_z2o_tables(
    rng, starts, lens, B, NC, C=128, scores=(1.0, 0.75, 2.0 / 3.0, 0.5), align=128
):
    """``make_tables`` for the fused z2o kernel: (c_start, c_skip, c_len,
    c_qterm, c_score, c_rank, qlen), entry scores drawn from ``scores`` so
    that equal scores share a rank."""
    tables = make_tables(rng, starts, lens, B, NC, C=C, align=align)
    c_start, c_skip, c_len, c_qterm, _scale = tables
    c_score = rng.choice(np.asarray(scores, np.float32), (B, NC))
    qlen = rng.integers(1, 5, B).astype(np.float32)
    return [c_start, c_skip, c_len, c_qterm, c_score, score_ranks(c_score), qlen]


def merge_rows(rng, rows, n_runs, run, excl, presorted, n_docs=200):
    """Rows of the standalone merge, key int32 / score f32 [rows, n_runs * run].

    ``presorted``: ascending runs of ``run`` lanes with -1 leading pads and
    INT32_MAX trailing pads (the phase "lanes" layout), 10% of the docs dead
    (-inf on every lane of the doc).  Else unsorted lanes with INT32_MAX pads
    only (a range class).  Keys repeat (one (doc, qterm) key per expansion
    of a query term), and scores come from a few values, so that equal doc
    totals happen; ``excl`` clamps them to >= 0 as the BM25 caller does."""
    L = n_runs * run
    inv = np.int32(2**31 - 1)
    key = np.full((rows, L), inv, np.int32)
    val = rng.choice(np.array([0.5, 1.0, 1.5, 2.25, -0.75], np.float32), (rows, L))
    if excl:
        val = np.maximum(val, 0.0).astype(np.float32)
    for r in range(rows):
        if not presorted:
            docs = rng.integers(0, n_docs // 2, L)
            keys = (docs << QB) | rng.integers(0, 4, L)
            key[r] = np.where(rng.random(L) < 0.15, inv, keys)
            continue
        for c in range(n_runs):
            skip = int(rng.integers(0, run // 4 + 1))
            n = int(rng.integers(0, run - skip + 1))
            docs = np.sort(rng.choice(n_docs, size=n, replace=False))
            lo = c * run
            key[r, lo : lo + skip] = -1
            key[r, lo + skip : lo + skip + n] = (docs << QB) | int(rng.integers(0, 3))
        dead = rng.choice(n_docs, size=n_docs // 10, replace=False)
        live = (key[r] >= 0) & (key[r] != inv)
        val[r, live & np.isin(key[r] >> QB, dead)] = -np.inf
        val[r, ~live] = 0.0
    return key, val


def merge_edge_rows(rng, kind, rows, L):
    """Unsorted rows (run = 0) of the merge kernel's edge cases, key int32 /
    score f32 [rows, L]:

      "random"  docs over L / 8 slots and 4 query terms, 15% INT32_MAX pads,
                scores from four values (equal totals happen)
      "ties"    every live doc totals 1.0 (one query term, score 1.0)
      "pads"    every lane a pad
      "one"     one live lane
      "few"     five live lanes (k above the live docs)
      "high"    docs just below 2^(31 - QB) - 1: keys use all 31 bits"""
    inv = np.int32(2**31 - 1)
    key = np.full((rows, L), inv, np.int32)
    val = rng.choice(np.array([0.5, 1.0, 1.5, 2.25], np.float32), (rows, L))
    if kind in ("random", "ties", "high"):
        top = (1 << (31 - QB)) - 2
        lo = top - max(L // 8, 1) if kind == "high" else 0
        hi = top if kind == "high" else max(L // 8, 1)
        docs = rng.integers(lo, hi + (kind == "high"), (rows, L))
        qt = 0 if kind == "ties" else rng.integers(0, 1 << QB if kind == "high" else 4, (rows, L))
        key = ((docs << QB) | qt).astype(np.int32)
        key[rng.random((rows, L)) < 0.15] = inv
        if kind == "ties":
            val[:] = 1.0
    elif kind in ("one", "few"):
        for r in range(rows):
            lanes = rng.choice(L, size=min(L, 1 if kind == "one" else 5), replace=False)
            key[r, lanes] = (rng.integers(0, 1000, len(lanes)) << QB).astype(np.int32)
    elif kind != "pads":
        raise ValueError(kind)
    return key, val


# K4's edge shapes: kind -> (C, NC, F, B, k).
Z2O_EDGES = {
    "k_eq_L": (1024, 8, 4, 8, 8192),  # the largest shared memory; top-k words in scratch
    "one_lane": (128, 4, 2, 16, 10),
    "dead_docs": (128, 4, 2, 16, 10),
    "tf_zero": (128, 4, 2, 16, 10),
    "ties": (128, 4, 2, 16, 10),
    "high_slots": (128, 4, 2, 16, 10),
    "c128": (128, 64, 2, 16, 10),
    "c32": (32, 256, 1, 16, 10),  # past 64 chunks: the tables stay in device memory
    "c2": (2, 64, 2, 16, 10),  # a chunk narrower than one 16-B load: scalar loads
}
# The edges whose row 0 alone holds the case (the other rows are seeded).
Z2O_ROW0_EDGES = ("one_lane", "dead_docs", "tf_zero")
# Slot count of the "high_slots" edge: the most the fused kernel takes
# (fewer than 2^26), so its keys use all 31 bits.
Z2O_HIGH_SLOTS = (1 << 26) - 1


def _slice(starts, lens, t, o, n, C):
    """Chunk-table entry (start, skip, len) of ``n`` postings of term ``t``
    from its ``o``-th on, within one chunk of C lanes."""
    col = int(starts[t] + o)
    start = col // 128 * 128
    skip = col - start
    return start, skip, int(min(n, lens[t] - o, C - skip))


def z2o_edge(kind, seed=0):
    """Inputs of one K4 edge case: (rec int32[R, P + C], [c_start, c_skip,
    c_len, c_qterm, c_score, c_rank, qlen], C, F, k, num_slots), over
    ``make_rec`` and ``make_z2o_tables`` with these changes:

      "k_eq_L"     C 1,024, NC 8, four fields, k = L = 8,192
      "one_lane"   row 0 holds one live lane
      "dead_docs"  row 0 reads only term 0, whose docs are all latently dead
      "tf_zero"    row 0 reads only term 1, whose postings have tf 0 in every
                   field (alive docs that score 0)
      "ties"       tf 1, field length 1, qlen 1 and entry score 1.0
                   everywhere: every contribution is 1.0, so docs tie
      "high_slots" doc slots up to 2^26 - 2 (keys use 31 bits)
      "c128"       C 128, NC 64 (L = 8,192)
      "c32"        C 32, NC 256, chunk starts multiples of 4
      "c2"         C 2, NC 64, chunk starts anywhere"""
    C, NC, F, B, k = Z2O_EDGES[kind]
    rng = np.random.default_rng(seed)
    n_docs = 4000
    rec, starts, lens = make_rec(rng, F=F, n_docs=n_docs, n_terms=200, C=C)
    P = int(lens.sum())
    alive = rec[1 + 2 * F]
    if kind == "dead_docs":
        dead = rec[0, starts[0] : starts[0] + lens[0]]
        alive[:P][np.isin(rec[0, :P], dead)] = 0
    if kind == "tf_zero":
        rec[1 : 1 + F, starts[1] : starts[1] + lens[1]] = 0
    if kind == "ties":
        rec[1 : 1 + F, :P] = 1
        rec[1 + F : 1 + 2 * F, :P] = np.float32(1.0).view(np.int32)
    num_slots = n_docs
    if kind == "high_slots":
        rec[0, :P] += Z2O_HIGH_SLOTS - n_docs
        num_slots = Z2O_HIGH_SLOTS
    align = {"c32": 4, "c2": 1}.get(kind, 128)
    tables = make_z2o_tables(rng, starts, lens, B, NC, C=C, align=align)
    c_start, c_skip, c_len, c_qterm, c_score, _rank, qlen = tables
    if kind in ("one_lane", "dead_docs", "tf_zero"):
        c_start[0], c_skip[0], c_len[0] = 0, 0, 0
        if kind == "one_lane":
            o = int(np.flatnonzero(alive[starts[2] : starts[2] + lens[2]] > 0)[0])
            c_start[0, 1], c_skip[0, 1], c_len[0, 1] = _slice(starts, lens, 2, o, 1, C)
        else:
            t = 0 if kind == "dead_docs" else 1
            for c in range(NC):
                o = int(c * lens[t] // NC)
                c_start[0, c], c_skip[0, c], c_len[0, c] = _slice(starts, lens, t, o, lens[t], C)
    if kind == "ties":
        c_score[:] = 1.0
        qlen[:] = 1.0
    tables = [c_start, c_skip, c_len, c_qterm, c_score, score_ranks(c_score), qlen]
    return rec, tables, C, F, k, num_slots


def kernel_case(name, dev):
    """Seeded inputs on ``dev`` for one kernel wrapper (K1 phase full, K3
    phase lanes, K4, K5 or P1): (inputs, kernel(*inputs), plain(*inputs),
    (its launch counter, key)).  Shared by the card tests and
    ``tools/torch_card_probe.py``."""
    from probly_search_tpu_torch import bm25
    from probly_search_tpu_torch.ops import fused_merge as fm
    from probly_search_tpu_torch.ops import fused_query as fq
    from probly_search_tpu_torch.ops import fused_z2o as fz
    from probly_search_tpu_torch.ops import launch_probe as lp

    rng = np.random.default_rng(11)
    if name == "P1":
        x = torch.from_numpy(rng.standard_normal(lp.SHAPE).astype(np.float32)).to(dev)
        return [x], lambda x: (lp.probe_add(x),), lambda x: (lp.probe_add_reference(x),), (
            lp.launches, "probe_add")
    if name == "K5":
        key, val = merge_rows(rng, 4, 32, 1024, False, presorted=True, n_docs=4096)
        kw = dict(k=10, qterm_bits=QB, run=1024, max_seg=32)
        return to_torch([key, val], dev), lambda *a: fm.merge_scores_topk_fused(*a, **kw), \
            lambda *a: fm.merge_scores_topk_fused_reference(*a, **kw), (fm.launches, "merge_topk")
    rec, starts, lens = make_rec(rng, n_docs=3000, n_terms=400, C=1024)
    rec_t = fq.padded_rows(rec, dev)
    if name == "K4":
        tables = to_torch(make_z2o_tables(rng, starts, lens, 16, 4, C=1024), dev)
        kw = dict(chunk=1024, k=10, num_fields=1)
        return [rec_t, *tables], lambda *a: fz.fused_z2o_topk(*a, **kw), \
            lambda *a: fz.fused_z2o_topk_reference(*a, **kw), (fz.launches, "fused_z2o")
    phase, NC = ("full", 8) if name == "K1" else ("lanes", 24)
    tables = to_torch(make_tables(rng, starts, lens, 16, NC, C=1024), dev)
    scalars = torch.tensor([6.5, 1.5], dtype=torch.float32, device=dev)
    kw = dict(chunk=1024, k=10, qterm_bits=QB, num_fields=1, phase=phase)
    return [rec_t, *tables, scalars], lambda *a: fq.fused_query_topk(bm25.new(), *a, **kw), \
        lambda *a: fq.fused_query_topk_reference(bm25.new(), *a, **kw), (fq.launches, phase)
