"""Seeded posting records and chunk tables for the torch port's kernel tests
(JAX-free, so the CUDA tests also run where JAX is not installed)."""

import numpy as np
import torch

QB = 4  # qterm bits of the merge key


def make_rec(rng, F=1, n_docs=400, n_terms=120, C=128):
    """Posting records int32[R, P + C]: ascending doc runs per term, 5% of
    docs latently dead.  Few docs, so chunks of one row share docs."""
    R = 4 if 2 + 2 * F <= 4 else 8
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


def make_tables(rng, starts, lens, B, NC, C=128, max_len=None):
    """[B, NC] chunk tables: slices of one term's run each (leading and
    trailing pads, payloads of at most ``max_len`` lanes), 20% dead chunks,
    row 5 empty."""
    t = rng.integers(0, len(starts), (B, NC))
    o = (rng.random((B, NC)) * lens[t]).astype(np.int64)
    col = starts[t] + o
    c_start = col // 128 * 128
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


def make_z2o_tables(rng, starts, lens, B, NC, C=128, scores=(1.0, 0.75, 2.0 / 3.0, 0.5)):
    """``make_tables`` for the fused z2o kernel: (c_start, c_skip, c_len,
    c_qterm, c_score, c_rank, qlen), entry scores drawn from ``scores`` so
    that equal scores share a rank."""
    c_start, c_skip, c_len, c_qterm, _scale = make_tables(rng, starts, lens, B, NC, C=C)
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
