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
