"""Sort-based segmented merge + top-k in plain torch.

Counterpart of ``probly_search_tpu/ops/merge.py`` (``merge_scores_topk`` and
``merge_scores_topk_presorted``, which JAX runs as XLA), in plain torch: the
plain versions of the kernels' merges.  ``merge_scores_topk_presorted`` with
``run = 0`` sorts the whole row, so it also computes ``merge_scores_topk``.
It implements the reference's score-combination rule (``max_score_merger``):
a segmented MAX over equal (doc, query-term) key runs, a segmented SUM of
those maxima over equal doc runs, then the top-k doc totals.

``torch.topk`` promises no order among equal values, while the JAX engine
relies on ``lax.top_k`` returning the lowest lane first.  Selection here is a
stable descending sort over the doc-ascending row, so equal totals go to the
lowest doc, as the host oracle orders them.
"""

from __future__ import annotations

import torch

INVALID_KEY = 2**31 - 1  # int32 max: trailing pads / dead lanes sort last


def _shift_right(x, d: int, fill):
    """``x`` shifted ``d`` lanes toward higher index; the first ``d`` = fill."""
    pad = torch.full_like(x[..., :d], fill)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _shift_left(x, d: int, fill):
    pad = torch.full_like(x[..., :d], fill)
    return torch.cat([x[..., d:], pad], dim=-1)


def segmented_scan(op, values, heads, identity):
    """Inclusive segmented scan along the last axis (Hillis-Steele).

    ``heads`` (bool) marks the first lane of each segment; the scan restarts
    there.  ``identity`` fills lanes shifted in from before lane 0."""
    L = values.shape[-1]
    d = 1
    while d < L:
        shifted = _shift_right(values, d, identity)
        values = torch.where(heads, values, op(values, shifted))
        heads = heads | _shift_right(heads, d, True)
        d *= 2
    return values


def merge_scores_topk_presorted(key, score, k: int, qterm_bits: int, run: int, excl: bool):
    """Merge per-lane scores into per-doc totals and select the top-k, for
    lanes that arrive as ascending runs of ``run`` lanes (posting chunks are
    doc-sorted; ``run = 0`` or ``run < L`` sorts the row): ``key`` int32[...,
    L] is ``doc << qterm_bits | qterm``, leading pads carry key ``-1``,
    trailing pads ``INVALID_KEY``, latently dead docs keep ordered keys with
    score ``-inf``.  ``excl`` drops doc totals that are not > 0 (the caller
    already clamped nonpositive posting scores to 0).  Returns (f32[..., k],
    int32[..., k]); missing entries are (-inf, -1)."""
    if run < key.shape[-1]:
        key_s, order = torch.sort(key, dim=-1, stable=True)
        score_s = torch.gather(score, -1, order)
    else:
        key_s, score_s = key, score
    # max over each (doc, qterm) key run, summed over each doc run
    head1 = key_s != _shift_right(key_s, 1, -1)
    run_max = segmented_scan(torch.maximum, score_s, head1, float("-inf"))
    tail1 = key_s != _shift_left(key_s, 1, -1)
    contrib = torch.where(tail1, run_max, 0.0)

    doc = key_s >> qterm_bits
    head2 = doc != _shift_right(doc, 1, -1)
    doc_sum = segmented_scan(torch.add, contrib, head2, 0.0)
    tail2 = doc != _shift_left(doc, 1, -1)

    keep = tail2 & (key_s != INVALID_KEY) & (key_s >= 0)
    if excl:
        keep = keep & (doc_sum > 0.0)
    final = torch.where(keep, doc_sum, float("-inf"))
    top_scores, top_lanes = torch.sort(final, dim=-1, descending=True, stable=True)
    top_scores = top_scores[..., :k]
    top_docs = torch.gather(doc, -1, top_lanes[..., :k]).to(torch.int32)
    top_docs = torch.where(torch.isfinite(top_scores), top_docs, -1)
    return top_scores, top_docs
