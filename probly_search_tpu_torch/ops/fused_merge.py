"""Standalone merge kernel (K5): sort + segmented max and sum + top-k.

Counterpart of ``probly_search_tpu/ops/pallas_merge.py``
(``merge_scores_topk_pallas``).  On a CUDA tensor the wrapper launches the
hand-written kernels of ``csrc/fused_merge.cu``; on a CPU tensor it runs
``merge_scores_topk_fused_reference``, the plain torch version of the same
function, which the tests hold against the Pallas kernel in interpret mode
and the chip smoke holds the kernel against.

The BM25 path merges through it on the card wherever the fused query kernel
does not merge itself: term-range classes and chunk widths that are not a
power of two (``run=0``, a full sort), and the classes wider than the fused
kernel's shared memory after phase "lanes" (``run=C``, ``excl``,
``max_seg=NC``).

``launches`` counts calls that launched the kernels; it moves only where
the wrapper launches them, never on the CPU path.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_query import _check
from .merge import merge_scores_topk_presorted

launches = {"merge_topk": 0}

# Largest k the kernel's top-k passes take (a segment of 16,384 candidates
# must shrink to k).
MAX_K = 4096


def merge_scores_topk_fused_reference(
    key, score, k: int, qterm_bits: int, run: int = 0, excl: bool = False, max_seg: int = 0
):
    """Plain torch version of ``merge_scores_topk_fused`` on any device: a
    stable sort of the row by key (skipped when one run covers it), the
    segmented max and sum, and the top-k with ties to the lowest doc.
    ``max_seg`` only bounds the Pallas kernel's scan ladder; the result does
    not depend on it."""
    del max_seg
    return merge_scores_topk_presorted(key, score, k, qterm_bits, run, excl)


def merge_scores_topk_fused(
    key, score, k: int, qterm_bits: int, run: int = 0, excl: bool = False, max_seg: int = 0
):
    """Merge per-lane scores into per-doc totals and select the top-k.

    ``key`` int32[B, L] is ``doc << qterm_bits | qterm`` per lane; live lanes
    have ``key >= 0`` and ``key != INT32_MAX``.  ``run = 0`` sorts each row
    fully; ``run > 0`` (a power of two) declares the row ascending runs of
    that many lanes, with ``-1`` leading pads, ``INT32_MAX`` trailing pads and
    ``-inf`` scores on dead docs.  ``excl`` drops doc totals that are not
    > 0.  Returns (scores f32[B, k], docs int32[B, k]); missing entries are
    (-inf, -1)."""
    if key.device.type == "cpu":
        return merge_scores_topk_fused_reference(key, score, k, qterm_bits, run, excl, max_seg)
    if key.device.type != "cuda":
        raise ValueError(f"merge_scores_topk_fused runs on cpu or cuda, not {key.device}")
    if key.dim() != 2:
        raise ValueError(f"key must be int32[B, L], got shape {tuple(key.shape)}")
    B, L = key.shape
    dev = key.device
    _check("key", key, torch.int32, (B, L), dev)
    _check("score", score, torch.float32, (B, L), dev)
    if not 0 < k <= min(L, MAX_K):
        raise ValueError(f"k must lie in [1, {min(L, MAX_K)}], got {k}")
    if run < 0 or run & (run - 1):
        raise ValueError(f"run must be 0 or a power of two, got {run}")
    if B > 65535 or L > (1 << 30):
        raise ValueError(f"the kernel takes at most 65535 rows of 2^30 lanes, got {B} x {L}")
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    lib = _build.load()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    ws = torch.empty(lib.merge_topk_workspace(B, L, k), dtype=torch.uint8, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    err = lib.merge_topk(
        index, key.data_ptr(), score.data_ptr(), B, L, k, qterm_bits, run, int(bool(excl)),
        ws.data_ptr(), out_s.data_ptr(), out_d.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"merge_topk launch failed: {lib.fused_query_error_string(err).decode()}")
    launches["merge_topk"] += 1
    return out_s, out_d
