"""Standalone merge kernel (K5): sort + segmented max and sum + top-k.

Counterpart of ``probly_search_tpu/ops/pallas_merge.py``
(``merge_scores_topk_pallas``).  On a CUDA tensor the wrapper launches the
hand-written kernels of ``csrc/fused_merge.cu``; on a CPU tensor it runs
``merge_scores_topk_fused_reference``, the plain torch version of the same
function, which the tests hold against the Pallas kernel in interpret mode
and the chip smoke holds the kernel against.

The kernel takes one of two paths, chosen by ``merge_plan`` from the shape
alone (B, L, k and the card's shared-memory limit, read once per device):
"block" (one CTA per row, one launch) and "radix" (an LSD radix sort over
``key_bits`` bits, then the doc totals and a radix top-k select).

The BM25 path merges through it on the card wherever the fused query kernel
does not merge itself: term-range classes and chunk widths that are not a
power of two (``run=0``, a full sort), and the classes wider than the fused
kernel's shared memory after phase "lanes" (``run=C``, ``excl``,
``max_seg=NC``).

``launches`` counts calls that launched the kernels; it moves only where
the wrapper launches them, never on the CPU path.  ``path_calls`` counts the
calls per path, ``device_launches`` per card (``"merge_topk@cuda:1"``), all
through ``counts.add`` (safe across threads).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, counts
from .fused_query import _check, cand_words
from .merge import merge_scores_topk_presorted

launches = {"merge_topk": 0}
path_calls = {"block": 0, "radix": 0}
device_launches: dict = {}
PATHS = ("block", "radix")  # the C launcher's path numbers

# Largest k the kernel takes (the radix path's last block orders <= 4,096
# words in 32 KB of shared memory).
MAX_K = 4096
# Lanes one CTA holds: 1,024 threads x 16 lanes kept in registers during a
# radix pass.  The block path's cap.
TILE_LANES = 16384


def radix_tile(L: int) -> int:
    """Lanes per block of the radix passes (csrc radix_tile): 1,024 up to
    2^20 lanes, 4,096 past that."""
    return 1024 if L <= 1 << 20 else 4096


# Bits of a key (keys are int32 >= 0).
KEY_BITS = 31


class MergePlan(NamedTuple):
    path: str  # "block" or "radix"
    smem: int  # dynamic shared memory of one CTA, bytes
    ws_bytes: int  # device scratch, bytes


def _align256(x: int) -> int:
    return (x + 255) & ~255


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def key_bits_for(num_slots: int, qterm_bits: int) -> int:
    """Bits the live keys ``doc << qterm_bits | qterm`` of an index of
    ``num_slots`` doc slots can use (the radix path sorts only these)."""
    return max(1, ((max(num_slots, 1) - 1) << qterm_bits | ((1 << qterm_bits) - 1)).bit_length())


def merge_plan(B: int, L: int, k: int, smem_max: int) -> MergePlan:
    """The path, shared memory and scratch of one K5 call, from its shape
    and ``smem_max``, the dynamic shared memory bytes one block may use.
    Every path sorts the live lanes whole, so ``run`` does not enter it.  The
    C launcher lays the radix path's scratch out the same way (radix_ws) and
    refuses a smaller one."""
    block_smem = 8 * L + 8 * cand_words(k)
    if L <= TILE_LANES and block_smem <= smem_max:
        return MergePlan("block", block_smem, 0)
    nblk = _ceil_div(L, radix_tile(L))
    lanes = B * L
    kpad = _next_pow2(k)
    ws = (
        4 * _align256(lanes * 4)
        + _align256(lanes * 8)
        + _align256(B * 256 * nblk * 4)
        + _align256(B * 4 * 256 * 4)
        + _align256(B * 8 * 256 * 4)
        + _align256(B * 16)
        + _align256(B * kpad * 8)
    )
    return MergePlan("radix", 8 * kpad, ws)


def check_merge_args(B: int, L: int, k: int, run: int, key_bits: int) -> None:
    """Raise ValueError for arguments the kernel does not take."""
    if not 0 < k <= min(L, MAX_K):
        raise ValueError(f"k must lie in [1, {min(L, MAX_K)}], got {k}")
    if run < 0 or run & (run - 1):
        raise ValueError(f"run must be 0 or a power of two, got {run}")
    if not 1 <= key_bits <= KEY_BITS:
        raise ValueError(f"key_bits must lie in [1, {KEY_BITS}], got {key_bits}")
    if B > 65535 or L > (1 << 30):
        raise ValueError(f"the kernel takes at most 65535 rows of 2^30 lanes, got {B} x {L}")


_smem: dict = {}


def device_smem(index: int) -> int:
    """Dynamic shared memory bytes a block path CTA may use on CUDA device
    ``index``, read once; the first call also lifts the kernel's cap."""
    got = _smem.get(index)
    if got is None:
        lib = _build.load()
        got = lib.merge_topk_init(index)
        if got < 0:
            raise RuntimeError(f"merge_topk_init failed on cuda:{index}")
        _smem[index] = got
    return got


def merge_scores_topk_fused_reference(
    key, score, k: int, qterm_bits: int, run: int = 0, excl: bool = False, max_seg: int = 0,
    key_bits: int = KEY_BITS,
):
    """Plain torch version of ``merge_scores_topk_fused`` on any device: a
    stable sort of the row by key (skipped when one run covers it), the
    segmented max and sum, and the top-k with ties to the lowest doc.
    ``max_seg`` only bounds the Pallas kernel's scan ladder and ``key_bits``
    only the kernel's radix passes; the result depends on neither."""
    del max_seg, key_bits
    return merge_scores_topk_presorted(key, score, k, qterm_bits, run, excl)


def merge_scores_topk_fused(
    key, score, k: int, qterm_bits: int, run: int = 0, excl: bool = False, max_seg: int = 0,
    key_bits: int = KEY_BITS,
):
    """Merge per-lane scores into per-doc totals and select the top-k.

    ``key`` int32[B, L] is ``doc << qterm_bits | qterm`` per lane; live lanes
    have ``key >= 0`` and ``key != INT32_MAX``.  ``run = 0`` sorts each row
    fully; ``run > 0`` (a power of two) declares the row ascending runs of
    that many lanes, with ``-1`` leading pads, ``INT32_MAX`` trailing pads and
    ``-inf`` scores on dead docs.  ``excl`` drops doc totals that are not
    > 0.  ``key_bits``: every live key is below ``2**key_bits`` (the caller
    knows it from the slot count, ``key_bits_for``); the radix path sorts
    only those bits.  Returns (scores f32[B, k], docs int32[B, k]); missing
    entries are (-inf, -1)."""
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
    check_merge_args(B, L, k, run, key_bits)
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    lib = _build.load()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    plan = merge_plan(B, L, k, device_smem(index))
    ws = torch.empty(max(plan.ws_bytes, 1), dtype=torch.uint8, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    err = lib.merge_topk(
        index, key.data_ptr(), score.data_ptr(), B, L, k, qterm_bits, int(bool(excl)),
        key_bits, PATHS.index(plan.path), plan.smem, ws.data_ptr(), plan.ws_bytes,
        out_s.data_ptr(), out_d.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"merge_topk ({plan.path}) launch failed: {lib.fused_query_error_string(err).decode()}"
        )
    counts.add((
        (launches, "merge_topk", 1), (path_calls, plan.path, 1),
        (device_launches, f"merge_topk@cuda:{index}", 1),
    ))
    return out_s, out_d
