"""Fused BM25 query: gather + score + merge + top-k per query row.

Counterpart of ``probly_search_tpu/ops/pallas_query.py`` (``fused_query_topk``,
phases ``"full"`` and ``"lanes"``).  On a CUDA tensor the wrapper launches
the hand-written kernel of ``csrc/fused_query.cu``; on a CPU tensor it runs
``fused_query_topk_reference``, the plain torch version of the same function
(the staged gather -> score -> presorted merge of the JAX engine), which the
tests and the chip smoke also hold the kernel against.

``launches`` counts kernel launches per phase, ``chunk_launches`` the same
launches by phase and chunk width (``"full@256"``: a light class's) and
``device_launches`` by phase and card (``"full@cuda:1"``).  They move only
where the wrapper launches a kernel, never on the CPU path, and only
through ``counts.add`` (safe across threads).  A launch on any card leaves
the caller's current device as it was (the C entries select their device
for the call only).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bm25 import BM25
from . import _build, counts
from .merge import INVALID_KEY, merge_scores_topk_presorted

launches = {"full": 0, "lanes": 0}
chunk_launches: dict = {}
device_launches: dict = {}

# Most chunks of record rows the full phase stages in shared memory at once.
MAX_RING = 4
# Up to this many lanes the full phase runs 512-thread blocks, two to an SM:
# their ring is kept small enough that two blocks fit an SM's shared memory
# (228 KB; each block also holds about 12 KB of static shared memory).
SHARED_SM_LANES = 8192
_SM_SHARED = 233472
_BLOCK_STATIC = 12 * 1024
# Largest k whose top-k words the full phase keeps in shared memory; past
# it they go to device scratch.
MAX_K = 4096
# Record rows are padded to a multiple of this many int32 (512 B), so every
# 128-aligned chunk start is 16-B aligned in every row.
ROW_ALIGN = 128


def cand_words(k: int) -> int:
    """Words of a row's top-k buffer (csrc/block_merge.cuh cand_words): the
    next power of two of k, at least 32."""
    return max(32, 1 << max(0, (k - 1).bit_length()))


def full_smem_bytes(L: int, chunk: int, num_fields: int, k: int, ring: int) -> int:
    """Dynamic shared memory of one full-phase block: key and score lanes
    (8 B each), a ring of ``ring`` chunks of staged record rows, the top-k
    words (up to ``MAX_K``; past it they sit in device scratch), the row's
    chunk tables (20 B a chunk) and the 2F scalars."""
    words = cand_words(k) if k <= MAX_K else 0
    tables = 20 * (L // chunk) + 8 * num_fields
    return 8 * L + 4 * ring * (2 + 2 * num_fields) * chunk + 8 * words + tables


def full_launch(L: int, chunk: int, num_fields: int, k: int, avail: int):
    """(ring, smem bytes) of a full-phase launch: the deepest ring up to
    ``MAX_RING`` and the class's chunk count whose block fits ``avail``
    bytes (up to ``SHARED_SM_LANES`` lanes, also two blocks to an SM); (0,
    bytes of a ring of 1) when none fits."""
    for ring in range(min(MAX_RING, max(L // chunk, 1)), 0, -1):
        smem = full_smem_bytes(L, chunk, num_fields, k, ring)
        two_fit = 2 * (smem + _BLOCK_STATIC) <= _SM_SHARED
        if smem <= avail and (L > SHARED_SM_LANES or two_fit or ring == 1):
            return ring, smem
    return 0, full_smem_bytes(L, chunk, num_fields, k, 1)


def padded_rows(a, device):
    """Upload int32[R, W] ``a`` as a view of a buffer whose rows are padded
    to a multiple of ``ROW_ALIGN`` int32: the result has shape (R, W), the
    same values, ``stride(1) == 1`` and ``stride(0) % ROW_ALIGN == 0``."""
    R, W = a.shape
    buf = np.zeros((R, -(-max(W, 1) // ROW_ALIGN) * ROW_ALIGN), dtype=np.int32)
    buf[:, :W] = a
    return torch.from_numpy(buf).to(device)[:, :W]


def check_rec(rec, num_fields: int) -> None:
    """Raise ValueError unless ``rec`` is an int32[R >= 2 + 2F, P + C] view
    with unit column stride and 16-B aligned rows, as every kernel's 16-B
    loads need (``padded_rows`` makes such a view)."""
    F = num_fields
    if rec.dtype != torch.int32:
        raise ValueError(f"rec has dtype {rec.dtype}, expected torch.int32")
    if rec.dim() != 2 or rec.shape[0] < 2 + 2 * F:
        raise ValueError(f"rec must be int32[R >= {2 + 2 * F}, P + C], got {tuple(rec.shape)}")
    if rec.stride(1) != 1 or rec.stride(0) < rec.shape[1]:
        raise ValueError(f"rec needs unit column stride and whole rows, got strides {rec.stride()}")
    if rec.stride(0) % 4 or rec.data_ptr() % 16:
        raise ValueError(
            f"rec rows must be 16-B aligned (row stride {rec.stride(0)} int32): "
            "build it with padded_rows"
        )


_smem: dict = {}


def device_smem(index: int):
    """(opt-in shared memory per block, what the full phase may use) of CUDA
    device ``index``, read once; the first call also lifts the full phase's
    shared-memory cap."""
    got = _smem.get(index)
    if got is None:
        lib = _build.load()
        avail = lib.fused_query_init(index)
        if avail < 0:
            raise RuntimeError(f"fused_query_init failed on cuda:{index}")
        got = _smem[index] = (lib.fused_query_max_smem(index), avail)
    return got


def _kernel_scores(scorer) -> bool:
    """True when the CUDA kernel computes exactly ``scorer``'s per-lane
    score: the port's BM25, its formula not overridden.  The kernel cannot
    call a Python ``device_score_lanes``."""
    return isinstance(scorer, BM25) and type(scorer).device_score_lanes is BM25.device_score_lanes


def gather_score(
    scorer, rec, c_start, c_skip, c_len, c_qterm, scale, scalars, chunk: int, num_fields: int
):
    """Staged gather + score of every chunk lane, in plain torch.

    ``scale`` is f32[B, NC, 1] (the job's scale per chunk) or f32[B, NC, C]
    (per lane, term-range classes).  Returns (score f32[B, NC, C], doc
    int32[B, NC, C], pos int32[1, 1, C], in_pay bool[B, NC, C], alive
    bool[B, NC, C])."""
    from ..index.device import ScoreLanes

    C, F = chunk, num_fields
    pos = torch.arange(C, dtype=torch.int32, device=rec.device)[None, None, :]
    g = rec[: 2 + 2 * F, c_start.long()[..., None] + pos.long()]  # [R', B, NC, C]
    doc = g[0]
    tf = g[1 : 1 + F].permute(1, 2, 0, 3).to(torch.float32)  # [B, NC, F, C]
    flen = g[1 + F : 1 + 2 * F].permute(1, 2, 0, 3).contiguous().view(torch.float32)
    alive = g[1 + 2 * F] > 0
    in_pay = (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None])
    scalars = scalars.reshape(-1)
    lanes = ScoreLanes(
        tf=tf,
        field_length=flen,
        field_avg=scalars[:F],
        fields_boost=scalars[F : 2 * F],
        scale=scale,
        doc=doc,
        live=in_pay & alive,
        qterm=c_qterm,
    )
    return scorer.device_score_lanes(lanes), doc, pos, in_pay, alive


def fused_query_topk_reference(
    scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars,
    *, chunk: int, k: int, qterm_bits: int, num_fields: int, phase: str = "full",
    key_bits: int = 31,
):
    """Plain torch version of ``fused_query_topk`` on any device.

    Phase "full" returns (scores f32[B, k], docs int32[B, k]); phase "lanes"
    returns (score f32[B, L], key int32[B, L]), L = NC * chunk, with the
    kernel's key layout: doc-sorted payload keys, -1 leading pads,
    INVALID_KEY trailing pads, -inf scores on latently dead docs.
    ``key_bits`` only bounds the kernel's sort; the result does not depend
    on it."""
    del key_bits
    B, NC = c_start.shape
    score, doc, pos, in_pay, alive = gather_score(
        scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale[..., None], scalars, chunk,
        num_fields,
    )
    excl = bool(getattr(scorer, "device_excludes_nonpositive", False))
    if excl:
        score = torch.where(score > 0.0, score, 0.0)
    score = torch.where(in_pay, score, 0.0)
    score = torch.where(in_pay & ~alive, float("-inf"), score)
    key = torch.where(
        in_pay,
        (doc << qterm_bits) | c_qterm[..., None],
        torch.where(pos < c_skip[..., None], -1, INVALID_KEY).to(torch.int32),
    )
    L = NC * chunk
    if phase == "lanes":
        return score.reshape(B, L), key.reshape(B, L)
    if phase != "full":
        raise ValueError(f"unknown phase {phase!r}")
    return merge_scores_topk_presorted(
        key.reshape(B, L), score.reshape(B, L), k, qterm_bits, chunk, excl
    )


def check_tables(device, shape, ints, floats) -> None:
    """Raise ValueError unless every (name, tensor) of ``ints`` is int32 and
    of ``floats`` f32, each contiguous, of ``shape`` and on ``device``."""
    for dtype, named in ((torch.int32, ints), (torch.float32, floats)):
        for name, t in named:
            if t.dtype != dtype or t.shape != shape or t.device != device or not t.is_contiguous():
                _check(name, t, dtype, shape, device)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_query_args(
    rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars,
    *, chunk: int, k: int, num_fields: int, phase: str, key_bits: int,
) -> None:
    """Raise ValueError for arguments the kernel does not take: ``rec`` with
    16-B aligned rows (``padded_rows``; both phases load 16 B at a time),
    contiguous [B, NC] tables and f32[2F] ``scalars`` on its device, a
    power-of-two chunk; phase "full": 1 <= k <= L, a chunk of at least 4,
    1 <= key_bits <= 31; phase "lanes": at most 65,535 rows."""
    if phase not in launches:
        raise ValueError(f"unknown phase {phase!r}")
    B, NC = c_start.shape
    C, F = chunk, num_fields
    dev = rec.device
    check_rec(rec, F)
    check_tables(
        dev, c_start.shape,
        (("c_start", c_start), ("c_skip", c_skip), ("c_len", c_len), ("c_qterm", c_qterm)),
        (("c_scale", c_scale),),
    )
    if scalars.numel() != 2 * F:
        raise ValueError(f"scalars must hold 2F = {2 * F} values, got {tuple(scalars.shape)}")
    _check("scalars", scalars, torch.float32, None, dev)
    if C <= 0 or C & (C - 1):
        raise ValueError(f"the kernel needs a power-of-two chunk width, got {C}")
    if phase == "lanes":
        if B > 65535:
            raise ValueError(f"lanes phase takes at most 65535 rows, got {B}")
        return
    L = NC * C
    if not 0 < k <= L:
        raise ValueError(f"k must lie in [1, {L}], got {k}")
    if C < 4:
        raise ValueError(f"the full phase needs a chunk width of at least 4, got {C}")
    if not 1 <= key_bits <= 31:
        raise ValueError(f"key_bits must lie in [1, 31], got {key_bits}")


def fused_query_topk(
    scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars,
    *, chunk: int, k: int, qterm_bits: int, num_fields: int, phase: str = "full",
    key_bits: int = 31,
):
    """Run the fused query over one shape class.

    ``rec`` is the transposed posting record array int32[R, P + C]; the
    chunk tables are [B, NC] (int32, ``c_scale`` f32); ``scalars`` is
    f32[2F] (or [1, 2F]) = (field_avg, fields_boost).  Returns what
    ``fused_query_topk_reference`` returns, computed by the CUDA kernel when
    the tensors are on a CUDA device (``check_query_args`` there).
    ``key_bits``: every live key ``doc << qterm_bits | qterm`` lies below
    ``2**key_bits`` (the full phase sorts only those bits; the plain version
    ignores it)."""
    if rec.device.type == "cpu":
        return fused_query_topk_reference(
            scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars,
            chunk=chunk, k=k, qterm_bits=qterm_bits, num_fields=num_fields, phase=phase,
        )
    if rec.device.type != "cuda":
        raise ValueError(f"fused_query_topk runs on cpu or cuda, not {rec.device}")
    if not _kernel_scores(scorer):
        raise NotImplementedError(
            f"{type(scorer).__name__}: of the one-phase scorers only "
            "probly_search_tpu_torch.bm25 runs on a CUDA device (the kernel cannot "
            "call a Python device_score_lanes)"
        )
    check_query_args(rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars, chunk=chunk, k=k,
                     num_fields=num_fields, phase=phase, key_bits=key_bits)
    B, NC = c_start.shape
    C, F = chunk, num_fields
    dev = rec.device
    L = NC * C
    lib = _build.load()
    excl = int(bool(getattr(scorer, "device_excludes_nonpositive", False)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = torch.cuda.current_device() if dev.index is None else dev.index
    common = (
        index, rec.data_ptr(), rec.stride(0), c_start.data_ptr(), c_skip.data_ptr(),
        c_len.data_ptr(), c_qterm.data_ptr(), c_scale.data_ptr(), scalars.data_ptr(),
        B, NC, C, F,
    )
    if phase == "full":
        ring, smem = full_launch(L, C, F, k, device_smem(index)[1])
        if not ring:
            raise ValueError(f"{L} lanes exceed one block's shared memory ({smem} B)")
        out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
        out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
        cand = None
        if k > MAX_K:
            cand = torch.empty((B, cand_words(k)), dtype=torch.int64, device=dev)
        err = lib.fused_query_full(
            *common, k, qterm_bits, float(scorer.bm25k1), float(scorer.bm25b), excl, key_bits, ring,
            smem, None if cand is None else cand.data_ptr(), out_s.data_ptr(), out_d.data_ptr(),
            stream,
        )
    else:
        out_s = torch.empty((B, L), dtype=torch.float32, device=dev)
        out_d = torch.empty((B, L), dtype=torch.int32, device=dev)
        err = lib.fused_query_lanes(
            *common, qterm_bits, float(scorer.bm25k1), float(scorer.bm25b), excl,
            out_s.data_ptr(), out_d.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"fused_query {phase} launch failed: {lib.fused_query_error_string(err).decode()}"
        )
    counts.add((
        (launches, phase, 1), (chunk_launches, f"{phase}@{C}", 1),
        (device_launches, f"{phase}@cuda:{index}", 1),
    ))
    return out_s, out_d
