"""Fused BM25 query: gather + score + merge + top-k per query row.

Counterpart of ``probly_search_tpu/ops/pallas_query.py`` (``fused_query_topk``,
phases ``"full"`` and ``"lanes"``).  On a CUDA tensor the wrapper launches
the hand-written kernel of ``csrc/fused_query.cu``; on a CPU tensor it runs
``fused_query_topk_reference``, the plain torch version of the same function
(the staged gather -> score -> presorted merge of the JAX engine), which the
tests and the chip smoke also hold the kernel against.

``launches`` counts kernel launches per phase.  It moves only where the
wrapper launches a kernel, never on the CPU path.
"""

from __future__ import annotations

import torch

from ..models.bm25 import BM25
from . import _build
from .merge import INVALID_KEY, merge_scores_topk_presorted

launches = {"full": 0, "lanes": 0}

# Shared memory the full phase keeps per lane (key int32 + score f32).
_SMEM_BYTES_PER_LANE = 8
# Static shared memory of the full-phase kernel, rounded up.
_SMEM_STATIC = 1024


def _kernel_scores(scorer) -> bool:
    """True when the CUDA kernel computes exactly ``scorer``'s per-lane
    score: the port's BM25, its formula not overridden.  The kernel cannot
    call a Python ``device_score_lanes``."""
    return isinstance(scorer, BM25) and type(scorer).device_score_lanes is BM25.device_score_lanes


def gather_score(
    scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars, chunk: int, num_fields: int
):
    """Staged gather + score of every chunk lane, in plain torch.

    Returns (score f32[B, NC, C], doc int32[B, NC, C], pos int32[1, 1, C],
    in_pay bool[B, NC, C], alive bool[B, NC, C])."""
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
        scale=c_scale[..., None],
        doc=doc,
        live=in_pay & alive,
        qterm=c_qterm,
    )
    return scorer.device_score_lanes(lanes), doc, pos, in_pay, alive


def fused_query_topk_reference(
    scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars,
    *, chunk: int, k: int, qterm_bits: int, num_fields: int, phase: str = "full",
):
    """Plain torch version of ``fused_query_topk`` on any device.

    Phase "full" returns (scores f32[B, k], docs int32[B, k]); phase "lanes"
    returns (score f32[B, L], key int32[B, L]), L = NC * chunk, with the
    kernel's key layout: doc-sorted payload keys, -1 leading pads,
    INVALID_KEY trailing pads, -inf scores on latently dead docs."""
    B, NC = c_start.shape
    score, doc, pos, in_pay, alive = gather_score(
        scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars, chunk, num_fields
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


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_query_topk(
    scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars,
    *, chunk: int, k: int, qterm_bits: int, num_fields: int, phase: str = "full",
):
    """Run the fused query over one shape class.

    ``rec`` is the transposed posting record array int32[R, P + C]; the
    chunk tables are [B, NC] (int32, ``c_scale`` f32); ``scalars`` is
    f32[2F] (or [1, 2F]) = (field_avg, fields_boost).  Returns what
    ``fused_query_topk_reference`` returns, computed by the CUDA kernel when
    the tensors are on a CUDA device."""
    if rec.device.type == "cpu":
        return fused_query_topk_reference(
            scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars,
            chunk=chunk, k=k, qterm_bits=qterm_bits, num_fields=num_fields, phase=phase,
        )
    if rec.device.type != "cuda":
        raise ValueError(f"fused_query_topk runs on cpu or cuda, not {rec.device}")
    if not _kernel_scores(scorer):
        raise NotImplementedError(
            f"{type(scorer).__name__}: only probly_search_tpu_torch.bm25 runs on a "
            "CUDA device (the kernel cannot call a Python device_score_lanes; "
            "zero-to-one is ROADMAP Queue 1, item 5, M7)"
        )
    if phase not in launches:
        raise ValueError(f"unknown phase {phase!r}")
    B, NC = c_start.shape
    C, F = chunk, num_fields
    dev = rec.device
    _check("rec", rec, torch.int32, None, dev)
    if rec.dim() != 2 or rec.shape[0] < 2 + 2 * F:
        raise ValueError(f"rec must be int32[R >= {2 + 2 * F}, P + C], got {tuple(rec.shape)}")
    tables = {"c_start": c_start, "c_skip": c_skip, "c_len": c_len, "c_qterm": c_qterm}
    for name, t in tables.items():
        _check(name, t, torch.int32, (B, NC), dev)
    _check("c_scale", c_scale, torch.float32, (B, NC), dev)
    scalars = scalars.reshape(-1)
    _check("scalars", scalars, torch.float32, (2 * F,), dev)
    if C <= 0 or C & (C - 1):
        raise ValueError(f"the kernel needs a power-of-two chunk width, got {C}")
    if B > 65535 and phase == "lanes":
        raise ValueError(f"lanes phase takes at most 65535 rows, got {B}")
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
        if not 0 < k <= L:
            raise ValueError(f"k must lie in [1, {L}], got {k}")
        smem_max = lib.fused_query_max_smem(index)
        if L * _SMEM_BYTES_PER_LANE > smem_max - _SMEM_STATIC:
            raise ValueError(f"{L} lanes exceed one block's shared memory ({smem_max} B)")
        out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
        out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
        err = lib.fused_query_full(
            *common, k, qterm_bits, float(scorer.bm25k1), float(scorer.bm25b), excl,
            out_s.data_ptr(), out_d.data_ptr(), stream,
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
    launches[phase] += 1
    return out_s, out_d
