"""Fused zero-to-one fast kernel (K4): gather + two-key merge + first-valid
reduction + pool sums + top-k per query row.

Counterpart of ``probly_search_tpu/ops/pallas_z2o.py`` (``fused_z2o_topk``).
On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/fused_z2o.cu``; on a CPU tensor it runs ``fused_z2o_topk_reference``,
the plain torch version of the same function, which the tests hold against
the Pallas kernel in interpret mode and the chip smoke holds the kernel
against.

What the kernel computes per query row of L = NC * C lanes:
  k1 = doc << 5 | alive << 4 | qterm on payload lanes, -1 on leading pads,
       INT32_MAX on trailing pads;  k2 = rank << 14 | lane
  contrib_f = min(s / tf_f, 1) * tf_f / max(flen_f, qlen), -1 where the lane
       is not live or tf_f == 0
  lanes in ascending (k1, k2) order; per field the first valid contribution
  of each (doc, alive, qterm) group, summed per doc; the max over fields,
  then max(., 0), for docs whose key says alive; top-k, ties to the lowest
  doc.  ``rank`` is the query's dense descending rank of the job's entry
  score, so (k1, k2) order is the oracle's stable (doc, score desc,
  enumeration) order.

``launches`` counts kernel launches; it moves only where the wrapper
launches the kernel, never on the CPU path.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_query import _check
from .merge import _shift_left, _shift_right, segmented_scan

launches = {"fused_z2o": 0}

# The JAX engine's caps for the fused branch (staged program beyond), kept
# so that the same classes take the same route on both engines.
FUSED_Z2O_MAX_LANES = 8192
FUSED_Z2O_MAX_FIELDS = 4

_I32_MAX = 2**31 - 1
_QT_BITS = 4
# Static shared memory of the kernel, rounded up.
_SMEM_STATIC = 1024


def gather_lanes(rec, c_start, chunk: int, num_fields: int):
    """Gather every chunk lane's record rows: (doc int32, tf f32[F, ...],
    flen f32[F, ...], alive int32), each [B, NC, C] (tf and flen with a
    leading field dim), and the lane iota int32[C]."""
    F = num_fields
    pos = torch.arange(chunk, dtype=torch.int32, device=rec.device)
    g = rec[: 2 + 2 * F, c_start.long()[..., None] + pos.long()]  # [R', B, NC, C]
    tf = g[1 : 1 + F].to(torch.float32)
    flen = g[1 + F : 1 + 2 * F].contiguous().view(torch.float32)
    return g[0], tf, flen, g[1 + 2 * F], pos


def contribution(s, tf, flen, qlen):
    """An accepted entry's contribution, ``min(s / tf, 1) * tf / max(flen,
    qlen)`` (zero_to_one.rs:118-120), in f32 and in the JAX engine's order."""
    return torch.clamp(s / tf, max=1.0) * tf / torch.maximum(flen, qlen)


def _first_valid(cur, earlier):
    """Scan combiner: the earlier aggregate wins when it is defined (>= 0)."""
    return torch.where(earlier >= 0.0, earlier, cur)


def pool_scores(key, dock, valid, contribs):
    """The fast program's reduction over lanes sorted by ``key``: per field
    the first valid (>= 0) contribution of each equal-``key`` group, summed
    over each doc's run (equal ``dock``), then the max over fields.  Returns
    that on every lane and the doc-tail mask, where it is the doc's score."""
    head1 = key != _shift_right(key, 1, -1)
    tail1 = key != _shift_left(key, 1, -1)
    head_d = (dock != _shift_right(dock, 1, -1)) & valid
    doc_best = None
    for cf in contribs:
        first = segmented_scan(_first_valid, cf, head1, -1.0)
        sel = torch.where(tail1 & (first >= 0.0), first, 0.0)
        pool = segmented_scan(torch.add, sel, head_d, 0.0)
        doc_best = pool if doc_best is None else torch.maximum(doc_best, pool)
    return doc_best, dock != _shift_left(dock, 1, -1)


def topk_lanes(final, key, k: int):
    """Top-k of ``final`` f32[B, L] with ties to the lowest lane (a stable
    descending sort, as ``lax.top_k`` orders them; docs ascend along the
    sorted row, so that is the lowest doc) -> (scores, ``key`` at the chosen
    lanes as int32, -1 where the score is -inf)."""
    top_s, top_l = torch.sort(final, dim=-1, descending=True, stable=True)
    top_s, top_l = top_s[:, :k], top_l[:, :k]
    top_d = torch.gather(key, 1, top_l).to(torch.int32)
    return top_s, torch.where(torch.isfinite(top_s), top_d, -1)


def fused_z2o_topk_reference(
    rec, c_start, c_skip, c_len, c_qterm, c_score, c_rank, qlen,
    *, chunk: int, k: int, num_fields: int,
):
    """Plain torch version of ``fused_z2o_topk`` on any device: a full sort
    of the row's (k1, k2) keys in place of the kernel's merge, segmented
    scans in place of its run walks.  Returns (f32[B, k'], int32[B, k']),
    k' = min(k, L)."""
    C, F = chunk, num_fields
    B, NC = c_start.shape
    L = NC * C
    doc, tf, flen, alive, pos = gather_lanes(rec, c_start, C, F)
    in_pay = (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None])
    live = in_pay & (alive > 0)
    k1 = torch.where(
        in_pay,
        (doc << (_QT_BITS + 1)) | (alive << _QT_BITS) | c_qterm[..., None],
        torch.where(pos < c_skip[..., None], -1, _I32_MAX).to(torch.int32),
    ).reshape(B, L)
    lane = torch.arange(L, dtype=torch.int32, device=rec.device).reshape(NC, C)
    k2 = ((c_rank[..., None] << 14) | lane).reshape(B, L)
    contrib = torch.where(
        live & (tf > 0), contribution(c_score[..., None], tf, flen, qlen[:, None, None]), -1.0
    ).reshape(F, B, L)
    # (k1, k2) is unique per lane (k2 carries the lane), so any sort gives
    # the kernel's order.
    order = torch.sort((k1.long() << 32) | k2.long(), dim=-1)[1]
    key = torch.gather(k1, 1, order)
    contribs = torch.gather(contrib, 2, order.expand(F, B, L))
    valid = (key != _I32_MAX) & (key >= 0)
    dock = torch.where(valid, key >> (_QT_BITS + 1), _I32_MAX)
    doc_best, tail_d = pool_scores(key, dock, valid, contribs)
    alive_b = ((key >> _QT_BITS) & 1) > 0
    final = torch.where(tail_d & valid & alive_b, torch.clamp(doc_best, min=0.0), float("-inf"))
    return topk_lanes(final, dock, min(k, L))


def fused_z2o_topk(
    rec, c_start, c_skip, c_len, c_qterm, c_score, c_rank, qlen,
    *, chunk: int, k: int, num_fields: int,
):
    """Run the fused z2o kernel over one shape class.

    ``rec`` is the transposed posting record array int32[R, P + C]; the
    chunk tables are [B, NC] (int32; ``c_score`` f32), ``c_rank`` the jobs'
    score ranks, ``qlen`` f32[B].  Returns what ``fused_z2o_topk_reference``
    returns, computed by the CUDA kernel when the tensors are on a CUDA
    device (1 <= k <= L there)."""
    if rec.device.type == "cpu":
        return fused_z2o_topk_reference(
            rec, c_start, c_skip, c_len, c_qterm, c_score, c_rank, qlen,
            chunk=chunk, k=k, num_fields=num_fields,
        )
    if rec.device.type != "cuda":
        raise ValueError(f"fused_z2o_topk runs on cpu or cuda, not {rec.device}")
    B, NC = c_start.shape
    C, F = chunk, num_fields
    L = NC * C
    dev = rec.device
    _check("rec", rec, torch.int32, None, dev)
    if rec.dim() != 2 or rec.shape[0] < 2 + 2 * F:
        raise ValueError(f"rec must be int32[R >= {2 + 2 * F}, P + C], got {tuple(rec.shape)}")
    for name, t in (("c_start", c_start), ("c_skip", c_skip), ("c_len", c_len),
                    ("c_qterm", c_qterm), ("c_rank", c_rank)):
        _check(name, t, torch.int32, (B, NC), dev)
    _check("c_score", c_score, torch.float32, (B, NC), dev)
    _check("qlen", qlen, torch.float32, (B,), dev)
    if C <= 0 or C & (C - 1):
        raise ValueError(f"the kernel needs a power-of-two chunk width, got {C}")
    if not 1 <= F <= FUSED_Z2O_MAX_FIELDS:
        raise ValueError(f"the kernel takes 1 to {FUSED_Z2O_MAX_FIELDS} fields, got {F}")
    if not 0 < k <= L:
        raise ValueError(f"k must lie in [1, {L}], got {k}")
    if L >= 1 << 14:
        raise ValueError(f"the lane index packs into 14 bits; {L} lanes do not fit")
    lib = _build.load()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    smem_max = lib.fused_query_max_smem(index)
    if lib.fused_z2o_smem_bytes(NC, C, F) > smem_max - _SMEM_STATIC:
        raise ValueError(f"{L} lanes x {F} fields exceed one block's shared memory ({smem_max} B)")
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    err = lib.fused_z2o(
        index, rec.data_ptr(), rec.stride(0), c_start.data_ptr(), c_skip.data_ptr(),
        c_len.data_ptr(), c_qterm.data_ptr(), c_score.data_ptr(), c_rank.data_ptr(),
        qlen.data_ptr(), B, NC, C, F, k, out_s.data_ptr(), out_d.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_z2o launch failed: {lib.fused_query_error_string(err).decode()}")
    launches["fused_z2o"] += 1
    return out_s, out_d
