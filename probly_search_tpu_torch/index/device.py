"""Device-resident index and the batched BM25 query path in torch.

Counterpart of ``probly_search_tpu/index/device.py``: the same host planner
(carried over in numpy, so the port never imports JAX), the same posting
record layout and job tables, and a window step that runs one shape class
after another on the device:

  plan (host, numpy) -> pack job tables -> one H2D copy of the window
  per class: expand_chunks (torch) -> fused_query_topk (CUDA kernel;
             phase "full", or phase "lanes" + the merge kernel K5 for wide
             classes); term-range classes and chunk widths that are not a
             power of two: staged torch gather + score -> K5 (full sort)
  trim / pad / pack_result_rows -> one packed result -> one D2H copy

Term-range jobs (word 1 bit 30): a query term with at least
``IndexConfig.range_min_expansions`` expansions plans as one job per segment
over its whole contiguous CSR range, not one job per expansion; word 2 then
holds the query term's UTF-8 byte length, and the device reads each
posting's idf and term byte length from the aux record array
(``DeviceIndex._aux_rec``) to build the per-lane scale.

Posting record layout (transposed int32[R, P + C]; R = 4 for one field,
else 2 + 2F rounded up to a multiple of 8), as in the JAX package:
  rec[0]         doc slot, the true slot even for dead docs (runs stay sorted)
  rec[1:1+F]     per-field term frequency
  rec[1+F:1+2F]  per-field doc length, f32 bits
  rec[1+2F]      doc liveness at snapshot time (0/1)

Two-phase scorers (zero-to-one) take the z2o window engine of
``ops/z2o_device.py``, which shares this module's job expansion, packed
result formats and ``PendingBatch``.

What the port does not do yet (each raises or is documented): block-max
pruning (``prune_blocks`` is not honoured; pruning is exact, so results are
unchanged), light classes, per-class dispatch, template save/load and
prewarm, sharding and ``fetch_windows_jointly``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import HostFallbackError
from ..models.base import QueryResult
from ..ops.fused_merge import merge_scores_topk_fused
from ..ops.fused_query import fused_query_topk, gather_score
from ..ops.merge import INVALID_KEY
from ..utils.metrics import metrics
from ..utils.tokenizers import whitespace_tokenizer
from .core import Index
from .segment import escape_terms_fixed, probe_terms_fixed

_MAX_CHAR = "\U0010FFFF"  # prefix upper-bound sentinel

# Job word1 layout: len(26) | qterm(4) | range(1).
_LEN_BITS = 26
_QT_BITS = 4
_MAX_JOB_LEN = (1 << _LEN_BITS) - 1

# Widest lane class the full-phase kernel takes: one row's key + score lanes
# (8 B each) live in one block's shared memory.  Wider classes run the kernel
# in phase "lanes" and merge with K5.  The value matches the JAX engine's,
# so the same classes take the same phase on both.
_FUSED_MAX_LANES = 16384


def _host_fallback_policy(config, n: int, reason: str) -> None:
    """Enforce ``IndexConfig.host_fallback`` for ``n`` degraded queries."""
    policy = config.host_fallback
    if policy == "allow" or n <= 0:
        return
    msg = (
        f"{n} quer{'y' if n == 1 else 'ies'} degraded to the host-speed "
        f"path ({reason}); see IndexConfig.host_fallback"
    )
    if policy == "error":
        raise HostFallbackError(msg)
    import warnings

    warnings.warn(msg, RuntimeWarning, stacklevel=3)


@dataclass
class ScoreLanes:
    """Vectorized scoring context (the per-posting arguments of the scorer's
    ``score``), with the posting lane dimension C minor."""

    tf: Any  # f32[B, NC, F, C] — per-field term frequency
    field_length: Any  # f32[B, NC, F, C] — per-field doc lengths
    field_avg: Any  # f32[F]
    fields_boost: Any  # f32[F]
    scale: Any  # f32[B, NC, 1] — the job's idf * expansion boost per chunk,
    # or f32[B, NC, C] per lane in a term-range class (see _range_scale)
    doc: Any  # int32[B, NC, C] — doc slot
    live: Any  # bool[B, NC, C] — posting is in the payload and its doc alive
    qterm: Any  # int32[B, NC] — dense query-term index per chunk


def chunk_tables(jobs, chunk: int, num_chunks: int):
    """Expand job descriptors int32[B, NJ, W] (word 0 the start, word 1
    ``len | qterm << 26``) into per-chunk tables.

    A job's chunks are contiguous stride-C slices off one 128-aligned base,
    so only its first chunk carries an alignment skip (< 128 lanes).  Returns
    (take, c_start, c_skip, c_len, c_qterm), where ``take`` maps any per-job
    [B, NJ] word to its per-chunk [B, NC] table; chunks past a row's last job
    are dead (start, skip, len all 0).  The integer tables equal the JAX
    prologue's bit for bit."""
    C, NC = chunk, num_chunks
    B, NJ, _ = jobs.shape
    jstart = jobs[..., 0]
    w1 = jobs[..., 1]
    jlen = w1 & _MAX_JOB_LEN
    jqterm = (w1 >> _LEN_BITS) & ((1 << _QT_BITS) - 1)

    base = (jstart // 128) * 128
    skip0 = jstart - base
    njc = torch.where(jlen > 0, (skip0 + jlen + (C - 1)) // C, 0)
    cum = torch.cumsum(njc, dim=1, dtype=torch.int32)
    chunk_ids = torch.arange(NC, dtype=torch.int32, device=jobs.device).expand(B, NC)
    # searchsorted(cum, id, right): NJ <= NC is small, so a broadcast
    # compare-sum.
    chunk_job = (cum[:, None, :] <= chunk_ids[:, :, None]).sum(-1, dtype=torch.int32)
    jc = torch.clamp(chunk_job, max=NJ - 1).long()

    def take(a):
        return torch.gather(a, 1, jc)

    within = chunk_ids - (take(cum) - take(njc))
    off = within * C
    c_start = take(base) + off
    c_skip = torch.clamp(take(skip0) - off, 0, C)
    c_end = torch.clamp(take(skip0) + take(jlen) - off, 0, C)
    c_len = torch.clamp(c_end - c_skip, min=0)
    c_valid = chunk_ids < cum[:, -1:]
    c_len = torch.where(c_valid, c_len, 0)
    c_start = torch.where(c_valid, c_start, 0)
    c_skip = torch.where(c_valid, c_skip, 0)
    return take, c_start, c_skip, c_len, take(jqterm)


def expand_chunks(jobs, chunk: int, num_chunks: int):
    """Expand BM25 job descriptors int32[B, NJ, 3] into per-chunk tables:
    (c_start, c_skip, c_len, c_qterm) int32[B, NC] and c_scale f32[B, NC]
    (word 2, the job's premultiplied scale).  See ``chunk_tables``."""
    take, *tables = chunk_tables(jobs, chunk, num_chunks)
    return (*tables, take(jobs[..., 2].contiguous().view(torch.float32)))


def _range_scale(scorer, aux, jobs, take, c_start, c_scale, chunk: int):
    """Per-lane scale f32[B, NC, C] of a term-range class.

    Chunks of a range job (word 1 bit 30) take ``idf * device_range_boost(
    term_len, qlen)`` per posting, with idf (f32 bits) and the posting's term
    byte length from aux rows 0 and 1 and the query term's byte length from
    word 2, converted to f32 (word 2 of a range job is an int, not scale
    bits); chunks of per-expansion jobs keep their job's scale."""
    c_range = (take(jobs[..., 1]) >> 30) & 1
    c_qlenb = take(jobs[..., 2]).to(torch.float32)
    pos = torch.arange(chunk, dtype=torch.int64, device=aux.device)
    a = aux[:2, c_start.long()[..., None] + pos]  # [2, B, NC, C]
    idf = a[0].contiguous().view(torch.float32)
    boost = scorer.device_range_boost(a[1].to(torch.float32), c_qlenb[..., None])
    return torch.where(c_range[..., None] > 0, idf * boost, c_scale[..., None])


def _query_step(
    scorer, rec, field_avg, fields_boost, jobs_flat, aux=None,
    *, chunk: int, k: int, qterm_bits: int, num_fields: int, num_chunks: int,
    use_ranges: bool = False,
):
    """One shape class: ``jobs_flat`` int32[B, NJ * 3] -> top-k per row.

    Classes of power-of-two chunk width without range jobs run the fused
    kernel (K1, or K3 + the merge kernel K5 over presorted runs).  Range
    classes (``use_ranges``, which need ``aux``) and other chunk widths run
    ``staged_lanes``, then K5 with a full sort: a range chunk spans many
    terms, so its lanes are not doc-sorted."""
    C, NC = chunk, num_chunks
    if not use_ranges and C & (C - 1) == 0:
        jobs = jobs_flat.reshape(jobs_flat.shape[0], -1, 3)
        tables = expand_chunks(jobs, C, NC)
        scalars = torch.cat([field_avg, fields_boost])
        kw = dict(chunk=C, k=k, qterm_bits=qterm_bits, num_fields=num_fields)
        if NC * C <= _FUSED_MAX_LANES:
            return fused_query_topk(scorer, rec, *tables, scalars, **kw)
        score_l, key_l = fused_query_topk(scorer, rec, *tables, scalars, **kw, phase="lanes")
        excl = bool(getattr(scorer, "device_excludes_nonpositive", False))
        return merge_scores_topk_fused(
            key_l, score_l, k, qterm_bits, run=C, excl=excl, max_seg=NC
        )
    key, score = staged_lanes(
        scorer, rec, field_avg, fields_boost, jobs_flat, aux, chunk=C,
        qterm_bits=qterm_bits, num_fields=num_fields, num_chunks=NC, use_ranges=use_ranges,
    )
    return merge_scores_topk_fused(key, score, k, qterm_bits)


def staged_lanes(
    scorer, rec, field_avg, fields_boost, jobs_flat, aux=None,
    *, chunk: int, qterm_bits: int, num_fields: int, num_chunks: int, use_ranges: bool = False,
):
    """The staged torch gather + score of one class (the JAX engine's XLA
    path): (key int32[B, L], score f32[B, L]), L = NC * C, with keys
    ``doc << qterm_bits | qterm`` on live lanes (in the payload, the doc
    alive, and for an excluding scorer a positive score) and INT32_MAX
    elsewhere: the input of K5's full sort."""
    C, NC = chunk, num_chunks
    B = jobs_flat.shape[0]
    jobs = jobs_flat.reshape(B, -1, 3)
    take, c_start, c_skip, c_len, c_qterm = chunk_tables(jobs, C, NC)
    c_scale = take(jobs[..., 2].contiguous().view(torch.float32))
    scale = (
        _range_scale(scorer, aux, jobs, take, c_start, c_scale, C)
        if use_ranges
        else c_scale[..., None]
    )
    score, doc, _pos, in_pay, alive = gather_score(
        scorer, rec, c_start, c_skip, c_len, c_qterm, scale,
        torch.cat([field_avg, fields_boost]), C, num_fields,
    )
    live = in_pay & alive
    if getattr(scorer, "device_excludes_nonpositive", False):
        live = live & (score > 0.0)
    key = torch.where(live, (doc << qterm_bits) | c_qterm[..., None], INVALID_KEY)
    return key.to(torch.int32).reshape(B, NC * C), score.reshape(B, NC * C)


def _window_step(
    scorer, rec, field_avg, fields_boost, words_flat, aux=None,
    *, chunk: int, k: int, qterm_bits: int, num_fields: int, class_specs, fmt: str = "f32",
):
    """Run every shape class of a window and pack the results.

    ``words_flat`` int32[total] holds every class's [b_pad, NJ * 3] job
    table back to back; ``class_specs`` = ((b_pad, b_out, nj, nc, rng), ...),
    ``rng`` marking a term-range class (``aux`` goes to those only).  Only
    the first ``b_out`` rows of a class are computed (rows are independent;
    the rest are padding).  Returns the packed rows of every class,
    concatenated (see ``pack_result_rows``)."""
    outs = []
    off = 0
    for b_pad, b_out, nj, nc, rng in class_specs:
        n = b_pad * nj * 3
        jobs_flat = words_flat[off : off + n].reshape(b_pad, nj * 3)[:b_out]
        off += n
        kk = min(k, nc * chunk)
        s, d = _query_step(
            scorer, rec, field_avg, fields_boost, jobs_flat, aux if rng else None,
            chunk=chunk, k=kk, qterm_bits=qterm_bits, num_fields=num_fields, num_chunks=nc,
            use_ranges=rng,
        )
        if kk < k:
            s = torch.nn.functional.pad(s, (0, k - kk), value=float("-inf"))
            d = torch.nn.functional.pad(d, (0, k - kk), value=-1)
        outs.append(pack_result_rows(s, d, fmt))
    return torch.cat(outs, dim=0)


def pack_result_rows(s, d, fmt: str):
    """Pack one class's top-k rows into the window's result format.

      "f32"     int32[rows, 2, k] — f32 score bits + int32 slots
      "compact" int16[rows, 3, k] — f16 score bits + slot lo/hi halves
      "slots"   int8[rows, 3, k]  — slot bytes only, no scores; the sentinel
                slot -1 survives as three 0xFF bytes
      "slots20" int8[rows, 2k + ceil(k/2)] — 20-bit nibble-packed slots
                (k lo bytes, k mid bytes, ceil(k/2) packed hi nibbles, even
                entry in the low nibble); needs slots < 2^20, and the
                sentinel -1 packs to 0xFFFFF (``>> 16`` is arithmetic)
    Byte for byte what the JAX engine packs."""
    if fmt == "compact":
        s16 = s.to(torch.float16).view(torch.int16)
        lo = (d & 0xFFFF).to(torch.int16)
        hi = ((d >> 16) & 0xFFFF).to(torch.int16)
        return torch.stack([s16, lo, hi], dim=1)
    if fmt == "slots":
        lo = (d & 0xFF).to(torch.int8)
        mid = ((d >> 8) & 0xFF).to(torch.int8)
        hi = ((d >> 16) & 0xFF).to(torch.int8)
        return torch.stack([lo, mid, hi], dim=1)
    if fmt == "slots20":
        lo = (d & 0xFF).to(torch.int8)
        mid = ((d >> 8) & 0xFF).to(torch.int8)
        hi = (d >> 16) & 0xF
        if hi.shape[1] % 2:
            hi = torch.nn.functional.pad(hi, (0, 1), value=0xF)
        hp = (hi[:, 0::2] | (hi[:, 1::2] << 4)).to(torch.int8)
        return torch.cat([lo, mid, hp], dim=1)
    return torch.stack([s.view(torch.int32), d], dim=1)


def unpack_result_rows(packed: np.ndarray, fmt: str, k: int):
    """Decode a host copy of packed rows -> (scores f32[rows, k] | None,
    slots int32[rows, k]); slots formats carry no scores."""
    if fmt == "compact":
        scores = packed[:, 0, :].view(np.float16).astype(np.float32)
        lo = packed[:, 1, :].view(np.uint16).astype(np.uint32)
        hi = packed[:, 2, :].view(np.uint16).astype(np.uint32)
        slots = (lo | (hi << 16)).view(np.int32)
    elif fmt == "slots":
        lo = packed[:, 0, :].astype(np.int32) & 0xFF
        mid = packed[:, 1, :].astype(np.int32) & 0xFF
        hi = packed[:, 2, :].astype(np.int32)  # sign-extends bit 23
        slots = lo | (mid << 8) | (hi << 16)
        scores = None
    elif fmt == "slots20":
        lo = packed[:, :k].astype(np.int32) & 0xFF
        mid = packed[:, k : 2 * k].astype(np.int32) & 0xFF
        hp = packed[:, 2 * k :].astype(np.int32) & 0xFF
        hi = np.empty((packed.shape[0], 2 * hp.shape[1]), np.int32)
        hi[:, 0::2] = hp & 0xF
        hi[:, 1::2] = hp >> 4
        slots = lo | (mid << 8) | (hi[:, :k] << 16)
        # 0xFFFFF is the -1 sentinel (the format needs num_slots < 2^20).
        slots = np.where(slots == 0xFFFFF, -1, slots).astype(np.int32)
        scores = None
    else:
        scores = packed[:, 0, :].view(np.float32)
        slots = packed[:, 1, :]
    return scores, slots


def resolve_result_format(fmt: str, num_slots: int) -> str:
    """Downgrade a requested format to one that can address every doc slot:
    slots20 needs < 2^20 slots, slots < 2^23, else compact."""
    if fmt == "slots20" and num_slots >= (1 << 20):
        fmt = "slots"
    if fmt in ("slots", "slots20") and num_slots >= (1 << 23):
        return "compact"
    return fmt


def _scorer_cache_key(scorer):
    key = getattr(scorer, "device_cache_key", None)
    return key() if callable(key) else ("id", id(scorer))


def _bucket(n: int, buckets: Sequence[int], minimum: int) -> int:
    n = max(n, minimum)
    for b in buckets:
        if b >= n:
            return b
    return 1 << (n - 1).bit_length()


def _bucket_vec(n: np.ndarray, buckets: Sequence[int], minimum: int) -> np.ndarray:
    """Vectorized ``_bucket``."""
    n = np.maximum(np.asarray(n, dtype=np.int64), minimum)
    b = np.asarray(buckets, dtype=np.int64)
    idx = np.searchsorted(b, n, side="left")
    out = b[np.minimum(idx, len(b) - 1)]
    big = idx >= len(b)
    if big.any():
        # exact next power of two (log2 of ints is exact at powers of two)
        out[big] = 1 << np.ceil(np.log2(n[big])).astype(np.int64)
    return out


def _segment_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (vectorized)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


@dataclass
class PlannedJobs:
    """Flat job table for a batch, sorted by query."""

    jquery: np.ndarray  # int64[NJOBS]
    # int32[NJOBS, 3] — start; len | qterm << 26 | range << 30; scale bits
    # (a range job: the query term's UTF-8 byte length as an int)
    words: np.ndarray
    nchunks: np.ndarray  # int64[B] — total chunks per query
    njobs: np.ndarray  # int64[B]
    has_range: np.ndarray  # bool[B] — query carries a term-range job


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, {item})")


def fetch_windows_jointly(batches) -> None:
    """Not ported: the port starts each window's D2H copy at submit time."""
    raise _not_ported("fetch_windows_jointly", "M5 entry points")


class DeviceIndex:
    """Device-resident snapshot of an ``Index`` on a torch device.

    ``DeviceIndex(index, device="cuda")`` uploads the posting records once;
    ``query_batch_async`` plans, uploads and launches a query window without
    blocking, and the returned ``PendingBatch`` drains it.  ``device="cpu"``
    runs the same path through the kernels' plain torch versions."""

    # Heavy-query result cache capacity (entries), LRU.
    _HEAVY_CACHE_CAP = 4096
    # Postings per chunk (overridable via IndexConfig.chunk_size).
    CHUNK = 1024
    LANES_PER_DISPATCH = 1 << 24
    NC_BUCKETS = (
        4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
        3072, 4096, 6144, 8192, 12288, 16384,
    )
    # Fine buckets (IndexConfig.fine_nc_buckets, default on): non-pow2 chunk
    # counts, so e.g. a query of three single-chunk terms pads to 3 chunks,
    # not 4.  The merge runs on a virtual pow2 lane space, so any NC works.
    NC_BUCKETS_FINE = (
        2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128, 256, 512, 1024, 2048,
        3072, 4096, 6144, 8192, 12288, 16384,
    )
    NJ_BUCKETS = (4, 8, 16, 32, 64, 128, 256)

    def __init__(self, index, device="cuda") -> None:
        if not isinstance(index, Index):
            raise TypeError(
                f"DeviceIndex takes probly_search_tpu_torch.Index, not {type(index).__module__}."
                f"{type(index).__name__}; carry another package's index across with "
                "probly_search_tpu_torch.index.snapshot"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DeviceIndex(device={device!r}) needs a CUDA device; none is available"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"DeviceIndex runs on cuda or cpu, not {self.device}")
        if index.config.light_chunk_size:
            raise _not_ported("light_chunk_size (light classes)", "per-class dispatch")
        index._flush_pending()
        self.version = index.version
        self._index = index
        self.config = index.config
        self.CHUNK = int(index.config.chunk_size or type(self).CHUNK)
        if index.config.fine_nc_buckets:
            self.nc_buckets = type(self).NC_BUCKETS_FINE
            self.nc_min = 2
        else:
            self.nc_buckets = type(self).NC_BUCKETS
            self.nc_min = 4
        F = index.num_fields
        self.num_fields = F
        self.segments = list(index._segments)
        C = self.CHUNK

        # --- host-side planning structures -------------------------------
        self.seg_terms: List[np.ndarray] = []
        self.seg_term_lens: List[np.ndarray] = []
        self.seg_offsets: List[np.ndarray] = []
        self.seg_base: List[int] = []
        # Cumulative live-occurrence counts over each segment's postings:
        # df for any posting range is two lookups (static per snapshot).
        self.seg_live_cum: List[np.ndarray] = []
        base = 0
        doc_parts, tf_parts = [], []
        alive0 = index._alive
        for seg in self.segments:
            # Escaped <U tables: trailing-NUL terms must not alias under the
            # fixed-width conversion (segment.escape_terms_fixed).
            self.seg_terms.append(escape_terms_fixed(seg.terms))
            self.seg_term_lens.append(seg.term_lens)
            self.seg_offsets.append(seg.offsets)
            self.seg_base.append(base)
            occ_live = np.where(alive0[seg.post_doc], seg.post_occ, 0).astype(np.int64)
            cum = np.zeros(seg.num_postings + 1, dtype=np.int64)
            np.cumsum(occ_live, out=cum[1:])
            self.seg_live_cum.append(cum)
            doc_parts.append(seg.post_doc)
            tf_parts.append(seg.post_tf)
            base += seg.num_postings
        self.num_postings = base

        # --- posting record array ----------------------------------------
        S = index._next_slot
        self.num_slots = S
        self._qterm_bits = _QT_BITS
        if S >= (1 << (31 - self._qterm_bits)):
            raise ValueError(
                f"doc slots ({S}) exceed the packed int32 merge-key capacity"
            )
        P = self.num_postings
        R = 4 if (2 + 2 * F) <= 4 else -(-(2 + 2 * F) // 8) * 8
        rec = np.zeros((R, P + C), dtype=np.int32)
        rec[0] = -1  # slack tail: never in any job's payload range
        if P:
            post_doc = np.concatenate(doc_parts)
            post_tf = np.concatenate(tf_parts)
            alive = index._alive[:S]
            doc_len = index._doc_len[:S].astype(np.float32)
            rec[0, :P] = post_doc  # true slot even when dead: keeps runs sorted
            rec[1 : 1 + F, :P] = post_tf.T
            rec[1 + F : 1 + 2 * F, :P] = doc_len[post_doc].view(np.int32).T
            rec[1 + 2 * F, :P] = alive[post_doc]
        self.rec = torch.from_numpy(rec).to(self.device)
        self.field_avg = torch.from_numpy(
            np.array([fd.avg for fd in index._fields], dtype=np.float32)
        ).to(self.device)
        self.n_docs = float(len(index._docs))
        self.slot_to_key = list(index._slot_to_key)
        self._key_arr: Optional[np.ndarray] = None
        # Per-scorer pooled term plans and per-(scorer, tokenizer) pooled
        # query plans (see _term_plans / plan_batch); the lock serializes
        # pool growth across concurrent submitters.
        self._plan_pools: Dict[Any, Dict[str, Any]] = {}
        self._qplan_pools: Dict[Any, Dict[str, Any]] = {}
        # Per-tokenizer pooled zero-to-one query plans (ops/z2o_device.py).
        self._z2o_qplans: Dict[Any, Dict[str, Any]] = {}
        self._plan_lock = threading.RLock()
        # Per-scorer aux record arrays of term-range jobs (_aux_rec), on the
        # index's device.
        self._aux_cache: Dict[Any, Any] = {}
        # Heavy-query result cache: (scorer key, job-table bytes, boosts) ->
        # (scores f32[Kc] | None, slots int32[Kc]); snapshot-static.
        self._heavy_cache: Dict[Any, Any] = {}
        # Frozen window-composition templates: (scorer key, k, fmt, window
        # size) -> [(nc, nj, row_capacity), ...].
        self._comp_templates: Dict[Any, list] = {}

    def _aux_rec(self, scorer):
        """Aux record array int32[4, P + C] of term-range jobs, built on the
        host and uploaded once per scorer to the index's device:

          aux[0]  f32 bits: the scorer's static per-term scale part
                  (``device_term_static`` over the term's global live df,
                  summed across segments; BM25: the df-clamped idf)
          aux[1]  the posting's term UTF-8 byte length
          aux[2:] zero pad

        Bit for bit the JAX engine's array."""
        key = _scorer_cache_key(scorer)
        cached = self._aux_cache.get(key)
        if cached is not None:
            return cached
        P = self.num_postings
        aux = np.zeros((4, P + self.CHUNK), dtype=np.int32)
        if P:
            gterms = np.unique(np.concatenate(self.seg_terms))
            gdf = np.zeros(len(gterms), dtype=np.float64)
            for si, terms in enumerate(self.seg_terms):
                if len(terms) == 0:
                    continue
                offs = self.seg_offsets[si]
                cum = self.seg_live_cum[si]
                gdf[np.searchsorted(gterms, terms)] += cum[offs[1:]] - cum[offs[:-1]]
            static = np.asarray(scorer.device_term_static(gdf, self.n_docs), dtype=np.float32)
            pos = 0
            for si, terms in enumerate(self.seg_terms):
                if len(terms) == 0:
                    continue
                reps = np.diff(self.seg_offsets[si]).astype(np.int64)
                n = int(reps.sum())
                gid = np.searchsorted(gterms, terms)
                aux[0, pos : pos + n] = np.repeat(static[gid], reps).view(np.int32)
                aux[1, pos : pos + n] = np.repeat(
                    np.asarray(self.seg_term_lens[si], np.int32), reps
                )
                pos += n
        arr = torch.from_numpy(aux).to(self.device)
        self._aux_cache[key] = arr
        return arr

    # ------------------------------------------------------------------ #
    # planning (host, vectorized)                                         #
    # ------------------------------------------------------------------ #

    def _term_plans(self, uniq_terms: Sequence[str], scorer) -> None:
        """Compute and pool the per-term job plan of every term in
        ``uniq_terms`` not pooled yet: its prefix expansion ranges per
        segment, the per-expansion df (grouped across segments; df == 0
        expansions dropped), the expansion boost and the premultiplied
        per-job scale (the vectorized ``before_each``).  A term with at least
        ``range_min_expansions`` expansions (for a scorer with the range
        halves) instead plans one term-range job per segment over its whole
        contiguous CSR range."""
        pool = self._plan_pools.get(_scorer_cache_key(scorer))
        if pool is None:
            pool = {
                "ids": {},  # term -> dense id
                "sorted_terms": np.zeros(0, dtype=np.str_),  # probe arrays
                "sorted_ids": np.zeros(0, dtype=np.int64),
                "off": np.zeros(1, dtype=np.int64),
                "start": np.zeros(0, dtype=np.int64),
                "len": np.zeros(0, dtype=np.int64),
                "scale": np.zeros(0, dtype=np.float32),
                "chunks": np.zeros(0, dtype=np.int64),  # per term
                "over_cap": np.zeros(0, dtype=bool),  # per term
                "range": np.zeros(0, dtype=bool),  # per job: term-range job
            }
            self._plan_pools[_scorer_cache_key(scorer)] = pool
        ids = pool["ids"]
        miss = [t for t in uniq_terms if t not in ids]
        if not miss:
            return
        cfg = self.config
        # Escaped probes paired with the escaped seg_terms tables; byte
        # lengths are of the raw terms.
        flat_terms, flat_blen = probe_terms_fixed(miss)
        M = len(flat_terms)
        flat_upper = np.char.add(flat_terms, _MAX_CHAR)

        # Prefix ranges per segment, and term-range eligibility: a term with
        # at least range_min_expansions expansions gets one job per segment
        # over its whole contiguous CSR range instead of one per expansion.
        thr = cfg.range_min_expansions
        supports_ranges = (
            thr > 0
            and hasattr(scorer, "device_term_static")
            and hasattr(scorer, "device_range_boost")
        )
        seg_ranges: List[Any] = []
        nexp_total = np.zeros(M, dtype=np.int64)
        for si in range(len(self.segments)):
            terms = self.seg_terms[si]
            if len(terms) == 0:
                seg_ranges.append(None)
                continue
            lo = np.searchsorted(terms, flat_terms, side="left")
            hi = np.searchsorted(terms, flat_upper, side="left")
            seg_ranges.append((lo, hi))
            nexp_total += hi - lo
        eligible = nexp_total >= thr if supports_ranges else np.zeros(M, dtype=bool)

        # Per segment: one job per expansion of a non-eligible term, each
        # carrying its live df (two lookups in the live-occurrence cumsum).
        job_parts = []
        for si in range(len(self.segments)):
            terms = self.seg_terms[si]
            if seg_ranges[si] is None:
                continue
            lo, hi = seg_ranges[si]
            nexp = np.where(eligible, 0, hi - lo)
            if nexp.max(initial=0) == 0:
                continue
            tid = np.repeat(lo, nexp) + _segment_arange(nexp)
            jidx = np.repeat(np.arange(M, dtype=np.int64), nexp)
            offs = self.seg_offsets[si]
            local = offs[tid].astype(np.int64)
            length = (offs[tid + 1] - offs[tid]).astype(np.int64)
            cum = self.seg_live_cum[si]
            ldf = cum[local + length] - cum[local]
            job_parts.append(
                (
                    jidx,
                    self.seg_base[si] + local,
                    length,
                    terms[tid],
                    self.seg_term_lens[si][tid].astype(np.int64),
                    ldf,
                )
            )
        if job_parts:
            jidx, jstart, jlen, jexp, jblen, jldf = (
                np.concatenate([p[i] for p in job_parts]) for i in range(6)
            )
            keep = jlen > 0
            jidx, jstart, jlen, jexp, jblen, jldf = (
                jidx[keep], jstart[keep], jlen[keep], jexp[keep], jblen[keep],
                jldf[keep],
            )
        else:
            jidx = np.zeros(0, dtype=np.int64)

        if len(jidx):
            # df groups: jobs of the same (term, expanded term) across
            # segments share one df (the sum of the segment dfs).
            order = np.lexsort((jexp, jidx))
            jidx, jstart, jlen, jexp, jblen, jldf = (
                jidx[order], jstart[order], jlen[order], jexp[order],
                jblen[order], jldf[order],
            )
            new_group = np.ones(len(jidx), dtype=bool)
            new_group[1:] = (jidx[1:] != jidx[:-1]) | (jexp[1:] != jexp[:-1])
            group_global = np.cumsum(new_group) - 1
            group_df = np.bincount(group_global, weights=jldf.astype(np.float64))
            jdf = group_df[group_global]

            # df == 0 expansions are never scored: drop their jobs.
            keep_df = jdf > 0
            jidx, jstart, jlen, jexp, jblen, jdf, new_group = (
                jidx[keep_df], jstart[keep_df], jlen[keep_df], jexp[keep_df],
                jblen[keep_df], jdf[keep_df], new_group[keep_df],
            )

        if len(jidx):
            per_term_groups = np.bincount(jidx[new_group], minlength=M)
            over_cap = (
                per_term_groups > cfg.max_expansions
                if cfg.max_expansions
                else np.zeros(M, dtype=bool)
            )
            # Expansion boost (byte lengths), f64 until the single rounding
            # into the packed f32 scale word.
            exact = jexp == flat_terms[jidx]
            boost = np.where(
                exact, 1.0, np.log1p(1.0 / (1.0 + jblen - flat_blen[jidx]))
            )
            scale = scorer.device_term_scale(jdf, self.n_docs, boost)
        else:
            over_cap = np.zeros(M, dtype=bool)
            jstart = np.zeros(0, dtype=np.int64)
            jlen = np.zeros(0, dtype=np.int64)
            scale = np.zeros(0, dtype=np.float32)
        jrange = np.zeros(len(jidx), dtype=bool)

        # Term-range jobs of eligible terms: one per (term, segment) over the
        # whole expansion range (the postings of terms [lo, hi) are
        # contiguous in the CSR).  Word 2 carries the query term's byte
        # length; the device builds the per-lane scale from the aux rows.
        if eligible.any():
            r_idx, r_start, r_len, r_qb = [], [], [], []
            for si, rng_ in enumerate(seg_ranges):
                if rng_ is None:
                    continue
                lo, hi = rng_
                offs = self.seg_offsets[si]
                for i in np.flatnonzero(eligible & (hi > lo)):
                    s, e = int(offs[lo[i]]), int(offs[hi[i]])
                    if e > s:
                        r_idx.append(i)
                        r_start.append(self.seg_base[si] + s)
                        r_len.append(e - s)
                        r_qb.append(int(flat_blen[i]))
            if r_idx:
                jidx = np.concatenate([jidx, np.asarray(r_idx, np.int64)])
                jstart = np.concatenate([jstart, np.asarray(r_start, np.int64)])
                jlen = np.concatenate([jlen, np.asarray(r_len, np.int64)])
                scale = np.concatenate([scale, np.asarray(r_qb, np.int32).view(np.float32)])
                jrange = np.concatenate([jrange, np.ones(len(r_idx), bool)])

        if len(jidx):
            # Split jobs longer than the packed-length capacity (the parts
            # share the job's scale word, so scores are unchanged).
            if jlen.max(initial=0) > _MAX_JOB_LEN:
                nsplit = (jlen + _MAX_JOB_LEN - 1) // _MAX_JOB_LEN
                si_ = _segment_arange(nsplit)
                sj = np.repeat(np.arange(len(jidx), dtype=np.int64), nsplit)
                jstart = jstart[sj] + si_ * _MAX_JOB_LEN
                jlen = np.minimum(jlen[sj] - si_ * _MAX_JOB_LEN, _MAX_JOB_LEN)
                jidx = jidx[sj]
                scale = scale[sj]
                jrange = jrange[sj]
            # Over-cap terms contribute no pooled jobs (their queries fall
            # back to the host path).
            if over_cap.any():
                keep3 = ~over_cap[jidx]
                jidx, jstart, jlen, scale, jrange = (
                    jidx[keep3], jstart[keep3], jlen[keep3], scale[keep3], jrange[keep3],
                )
            order2 = np.argsort(jidx, kind="stable")
            jidx, jstart, jlen, scale, jrange = (
                jidx[order2], jstart[order2], jlen[order2], scale[order2], jrange[order2],
            )
            nj_per_term = np.bincount(jidx, minlength=M)
        else:
            nj_per_term = np.zeros(M, dtype=np.int64)

        # Chunks per job under the stride-C contiguous scheme (must match
        # expand_chunks exactly: class bucketing depends on it).
        C_ = self.CHUNK
        job_chunks = np.where(jlen > 0, (jstart % 128 + jlen + C_ - 1) // C_, 0)
        term_chunks = np.bincount(
            jidx, weights=job_chunks.astype(np.float64), minlength=M
        ).astype(np.int64) if len(jidx) else np.zeros(M, dtype=np.int64)

        base = len(pool["off"]) - 1
        for i, t in enumerate(miss):
            ids[str(t)] = base + i
        pool["off"] = np.concatenate(
            [pool["off"], pool["off"][-1] + np.cumsum(nj_per_term)]
        )
        pool["start"] = np.concatenate([pool["start"], jstart])
        pool["len"] = np.concatenate([pool["len"], jlen])
        pool["scale"] = np.concatenate([pool["scale"], scale])
        pool["chunks"] = np.concatenate([pool["chunks"], term_chunks])
        pool["over_cap"] = np.concatenate([pool["over_cap"], over_cap])
        pool["range"] = np.concatenate([pool["range"], jrange])
        # Rebuild the sorted (escaped) probe arrays; ids stay raw-keyed.
        keys_raw = list(ids.keys())
        esc = escape_terms_fixed(keys_raw)
        order = np.argsort(esc)
        pool["sorted_terms"] = esc[order]
        vals = np.fromiter((ids[k] for k in keys_raw), dtype=np.int64, count=len(keys_raw))
        pool["sorted_ids"] = vals[order]

    # Query-plan pool caps: beyond these the pool restarts (bounds memory
    # under all-distinct traffic).
    _QPLAN_MAX_QUERIES = 1 << 20
    _QPLAN_MAX_ROWS = 8 << 20

    def plan_batch(self, queries: Sequence[str], tokenizer, scorer):
        """Plan a batch into a flat job table (thread-safe).

        A repeated query string costs one dict lookup plus a CSR gather from
        the query-plan pool.  Returns ``(PlannedJobs | None, fallback)``
        where ``fallback`` lists the queries past a device cap (too many
        terms or expansions, or too many chunks); those run on the host."""
        with self._plan_lock:
            qp = self._qplan_pool(scorer, tokenizer)
            ids = qp["ids"]
            B = len(queries)
            qids = np.fromiter((ids.get(q, -1) for q in queries), np.int64, count=B)
            if (qids < 0).any():
                miss = sorted({queries[i] for i in np.flatnonzero(qids < 0)})
                self._qplan_insert(qp, miss, tokenizer, scorer)
                qids = np.fromiter((ids[q] for q in queries), np.int64, count=B)
            fallback = [int(i) for i in np.flatnonzero(qp["fallback"][qids])]
            nj = qp["njobs"][qids]
            if int(nj.sum()) == 0:
                return None, fallback
            jquery = np.repeat(np.arange(B, dtype=np.int64), nj)
            rows = np.repeat(qp["off"][qids], nj) + _segment_arange(nj)
            return PlannedJobs(
                jquery=jquery,
                words=qp["words"][rows],
                nchunks=qp["nchunks"][qids],
                njobs=nj,
                has_range=qp["has_range"][qids],
            ), fallback

    def _qplan_pool(self, scorer, tokenizer):
        key = (_scorer_cache_key(scorer), tokenizer)
        qp = self._qplan_pools.get(key)
        if qp is None or (
            len(qp["ids"]) > self._QPLAN_MAX_QUERIES
            or len(qp["words"]) > self._QPLAN_MAX_ROWS
        ):
            qp = {
                "ids": {},  # query string -> dense qid
                "off": np.zeros(1, dtype=np.int64),
                "words": np.zeros((0, 3), dtype=np.int32),
                "nchunks": np.zeros(0, dtype=np.int64),
                "njobs": np.zeros(0, dtype=np.int64),
                "has_range": np.zeros(0, dtype=bool),
                "fallback": np.zeros(0, dtype=bool),
            }
            self._qplan_pools[key] = qp
        return qp

    def _qplan_insert(self, qp, miss: List[str], tokenizer, scorer) -> None:
        """Plan first-seen queries and pool their job rows (a query's rows
        are contiguous: ``jquery`` ascends by construction)."""
        plan, fb = self._plan_batch_impl(miss, tokenizer, scorer)
        M = len(miss)
        fb_m = np.zeros(M, dtype=bool)
        fb_m[list(fb)] = True
        if plan is None:
            nj_m = np.zeros(M, dtype=np.int64)
            words_m = np.zeros((0, 3), dtype=np.int32)
            nch_m = np.zeros(M, dtype=np.int64)
            rng_m = np.zeros(M, dtype=bool)
        else:
            nj_m, words_m, nch_m, rng_m = plan.njobs, plan.words, plan.nchunks, plan.has_range
        base = len(qp["off"]) - 1
        for i, q in enumerate(miss):
            qp["ids"][q] = base + i
        qp["off"] = np.concatenate([qp["off"], qp["off"][-1] + np.cumsum(nj_m)])
        qp["words"] = np.concatenate([qp["words"], words_m])
        qp["nchunks"] = np.concatenate([qp["nchunks"], nch_m])
        qp["njobs"] = np.concatenate([qp["njobs"], nj_m])
        qp["has_range"] = np.concatenate([qp["has_range"], rng_m])
        qp["fallback"] = np.concatenate([qp["fallback"], fb_m])

    def _plan_batch_impl(self, queries: Sequence[str], tokenizer, scorer):
        B = len(queries)
        fallback: List[int] = []

        tok_lists = [[t for t in tokenizer(q) if t] for q in queries]
        max_terms = min(self.config.max_query_terms, 1 << self._qterm_bits)
        for qi, toks in enumerate(tok_lists):
            if len(toks) > max_terms:
                fallback.append(qi)
                tok_lists[qi] = []
        counts = np.array([len(t) for t in tok_lists], dtype=np.int64)
        if int(counts.sum()) == 0 or self.num_postings == 0:
            return None, fallback
        flat_query = np.repeat(np.arange(B, dtype=np.int64), counts)
        flat_qterm = _segment_arange(counts).astype(np.int64)
        flat_terms = [t for toks in tok_lists for t in toks]

        def lookup(pool, flat_arr):
            st = pool["sorted_terms"] if pool is not None else None
            if st is None or len(st) == 0:
                return np.full(len(flat_arr), -1, np.int64)
            p = np.minimum(np.searchsorted(st, flat_arr), len(st) - 1)
            return np.where(st[p] == flat_arr, pool["sorted_ids"][p], -1)

        pool = self._plan_pools.get(_scorer_cache_key(scorer))
        flat_arr = escape_terms_fixed(flat_terms)  # matches the pool's probes
        tids = lookup(pool, flat_arr)
        if (tids < 0).any():
            miss = sorted({t for t, i in zip(flat_terms, tids) if i < 0})
            self._term_plans(miss, scorer)
            pool = self._plan_pools[_scorer_cache_key(scorer)]
            tids = lookup(pool, flat_arr)

        # Queries containing an over-cap term degrade to the host path.
        over = pool["over_cap"][tids]
        if over.any():
            bad = np.unique(flat_query[over])
            fallback.extend(int(q) for q in bad)
            keep = ~np.isin(flat_query, bad)
            flat_query, flat_qterm, tids = flat_query[keep], flat_qterm[keep], tids[keep]
            if len(tids) == 0:
                return None, fallback

        # Assemble the flat job table: CSR gather from the pooled plans.
        off = pool["off"]
        nj = off[tids + 1] - off[tids]
        rows = np.repeat(off[tids], nj) + _segment_arange(nj)
        if len(rows) == 0:
            return None, fallback
        jquery = np.repeat(flat_query, nj)
        jqterm = np.repeat(flat_qterm, nj)
        jrange = pool["range"][rows]
        words = np.empty((len(rows), 3), dtype=np.int32)
        words[:, 0] = pool["start"][rows]
        words[:, 1] = pool["len"][rows] | (jqterm << _LEN_BITS) | (jrange << 30)
        words[:, 2] = pool["scale"][rows].view(np.int32)
        has_range = np.bincount(jquery, weights=jrange.astype(np.float64), minlength=B) > 0
        nchunks = np.bincount(
            flat_query, weights=pool["chunks"][tids].astype(np.float64), minlength=B
        ).astype(np.int64)
        njobs = np.bincount(jquery, minlength=B)

        # Lane-budget guard: a query whose chunk total exceeds one class's
        # lane budget runs on the scorer's vectorized host path.
        over_lanes = np.flatnonzero(nchunks > self.LANES_PER_DISPATCH // self.CHUNK)
        if len(over_lanes):
            fallback.extend(int(q) for q in over_lanes)
            keep = ~np.isin(jquery, over_lanes)
            jquery, words = jquery[keep], words[keep]
            nchunks[over_lanes] = 0
            njobs = np.bincount(jquery, minlength=B)
            if len(jquery) == 0:
                return None, fallback
        return PlannedJobs(
            jquery=jquery, words=words, nchunks=nchunks, njobs=njobs.astype(np.int64),
            has_range=has_range,
        ), fallback

    @staticmethod
    def _pow2_spans(n: int, cap: int, min_pad: int = 8, min_take: int = 512):
        """Split ``n`` class rows into (take, padded_rows) spans: greedy
        largest-power-of-two slices (bounded by ``cap``) while at least
        ``min_take`` rows remain, then one padded tail."""
        cap2 = 1 << (max(cap, 1).bit_length() - 1)  # largest pow2 <= cap
        spans = []
        rem = n
        while rem > 0:
            big = min(1 << (rem.bit_length() - 1), cap2)
            if big >= min_take and big < rem:
                spans.append((big, big))
                rem -= big
            else:
                take = min(rem, cap2)
                spans.append((take, max(min_pad, 1 << (take - 1).bit_length())))
                rem -= take
        return spans

    def _fill_jobs(self, plan: PlannedJobs, jpos, idxs, rows_cap: int, nj: int):
        """int32[rows_cap, nj * 3] job table of the queries ``idxs``."""
        jobs_flat = np.zeros((rows_cap, nj, 3), dtype=np.int32)
        if len(idxs):
            qnj = plan.njobs[idxs]
            rows = np.repeat(np.arange(len(idxs), dtype=np.int64), qnj)
            pos = _segment_arange(qnj)
            src = np.repeat(jpos[idxs], qnj) + pos
            jobs_flat[rows, pos] = plan.words[src]
        return jobs_flat.reshape(rows_cap, nj * 3)

    @staticmethod
    def _job_rows(plan: PlannedJobs, n_queries: int):
        jpos = np.zeros(n_queries, dtype=np.int64)
        np.subtract(np.cumsum(plan.njobs), plan.njobs, out=jpos)
        return jpos

    def pack_dispatches(self, n_queries: int, plan: PlannedJobs):
        """Bucket queries into shape classes and pack their job tables.

        Returns [(query_indices, jobs_flat int32[B_pad, NJ*3], NC, NJ, rng),
        ...]; each dispatch holds at most LANES_PER_DISPATCH lanes.  Queries
        that carry a term-range job form classes of their own (``rng``; class
        id bit 0), of at most 2 rows padded to the real row count: their
        staged gather holds [B, NC, C] record and aux lanes at once."""
        C = self.CHUNK
        nc_bucket = _bucket_vec(plan.nchunks, self.nc_buckets, self.nc_min)
        alive = plan.njobs > 0
        class_of_q = np.where(alive, nc_bucket * 2 + plan.has_range.astype(np.int64), -1)
        order = np.argsort(class_of_q, kind="stable")
        sorted_cls = class_of_q[order]
        jpos = self._job_rows(plan, n_queries)

        out = []
        for cls in np.unique(class_of_q[alive]) if alive.any() else []:
            cls = int(cls)
            nc, rng = cls // 2, bool(cls & 1)
            members = order[sorted_cls == cls]
            nj = _bucket(int(plan.njobs[members].max()), self.NJ_BUCKETS, 4)
            b_cap = max(1, int(self.LANES_PER_DISPATCH // (nc * C)))
            # Range classes and huge classes (usually single queries) pad to
            # their real row count, not to 8 rows.
            min_pad = 1 if (rng or nc * C > (1 << 21)) else 8
            if rng:
                b_cap = min(b_cap, 2)
            if rng or not self.config.pow2_row_split:
                spans = [
                    (m, max(min_pad, 1 << (m - 1).bit_length()))
                    for m in (
                        len(members[s : s + b_cap])
                        for s in range(0, len(members), b_cap)
                    )
                ]
            else:
                spans = self._pow2_spans(len(members), b_cap, min_pad)
            s = 0
            for B, B_pad in spans:
                idxs = members[s : s + B]
                s += B
                out.append((idxs, self._fill_jobs(plan, jpos, idxs, B_pad, nj), nc, nj, rng))
        return out

    def _pack_dispatches_template(self, n_queries: int, plan: PlannedJobs, tkey):
        """Template-composition packing (IndexConfig.template_compositions).

        Returns (dispatches, class_specs) with the class layout drawn from a
        frozen per-(scorer, k, fmt, window size) template: fixed entry
        order, fixed row capacities (b_pad == b_out), one dispatch per
        entry.  Queries that overflow an entry spill into the next larger
        eligible one (their extra chunk slots are dead padding); only a
        window the whole template cannot hold re-freezes it."""
        C = self.CHUNK
        nc_b = _bucket_vec(plan.nchunks, self.nc_buckets, self.nc_min)
        nj_b = _bucket_vec(plan.njobs, self.NJ_BUCKETS, 4)
        alive = plan.njobs > 0
        jpos = self._job_rows(plan, n_queries)

        # Distinct live query classes, ascending (nc, nj).
        cls = np.where(alive, (nc_b << 12) | nj_b, -1)
        order = np.argsort(cls, kind="stable")
        scls = cls[order]
        start = int(np.searchsorted(scls, 0))
        qorder, qcls = order[start:], scls[start:]
        if len(qorder) == 0:
            return [], ()
        bounds = np.flatnonzero(np.r_[True, qcls[1:] != qcls[:-1], True])
        qclasses = [
            (
                int(qcls[bounds[i]]) >> 12,
                int(qcls[bounds[i]]) & 0xFFF,
                qorder[bounds[i] : bounds[i + 1]],
            )
            for i in range(len(bounds) - 1)
        ]

        def try_assign(entries):
            remaining = [e[2] for e in entries]
            buckets = [[] for _ in entries]
            for ncq, njq, members in qclasses:
                pos = 0
                for ei, (nct, njt, _cap) in enumerate(entries):
                    if nct < ncq or njt < njq:
                        continue
                    take = min(remaining[ei], len(members) - pos)
                    if take:
                        buckets[ei].append(members[pos : pos + take])
                        remaining[ei] -= take
                        pos += take
                    if pos == len(members):
                        break
                if pos < len(members):
                    return None
            return buckets

        entries = self._comp_templates.get(tkey)
        buckets = try_assign(entries) if entries else None
        if buckets is None:
            # (Re)freeze.  Per nc: capacity = max(current count x headroom,
            # previous total capacity), rounded up to 8 rows; nj = the
            # largest bucket seen.  Capacities only grow, so refreezes
            # converge.
            headroom = float(self.config.template_headroom)
            need: Dict[int, int] = {}
            njmax: Dict[int, int] = {}
            prev_cap: Dict[int, int] = {}
            for ncq, njq, members in qclasses:
                need[ncq] = need.get(ncq, 0) + len(members)
                njmax[ncq] = max(njmax.get(ncq, 0), njq)
            for nc, nj, cap in entries or ():
                prev_cap[nc] = prev_cap.get(nc, 0) + cap
                njmax[nc] = max(njmax.get(nc, 0), nj)
            entries = []
            for nc in sorted(set(need) | set(prev_cap)):
                want = max(int(need.get(nc, 0) * headroom), prev_cap.get(nc, 0))
                cap_total = -(-want // 8) * 8
                b_cap = max(8, (self.LANES_PER_DISPATCH // (nc * C)) // 8 * 8)
                while cap_total > 0:
                    cap = min(cap_total, b_cap)
                    entries.append((nc, njmax[nc], cap))
                    cap_total -= cap
            self._comp_templates[tkey] = entries
            metrics.inc("template_refreezes", 1)
            buckets = try_assign(entries)
            if buckets is None:  # capacities were sized to hold this window
                raise RuntimeError(
                    f"template refreeze failed to hold its own window: {entries}"
                )

        dispatches, class_specs = [], []
        for (nc, nj, cap), blist in zip(entries, buckets):
            idxs = np.concatenate(blist) if blist else np.empty(0, dtype=np.int64)
            dispatches.append((idxs, self._fill_jobs(plan, jpos, idxs, cap, nj), nc, nj, False))
            class_specs.append((cap, cap, nj, nc, False))
        return dispatches, tuple(class_specs)

    # ------------------------------------------------------------------ #
    # execution                                                           #
    # ------------------------------------------------------------------ #

    def query_batch(
        self,
        queries: Sequence[str],
        scorer,
        tokenizer=whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
    ) -> List[List[QueryResult]]:
        """Blocking convenience over the async path.  With
        ``IndexConfig.serving_window`` set, larger batches go as a pipeline
        of ``serving_depth`` windows; results are identical."""
        sw = self.config.serving_window
        if not sw or len(queries) <= sw:
            return self.query_batch_async(
                queries, scorer, tokenizer, fields_boost, top_k
            ).get()
        depth = max(1, self.config.serving_depth)
        out: List[List[QueryResult]] = []
        inflight: List[Any] = []
        for s in range(0, len(queries), sw):
            inflight.append(
                self.query_batch_async(
                    queries[s : s + sw], scorer, tokenizer, fields_boost, top_k
                )
            )
            while len(inflight) >= depth:
                out.extend(inflight.pop(0).get())
        for h in inflight:
            out.extend(h.get())
        return out

    def _check_supported(self, scorer) -> None:
        cfg = self.config
        if cfg.per_class_dispatch:
            raise _not_ported("per_class_dispatch", "per-class dispatch")
        if not cfg.single_dispatch_windows:
            raise _not_ported("single_dispatch_windows=False", "per-class dispatch")

    def save_templates(self, path: str) -> int:
        raise _not_ported("save_templates", "M8, templates and prewarm")

    def load_templates(self, path: str) -> int:
        raise _not_ported("load_templates", "M8, templates and prewarm")

    def prewarm(self, scorer, fields_boost=None) -> int:
        raise _not_ported("prewarm", "M8, templates and prewarm")

    def _upload(self, words: np.ndarray):
        """One H2D copy of the window's int32 words, through pinned memory
        and without blocking the host."""
        t = torch.from_numpy(words)
        if self.device.type == "cpu":
            return t
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(self.device, non_blocking=True)

    def query_batch_async(
        self,
        queries: Sequence[str],
        scorer,
        tokenizer=whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
        _heavy: bool = False,
    ) -> "PendingBatch":
        """Plan, upload and launch a query window without blocking.

        Queries regroup into shape classes across the whole window, so
        submit the largest windows the latency budget allows.  A two-phase
        scorer (zero-to-one) takes the z2o window engine, which ignores
        ``fields_boost`` as the scorer does."""
        self._check_supported(scorer)
        if getattr(scorer, "device_two_phase", False):
            from ..ops.z2o_device import z2o_query_batch_async

            return z2o_query_batch_async(self, queries, tokenizer, top_k, scorer=scorer)
        if fields_boost is None:
            fields_boost = [1.0] * self.num_fields
        k = top_k or self.config.default_top_k
        metrics.inc("queries_submitted", len(queries))
        with metrics.timer("query/plan"):
            plan, fallback = self.plan_batch(queries, tokenizer, scorer)
        host_rows = None
        if fallback:
            # Cap-exceeding queries run on the host (which has no caps),
            # through the scorer's vectorized numpy path when it has one.
            metrics.inc("device_fallback_queries", len(fallback))
            _host_fallback_policy(self.config, len(fallback), "device plan caps exceeded")
            vq = getattr(scorer, "vectorized_query", None)
            with metrics.timer("query/host_fallback"):
                host_rows = {
                    qi: (
                        vq(self._index, queries[qi], tokenizer, top_k=k,
                           fields_boost=fields_boost)
                        if vq is not None
                        else self._index.query(
                            queries[qi], scorer, tokenizer, fields_boost, top_k=k
                        )
                    )
                    for qi in fallback
                }
        fmt = resolve_result_format(self.config.effective_result_format(), self.num_slots)

        # Heavy-query result cache (IndexConfig.heavy_cache_min_chunks):
        # queries spanning a huge posting range are answered from a
        # snapshot-static cache keyed by the query's job-table bytes (its
        # exact device input).  A miss computes the row once, blocking, at
        # k = heavy_cache_top_k.
        array_rows = None
        cfg = self.config
        if (
            plan is not None
            and not _heavy
            and cfg.heavy_cache_min_chunks
            and k <= cfg.heavy_cache_top_k
        ):
            heavy = np.flatnonzero(plan.nchunks >= cfg.heavy_cache_min_chunks)
            if len(heavy):
                boosts_key = tuple(float(b) for b in fields_boost)
                skey = _scorer_cache_key(scorer)
                array_rows = {}
                for qi in heavy:
                    qi = int(qi)
                    rows_q = plan.words[plan.jquery == qi]
                    ck = (skey, rows_q.tobytes(), boosts_key)
                    hit = self._heavy_cache.get(ck)
                    if hit is None or (hit[0] is None and not fmt.startswith("slots")):
                        metrics.inc("heavy_cache_misses", 1)
                        sub = self.query_batch_async(
                            [queries[qi]], scorer, tokenizer, fields_boost,
                            top_k=cfg.heavy_cache_top_k, _heavy=True,
                        )
                        s_row, sl_row, _ = sub.get_arrays(want_keys=False)
                        hit = (s_row[0] if s_row is not None else None, sl_row[0])
                        # LRU: dict order is insertion order and hits
                        # re-insert, so the first key is the least recent.
                        while len(self._heavy_cache) >= self._HEAVY_CACHE_CAP:
                            del self._heavy_cache[next(iter(self._heavy_cache))]
                        self._heavy_cache[ck] = hit
                    else:
                        metrics.inc("heavy_cache_hits", 1)
                        self._heavy_cache[ck] = self._heavy_cache.pop(ck)
                    array_rows[qi] = hit
                hit_list = np.fromiter(array_rows, np.int64, len(array_rows))
                keep = ~np.isin(plan.jquery, hit_list)
                jq2 = plan.jquery[keep]
                nchunks2 = plan.nchunks.copy()
                nchunks2[hit_list] = 0
                plan = (
                    PlannedJobs(
                        jquery=jq2,
                        words=plan.words[keep],
                        nchunks=nchunks2,
                        njobs=np.bincount(jq2, minlength=len(queries)),
                        has_range=plan.has_range,
                    )
                    if len(jq2)
                    else None
                )
        if plan is None:
            return PendingBatch(
                self, len(queries), host_rows=host_rows, k=k,
                array_rows=array_rows, fmt=fmt,
            )
        tpl_specs = None
        with metrics.timer("query/pack"):
            if (
                cfg.template_compositions
                and not bool(plan.has_range.any())
                and not bool((plan.nchunks > 2048).any())
            ):
                # Windows with a term-range query or a huge class (nc > 2048)
                # keep the composed path: their row pads track the real
                # query count.
                tkey = (_scorer_cache_key(scorer), k, fmt, len(queries))
                dispatches, tpl_specs = self._pack_dispatches_template(
                    len(queries), plan, tkey
                )
            else:
                dispatches = self.pack_dispatches(len(queries), plan)
        if not dispatches:
            return PendingBatch(
                self, len(queries), host_rows=host_rows, k=k,
                array_rows=array_rows, fmt=fmt,
            )
        metrics.inc("dispatches", len(dispatches))
        if tpl_specs is None:
            dispatches.sort(key=lambda d: (d[2], d[3], d[1].shape[0]))
            # Output rows per class: the real query count rounded up to 256.
            class_specs = tuple(
                (d[1].shape[0], min(d[1].shape[0], -(-len(d[0]) // 256) * 256), d[3], d[2], d[4])
                for d in dispatches
            )
        else:
            class_specs = tpl_specs
        F = self.num_fields
        with metrics.timer("query/h2d"):
            # The field boosts ride at the end of the one H2D buffer.
            words_np = np.concatenate(
                [d[1].reshape(-1) for d in dispatches]
                + [np.asarray(fields_boost, dtype=np.float32).view(np.int32)]
            )
            words_flat = self._upload(words_np)
        n_words = len(words_np) - F
        aux = self._aux_rec(scorer) if any(spec[4] for spec in class_specs) else None
        with metrics.timer("query/dispatch"):
            packed = _window_step(
                scorer,
                self.rec,
                self.field_avg,
                words_flat[n_words:].view(torch.float32),
                words_flat[:n_words],
                aux,
                chunk=self.CHUNK,
                k=k,
                qterm_bits=self._qterm_bits,
                num_fields=F,
                class_specs=class_specs,
                fmt=fmt,
            )
        layout = []
        row = 0
        for (idxs, *_a), (_, b_out, *_b) in zip(dispatches, class_specs):
            layout.append((idxs, row))
            row += b_out
        return PendingBatch(
            self, len(queries), packed=packed, layout=layout, host_rows=host_rows,
            fmt=fmt, k=k, array_rows=array_rows, **self._start_fetch(packed),
        )

    def _start_fetch(self, packed) -> Dict[str, Any]:
        """Start the D2H copy of a window's packed rows behind its kernels
        (``IndexConfig.prefetch_results``), so it streams while later windows
        compute; the drain then waits on this window's event only.  Returns
        the ``host`` / ``event`` arguments of ``PendingBatch``."""
        if self.device.type != "cuda" or not self.config.prefetch_results:
            return {}
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return {"host": host, "event": event}

    def to_results(self, top_scores: np.ndarray, top_docs: np.ndarray):
        out: List[List[QueryResult]] = []
        for scores_row, docs_row in zip(top_scores.tolist(), top_docs.tolist()):
            out.append(
                [
                    QueryResult(key=self.slot_to_key[d], score=s)
                    for s, d in zip(scores_row, docs_row)
                    if d >= 0 and s != float("-inf")
                ]
            )
        return out

    @property
    def key_arr(self) -> np.ndarray:
        """Doc slot -> user key: an int64 array when every key is a plain
        int, otherwise an object array."""
        if self._key_arr is None or len(self._key_arr) != len(self.slot_to_key):
            if self.slot_to_key and all(type(k) is int for k in self.slot_to_key):
                self._key_arr = np.asarray(self.slot_to_key, dtype=np.int64)
            else:
                arr = np.empty(len(self.slot_to_key), dtype=object)
                arr[:] = self.slot_to_key
                self._key_arr = arr
        return self._key_arr


class PendingBatch:
    """Handle for an in-flight query window; ``.get()`` / ``.get_arrays()``
    wait for it and assemble the results."""

    def __init__(
        self, dix: DeviceIndex, n: int, packed=None, layout=None, host_rows=None,
        fmt="f32", k=None, array_rows=None, host=None, event=None,
    ) -> None:
        self._dix = dix
        self._n = n
        self._packed = packed  # device tensor of packed rows (pack_result_rows)
        self._layout = layout  # [(query_indices, row_offset), ...]
        self._host_rows = host_rows  # {query_index: results} from fallback
        self._fmt = fmt
        # {query_index: (scores | None, slots)} from the heavy-query cache
        self._array_rows = array_rows
        self._k = k
        self._host = host  # pinned host copy in flight (prefetch_results)
        self._event = event  # recorded after that copy

    def _unpack(self):
        """Wait for the packed rows on the host and decode them."""
        with metrics.timer("query/fetch"):
            if self._event is not None:
                self._event.synchronize()
                packed = self._host.numpy()
            else:
                packed = self._packed.cpu().numpy()
        return unpack_result_rows(packed, self._fmt, self._k)

    def get(self) -> List[List[QueryResult]]:
        if self._fmt.startswith("slots") and (
            self._packed is not None or self._array_rows
        ):
            raise ValueError(
                "result_format='slots'/'slots20' windows carry no scores; use "
                "get_arrays() (ranked slots/keys) or a score-carrying "
                "result_format for QueryResult rows"
            )
        results: List[List[QueryResult]] = [[] for _ in range(self._n)]
        with metrics.timer("query/drain"):
            self._drain(results)
        return results

    def get_arrays(self, want_keys: bool = True):
        """Columnar results: ``(scores f32[n, k] | None, slots int32[n, k],
        keys[n, k])`` in query order; valid entries have ``slots >= 0``.
        Slots formats carry no scores (``scores`` is None).  ``keys`` is an
        int64 array when every document key is a plain int, else an object
        array with None at invalid entries; ``want_keys=False`` skips it."""
        with metrics.timer("query/drain"):
            slots_only = self._fmt.startswith("slots")
            if self._packed is None:
                k = self._k or 0
                scores = None if slots_only else np.full((self._n, k), -np.inf, np.float32)
                slots = np.full((self._n, k), -1, np.int32)
            else:
                p_scores, p_slots = self._unpack()
                k = p_slots.shape[-1]
                scores = None if slots_only else np.full((self._n, k), -np.inf, np.float32)
                slots = np.full((self._n, k), -1, np.int32)
                for idxs, row in self._layout:
                    if scores is not None:
                        scores[idxs] = p_scores[row : row + len(idxs)]
                    slots[idxs] = p_slots[row : row + len(idxs)]
            if self._array_rows:
                # Heavy-query cache rows; a row cached under a slots format
                # carries no scores (validity is ``slots >= 0`` there).
                for qi, (s_row, sl_row) in self._array_rows.items():
                    m = min(slots.shape[1], len(sl_row))
                    slots[qi, :m] = sl_row[:m]
                    slots[qi, m:] = -1
                    if scores is not None and s_row is not None:
                        scores[qi, :m] = s_row[:m]
                        scores[qi, m:] = -np.inf
            keys = None
            if want_keys:
                karr = self._dix.key_arr
                if karr.dtype == object:
                    valid = slots >= 0
                    keys = np.where(valid, karr[np.where(valid, slots, 0)], None)
                else:  # int64: invalid entries are masked by slot -1
                    keys = karr[np.clip(slots, 0, None)]
            if self._host_rows:
                k2s = self._dix._index._key_to_slot
                for qi, row in self._host_rows.items():
                    m = min(len(row), slots.shape[1])
                    if scores is not None:
                        scores[qi, :m] = [r.score for r in row[:m]]
                    slots[qi, :] = -1
                    slots[qi, :m] = [k2s.get(r.key, -1) for r in row[:m]]
                    if keys is not None:
                        if keys.dtype == object:
                            keys[qi, :] = None
                        keys[qi, :m] = [r.key for r in row[:m]]
        return scores, slots, keys

    def _drain(self, results) -> None:
        if self._host_rows:
            for qi, row in self._host_rows.items():
                results[qi] = row
        if self._array_rows:
            k = self._k or 0
            for qi, (s_row, sl_row) in self._array_rows.items():
                results[int(qi)] = self._dix.to_results(s_row[None, :k], sl_row[None, :k])[0]
        if self._packed is not None:
            scores, docs = self._unpack()
            for idxs, row in self._layout:
                rows = self._dix.to_results(
                    scores[row : row + len(idxs)], docs[row : row + len(idxs)]
                )
                for i, r in zip(idxs, rows):
                    results[int(i)] = r
