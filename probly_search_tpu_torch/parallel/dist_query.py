"""Doc-sharded query execution over a ("data", "docs") mesh of torch devices.

Counterpart of ``probly_search_tpu/parallel/dist_query.py``.  Layout: doc
slot ``g`` lives on shard ``g % n_shards`` with local slot ``g // n_shards``;
each shard holds the CSR postings of its docs for ALL terms (partition by
document).  One global sorted term dictionary is shared; per-shard CSR
offsets index each shard's posting record array.

Document frequencies are global but static per snapshot, so the host
computes them from the merged segment and premultiplies them into each
job's scale word: no shard needs another's counts at query time.  The only
exchange is the gather of every shard's top-k rows onto the data row's
first device, followed by one ordering of the ``n * k`` candidates by
(score descending, global slot ascending).

The host half (snapshot tables, planner, pruning trim, window packer) is the
JAX engine's, in numpy, bit for bit.  The device half runs the single-device
engine per (data row, shard) cell: each class of a window goes through
``index.device._query_step`` on that shard's records at that shard's own
merge-key width (K1, or K3 + K5; range classes and user scorers the staged
lanes + K5), and zero-to-one through ``z2o_fast_step`` (K4) or the lockstep
program.  A mesh is driven from one process, as JAX's single-controller
``shard_map`` is; cells that share a device run one after another on its
stream.

On a CUDA mesh the classes replay cached CUDA graphs, the counterpart of
the JAX engine's program cache ``_step_cache`` (``_get_window_step``,
``_get_z2o_window_step``), keyed per class as the single-device engine's
``ClassGraphs`` are: a *group* is the cells of one data row that sit on one
device, and each (group, class shape) has one graph that runs the class on
every shard of the group in turn (``ShardedClassKey``,
``ShardedZ2OClassKey``).  Each distinct device of the mesh has its own
``ClassGraphs`` (a graph captures on its own device: its own pool, lock and
side stream); cells that share a card share its cache, and the data rows of
a card share its graphs, since a capture bakes in only tensors that are one
per (shard, device).  The gather and merge stay outside the graphs (their
copies may cross devices).  A CPU mesh runs every cell eagerly.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..index.device import (
    _MAX_CHAR,
    _LEN_BITS,
    _MAX_JOB_LEN,
    _QT_BITS,
    ClassGraphs,
    DeviceIndex,
    _bucket,
    _bucket_vec,
    _host_fallback_policy,
    _pad_k,
    _query_step,
    _scorer_cache_key,
    _segment_arange,
    key_array,
    pack_result_rows,
    resolve_result_format,
    unpack_result_rows,
)
from ..index.segment import escape_terms_fixed, merge_segments, probe_terms_fixed
from ..models import zero_to_one as _z2o
from ..models.base import QueryResult
from ..ops.fused_merge import key_bits_for
from ..ops.fused_query import padded_rows
from ..ops.fused_z2o import DOC_SHIFT
from ..ops.z2o_device import _z2o_class_rows, z2o_fast_step, z2o_step
from ..utils.metrics import metrics
from ..utils.tokenizers import whitespace_tokenizer


class ShardedClassKey(NamedTuple):
    """Key of a sharded BM25 class graph: every field of
    ``index.device.ClassKey`` but ``fmt`` (``key_bits`` one per shard of
    the group), plus the group's shard ids.  With the snapshot's own
    statics (chunk, qterm_bits, num_fields) it holds every static of the
    JAX engine's ``_get_window_step`` key that shapes the graph: the
    scorer's ``device_cache_key``, the class spec and k.  JAX's ``fmt``
    has no field: the graph's output is the group's f32 scores and global
    slots whatever the format (the merge packs them outside it), so the
    windows of every format share its graphs."""

    program: str  # "bm25"
    scorer: Any
    chunk: int
    num_chunks: int
    nj: int
    b_out: int
    use_ranges: bool
    k: int
    qterm_bits: int
    num_fields: int
    key_bits: Tuple[int, ...]
    shards: Tuple[int, ...]


class ShardedZ2OClassKey(NamedTuple):
    """Key of a sharded zero-to-one class graph: every field of
    ``ops.z2o_device.Z2OClassKey`` but ``fmt`` (``fast`` is False for the
    lockstep program; ``key_bits`` K4's, one per shard of the group), plus
    the group's shard ids: every static of the JAX engine's
    ``_get_z2o_window_step`` key but its ``fmt``, which the graph's output
    does not depend on (see ``ShardedClassKey``)."""

    program: str  # "z2o"
    b_out: int
    nj: int
    num_chunks: int
    fast: bool
    kk: int
    num_fields: int
    chunk: int
    fused_ok: bool
    key_bits: Tuple[int, ...]
    k: int
    shards: Tuple[int, ...]


def _global_slots(local, n_shards: int, s: int):
    """Shard ``s``'s local doc slots -> global slots (-1 stays)."""
    return torch.where(local >= 0, local * n_shards + s, -1)


def _spans(class_specs, width: int):
    """Per class of a window: the offset of its words in a cell's words and
    the words of its first ``b_out`` rows (``width`` words a job)."""
    spans, off = [], 0
    for b_pad, b_out, nj, *_rest in class_specs:
        spans.append((off, b_out * nj * width))
        off += b_pad * nj * width
    return spans


class ShardedDeviceIndex:
    """Doc-sharded device snapshot of an ``Index`` over a mesh
    (``parallel.make_mesh``)."""

    CHUNK = 1024
    NC_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
    NJ_BUCKETS = (4, 8, 16, 32, 64, 128, 256)

    def __init__(self, index, mesh) -> None:
        from ..index.core import Index

        if not isinstance(index, Index):
            raise TypeError(
                f"ShardedDeviceIndex takes probly_search_tpu_torch.Index, not "
                f"{type(index).__module__}.{type(index).__name__}"
            )
        cells = list(mesh.devices.reshape(-1))
        for dev in cells:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {dev} needs a CUDA device; none is available")
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"ShardedDeviceIndex runs on cuda or cpu, not {dev}")
        index._flush_pending()
        self.version = index.version
        self._index = index
        self.config = index.config
        self.CHUNK = int(index.config.chunk_size or type(self).CHUNK)
        # Fine NC buckets, the single-device engine's ladder (the per-shard
        # compute is its _query_step).
        if index.config.fine_nc_buckets:
            self.nc_buckets = DeviceIndex.NC_BUCKETS_FINE
            self.nc_min = 2
        else:
            self.nc_buckets = type(self).NC_BUCKETS
            self.nc_min = 4
        self.mesh = mesh
        n = int(mesh.shape["docs"])
        self.n_shards = n
        F = index.num_fields
        self.num_fields = F
        C = self.CHUNK

        # One global merged segment (keeps latently-deleted postings, like
        # the single-device snapshot).
        gseg = merge_segments(index._segments, F)
        T = gseg.num_terms
        # Escaped <U table (trailing-NUL terms must not alias; segment.py).
        self.terms = escape_terms_fixed(gseg.terms)
        self.term_lens = gseg.term_lens.astype(np.int64)
        self.g_offsets = gseg.offsets.astype(np.int64)

        S = index._next_slot
        alive = index._alive[:S]
        doc_len = index._doc_len[:S].astype(np.float32) if S else np.zeros((0, F), np.float32)
        local_max = (S - 1) // n if S else 0
        self.local_slots = (local_max + 1) if S else 0
        if local_max >= (1 << (31 - _QT_BITS)):
            raise ValueError(
                f"per-shard doc slots ({local_max + 1}) exceed the packed "
                f"int32 merge-key capacity; use more shards"
            )
        # Local slots of each shard: its merge keys' width (K1, K5) and K4's.
        shard_slots = [max(0, -(-(S - s) // n)) for s in range(n)]
        self.key_bits = [key_bits_for(c, _QT_BITS) for c in shard_slots]
        self.z2o_key_bits = [key_bits_for(c, DOC_SHIFT) for c in shard_slots]

        # Global live-occurrence cumsum: df for any term is two lookups
        # (static per snapshot; premultiplied into job scales at plan time).
        occ_live = (
            np.where(alive[gseg.post_doc], gseg.post_occ, 0).astype(np.int64)
            if gseg.num_postings
            else np.zeros(0, np.int64)
        )
        self.g_live_cum = np.zeros(gseg.num_postings + 1, dtype=np.int64)
        np.cumsum(occ_live, out=self.g_live_cum[1:])

        # Per-shard CSR: select postings by doc % n (order within a term is
        # preserved, so per-shard postings stay doc-sorted).
        R = 4 if (2 + 2 * F) <= 4 else -(-(2 + 2 * F) // 8) * 8  # the port's row count
        post_doc = gseg.post_doc
        term_of_post = np.repeat(np.arange(T, dtype=np.int64), np.diff(gseg.offsets).astype(np.int64))
        shard_of = post_doc % n if len(post_doc) else post_doc
        offsets_sh = np.zeros((n, T + 1), dtype=np.int64)
        pmax = 0
        shard_rows = []
        for s in range(n):
            sel = np.flatnonzero(shard_of == s)
            counts = np.bincount(term_of_post[sel], minlength=T)
            np.cumsum(counts, out=offsets_sh[s, 1:])
            shard_rows.append(sel)
            pmax = max(pmax, len(sel))
        self.offsets_sh = offsets_sh
        # Global posting -> rows per shard (for the lazy aux build: term-range
        # jobs need per-posting statics in shard order).
        self._shard_rows = shard_rows
        self._term_of_post = term_of_post
        self._pmax = pmax
        self._aux_cache: Dict[Any, Any] = {}
        # Host posting stats for the sharded block-max bounds (index/prune.py),
        # built lazily at plan-pool insert from these snapshot copies (alive
        # and doc_len are copies: a later vacuum must not leak into them).
        self._post_tf_g = gseg.post_tf
        self._post_doc_g = post_doc
        self._alive_snap = alive.copy()
        self._doc_len_snap = doc_len  # f32 [S, F]; astype above copied
        self._field_avg_host = np.array([fd.avg for fd in index._fields], dtype=np.float64)
        self._prune_views: List[Any] = [None] * n

        # Device side: one record array per shard in the single-device row
        # layout (transposed [R, Pmax + C], rows padded to 128 int32), one
        # copy per distinct device of the shard's mesh column.
        field_avg = np.array([fd.avg for fd in index._fields], dtype=np.float32)
        self._field_avg = {dev: torch.from_numpy(field_avg).to(dev) for dev in dict.fromkeys(cells)}
        self._rec_cells = self._place(self._shard_records(gseg, doc_len, alive, R, pmax))
        self.rec = self._rec_cells[0]  # per shard, on the first data row's devices
        self.n_docs = float(len(index._docs))
        self.slot_to_key = list(index._slot_to_key)
        self._key_arr: Optional[np.ndarray] = None
        self.num_slots = S  # GLOBAL slot count (result formats gate on it)
        self._qterm_bits = _QT_BITS
        # Per-(scorer key, tokenizer) pooled per-query plans (the sharded
        # mirror of DeviceIndex._qplan_pools); the lock serializes pool growth
        # under concurrent submitters.
        self._qplan_pools: Dict[Any, Dict[str, Any]] = {}
        self._plan_lock = threading.RLock()
        # The groups of each data row: (device, the shards of the row on it).
        self._groups = []
        for d in range(int(mesh.shape["data"])):
            on: Dict[Any, List[int]] = {}
            for s in range(n):
                on.setdefault(mesh.devices[d, s], []).append(s)
            self._groups.append([(dev, tuple(shards)) for dev, shards in on.items()])
        # On a CUDA mesh, the class graphs of each distinct device.
        self._class_graphs = (
            {dev: ClassGraphs(dev) for dev in dict.fromkeys(cells)}
            if all(dev.type == "cuda" for dev in cells)
            else None
        )

    @property
    def key_arr(self) -> np.ndarray:
        """Global doc slot -> user key (``index.device.key_array``), built
        once."""
        if self._key_arr is None:
            self._key_arr = key_array(self.slot_to_key)
        return self._key_arr

    def _shard_records(self, gseg, doc_len, alive, R, pmax):
        """Each shard's record array int32[R, Pmax + C] on the host: rows
        0 .. 1 + 2F hold the JAX engine's ``rec[s]`` payload (true local slot
        even for dead docs, per-field tf, per-field doc length f32 bits,
        liveness), the slack tail -1 in row 0."""
        n, F, C = self.n_shards, self.num_fields, self.CHUNK
        post_doc = gseg.post_doc
        out = []
        for s in range(n):
            rec = np.zeros((R, pmax + C), dtype=np.int32)
            rec[0] = -1
            sel = self._shard_rows[s]
            m = len(sel)
            if m:
                gdoc = post_doc[sel]
                rec[0, :m] = gdoc // n
                rec[1 : 1 + F, :m] = gseg.post_tf[sel].T
                rec[1 + F : 1 + 2 * F, :m] = doc_len[gdoc].view(np.int32).T
                rec[1 + 2 * F, :m] = alive[gdoc]
            out.append(rec)
        return out

    def _place(self, per_shard):
        """Host arrays, one per shard -> [data row][shard] device tensors
        (``padded_rows``), one copy per distinct device of a shard."""
        d_ax = int(self.mesh.shape["data"])
        copies: Dict[Any, torch.Tensor] = {}
        cells = []
        for d in range(d_ax):
            row = []
            for s, arr in enumerate(per_shard):
                dev = self.mesh.devices[d, s]
                if (s, dev) not in copies:
                    copies[(s, dev)] = padded_rows(arr, dev)
                row.append(copies[(s, dev)])
            cells.append(row)
        return cells

    def _aux_rec(self, scorer):
        """Per-shard aux record arrays of term-range jobs, [data row][shard]
        tensors int32[4, Pmax + C] (mirrors DeviceIndex._aux_rec): row 0 the
        f32 bits of the scorer's static per-term scale over the GLOBAL live
        df, row 1 the term's UTF-8 byte length.  Built once per scorer."""
        key = _scorer_cache_key(scorer)
        with self._plan_lock:  # built and uploaded once, whatever thread asks first
            cached = self._aux_cache.get(key)
            if cached is None:
                cached = self._aux_cache[key] = self._build_aux(scorer)
        return cached

    def _build_aux(self, scorer):
        C = self.CHUNK
        gdf = (self.g_live_cum[self.g_offsets[1:]] - self.g_live_cum[self.g_offsets[:-1]]).astype(
            np.float64
        )
        static = np.asarray(scorer.device_term_static(gdf, self.n_docs), np.float32)
        tlens = np.asarray(self.term_lens, np.int32)
        per_shard = []
        for s in range(self.n_shards):
            aux = np.zeros((4, self._pmax + C), dtype=np.int32)
            sel = self._shard_rows[s]
            m = len(sel)
            if m:
                t = self._term_of_post[sel]
                aux[0, :m] = static[t].view(np.int32)
                aux[1, :m] = tlens[t]
            per_shard.append(aux)
        return self._place(per_shard)

    # ------------------------------------------------------------------ #
    # planning                                                            #
    # ------------------------------------------------------------------ #

    # Pool caps (mirror DeviceIndex): beyond these the pool restarts.
    _QPLAN_MAX_QUERIES = 1 << 20
    _QPLAN_MAX_ROWS = 4 << 20

    def plan_batch(self, queries: Sequence[str], tokenizer, scorer, with_rows: bool = False):
        """Plan a batch into per-shard job tables (thread-safe, pooled).

        Returns ``((jquery, words[n, NJOBS, 3], nchunks[B], njobs[B],
        has_range[B]) | None, fallback)``: ``nchunks`` is the max over
        shards; ``fallback`` lists cap-exceeding queries, which run on the
        host.  ``with_rows=True`` appends ``(rows, qp, qids)``, the pool job
        rows, the pool they index and the pool qid per window query, taken
        under the plan lock (the prune memo's keys,
        ``prune.prune_plan_sharded_cached``)."""
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
            total = int(nj.sum())
            if total == 0:
                return None, fallback
            jquery = np.repeat(np.arange(B, dtype=np.int64), nj)
            rows = np.repeat(qp["off"][qids], nj) + _segment_arange(nj)
            planned = (
                jquery,
                qp["words"][:, rows],
                qp["nchunks"][qids],
                nj,
                qp["has_range"][qids],
            )
            if with_rows:
                planned = planned + ((rows, qp, qids),)
            return planned, fallback

    def _qplan_pool(self, scorer, tokenizer):
        key = (_scorer_cache_key(scorer), tokenizer)
        qp = self._qplan_pools.get(key)
        if qp is None or (
            len(qp["ids"]) > self._QPLAN_MAX_QUERIES or qp["words"].shape[1] > self._QPLAN_MAX_ROWS
        ):
            qp = {
                "ids": {},  # query string -> dense qid
                "off": np.zeros(1, dtype=np.int64),
                "words": np.zeros((self.n_shards, 0, 3), dtype=np.int32),
                "nchunks": np.zeros(0, dtype=np.int64),
                "njobs": np.zeros(0, dtype=np.int64),
                "has_range": np.zeros(0, dtype=bool),
                "fallback": np.zeros(0, dtype=bool),
            }
            # Sharded block-max bounds ride along per (shard, job row).  The
            # decision is frozen at pool creation: a mid-life config flip
            # must not misalign rows and bounds.
            if (
                self.config.prune_blocks
                and hasattr(scorer, "device_impact")
                and np.isfinite(self._field_avg_host).all()
            ):
                k_cap = int(self.config.prune_max_top_k)
                F = self.num_fields
                qp["prune_sh"] = [
                    {
                        "ub": np.zeros((0, F), np.float32),
                        "topv": np.zeros((0, F, k_cap), np.float32),
                        "cub_off": np.zeros(0, np.int64),
                        "cub": np.zeros((0, F), np.float32),
                        "cub_min": np.zeros((0, F), np.float32),
                    }
                    for _ in range(self.n_shards)
                ]
            self._qplan_pools[key] = qp
        return qp

    def _qplan_insert(self, qp, miss: List[str], tokenizer, scorer) -> None:
        """Plan first-seen queries and pool their rows (a query's job rows
        are contiguous: ``_plan_batch_impl`` groups ``jquery`` ascending)."""
        planned, fb = self._plan_batch_impl(miss, tokenizer, scorer)
        M = len(miss)
        fb_m = np.zeros(M, dtype=bool)
        fb_m[list(fb)] = True
        if planned is None:
            nj_m = np.zeros(M, dtype=np.int64)
            words_m = np.zeros((self.n_shards, 0, 3), dtype=np.int32)
            nch_m = np.zeros(M, dtype=np.int64)
            rng_m = np.zeros(M, dtype=bool)
        else:
            _jq, words_m, nch_m, nj_m, rng_m = planned
        if "prune_sh" in qp:
            from ..index.prune import build_job_bounds, shard_bounds_view

            k_cap = int(self.config.prune_max_top_k)
            margin = float(self.config.prune_margin)
            for s in range(self.n_shards):
                b = build_job_bounds(
                    shard_bounds_view(self, s),
                    scorer,
                    words_m[s, :, 0].astype(np.int64),
                    (words_m[s, :, 1] & _MAX_JOB_LEN).astype(np.int64),
                    ((words_m[s, :, 1] >> 30) & 1) > 0,
                    self.CHUNK,
                    k_cap,
                    margin,
                )
                assert b is not None  # gating matched at pool creation
                ps = qp["prune_sh"][s]
                ps["cub_off"] = np.concatenate([ps["cub_off"], b["cub_off"][:-1] + len(ps["cub"])])
                for f in ("ub", "topv", "cub", "cub_min"):
                    ps[f] = np.concatenate([ps[f], b[f]])
        base = len(qp["off"]) - 1
        for i, q in enumerate(miss):
            qp["ids"][q] = base + i
        qp["off"] = np.concatenate([qp["off"], qp["off"][-1] + np.cumsum(nj_m)])
        qp["words"] = np.concatenate([qp["words"], words_m], axis=1)
        qp["nchunks"] = np.concatenate([qp["nchunks"], nch_m])
        qp["njobs"] = np.concatenate([qp["njobs"], nj_m])
        qp["has_range"] = np.concatenate([qp["has_range"], rng_m])
        qp["fallback"] = np.concatenate([qp["fallback"], fb_m])

    def _plan_batch_impl(self, queries: Sequence[str], tokenizer, scorer):
        """Uncached planning pass (see ``plan_batch`` for the contract)."""
        cfg = self.config
        B = len(queries)
        n = self.n_shards
        C = self.CHUNK
        fallback: List[int] = []

        tok_lists = [[t for t in tokenizer(q) if t] for q in queries]
        max_terms = min(cfg.max_query_terms, 1 << self._qterm_bits)
        for qi, toks in enumerate(tok_lists):
            if len(toks) > max_terms:
                fallback.append(qi)
                tok_lists[qi] = []
        counts = np.array([len(t) for t in tok_lists], dtype=np.int64)
        total_terms = int(counts.sum())
        if total_terms == 0 or len(self.terms) == 0:
            return None, fallback
        flat_query = np.repeat(np.arange(B, dtype=np.int64), counts)
        flat_qterm = _segment_arange(counts)
        flat_terms, flat_blen = probe_terms_fixed([t for toks in tok_lists for t in toks])

        lo = np.searchsorted(self.terms, flat_terms, side="left")
        hi = np.searchsorted(self.terms, np.char.add(flat_terms, _MAX_CHAR), side="left")
        nexp = hi - lo
        if nexp.max(initial=0) == 0:
            return None, fallback
        # Term-range eligibility (as the single-device planner): an
        # expansion-heavy term becomes ONE per-shard job over its whole
        # contiguous CSR range, its scale assembled on the device from aux.
        thr = cfg.range_min_expansions
        supports_ranges = (
            thr > 0
            and hasattr(scorer, "device_term_static")
            and hasattr(scorer, "device_range_boost")
        )
        eligible = nexp >= thr if supports_ranges else np.zeros(total_terms, dtype=bool)
        nexp = np.where(eligible, 0, nexp)
        tid = np.repeat(lo, nexp) + _segment_arange(nexp)
        jidx = np.repeat(np.arange(total_terms, dtype=np.int64), nexp)

        # Global df per expansion (live posting pointers across all shards);
        # df == 0 expansions are never scored (query.rs:48): drop their jobs.
        jdf = (self.g_live_cum[self.g_offsets[tid + 1]] - self.g_live_cum[self.g_offsets[tid]]).astype(
            np.float64
        )
        keep = jdf > 0
        tid, jidx, jdf = tid[keep], jidx[keep], jdf[keep]
        r_i = np.flatnonzero(eligible & (hi > lo))
        if len(tid) == 0 and len(r_i) == 0:
            return None, fallback

        # Expansion cap -> per-query host fallback (only when configured).
        per_term_exp = np.bincount(jidx, minlength=total_terms)
        bad: Set[int] = (
            set(int(q) for q in flat_query[np.flatnonzero(per_term_exp > cfg.max_expansions)])
            if cfg.max_expansions
            else set()
        )
        if bad:
            fallback.extend(sorted(bad))
            keep2 = ~np.isin(flat_query[jidx], np.fromiter(bad, dtype=np.int64))
            tid, jidx, jdf = tid[keep2], jidx[keep2], jdf[keep2]
            if len(tid) == 0 and len(r_i) == 0:
                return None, fallback
        jquery = flat_query[jidx]

        # Expansion boost (bm25.rs:44-55) -> premultiplied per-job scale.
        exact = self.terms[tid] == flat_terms[jidx]
        boost = np.where(exact, 1.0, np.log1p(1.0 / (1.0 + self.term_lens[tid] - flat_blen[jidx])))
        scale = scorer.device_term_scale(jdf, self.n_docs, boost)

        # Per-shard job words (the same job order on every shard, so one class
        # layout serves the whole mesh).  Jobs longer than the packed-length
        # capacity on some shard are SPLIT into parts, as many as the longest
        # shard needs; shorter shards get zero-length tail parts.
        meta1 = (flat_qterm[jidx] << _LEN_BITS).astype(np.int64)
        starts_all = self.offsets_sh[:, tid]  # [n, J]
        lens_all = (self.offsets_sh[:, tid + 1] - starts_all).astype(np.int64)
        jrange = np.zeros(len(jidx), dtype=bool)
        if len(r_i):
            # Per-shard CSR follows the global term order, so a term range
            # [lo, hi) is contiguous on every shard.
            starts_all = np.concatenate([starts_all, self.offsets_sh[:, lo[r_i]]], axis=1)
            lens_all = np.concatenate(
                [lens_all, (self.offsets_sh[:, hi[r_i]] - self.offsets_sh[:, lo[r_i]]).astype(np.int64)],
                axis=1,
            )
            jquery = np.concatenate([jquery, flat_query[r_i]])
            meta1 = np.concatenate([meta1, (flat_qterm[r_i] << _LEN_BITS).astype(np.int64)])
            scale = np.concatenate([scale, flat_blen[r_i].astype(np.int32).view(np.float32)])
            jrange = np.concatenate([jrange, np.ones(len(r_i), bool)])
        nsplit = np.maximum(1, (lens_all.max(axis=0) + _MAX_JOB_LEN - 1) // _MAX_JOB_LEN)
        if (nsplit > 1).any():
            sj = np.repeat(np.arange(lens_all.shape[1], dtype=np.int64), nsplit)
            si = _segment_arange(nsplit)
            starts_all = starts_all[:, sj] + si[None, :] * _MAX_JOB_LEN
            lens_all = np.clip(lens_all[:, sj] - si[None, :] * _MAX_JOB_LEN, 0, _MAX_JOB_LEN)
            jquery = jquery[sj]
            meta1 = meta1[sj]
            scale = scale[sj]
            jrange = jrange[sj]
        NJOBS = lens_all.shape[1]
        words = np.empty((n, NJOBS, 3), dtype=np.int32)
        words[:, :, 0] = starts_all
        words[:, :, 1] = lens_all | meta1[None, :] | (jrange.astype(np.int64) << 30)
        words[:, :, 2] = scale.view(np.int32)[None, :]
        has_range = np.bincount(jquery, weights=jrange.astype(np.float64), minlength=B) > 0
        if len(r_i):
            # The window packer needs each query's jobs contiguous (the
            # appended range jobs broke the grouping).
            order = np.argsort(jquery, kind="stable")
            jquery = jquery[order]
            words = words[:, order]
            lens_all = lens_all[:, order]
        max_chunks = np.zeros(B, dtype=np.int64)
        # Stride-C contiguous chunks (must match the on-device expansion).
        starts_mod = words[:, :, 0].astype(np.int64) % 128
        chunks_all = np.where(lens_all > 0, (starts_mod + lens_all + C - 1) // C, 0)  # [n, NJOBS]
        for s in range(n):
            nch = np.bincount(jquery, weights=chunks_all[s].astype(np.float64), minlength=B)
            np.maximum(max_chunks, nch.astype(np.int64), out=max_chunks)
        # Lane-budget guard (as the single-device planner): per-shard chunk
        # totals beyond one class's budget run on the host.
        over_lanes = np.flatnonzero(max_chunks > DeviceIndex.LANES_PER_DISPATCH // C)
        if len(over_lanes):
            fallback.extend(int(q) for q in over_lanes)
            keep_j = ~np.isin(jquery, over_lanes)
            jquery = jquery[keep_j]
            words = words[:, keep_j]
            max_chunks[over_lanes] = 0
            has_range[over_lanes] = False
            if len(jquery) == 0:
                return None, fallback
        njobs = np.bincount(jquery, minlength=B)
        return (jquery, words, max_chunks, njobs, has_range), fallback

    # ------------------------------------------------------------------ #
    # zero-to-one planning                                                 #
    # ------------------------------------------------------------------ #

    def plan_batch_z2o(self, queries: Sequence[str], tokenizer):
        """Plan a zero-to-one batch into per-shard 4-word job tables.

        Expansions are one searchsorted range of the merged term view, df
        two global live-cumsum lookups, per-shard (start, len) from
        ``offsets_sh``; word 2 is the per-query dense score rank, K4's
        stable-order tiebreak.  Queries whose expansions share a node get
        their own lockstep tables (``_build_z2o_lockstep_pack``).  Returns
        ``(jquery, words int32[n, NJ, 4], qlen f32[B], max_chunks, njobs,
        fallback, lock_pack)``, the arrays None where nothing plans.  Every
        query goes to the host at ``local_slots >= 2^27``."""
        cfg = self.config
        B = len(queries)
        n = self.n_shards
        C = self.CHUNK
        fallback: List[int] = []

        tok_lists = [list(tokenizer(q)) for q in queries]
        qlen = np.array([len(t) for t in tok_lists], dtype=np.float32)
        if self.local_slots >= (1 << 27):
            # The fast key packs local_doc << 4 | qterm into int32: shards
            # past the BM25 merge key's capacity run the host lockstep.
            fallback.extend(range(B))
            return None, None, qlen, None, None, fallback, None
        filt = [[t for t in toks if t] for toks in tok_lists]
        max_terms = min(cfg.max_query_terms, 1 << self._qterm_bits)
        for qi, toks in enumerate(filt):
            if len(toks) > max_terms:
                fallback.append(qi)
                filt[qi] = []
        counts = np.array([len(t) for t in filt], dtype=np.int64)
        total_terms = int(counts.sum())
        if total_terms == 0 or len(self.terms) == 0:
            return None, None, qlen, None, None, fallback, None
        flat_query = np.repeat(np.arange(B, dtype=np.int64), counts)
        flat_qterm = _segment_arange(counts)
        flat_terms, flat_blen = probe_terms_fixed([t for toks in filt for t in toks])
        lo = np.searchsorted(self.terms, flat_terms, side="left")
        hi = np.searchsorted(self.terms, np.char.add(flat_terms, _MAX_CHAR), side="left")
        nexp = hi - lo
        if nexp.max(initial=0) == 0:
            return None, None, qlen, None, None, fallback, None
        tid = np.repeat(lo, nexp) + _segment_arange(nexp)
        jidx = np.repeat(np.arange(total_terms, dtype=np.int64), nexp)
        jdf = self.g_live_cum[self.g_offsets[tid + 1]] - self.g_live_cum[self.g_offsets[tid]]
        keep = jdf > 0  # df == 0 expansions never scored (query.rs:48)
        tid, jidx = tid[keep], jidx[keep]
        if len(tid) == 0:
            return None, None, qlen, None, None, fallback, None
        jquery = flat_query[jidx]
        jqterm = flat_qterm[jidx]

        # Shared-node detection (node identity == merged tid per query): those
        # queries need the lockstep pool semantics, run per shard (the pool
        # rule is per (doc, field), and a doc lives on one shard); the host
        # only past the lockstep caps (F > 8, > 16 terms, > 16,384 lanes).
        o3 = np.lexsort((jqterm, tid, jquery))
        samegrp = (jquery[o3][1:] == jquery[o3][:-1]) & (tid[o3][1:] == tid[o3][:-1])
        diffq = jqterm[o3][1:] != jqterm[o3][:-1]
        shared_q = np.unique(jquery[o3][1:][samegrp & diffq])
        lock_pack = None
        if len(shared_q):
            sharedm = np.isin(jquery, shared_q)
            lock_ok = self.num_fields <= 8 and self.num_fields >= 1
            qt_ok = np.ones(B, bool)
            over_terms = np.flatnonzero(counts > 16)
            if len(over_terms):
                qt_ok[over_terms] = False
            lkeep = sharedm & lock_ok & qt_ok[jquery]
            lhost = sharedm & ~(lock_ok & qt_ok[jquery])
            if lhost.any():
                fallback.extend(int(q) for q in np.unique(jquery[lhost]))
            if lkeep.any():
                lock_pack = self._build_z2o_lockstep_pack(
                    tid[lkeep], jidx[lkeep], jquery[lkeep], jqterm[lkeep], flat_blen, B, fallback
                )
            keep2 = ~sharedm
            tid, jidx, jquery, jqterm = tid[keep2], jidx[keep2], jquery[keep2], jqterm[keep2]
            if len(tid) == 0:
                return None, None, qlen, None, None, fallback, lock_pack

        # Entry score (zero_to_one.rs:57-58, byte lengths).
        tlen = self.term_lens[tid].astype(np.float64)
        score = (1.0 - np.abs(tlen - flat_blen[jidx]) / tlen).astype(np.float32)
        meta1 = (jqterm << _LEN_BITS).astype(np.int64)

        starts_all = self.offsets_sh[:, tid]
        lens_all = (self.offsets_sh[:, tid + 1] - starts_all).astype(np.int64)
        nsplit = np.maximum(1, (lens_all.max(axis=0) + _MAX_JOB_LEN - 1) // _MAX_JOB_LEN)
        if (nsplit > 1).any():
            sj = np.repeat(np.arange(len(tid), dtype=np.int64), nsplit)
            si = _segment_arange(nsplit)
            starts_all = starts_all[:, sj] + si[None, :] * _MAX_JOB_LEN
            lens_all = np.clip(lens_all[:, sj] - si[None, :] * _MAX_JOB_LEN, 0, _MAX_JOB_LEN)
            jquery, meta1, score = jquery[sj], meta1[sj], score[sj]
        NJOBS = lens_all.shape[1]
        words = np.zeros((n, NJOBS, 4), dtype=np.int32)
        words[:, :, 0] = starts_all
        words[:, :, 1] = lens_all | meta1[None, :]
        words[:, :, 3] = score.view(np.int32)[None, :]
        # Word 2: per-query dense score rank (descending, ties equal).
        s64 = score.astype(np.float64)
        o = np.lexsort((-s64, jquery))
        jq_o, s_o = jquery[o], s64[o]
        new = np.ones(len(o), bool)
        new[1:] = (jq_o[1:] != jq_o[:-1]) | (s_o[1:] != s_o[:-1])
        grp = np.cumsum(new) - 1
        qnew = np.ones(len(o), bool)
        qnew[1:] = jq_o[1:] != jq_o[:-1]
        qfirst = np.maximum.accumulate(np.where(qnew, grp, -1))
        srank = np.empty(len(o), np.int64)
        srank[o] = grp - qfirst
        words[:, :, 2] = srank[None, :]

        # Stride-C contiguous chunks (must match the on-device expansion).
        starts_mod = words[:, :, 0].astype(np.int64) % 128
        chunks_all = np.where(lens_all > 0, (starts_mod + lens_all + C - 1) // C, 0)
        max_chunks = np.zeros(B, dtype=np.int64)
        for s in range(n):
            nch = np.bincount(jquery, weights=chunks_all[s].astype(np.float64), minlength=B)
            np.maximum(max_chunks, nch.astype(np.int64), out=max_chunks)
        # Fast-program lanes carry no field dimension (fields are sort
        # values), so the budget is in posting chunks alone.
        over = np.flatnonzero(max_chunks > DeviceIndex.LANES_PER_DISPATCH // C)
        if len(over):
            fallback.extend(int(q) for q in over)
            keep_j = ~np.isin(jquery, over)
            jquery = jquery[keep_j]
            words = words[:, keep_j]
            max_chunks[over] = 0
            if len(jquery) == 0:
                return None, None, qlen, None, None, fallback, None
        njobs = np.bincount(jquery, minlength=B)
        return jquery, words, qlen, max_chunks, njobs, fallback, lock_pack

    def _build_z2o_lockstep_pack(self, tid, jidx, jquery, jqterm, flat_blen, B, fallback):
        """Per-shard lockstep job tables for shared-node queries: words
        (start, len | qterm << 26, node id, entry score f32 bits), node ids
        dense per query over distinct merged tids (zero_to_one.rs:75).
        Queries past the lockstep lane cap (16,384 local entry lanes) join
        ``fallback``.  Returns ``(jquery, words[n, NJOBS, 4], max_chunks,
        njobs)`` or None."""
        n = self.n_shards
        C = self.CHUNK
        F = max(self.num_fields, 1)
        o = np.lexsort((tid, jquery))
        tid_o, jq_o = tid[o], jquery[o]
        newn = np.ones(len(o), bool)
        newn[1:] = (jq_o[1:] != jq_o[:-1]) | (tid_o[1:] != tid_o[:-1])
        grp = np.cumsum(newn) - 1
        qnew = np.ones(len(o), bool)
        qnew[1:] = jq_o[1:] != jq_o[:-1]
        qfirst = np.maximum.accumulate(np.where(qnew, grp, -1))
        node = np.empty(len(o), np.int64)
        node[o] = grp - qfirst

        tlen = self.term_lens[tid].astype(np.float64)
        score = (1.0 - np.abs(tlen - flat_blen[jidx]) / tlen).astype(np.float32)
        starts_all = self.offsets_sh[:, tid]
        lens_all = (self.offsets_sh[:, tid + 1] - starts_all).astype(np.int64)
        words = np.zeros((n, len(tid), 4), dtype=np.int32)
        words[:, :, 0] = starts_all
        words[:, :, 1] = lens_all | (jqterm << _LEN_BITS)[None, :]
        words[:, :, 2] = node[None, :]
        words[:, :, 3] = score.view(np.int32)[None, :]

        starts_mod = words[:, :, 0].astype(np.int64) % 128
        chunks_all = np.where(lens_all > 0, (starts_mod + lens_all + C - 1) // C, 0)
        max_chunks = np.zeros(B, dtype=np.int64)
        for s in range(n):
            nch = np.bincount(jquery, weights=chunks_all[s].astype(np.float64), minlength=B)
            np.maximum(max_chunks, nch.astype(np.int64), out=max_chunks)
        nc_bucket = _bucket_vec(max_chunks, self.NC_BUCKETS, 4)
        over = np.flatnonzero((max_chunks > 0) & (nc_bucket * C * F > 16384))
        if len(over):
            fallback.extend(int(q) for q in over)
            keep = ~np.isin(jquery, over)
            jquery, words = jquery[keep], words[:, keep]
            if len(jquery) == 0:
                return None
        njobs = np.bincount(jquery, minlength=B)
        return jquery, words, max_chunks, njobs

    def _pack_z2o(self, B, jquery, words, max_chunks, njobs, qlen):
        """Pack a z2o job set into (class_specs, layout, buf int32[n, d_ax,
        words], qlen f32[d_ax, rows]): classes by NC bucket, ``b_pad`` a
        power of two per data cell, ``b_out`` the kept rows; ``layout`` as
        ``_pack_window``'s."""
        n = self.n_shards
        d_ax = int(self.mesh.shape["data"])
        nc_bucket = _bucket_vec(max_chunks, self.nc_buckets, self.nc_min)
        class_specs, layout = [], []
        flat_parts: List[List[np.ndarray]] = [[] for _ in range(n)]
        qlen_parts = []
        row_base = 0
        for nc in np.unique(nc_bucket):
            nc = int(nc)
            members = np.flatnonzero((nc_bucket == nc) & (njobs > 0))
            if len(members) == 0:
                continue
            nj = _bucket(int(njobs[members].max()), self.NJ_BUCKETS, 4)
            b_pad = max(8, 1 << (-(-len(members) // d_ax) - 1).bit_length())
            rank = np.arange(len(members))
            drow = rank // b_pad
            dslot = rank % b_pad
            b_out = min(b_pad, -(-min(len(members), b_pad) // 256) * 256)
            jobs_cls = np.zeros((n, d_ax, b_pad, nj, 4), dtype=np.int32)
            sel = np.isin(jquery, members)
            jq = jquery[sel]
            pos = _segment_arange(np.bincount(jq, minlength=B)[members])
            r = np.searchsorted(members, jq)
            jobs_cls[:, drow[r], dslot[r], pos] = words[:, sel]
            qlen_cls = np.ones((d_ax, b_pad), np.float32)
            qlen_cls[drow, dslot] = qlen[members]
            for s in range(n):
                flat_parts[s].append(jobs_cls[s].reshape(d_ax, -1))
            qlen_parts.append(qlen_cls)
            class_specs.append((b_pad, b_out, nj, nc))
            layout.append((members, drow, dslot, row_base))
            row_base += b_out
        if not class_specs:
            return None
        buf = np.stack([np.concatenate(parts, axis=1) for parts in flat_parts])
        return class_specs, layout, buf, np.concatenate(qlen_parts, axis=1)

    # ------------------------------------------------------------------ #
    # execution                                                           #
    # ------------------------------------------------------------------ #

    def _upload(self, cell_words, tail=None):
        """One host-to-device copy per distinct device of the mesh.
        ``cell_words[d][s]`` are the cells' int32 words; ``tail`` int32 words
        every device also gets (the field boosts).  Returns ([d][s] device
        words, {device: tail tensor})."""
        d_ax, n = len(cell_words), self.n_shards
        by_dev: Dict[Any, list] = {}
        for d in range(d_ax):
            for s in range(n):
                by_dev.setdefault(self.mesh.devices[d, s], []).append((d, s))
        out = [[None] * n for _ in range(d_ax)]
        tails = {}
        for dev, cells in by_dev.items():
            parts = [cell_words[d][s] for d, s in cells]
            if tail is not None:
                parts.append(tail)
            host = torch.from_numpy(np.concatenate(parts))
            if dev.type == "cuda":
                pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                pinned.copy_(host)
                flat = pinned.to(dev, non_blocking=True)
            else:
                flat = host
            off = 0
            for (d, s), p in zip(cells, parts):
                out[d][s] = flat[off : off + len(p)]
                off += len(p)
            if tail is not None:
                tails[dev] = flat[off:]
        return out, tails

    def _gather_merge(self, d: int, parts, k: int, fmt: str):
        """Data row ``d``'s shard rows ([(scores f32[SB, k], global slots
        int32[SB, k]) per shard]) gathered onto the row's first device and
        merged: the top k of the n * k candidates by (score descending,
        global slot ascending), two stable sorts, never ``topk`` (whose tie
        order is unspecified).  Returns the packed rows."""
        dev0 = self.mesh.devices[d, 0]
        s_parts, d_parts = [], []
        for s, (sc, gl) in enumerate(parts):
            if self.mesh.devices[d, s] != dev0:
                # Card to card (torch enables peer access at the first
                # copy), on the producing card's current stream behind its
                # work; torch orders both cards' streams around the copy.
                sc, gl = sc.to(dev0, non_blocking=True), gl.to(dev0, non_blocking=True)
            s_parts.append(sc)
            d_parts.append(gl)
        SB = s_parts[0].shape[0]
        s_cat = torch.stack(s_parts, dim=1).reshape(SB, -1)  # [SB, n * k], shard-major
        d_cat = torch.stack(d_parts, dim=1).reshape(SB, -1)
        o = torch.sort(d_cat, dim=1, stable=True)[1]
        s1, d1 = torch.gather(s_cat, 1, o), torch.gather(d_cat, 1, o)
        o = torch.sort(-s1, dim=1, stable=True)[1][:, :k]
        v, top = torch.gather(s1, 1, o), torch.gather(d1, 1, o)
        top = torch.where(torch.isfinite(v), top, -1)
        return pack_result_rows(v, top, fmt)

    def _cell_rows(self, s: int, outs, k: int):
        """One cell's class outputs -> (scores f32[SB, k], global slots)."""
        padded = [_pad_k(sc, dl, k) for sc, dl in outs]
        scores = torch.cat([sc for sc, _dl in padded], dim=0)
        local = torch.cat([dl for _sc, dl in padded], dim=0)
        return scores, _global_slots(local, self.n_shards, s)

    def _group_inputs(self, buf, d: int, shards, spans, tails, dev):
        """The static inputs of a group's classes, in one host buffer
        (pinned for a CUDA device): per class, the group's cells' first rows
        back to back (``spans``: per class the offset of its words in a
        cell's words of ``buf[s, d]`` and the words of its first ``b_out``
        rows), then the tails (``tails``: an int32 array per class, or one
        that every class shares).  Returns [(rows, tail) per class]."""
        G = len(shards)
        total = G * sum(n for _o, n in spans) + sum(len(t) for t in tails)
        host = torch.empty(total, dtype=torch.int32, pin_memory=dev.type == "cuda")
        h = host.numpy()
        sel = list(shards)
        rows, off = [], 0
        for src, n in spans:
            h[off : off + G * n].reshape(G, n)[:] = buf[sel, d, src : src + n]
            rows.append(host[off : off + G * n])
            off += G * n
        ends = []
        for t in tails:
            h[off : off + len(t)] = t
            ends.append(host[off : off + len(t)])
            off += len(t)
        return list(zip(rows, ends if len(ends) > 1 else ends * len(spans)))

    def _run_groups(self, classes_of, k: int, fmt: str):
        """The window on the class graphs: every group's classes
        (``classes_of(d, dev, shards)``, as ``ClassGraphs.run`` takes them)
        on its device's cache, each output copied out before the next
        replay; then each data row's gather and merge.  Every group of
        every row is enqueued before any gather waits on one, so the cards
        of a mesh over several compute at once.  Returns the packed rows
        per data row."""
        rows = []
        for d, groups in enumerate(self._groups):
            parts = [None] * self.n_shards
            for dev, shards in groups:
                outs = self._class_graphs[dev].run(classes_of(d, dev, shards))
                scores = torch.cat([o[0] for o in outs], dim=1)  # [G, SB, k]
                slots = torch.cat([o[1] for o in outs], dim=1)
                for g, s in enumerate(shards):
                    parts[s] = (scores[g], slots[g])
            rows.append(parts)
        return [self._gather_merge(d, parts, k, fmt) for d, parts in enumerate(rows)]

    def _bm25_step(self, scorer, class_specs, buf, fields_boost, aux, k: int, fmt: str):
        """The BM25 window on every cell: per class ``_query_step`` on the
        shard's records at the shard's key width (rows beyond ``b_out`` are
        padding and not computed), then per data row the gather and merge.
        On a CUDA mesh each group's classes replay their graphs
        (``_bm25_group_step``).  Returns the packed rows per data row."""
        d_ax, n, C, F = int(self.mesh.shape["data"]), self.n_shards, self.CHUNK, self.num_fields
        boost = np.asarray(fields_boost, dtype=np.float32).view(np.int32)
        if self._class_graphs is not None:
            classes = functools.partial(self._bm25_classes, scorer, class_specs, buf, boost, aux, k)
            return self._run_groups(classes, k, fmt)
        words, boosts = self._upload([[buf[s, d] for s in range(n)] for d in range(d_ax)], boost)
        rows = []
        for d in range(d_ax):
            parts = []
            for s in range(n):
                dev = self.mesh.devices[d, s]
                w = words[d][s]
                outs = []
                off = 0
                for b_pad, b_out, nj, nc, rng in class_specs:
                    nw = b_pad * nj * 3
                    jobs_flat = w[off : off + nw].reshape(b_pad, nj * 3)[:b_out]
                    off += nw
                    outs.append(_query_step(
                        scorer, self._rec_cells[d][s], self._field_avg[dev],
                        boosts[dev].view(torch.float32), jobs_flat,
                        aux[d][s] if rng else None, chunk=C, k=min(k, nc * C),
                        qterm_bits=self._qterm_bits, num_fields=F, num_chunks=nc,
                        use_ranges=rng, key_bits=self.key_bits[s],
                    ))
                parts.append(self._cell_rows(s, outs, k))
            rows.append(self._gather_merge(d, parts, k, fmt))
        return rows

    def _bm25_classes(self, scorer, class_specs, buf, boost, aux, k: int, d: int, dev, shards):
        """The BM25 classes of the group ``shards`` of data row ``d`` on
        ``dev``, as ``ClassGraphs.run`` takes them: per class its
        ``ShardedClassKey``, its step's maker (``_bm25_group_step``) and the
        pieces of its static input (``_group_inputs``: the cells' job rows,
        then the F boost words ``boost``)."""
        spans = _spans(class_specs, 3)
        pieces = self._group_inputs(buf, d, shards, spans, [boost], dev)
        skey, C, F = _scorer_cache_key(scorer), self.CHUNK, self.num_fields
        key_bits = tuple(self.key_bits[s] for s in shards)
        classes = []
        for (_bp, b_out, nj, nc, rng), piece in zip(class_specs, pieces):
            key = ShardedClassKey(
                "bm25", skey, C, nc, nj, b_out, rng, k, self._qterm_bits, F, key_bits, shards
            )
            make = functools.partial(self._bm25_group_step, scorer, key, d, aux if rng else None)
            classes.append((key, make, piece))
        return classes

    def _bm25_group_step(self, scorer, key: ShardedClassKey, d: int, aux):
        """The step of the class ``key`` on its group (of data row ``d``)
        as a function of its static input: each shard's first ``b_out`` job
        rows in turn, then the F field-boost words -> the group's (f32
        scores, global slots) [G, b_out, k], padded to k.  Row ``d``'s
        tensors are its shards' copies on the device, which every row on
        that device shares.  The step (which its graph keeps) holds tensors,
        not the snapshot, so a dropped snapshot is freed at once."""
        recs = [self._rec_cells[d][s] for s in key.shards]
        field_avg = self._field_avg[recs[0].device]
        auxs = [aux[d][s] for s in key.shards] if aux is not None else None
        n, n_shards = key.b_out * key.nj * 3, self.n_shards

        def step(words):
            boost = words[len(recs) * n :].view(torch.float32)
            scores, slots = [], []
            for g, s in enumerate(key.shards):
                sc, dl = _query_step(
                    scorer, recs[g], field_avg, boost,
                    words[g * n : (g + 1) * n].view(key.b_out, key.nj * 3),
                    auxs[g] if auxs is not None else None, chunk=key.chunk,
                    k=min(key.k, key.num_chunks * key.chunk), qterm_bits=key.qterm_bits,
                    num_fields=key.num_fields, num_chunks=key.num_chunks,
                    use_ranges=key.use_ranges, key_bits=key.key_bits[g],
                )
                sc, dl = _pad_k(sc, dl, key.k)
                scores.append(sc)
                slots.append(_global_slots(dl, n_shards, s))
            return torch.stack(scores), torch.stack(slots)

        return step

    def _z2o_step(self, class_specs, buf, qcat, k: int, fmt: str, lockstep: bool):
        """The z2o window on every cell: per class K4 through
        ``z2o_fast_step`` (fused where the doc slots allow, ``local_slots <
        2^26``) or the lockstep program for shared-node queries, then per
        data row the gather and merge.  On a CUDA mesh each group's classes
        replay their graphs (``_z2o_group_step``).  Returns the packed rows
        per row."""
        d_ax, n, C, F = int(self.mesh.shape["data"]), self.n_shards, self.CHUNK, self.num_fields
        if self._class_graphs is not None:
            classes = functools.partial(self._z2o_classes, class_specs, buf, qcat, k, lockstep)
            return self._run_groups(classes, k, fmt)
        nq = qcat.shape[1]
        cell_words = [
            [np.concatenate([buf[s, d], qcat[d].view(np.int32)]) for s in range(n)]
            for d in range(d_ax)
        ]
        words, _ = self._upload(cell_words)
        rows = []
        for d in range(d_ax):
            parts = []
            for s in range(n):
                w = words[d][s]
                ql = w[w.numel() - nq :].view(torch.float32)
                rec = self._rec_cells[d][s]
                outs = []
                off = qoff = 0
                for b_pad, b_out, nj, nc in class_specs:
                    nw = b_pad * nj * 4
                    jobs = w[off : off + nw].reshape(b_pad, nj, 4)[:b_out]
                    off += nw
                    ql_c = ql[qoff : qoff + b_out]
                    qoff += b_pad
                    kw = dict(chunk=C, k=min(k, nc * C * max(F, 1)), num_fields=F, num_chunks=nc)
                    if lockstep:
                        outs.append(z2o_step(rec, jobs, ql_c, **kw))
                    else:
                        outs.append(z2o_fast_step(
                            rec, jobs, ql_c, fused_ok=self.local_slots < (1 << 26),
                            key_bits=self.z2o_key_bits[s], **kw,
                        ))
                parts.append(self._cell_rows(s, outs, k))
            rows.append(self._gather_merge(d, parts, k, fmt))
        return rows

    def _z2o_classes(self, class_specs, buf, qcat, k: int, lockstep: bool, d: int, dev, shards):
        """The z2o classes of the group ``shards`` of data row ``d`` on
        ``dev``, as ``ClassGraphs.run`` takes them (see ``_bm25_classes``;
        each class's tail is its ``b_out`` qlen words of row ``d``)."""
        qoffs = np.cumsum([0] + [spec[0] for spec in class_specs])
        qlen = [qcat[d, qo : qo + spec[1]].view(np.int32) for qo, spec in zip(qoffs, class_specs)]
        pieces = self._group_inputs(buf, d, shards, _spans(class_specs, 4), qlen, dev)
        C, F = self.CHUNK, self.num_fields
        key_bits = tuple(self.z2o_key_bits[s] for s in shards)
        classes = []
        for (_bp, b_out, nj, nc), piece in zip(class_specs, pieces):
            key = ShardedZ2OClassKey(
                "z2o", b_out, nj, nc, not lockstep, min(k, nc * C * max(F, 1)), F, C,
                self.local_slots < (1 << 26), key_bits, k, shards,
            )
            classes.append((key, functools.partial(self._z2o_group_step, key, d), piece))
        return classes

    def _z2o_group_step(self, key: ShardedZ2OClassKey, d: int):
        """The step of the z2o class ``key`` on its group (of data row
        ``d``): each shard's first ``b_out`` job rows in turn, then the
        ``b_out`` qlen words -> the group's (f32 scores, global slots)
        [G, b_out, k], padded to k (``z2o_device._z2o_class_rows``; the
        step holds tensors, not the snapshot, as ``_bm25_group_step``'s)."""
        recs = [self._rec_cells[d][s] for s in key.shards]
        n, n_shards = key.b_out * key.nj * 4, self.n_shards

        def step(words):
            ql = words[len(recs) * n :].view(torch.float32)
            scores, slots = [], []
            for g, s in enumerate(key.shards):
                sc, dl = _z2o_class_rows(
                    recs[g], words[g * n : (g + 1) * n].view(key.b_out, key.nj, 4), ql,
                    chunk=key.chunk, k=key.k, num_fields=key.num_fields,
                    num_chunks=key.num_chunks, fast=key.fast, fused_ok=key.fused_ok,
                    fmt="parts", key_bits=key.key_bits[g],
                )
                scores.append(sc)
                slots.append(_global_slots(dl, n_shards, s))
            return torch.stack(scores), torch.stack(slots)

        return step

    def _start_fetch(self, rows):
        """Start the D2H copy of each data row's packed rows behind its work
        (``IndexConfig.prefetch_results``; without it ``host`` is None) and
        record each row's event on the submitting stream: the drain waits on
        the events, on any thread and stream."""
        fetch = []
        for d, packed in enumerate(rows):
            dev = self.mesh.devices[d, 0]
            if dev.type != "cuda":
                return None
            host = None
            if self.config.prefetch_results:
                host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            fetch.append((host, event))
        return fetch

    def query_batch(
        self,
        queries: Sequence[str],
        scorer,
        tokenizer=whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
    ) -> List[List[QueryResult]]:
        """Blocking convenience over :meth:`query_batch_async`."""
        return self.query_batch_async(queries, scorer, tokenizer, fields_boost, top_k).get()

    def query_batch_async(
        self,
        queries: Sequence[str],
        scorer,
        tokenizer=whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
    ) -> "ShardedPendingBatch":
        """Plan, prune, pack and launch a one-phase (BM25-style) window on
        the mesh without blocking; drain with ``.get_arrays()``."""
        if fields_boost is None:
            fields_boost = [1.0] * self.num_fields
        k = top_k or self.config.default_top_k
        B = len(queries)
        with metrics.timer("sharded/plan"):
            planned, fallback = self.plan_batch(queries, tokenizer, scorer, with_rows=True)
        pool_rows = plan_qp = plan_qids = None
        if planned is not None:
            planned, (pool_rows, plan_qp, plan_qids) = planned[:5], planned[5]
        host_rows = None
        if fallback:
            metrics.inc("device_fallback_queries", len(fallback))
            _host_fallback_policy(self.config, len(fallback), "sharded plan caps exceeded")
            vq = getattr(scorer, "vectorized_query", None)
            host_rows = {
                qi: (
                    vq(self._index, queries[qi], tokenizer, top_k=k, fields_boost=fields_boost)
                    if vq is not None
                    else self._index.query(queries[qi], scorer, tokenizer, fields_boost, top_k=k)
                )
                for qi in fallback
            }
        if planned is None:
            return ShardedPendingBatch(self, B, None, None, host_rows, k=k)
        # Sharded block-max pruning (index/prune.py prune_plan_sharded):
        # trim-only, exact; decisions memoized per (pooled query, k, boosts).
        if self.config.prune_blocks and plan_qp is not None and "prune_sh" in plan_qp:
            from ..index.prune import prune_plan_sharded_cached

            with metrics.timer("sharded/prune"):
                planned = prune_plan_sharded_cached(
                    self, planned, pool_rows, plan_qp, plan_qids, k, fields_boost
                )
        fmt = resolve_result_format(self.config.effective_result_format(), self.num_slots)
        with metrics.timer("sharded/pack"):
            class_specs, layout, buf = self._pack_window(planned, B)
        if not class_specs:
            return ShardedPendingBatch(self, B, None, None, host_rows, k=k)
        aux = self._aux_rec(scorer) if any(rng for *_s, rng in class_specs) else None
        with metrics.timer("sharded/dispatch"):
            rows = self._bm25_step(scorer, tuple(class_specs), buf, fields_boost, aux, k, fmt)
        return ShardedPendingBatch(
            self, B, [rows], [layout], host_rows, k=k, fmt=fmt, fetch=[self._start_fetch(rows)]
        )

    def query_batch_z2o(
        self,
        queries: Sequence[str],
        scorer=None,
        tokenizer=whitespace_tokenizer,
        top_k: Optional[int] = None,
    ) -> "ShardedPendingBatch":
        """Async zero-to-one window on the mesh: the fast program (K4) and,
        for shared-node queries, the lockstep program per shard as a second
        dispatch; only cap-exceeding queries run the host lockstep."""
        k = top_k or self.config.default_top_k
        B = len(queries)
        with metrics.timer("sharded/plan"):
            jquery, words, qlen, max_chunks, njobs, fallback, lock_pack = self.plan_batch_z2o(
                queries, tokenizer
            )
        host_rows = None
        if fallback:
            metrics.inc("device_fallback_queries", len(fallback))
            _host_fallback_policy(self.config, len(fallback), "sharded z2o plan caps exceeded")
            plain = scorer is None or type(scorer) is _z2o.ZeroToOne
            host_rows = {
                qi: (
                    _z2o.ZeroToOne.vectorized_query(self._index, queries[qi], tokenizer, top_k=k)
                    if plain
                    else self._index.query(
                        queries[qi], scorer, tokenizer, [1.0] * self.num_fields, top_k=k
                    )
                )
                for qi in fallback
            }
        if jquery is None and lock_pack is None:
            return ShardedPendingBatch(self, B, None, None, host_rows, k=k)
        with metrics.timer("sharded/pack"):
            packs = []
            if jquery is not None:
                fast = self._pack_z2o(B, jquery, words, max_chunks, njobs, qlen)
                if fast is not None:
                    packs.append((fast, False))
            if lock_pack is not None:
                ljq, lwords, lmax_chunks, lnjobs = lock_pack
                metrics.inc("z2o_sharded_lockstep_queries", int((lnjobs > 0).sum()))
                lock = self._pack_z2o(B, ljq, lwords, lmax_chunks, lnjobs, qlen)
                if lock is not None:
                    packs.append((lock, True))
            if not packs:
                return ShardedPendingBatch(self, B, None, None, host_rows, k=k)
        fmt = resolve_result_format(self.config.effective_result_format(), self.num_slots)
        dispatches, layouts, fetches = [], [], []
        with metrics.timer("sharded/dispatch"):
            for (class_specs, layout, buf, qcat), is_lock in packs:
                rows = self._z2o_step(tuple(class_specs), buf, qcat, k, fmt, is_lock)
                dispatches.append(rows)
                layouts.append(layout)
                fetches.append(self._start_fetch(rows))
        return ShardedPendingBatch(self, B, dispatches, layouts, host_rows, k=k, fmt=fmt, fetch=fetches)

    def _pack_window(self, planned, B):
        """Pack a planned window into (class_specs, layout, buf).

        Shape classes (the single-device engine's bucketing), packed into one
        flat per-(shard, data cell) ``buf`` int32[n, d_ax, words].  Queries
        that carry a range job form classes of their own, padded to at most 2
        rows per data cell.  One stable class argsort of the queries,
        per-job destinations by direct lookup, and ONE scatter of all jobs.
        Returns ([], [], None) for an all-empty window."""
        jquery, words, max_chunks, njobs, has_range = planned
        n = self.n_shards
        d_ax = int(self.mesh.shape["data"])
        nc_bucket = _bucket_vec(max_chunks, self.nc_buckets, self.nc_min)
        alive = njobs > 0
        # Class id: (range flag, nc bucket); range classes sort last.
        cls_q = np.where(alive, nc_bucket + (has_range.astype(np.int64) << 32), -1)
        order = np.argsort(cls_q, kind="stable")
        scls = cls_q[order]
        first = int(np.searchsorted(scls, 0))
        qorder, qcls = order[first:], scls[first:]
        if len(qorder) == 0:
            return [], [], None
        jpos = np.zeros(B, dtype=np.int64)
        np.subtract(np.cumsum(njobs), njobs, out=jpos)
        cbounds = np.flatnonzero(np.r_[True, qcls[1:] != qcls[:-1], True])
        class_specs = []
        layout = []  # (query_indices, data_rows, data_slots, row_offset)
        spans = []  # (members, drow, dslot, nj, col_off)
        row_base = col_off = 0
        for ci in range(len(cbounds) - 1):
            cls = int(qcls[cbounds[ci]])
            nc, rng_mode = cls & 0xFFFFFFFF, bool(cls >> 32)
            all_members = qorder[cbounds[ci] : cbounds[ci + 1]]
            nj = _bucket(int(njobs[all_members].max()), self.NJ_BUCKETS, 4)
            step_sz = (2 * d_ax) if rng_mode else len(all_members)
            for s0 in range(0, len(all_members), step_sz):
                members = all_members[s0 : s0 + step_sz]
                b_pad = max(1 if rng_mode else 8, 1 << (-(-len(members) // d_ax) - 1).bit_length())
                rank = np.arange(len(members))
                drow = rank // b_pad
                dslot = rank % b_pad
                # Output rows kept per data cell: the fullest cell's count
                # (cell 0 fills first) rounded up to 256.
                b_out = min(b_pad, -(-min(len(members), b_pad) // 256) * 256)
                class_specs.append((b_pad, b_out, nj, nc, rng_mode))
                layout.append((members, drow, dslot, row_base))
                spans.append((members, drow, dslot, nj, col_off))
                row_base += b_out
                col_off += b_pad * nj * 3
        # One scatter: per-job (data row, flat column) destinations.
        src_p, dr_p, dc_p = [], [], []
        for members, drow, dslot, nj, coff in spans:
            qnj = njobs[members]
            r = np.repeat(np.arange(len(members), dtype=np.int64), qnj)
            pos = _segment_arange(qnj)
            src_p.append(np.repeat(jpos[members], qnj) + pos)
            dr_p.append(drow[r])
            dc_p.append(coff + (dslot[r] * nj + pos) * 3)
        src = np.concatenate(src_p)
        dr = np.concatenate(dr_p)
        dc = np.concatenate(dc_p)
        buf = np.zeros((n, d_ax, col_off), dtype=np.int32)
        for i in range(3):
            buf[:, dr, dc + i] = words[:, src, i]
        return class_specs, layout, buf


class ShardedPendingBatch:
    """Handle for an in-flight sharded window: ``packed`` is a list of
    dispatches (one for a BM25 window; z2o fast and lockstep), each a list of
    packed-row tensors, one per data row, with its own layout."""

    def __init__(self, sdix, n, packed, layout, host_rows=None, k=None, fmt="f32", fetch=None) -> None:
        self._sdix = sdix
        self._n = n
        self._packed = packed
        self._layout = layout
        self._host_rows = host_rows
        self._fmt = fmt
        self._fetch = fetch or [None] * len(packed or ())
        # The submitted top_k sizes the all-host result arrays.
        self._k = k if k is not None else sdix.config.default_top_k

    def get(self) -> List[List[QueryResult]]:
        """QueryResult rows, assembled through the columnar drain."""
        if self._fmt.startswith("slots") and self._packed is not None:
            raise ValueError(
                "result_format='slots'/'slots20' windows carry no scores; use "
                "get_arrays() (ranked slots/keys) or a score-carrying "
                "result_format for QueryResult rows"
            )
        scores, slots, keys = self.get_arrays()
        results: List[List[QueryResult]] = [[] for _ in range(self._n)]
        valid = np.isfinite(scores) if scores is not None else slots >= 0
        obj_keys = keys.dtype == object if keys is not None else False
        for qi in range(self._n):
            if self._host_rows and qi in self._host_rows:
                results[qi] = self._host_rows[qi]
                continue
            m = valid[qi]
            if not m.any():
                continue
            results[qi] = [
                QueryResult(key=kk if obj_keys else int(kk), score=float(s))
                for s, kk in zip(scores[qi][m], keys[qi][m])
            ]
        return results

    def _host(self, i: int) -> np.ndarray:
        """Dispatch ``i``'s packed rows on the host, [d_ax, SB, ...]."""
        fetch = self._fetch[i]
        if fetch is not None:
            parts = []
            for (host, event), packed in zip(fetch, self._packed[i]):
                event.synchronize()
                parts.append((packed.cpu() if host is None else host).numpy())
        else:
            parts = [p.cpu().numpy() for p in self._packed[i]]
        return np.stack(parts)

    def get_arrays(self, want_keys: bool = True):
        """Columnar results ``(scores f32[n, k] | None, slots int32[n, k],
        keys[n, k])`` in query order; ``slots`` are GLOBAL doc slots and
        ``slots >= 0`` is the validity mask (invalid scores are -inf).  The
        slots formats carry no scores (``scores`` is None)."""
        sdix = self._sdix
        slots_only = self._fmt.startswith("slots")
        with metrics.timer("sharded/drain"):
            k = self._k
            if self._packed is None:
                scores = np.full((self._n, k), -np.inf, np.float32)
                slots = np.full((self._n, k), -1, np.int32)
            else:
                scores = None if slots_only else np.full((self._n, k), -np.inf, np.float32)
                slots = np.full((self._n, k), -1, np.int32)
                for i, layout in enumerate(self._layout):
                    with metrics.timer("sharded/fetch"):
                        host = self._host(i)
                    d_ax, SB = host.shape[0], host.shape[1]
                    p_scores, p_slots = unpack_result_rows(
                        host.reshape((d_ax * SB,) + host.shape[2:]), self._fmt, k
                    )
                    p_slots = p_slots.reshape(d_ax, SB, k)
                    if p_scores is not None:
                        p_scores = p_scores.reshape(d_ax, SB, k)
                    for members, drow, dslot, row_base in layout:
                        if scores is not None:
                            scores[members] = p_scores[drow, row_base + dslot]
                        slots[members] = p_slots[drow, row_base + dslot]
                if scores is not None:
                    slots = np.where(np.isfinite(scores), slots, -1)
            keys = None
            if want_keys:
                karr = sdix.key_arr
                if not len(karr):  # empty index: every slot is -1
                    keys = np.full(slots.shape, None, dtype=object)
                elif karr.dtype != object:
                    keys = karr[np.clip(slots, 0, None)]
                else:
                    valid = slots >= 0
                    keys = np.where(valid, karr[np.where(valid, slots, 0)], None)
            if self._host_rows:
                k2s = sdix._index._key_to_slot
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
