"""Block-max safe top-k pruning (plan-time, exact), for the torch port.

The classic exact-top-k machinery of production BM25 engines (block-max
upper bounds, WAND/MaxScore-family thresholds) applied to this engine's
execution model.  The reference scores EVERY live posting (its
src/query.rs:61-89); this engine's device cost grows with the gathered
lanes, so dropping posting chunks that provably cannot reach the top-k cuts
device work with zero result change.

Everything happens on the HOST at plan time, in numpy: the kernels are
untouched; pruning only shrinks and splits the job descriptors they
receive.  The port's copy of the JAX package's ``index/prune.py`` (its
single-index half), bit for bit in its job tables and counters
(tests/test_torch_prune.py).

Static metadata (built once per (snapshot, scorer) in the term-plan pool,
see DeviceIndex._term_plans):

* ``ub``      f32[NJOBS, F]        -- per-job max per-field IMPACT over live
  postings, inflated by ``(1 + margin)``.  Impact is the scorer's per-
  posting, per-field score factor with idf/boost divided out -- for BM25 the
  tf-norm of bm25.rs:71-87 (``BM25.device_impact``).
* ``topv``    f32[NJOBS, F, K_CAP] -- per-job DESCENDING top-K_CAP impacts
  per field (live postings), deflated by ``(1 - margin)``.
* ``cub_off`` int64[NJOBS + 1] and ``cub`` f32[TOTCHUNKS, F] -- per-CHUNK
  max impact (the chunk decomposition is the engine's stride-C scheme off
  the job's 128-aligned base, exactly matching ``device.chunk_tables``),
  inflated.
* ``cub_min`` f32[NJOBS, F]      -- per-job MIN over its chunks of ``cub``
  (+inf for chunkless jobs).  A job-level NECESSARY condition for any of
  its chunks to prune: ``sum_f boost_f * min_c cub_c[f] <= min_c sum_f
  boost_f * cub_c[f]``, so if even that optimistic lhs clears tau, no
  chunk of the job can drop and the per-chunk gather/test is skipped.
  On mixes where nothing prunes (the 1M-doc 3-term bench mix -- see the
  workload note) this removes most of the per-window prune cost; the
  pruning DECISION still always uses the exact per-chunk test.

Prune rule (per query q with terms t1..tm, requested top-k, boosts >= 0):

* threshold  ``tau(q) = max over jobs e of scale_e * max_f boost_f *
  topv_e[f, k-1]`` -- ACHIEVABLE: job e's k best field-f postings are k
  distinct live docs whose totals are each >= that value (every other
  contribution is >= 0), so the true k-th best total >= tau.
* term bound ``UB(t) = max over t's jobs of scale_e * sum_f boost_f *
  ub_e[f]`` -- no doc's term-t contribution exceeds it.
* prune chunk c of term t iff
  ``scale_e * sum_f boost_f * cub_c[f]  +  sum_{t' != t} UB(t')  <  tau(q)``.

SAFETY (tested, tests/test_torch_prune.py): a doc whose term-t MAX lane
sits in a pruned chunk has total <= lhs < tau <= k-th best, so it is
strictly below every top-k row under any tie order; a doc with total >= tau
keeps its max lane for every term (else the rule above is contradicted), so
its computed total -- max within term over the surviving lanes, then sum --
is unchanged VALUE-FOR-VALUE and the surviving top-k rows are bit-equal to
the unpruned window's.  Bounds are computed in f64 with a ``margin``
(default 1e-4, IndexConfig.prune_margin) that dominates both the device's
<= 2e-5 relative f32 drift against the f64 oracle and the f64-vs-f32
scale-word rounding.

Pruning is DISABLED (per call or per query) whenever safety cannot be
proven: k > IndexConfig.prune_max_top_k, any negative field boost, scorers
without ``device_impact`` (e.g. zero-to-one), queries carrying term-range
jobs, or a snapshot with non-finite field averages.

A split job starts at ``base128 + w*C`` (or at its original start for its
first chunk), so its chunks stay the stride-C chunks of the unpruned job:
``chunk_tables`` and the kernels' 16-B row loads take it exactly as they
take an unpruned row.

The sharded engine prunes too (``prune_plan_sharded``), with two
sharding refinements to the same rule: tau(q) is the max over shards'
achievable thresholds (a shard's k best docs for a job are k distinct docs
of the GLOBAL corpus), and a chunk's "other terms" slack uses its OWN
shard's UB(t') -- a doc's postings all live on one shard, so the
shard-local bound is both valid and tighter.  The rebuild is TRIM-ONLY: a
job loses provably-hopeless leading/trailing chunks but keeps interior
ones, so job rows keep the cross-shard alignment the packed window layout
requires (a fully-pruned job becomes zero-length, which the per-shard job
tables already support as split-tail padding).  Bit for bit the JAX
package's tables (tests/test_torch_sharding.py).

Workload note (``chip_smoke.py`` phase 3p measures three mixes on the
1M-doc bench corpus, whose docs all hold 8 tokens, so a posting's impact is
its tf alone): on the 3-term bench mix the disjunctive bound ``sum UB(t')``
is far above any tau, so nothing prunes -- multi-term disjunctions over
same-magnitude-idf terms are the known weak spot of WAND-family bounds.
Single-term queries prune where a term has at least k docs holding it
twice (tau above every tf-1 posting).  Pairs of a mid-rank term with a rare
one prune nothing there either: the rare term's own bound ``idf_r *
impact(tf 1)`` already reaches every achievable tau, so no chunk of the
other term can fall below it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..utils.metrics import metrics


def _segment_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (vectorized)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def build_job_bounds(
    dix,
    scorer,
    jstart: np.ndarray,
    jlen: np.ndarray,
    jrange: np.ndarray,
    chunk: int,
    k_cap: int,
    margin: float,
) -> Optional[Dict[str, np.ndarray]]:
    """Compute the static bound arrays for a batch of FINAL job rows.

    Returns dict(ub, topv, cub_off, cub, cub_min) aligned with the job rows,
    or ``None`` when the scorer/snapshot cannot support pruning.  Range jobs
    get zeroed ``ub``/``topv`` and ZERO chunk rows (queries carrying them
    are never pruned).
    """
    impact_fn = getattr(scorer, "device_impact", None)
    avg = np.asarray(dix._field_avg_host, dtype=np.float64)
    if impact_fn is None or not np.isfinite(avg).all():
        return None
    J = len(jstart)
    F = dix.num_fields
    C = chunk
    ub = np.zeros((J, F), dtype=np.float32)
    cub_min = np.full((J, F), np.inf, dtype=np.float32)
    topv = np.full((J, F, k_cap), -np.inf, dtype=np.float32)
    nreal = np.where(
        jrange, 0, np.where(jlen > 0, (jstart % 128 + jlen + C - 1) // C, 0)
    ).astype(np.int64)
    cub_off = np.zeros(J + 1, dtype=np.int64)
    np.cumsum(nreal, out=cub_off[1:])
    cub = np.zeros((int(cub_off[-1]), F), dtype=np.float32)
    sel = np.flatnonzero(~jrange & (jlen > 0))
    if len(sel) == 0:
        return {"ub": ub, "topv": topv, "cub_off": cub_off, "cub": cub, "cub_min": cub_min}

    # Flat posting rows of the selected jobs (jobs never cross segments).
    s_start = jstart[sel]
    s_len = jlen[sel]
    flat = np.repeat(s_start, s_len) + _segment_arange(s_len)
    jobflat = np.repeat(np.arange(len(sel), dtype=np.int64), s_len)

    # Per-posting impact over the SNAPSHOT arrays (immutable segments + the
    # DeviceIndex's own copies of alive/doc_len -- a later vacuum must not
    # leak into a stale snapshot's bounds).
    tf = dix._post_tf_all[flat].astype(np.float64)
    doc = dix._post_doc_all[flat]
    flen = dix._doc_len_snap[doc].astype(np.float64)
    imp = np.asarray(impact_fn(tf, flen, avg), dtype=np.float64)
    imp[~dix._alive_snap[doc]] = 0.0  # dead lanes never score

    # Chunk boundaries in the flat array: the stride-C scheme's chunk w of
    # job j starts at global posting max(jstart, base + w*C).
    base = (s_start // 128) * 128
    njc = nreal[sel]
    w = _segment_arange(njc)
    jc = np.repeat(np.arange(len(sel), dtype=np.int64), njc)
    fs = np.zeros(len(sel), dtype=np.int64)
    np.subtract(np.cumsum(s_len), s_len, out=fs)
    bnd = fs[jc] + np.maximum(base[jc] + w * C - s_start[jc], 0)
    up = 1.0 + margin
    rank = _segment_arange(s_len)  # within-job position
    take = rank < k_cap
    for f in range(F):
        col = imp[:, f]
        cub[np.repeat(cub_off[sel], njc) + w, f] = np.maximum.reduceat(col, bnd) * up
        # Per-job max + descending top-K (one integer-keyed sort).
        order = np.lexsort((-col, jobflat))
        ub[sel, f] = np.maximum.reduceat(col, fs) * up
        tv = np.full((len(sel), k_cap), -np.inf, dtype=np.float64)
        tv[jobflat[order][take], rank[take]] = col[order][take] * (1.0 - margin)
        topv[sel, f, :] = tv.astype(np.float32)
    # Per-job min chunk bound (sel jobs' chunk rows are contiguous and in
    # sel order, every group non-empty -- reduceat segments line up).
    cub_min[sel] = np.minimum.reduceat(cub, cub_off[sel], axis=0)
    return {"ub": ub, "topv": topv, "cub_off": cub_off, "cub": cub, "cub_min": cub_min}


def prune_plan_cached(dix, plan, pool, k: int, fields_boost) -> Any:
    """Per-query memoized :func:`prune_plan`.

    On a frozen snapshot the prune decision for one query depends only on
    (its pooled job rows, k, boosts) -- the bound arrays are pool-static and
    tau / the slack terms are computed from the query's own jobs.  So the
    outcome is cached in the query-plan pool (``plan.qp``, captured under
    the plan lock by ``plan_batch``) keyed by ``(k, boosts)``:

    * status 1 (unchanged): the query's rows pass through verbatim -- the
      steady-state cost on no-prune mixes (e.g. the 1M-doc bench mix, where
      the direct pass re-derives every repeated query's bounds each window)
      collapses to one status gather.
    * status 2 (pruned): the pruned rows live in per-key alt pools and are
      spliced in by a vectorized two-source gather.

    First-seen queries run the exact :func:`prune_plan` once on a sub-plan.
    Queries whose window rows no longer match the pool (the heavy-cache
    splice zeroes their jobs) are trivially unchanged and are not cached.
    Results are bit-equal to the direct pass (tests/test_torch_prune.py).
    """
    qids, qp = plan.qids, plan.qp
    if qids is None or qp is None:
        return prune_plan(dix, plan, pool, k, fields_boost)
    k_cap = int(dix.config.prune_max_top_k)
    if plan.pool_rows is None or "prune_ub" not in pool or k > k_cap or k < 1:
        return plan
    boosts = np.asarray(fields_boost, dtype=np.float64)
    if (boosts < 0).any() or len(boosts) != dix.num_fields:
        return plan
    from .device import PlannedJobs

    key = (k, tuple(boosts.tolist()))
    with dix._plan_lock:
        caches = qp.setdefault("prune_cache", {})
        pc = caches.get(key)
        npool = len(qp["njobs"])
        if pc is None:
            pc = caches[key] = {
                "status": np.zeros(npool, dtype=np.int8),
                "alt_map": np.full(npool, -1, dtype=np.int64),
                "alt_off": np.zeros(0, dtype=np.int64),
                "alt_njobs": np.zeros(0, dtype=np.int64),
                "alt_nchunks": np.zeros(0, dtype=np.int64),
                "alt_words": np.zeros((0, 3), dtype=np.int32),
                "alt_prows": np.zeros(0, dtype=np.int64),
            }
        if len(pc["status"]) < npool:
            grow = npool - len(pc["status"])
            pc["status"] = np.concatenate([pc["status"], np.zeros(grow, np.int8)])
            pc["alt_map"] = np.concatenate([pc["alt_map"], np.full(grow, -1, np.int64)])
        status = pc["status"]

        B = len(plan.njobs)
        # A query is pool-aligned iff its window rows match its pooled rows;
        # the only in-window divergence (heavy splice) zeroes njobs, and
        # zero-job queries are trivially unchanged.
        sq = np.where(plan.njobs > 0, qids, -1)
        st_q = np.where(sq >= 0, status[np.maximum(sq, 0)], np.int8(1))
        unk_pos = np.flatnonzero(st_q == 0)
        poff = np.zeros(B + 1, np.int64)
        np.cumsum(plan.njobs, out=poff[1:])
        if len(unk_pos):
            uq, first = np.unique(sq[unk_pos], return_index=True)
            upos = unk_pos[first]
            nj_u = plan.njobs[upos]
            rsel = np.repeat(poff[upos], nj_u) + _segment_arange(nj_u)
            sub = PlannedJobs(
                jquery=np.repeat(np.arange(len(upos), dtype=np.int64), nj_u),
                words=plan.words[rsel],
                nchunks=plan.nchunks[upos],
                njobs=nj_u,
                has_range=plan.has_range[upos],
                pool_rows=plan.pool_rows[rsel],
            )
            out = prune_plan(dix, sub, pool, k, fields_boost)
            metrics.inc("prune/cache_fills", len(uq))
            if out is sub:
                status[uq] = 1
            else:
                # A pruned chunk strictly reduces its query's chunk total,
                # and untouched queries' rows pass through bit-equal
                # (prune_plan's rebuild) -- so the per-query change test is
                # exactly the nchunks comparison.
                changed_u = out.nchunks < sub.nchunks
                status[uq[~changed_u]] = 1
                ch = np.flatnonzero(changed_u)
                if len(ch):
                    ooff = np.zeros(len(out.njobs) + 1, np.int64)
                    np.cumsum(out.njobs, out=ooff[1:])
                    nj_c = out.njobs[ch]
                    csel = np.repeat(ooff[ch], nj_c) + _segment_arange(nj_c)
                    nb = len(pc["alt_njobs"])
                    pc["alt_map"][uq[ch]] = nb + np.arange(len(ch))
                    pc["alt_off"] = np.concatenate(
                        [pc["alt_off"], len(pc["alt_words"]) + np.cumsum(nj_c) - nj_c]
                    )
                    pc["alt_njobs"] = np.concatenate([pc["alt_njobs"], nj_c])
                    pc["alt_nchunks"] = np.concatenate([pc["alt_nchunks"], out.nchunks[ch]])
                    pc["alt_words"] = np.concatenate([pc["alt_words"], out.words[csel]])
                    pc["alt_prows"] = np.concatenate([pc["alt_prows"], out.pool_rows[csel]])
                    status[uq[ch]] = 2
            st_q = np.where(sq >= 0, status[np.maximum(sq, 0)], np.int8(1))

        use_alt = st_q == 2
        if not use_alt.any():
            return plan
        a_idx = np.where(use_alt, pc["alt_map"][np.maximum(sq, 0)], 0)
        nj_eff = np.where(use_alt, pc["alt_njobs"][a_idx], plan.njobs)
        nch_eff = np.where(use_alt, pc["alt_nchunks"][a_idx], plan.nchunks)
        src_off = np.where(use_alt, pc["alt_off"][a_idx], poff[:B])
        jq2 = np.repeat(np.arange(B, dtype=np.int64), nj_eff)
        rows_flat = np.repeat(src_off, nj_eff) + _segment_arange(nj_eff)
        cf = np.repeat(use_alt, nj_eff)
        words2 = np.empty((len(jq2), 3), np.int32)
        words2[~cf] = plan.words[rows_flat[~cf]]
        words2[cf] = pc["alt_words"][rows_flat[cf]]
        prows2 = np.empty(len(jq2), np.int64)
        prows2[~cf] = plan.pool_rows[rows_flat[~cf]]
        prows2[cf] = pc["alt_prows"][rows_flat[cf]]
        metrics.inc("prune/pruned_chunks", int((plan.nchunks - nch_eff).sum()))
        return PlannedJobs(
            jquery=jq2,
            words=words2,
            nchunks=nch_eff,
            njobs=nj_eff,
            has_range=plan.has_range,
            pool_rows=prows2,
        )


def prune_plan(dix, plan, pool, k: int, fields_boost) -> Any:
    """Apply block-max pruning to a planned batch.  Returns the (possibly)
    pruned PlannedJobs; the input plan is never mutated.  See the module
    docstring for the rule and its safety argument."""
    from .device import _LEN_BITS, _MAX_JOB_LEN, _QT_BITS, PlannedJobs

    k_cap = int(dix.config.prune_max_top_k)
    if (
        plan is None
        or plan.pool_rows is None
        or pool is None
        or "prune_ub" not in pool
        or k > k_cap
        or k < 1
    ):
        return plan
    boosts = np.asarray(fields_boost, dtype=np.float64)
    if (boosts < 0).any() or len(boosts) != dix.num_fields:
        return plan

    rows = plan.pool_rows
    jq = plan.jquery
    B = len(plan.njobs)
    C = dix.CHUNK
    words = plan.words
    jqterm = (words[:, 1] >> _LEN_BITS) & ((1 << _QT_BITS) - 1)
    is_rng = ((words[:, 1] >> 30) & 1) > 0
    scale = words[:, 2].view(np.float32).astype(np.float64)

    # Per-job weighted bounds (f64; the pooled arrays carry the margin).
    ubw = (pool["prune_ub"][rows].astype(np.float64) * boosts).sum(axis=1) * scale
    kth = pool["prune_topv"][rows, :, k - 1].astype(np.float64)  # [J, F]
    # -inf marks "fewer than k live postings in this job/field"; keep it
    # -inf under a zero boost too (-inf * 0 would be nan).
    kthw = np.where(kth == -np.inf, -np.inf, kth * boosts)
    tau_job = kthw.max(axis=1) * scale

    # (query, qterm) runs are contiguous (jobs are assembled per term in
    # token order) -- reduceat segments give UB(t) and then per-query sums.
    gkey = jq * (1 << _QT_BITS) + jqterm
    heads = np.ones(len(jq), dtype=bool)
    heads[1:] = gkey[1:] != gkey[:-1]
    hidx = np.flatnonzero(heads)
    ub_t = np.maximum.reduceat(ubw, hidx)  # per (q, qterm)
    tq = jq[hidx]
    S_q = np.bincount(tq, weights=ub_t, minlength=B)
    qheads = np.ones(len(jq), dtype=bool)
    qheads[1:] = jq[1:] != jq[:-1]
    qh = np.flatnonzero(qheads)
    tau_q = np.full(B, -np.inf)
    tau_q[jq[qh]] = np.maximum.reduceat(tau_job, qh)

    prunable_q = (tau_q > 0) & np.isfinite(tau_q) & ~plan.has_range
    test_j = prunable_q[jq] & ~is_rng
    if not test_j.any():
        return plan
    # Spread UB(t) back to jobs to form "other terms" slack per job.
    ub_t_job = np.repeat(ub_t, np.diff(np.r_[hidx, len(jq)]))
    other = S_q[jq] - ub_t_job

    # Chunk test for testable jobs.
    jlen_all = (words[:, 1] & _MAX_JOB_LEN).astype(np.int64)
    njc_all = np.where(
        jlen_all > 0,
        ((words[:, 0].astype(np.int64) % 128) + jlen_all + C - 1) // C,
        0,
    )
    keep = np.ones(int(njc_all.sum()), dtype=bool)
    coff = np.zeros(len(njc_all) + 1, dtype=np.int64)
    np.cumsum(njc_all, out=coff[1:])

    tj = np.flatnonzero(test_j)
    # Job-level necessary condition (module docstring, ``cub_min``): only
    # jobs whose OPTIMISTIC lower-bound lhs clears the threshold can have a
    # droppable chunk -- the rest skip the per-chunk gather/test entirely.
    # inf * 0 boost -> nan sums compare False: chunkless jobs fall out,
    # which is the correct (never-prunable) outcome.
    with np.errstate(invalid="ignore"):
        cminw = (pool["prune_cub_min"][rows[tj]].astype(np.float64) * boosts).sum(axis=1)
        maybe = cminw * scale[tj] + other[tj] < tau_q[jq[tj]]
    tj = tj[maybe]
    if not len(tj):
        return plan
    ncj = njc_all[tj]
    pj = np.repeat(tj, ncj)  # plan-job index per tested chunk
    w = _segment_arange(ncj)
    crows = np.repeat(pool["prune_cub_off"][rows[tj]], ncj) + w
    cubw = (pool["prune_cub"][crows].astype(np.float64) * boosts).sum(axis=1)
    lhs = cubw * scale[pj] + other[pj]
    drop = lhs < tau_q[jq[pj]]
    if not drop.any():
        return plan
    keep[np.repeat(coff[tj], ncj) + w] = ~drop

    # ---- rebuild jobs from kept-chunk runs --------------------------- #
    jobflat = np.repeat(np.arange(len(njc_all), dtype=np.int64), njc_all)
    wall = _segment_arange(njc_all)
    same_job_prev = np.zeros(len(jobflat), dtype=bool)
    same_job_prev[1:] = jobflat[1:] == jobflat[:-1]
    prev_keep = np.zeros(len(keep), dtype=bool)
    prev_keep[1:] = keep[:-1]
    starts = keep & ~(same_job_prev & prev_keep)
    same_job_next = np.zeros(len(jobflat), dtype=bool)
    same_job_next[:-1] = jobflat[1:] == jobflat[:-1]
    next_keep = np.zeros(len(keep), dtype=bool)
    next_keep[:-1] = keep[1:]
    ends = keep & ~(same_job_next & next_keep)

    rj = jobflat[starts]
    w_first = wall[starts]
    w_last = wall[ends]
    jstart = words[:, 0].astype(np.int64)
    jlen = (words[:, 1] & _MAX_JOB_LEN).astype(np.int64)
    base = (jstart // 128) * 128
    new_start = np.where(w_first == 0, jstart[rj], base[rj] + w_first * C)
    new_end = np.minimum(jstart[rj] + jlen[rj], base[rj] + (w_last + 1) * C)
    new_len = new_end - new_start

    # Jobs with zero chunks (range jobs; zero-length) pass through verbatim
    # -- splice them back in query-sorted job order.
    zero_j = np.flatnonzero(njc_all == 0)
    if len(zero_j):
        order = np.argsort(np.concatenate([rj, zero_j]), kind="stable")
        rj2 = np.concatenate([rj, zero_j])[order]
        new_start = np.concatenate([new_start, jstart[zero_j]])[order]
        new_len = np.concatenate([new_len, jlen[zero_j]])[order]
        w_span = np.concatenate([w_last - w_first + 1, np.zeros(len(zero_j), np.int64)])[order]
        rj = rj2
    else:
        w_span = w_last - w_first + 1

    words2 = np.empty((len(rj), 3), dtype=np.int32)
    words2[:, 0] = new_start
    words2[:, 1] = (
        new_len
        | (jqterm[rj].astype(np.int64) << _LEN_BITS)
        | (is_rng[rj].astype(np.int64) << 30)
    ).astype(np.int32)
    words2[:, 2] = words[rj, 2]
    jq2 = jq[rj]
    njobs2 = np.bincount(jq2, minlength=B).astype(np.int64)
    nchunks2 = np.bincount(jq2, weights=w_span.astype(np.float64), minlength=B).astype(np.int64)

    metrics.inc("prune/pruned_chunks", int(njc_all.sum() - w_span.sum()))
    metrics.inc("prune/pruned_jobs", int(len(words) - len(words2)))
    return PlannedJobs(
        jquery=jq2,
        words=words2,
        nchunks=nchunks2,
        njobs=njobs2,
        has_range=plan.has_range,
        pool_rows=rows[rj],
    )


# --------------------------------------------------------------------- #
# the sharded engine's trim (parallel/dist_query.py)                     #
# --------------------------------------------------------------------- #


class _ShardBoundsView:
    """One shard of a ShardedDeviceIndex presented as a
    :func:`build_job_bounds` source: shard-local posting rows (the shard
    CSR's row space -- ``_shard_rows[s]`` in global posting order keeps the
    per-term doc-sorted CSR invariant), global doc stats."""

    def __init__(self, sdix, s: int):
        sel = sdix._shard_rows[s]
        self._post_tf_all = sdix._post_tf_g[sel]
        self._post_doc_all = sdix._post_doc_g[sel]
        self._doc_len_snap = sdix._doc_len_snap
        self._alive_snap = sdix._alive_snap
        self._field_avg_host = sdix._field_avg_host
        self.num_fields = sdix.num_fields


def shard_bounds_view(sdix, s: int) -> _ShardBoundsView:
    """Cached per-shard bounds view (its gather is O(P / n))."""
    v = sdix._prune_views[s]
    if v is None:
        v = sdix._prune_views[s] = _ShardBoundsView(sdix, s)
    return v


def prune_plan_sharded_cached(sdix, planned, rows, qp, qids, k: int, fields_boost) -> Any:
    """Per-query memoized :func:`prune_plan_sharded` (the sharded mirror of
    :func:`prune_plan_cached`).

    The sharded trim is TRIM-ONLY -- job count and order are invariant -- so
    the cache stores, per (pooled query, k, boosts): status (unchanged /
    trimmed) plus, for trimmed queries, the trimmed ``[n_shards, nj, 3]``
    word rows and the new chunk total; repeats splice word rows in place of
    the pool gather.  Change detection is a word comparison per job (the
    per-query ``nchunks`` -- the MAX over shards -- can survive a trim on a
    non-max shard, so it is NOT a valid change test here, unlike the
    single-index rebuild).  Bit-equal to the direct pass."""
    if planned is None or rows is None or qids is None:
        return prune_plan_sharded(sdix, planned, rows, qp, k, fields_boost)
    k_cap = int(sdix.config.prune_max_top_k)
    if k > k_cap or k < 1:
        return planned
    boosts = np.asarray(fields_boost, dtype=np.float64)
    if (boosts < 0).any() or len(boosts) != sdix.num_fields:
        return planned

    key = (k, tuple(boosts.tolist()))
    n = sdix.n_shards
    with sdix._plan_lock:
        caches = qp.setdefault("prune_cache", {})
        pc = caches.get(key)
        npool = len(qp["njobs"])
        if pc is None:
            pc = caches[key] = {
                "status": np.zeros(npool, dtype=np.int8),
                "alt_map": np.full(npool, -1, dtype=np.int64),
                "alt_off": np.zeros(0, dtype=np.int64),
                "alt_njobs": np.zeros(0, dtype=np.int64),
                "alt_nchunks": np.zeros(0, dtype=np.int64),
                "alt_words": np.zeros((n, 0, 3), dtype=np.int32),
            }
        if len(pc["status"]) < npool:
            grow = npool - len(pc["status"])
            pc["status"] = np.concatenate([pc["status"], np.zeros(grow, np.int8)])
            pc["alt_map"] = np.concatenate([pc["alt_map"], np.full(grow, -1, np.int64)])
        status = pc["status"]

        jq, words, nchunks, njobs, has_range = planned
        B = len(njobs)
        sq = np.where(njobs > 0, qids, -1)
        st_q = np.where(sq >= 0, status[np.maximum(sq, 0)], np.int8(1))
        unk_pos = np.flatnonzero(st_q == 0)
        poff = np.zeros(B + 1, np.int64)
        np.cumsum(njobs, out=poff[1:])
        if len(unk_pos):
            uq, first = np.unique(sq[unk_pos], return_index=True)
            upos = unk_pos[first]
            nj_u = njobs[upos]
            rsel = np.repeat(poff[upos], nj_u) + _segment_arange(nj_u)
            sub = (
                np.repeat(np.arange(len(upos), dtype=np.int64), nj_u),
                words[:, rsel],
                nchunks[upos],
                nj_u,
                has_range[upos],
            )
            out = prune_plan_sharded(sdix, sub, rows[rsel], qp, k, fields_boost)
            metrics.inc("prune/sharded_cache_fills", len(uq))
            if out is sub:
                status[uq] = 1
            else:
                ow = out[1]
                chj = (ow != sub[1]).any(axis=(0, 2))  # [Jsub]
                soff = np.zeros(len(uq) + 1, np.int64)
                np.cumsum(nj_u, out=soff[1:])
                changed_u = np.add.reduceat(chj.astype(np.int64), soff[:-1]) > 0
                status[uq[~changed_u]] = 1
                ch = np.flatnonzero(changed_u)
                if len(ch):
                    nj_c = nj_u[ch]
                    csel = np.repeat(soff[ch], nj_c) + _segment_arange(nj_c)
                    nb = len(pc["alt_njobs"])
                    pc["alt_map"][uq[ch]] = nb + np.arange(len(ch))
                    pc["alt_off"] = np.concatenate(
                        [pc["alt_off"], pc["alt_words"].shape[1] + np.cumsum(nj_c) - nj_c]
                    )
                    pc["alt_njobs"] = np.concatenate([pc["alt_njobs"], nj_c])
                    pc["alt_nchunks"] = np.concatenate([pc["alt_nchunks"], out[2][ch]])
                    pc["alt_words"] = np.concatenate([pc["alt_words"], ow[:, csel]], axis=1)
                    status[uq[ch]] = 2
            st_q = np.where(sq >= 0, status[np.maximum(sq, 0)], np.int8(1))

        use_alt = st_q == 2
        if not use_alt.any():
            return planned
        a_idx = np.where(use_alt, pc["alt_map"][np.maximum(sq, 0)], 0)
        nch2 = np.where(use_alt, pc["alt_nchunks"][a_idx], nchunks)
        words2 = words.copy()
        ch_pos = np.flatnonzero(use_alt)
        nj_ch = njobs[ch_pos]
        dsel = np.repeat(poff[ch_pos], nj_ch) + _segment_arange(nj_ch)
        ssel = np.repeat(pc["alt_off"][a_idx[ch_pos]], nj_ch) + _segment_arange(nj_ch)
        words2[:, dsel] = pc["alt_words"][:, ssel]
        metrics.inc("prune/sharded_cache_splices", len(ch_pos))
        return jq, words2, nch2, njobs, has_range


def prune_plan_sharded(sdix, planned, rows, qp, k: int, fields_boost) -> Any:
    """Trim-only sharded block-max pruning (module docstring, sharded
    paragraph).  ``planned`` is the 5-tuple of
    ``ShardedDeviceIndex.plan_batch``; ``rows`` its pool job rows; ``qp`` the
    plan pool carrying ``prune_sh`` per-shard bounds.  Returns a (possibly)
    trimmed 5-tuple; inputs are never mutated."""
    from .device import _LEN_BITS, _MAX_JOB_LEN, _QT_BITS

    k_cap = int(sdix.config.prune_max_top_k)
    if planned is None or rows is None or k > k_cap or k < 1:
        return planned
    boosts = np.asarray(fields_boost, dtype=np.float64)
    if (boosts < 0).any() or len(boosts) != sdix.num_fields:
        return planned

    jq, words, nchunks, njobs, has_range = planned
    n, Jw = words.shape[0], words.shape[1]
    B = len(njobs)
    C = sdix.CHUNK
    if Jw == 0:
        return planned
    # word1's qterm/range bits and word2's scale are shard-invariant (the
    # planner broadcasts them); only start/len vary.
    jqterm = (words[0, :, 1] >> _LEN_BITS) & ((1 << _QT_BITS) - 1)
    is_rng = ((words[0, :, 1] >> 30) & 1) > 0
    scale = words[0, :, 2].view(np.float32).astype(np.float64)
    pbs = qp["prune_sh"]

    # Per-shard weighted job bounds [n, Jw] (f64; margins are pooled).
    with np.errstate(invalid="ignore"):
        ubw = (
            np.stack([(pbs[s]["ub"][rows].astype(np.float64) * boosts).sum(axis=1) for s in range(n)])
            * scale
        )
        kth = np.stack([pbs[s]["topv"][rows, :, k - 1].astype(np.float64) for s in range(n)])
        kthw = np.where(kth == -np.inf, -np.inf, kth * boosts)
        tau_job = kthw.max(axis=2) * scale  # [n, Jw]

    # (q, qterm) job runs are contiguous for non-range queries (range-
    # carrying queries may interleave, but they are never prunable).
    gkey = jq * (1 << _QT_BITS) + jqterm
    heads = np.ones(Jw, dtype=bool)
    heads[1:] = gkey[1:] != gkey[:-1]
    hidx = np.flatnonzero(heads)
    ub_t = np.maximum.reduceat(ubw, hidx, axis=1)  # [n, G]
    tq = jq[hidx]
    S_q = np.stack([np.bincount(tq, weights=ub_t[s], minlength=B) for s in range(n)])  # [n, B]
    qheads = np.ones(Jw, dtype=bool)
    qheads[1:] = jq[1:] != jq[:-1]
    qh = np.flatnonzero(qheads)
    tau_q = np.full(B, -np.inf)
    tau_q[jq[qh]] = np.maximum.reduceat(tau_job.max(axis=0), qh)

    prunable_q = (tau_q > 0) & np.isfinite(tau_q) & ~has_range
    test_j = prunable_q[jq] & ~is_rng
    if not test_j.any():
        return planned
    grp_sizes = np.diff(np.r_[hidx, Jw])
    ub_t_job = np.repeat(ub_t, grp_sizes, axis=1)  # [n, Jw]
    other = S_q[:, jq] - ub_t_job  # [n, Jw] -- shard-local slack

    words2 = words
    trimmed_total = 0
    for s in range(n):
        jstart_all = words[s, :, 0].astype(np.int64)
        jlen_all = (words[s, :, 1] & _MAX_JOB_LEN).astype(np.int64)
        njc_all = np.where(jlen_all > 0, (jstart_all % 128 + jlen_all + C - 1) // C, 0)
        tj = np.flatnonzero(test_j & (njc_all > 0))
        if not len(tj):
            continue
        # Job-level necessary condition via cub_min (see prune_plan).
        with np.errstate(invalid="ignore"):
            cminw = (pbs[s]["cub_min"][rows[tj]].astype(np.float64) * boosts).sum(axis=1)
            maybe = cminw * scale[tj] + other[s, tj] < tau_q[jq[tj]]
        tj = tj[maybe]
        if not len(tj):
            continue
        ncj = njc_all[tj]
        w = _segment_arange(ncj)
        pj = np.repeat(tj, ncj)
        crows = np.repeat(pbs[s]["cub_off"][rows[tj]], ncj) + w
        cubw = (pbs[s]["cub"][crows].astype(np.float64) * boosts).sum(axis=1)
        drop = cubw * scale[pj] + other[s, pj] < tau_q[jq[pj]]
        if not drop.any():
            continue
        # Trim-only rebuild: first/last KEPT chunk per tested job.
        off = np.zeros(len(tj), np.int64)
        np.subtract(np.cumsum(ncj), ncj, out=off)
        wk_min = np.minimum.reduceat(np.where(drop, 1 << 40, w), off)
        wk_max = np.maximum.reduceat(np.where(drop, -1, w), off)
        base = (jstart_all[tj] // 128) * 128
        empty = wk_max < 0
        new_start = np.where(wk_min == 0, jstart_all[tj], base + wk_min * C)
        new_end = np.minimum(jstart_all[tj] + jlen_all[tj], base + (wk_max + 1) * C)
        new_len = np.where(empty, 0, new_end - new_start)
        new_start = np.where(empty, jstart_all[tj], new_start)
        if not (new_len != jlen_all[tj]).any():
            continue
        if words2 is words:
            words2 = words.copy()
        words2[s, tj, 0] = new_start.astype(np.int32)
        words2[s, tj, 1] = (
            new_len
            | (jqterm[tj].astype(np.int64) << _LEN_BITS)
            | (is_rng[tj].astype(np.int64) << 30)
        ).astype(np.int32)
        trimmed_total += int((ncj - np.where(empty, 0, wk_max - wk_min + 1)).sum())
    if words2 is words:
        return planned
    # Per-query chunk totals = max over shards (plan_batch's nchunks
    # contract; the class bucketing keys on it).
    nch_sh = np.zeros((n, B))
    for s in range(n):
        jl = (words2[s, :, 1] & _MAX_JOB_LEN).astype(np.int64)
        js = words2[s, :, 0].astype(np.int64)
        njc = np.where(jl > 0, (js % 128 + jl + C - 1) // C, 0)
        nch_sh[s] = np.bincount(jq, weights=njc.astype(np.float64), minlength=B)
    nch2 = nch_sh.max(axis=0).astype(np.int64)
    metrics.inc("prune/sharded_trimmed_chunks", trimmed_total)
    return jq, words2, nch2, njobs, has_range
