"""Zero-to-one scoring on a torch device.

Counterpart of ``probly_search_tpu/ops/z2o_device.py``.  The reference's
finalize (zero_to_one.rs:84-126) is a per-(doc, field) consumption loop:
entries sorted by score descending are accepted unless their query term was
already consumed or their trie node's df pool (``tf - 1``, decremented on
reuse) is exhausted; an accepted entry contributes ``min(s / tf, 1) * tf /
max(field_length, query_terms_len)``, and a doc scores the max over fields of
its pool sums.  The planner is the JAX engine's, carried over in numpy, and
routes every query to one of three device programs:

* the fast program (``z2o_fast_step``) for queries whose expansion nodes are
  not shared: the loop reduces to "accept the best entry per (doc, field,
  query term)".  Classes the fused kernel takes (the JAX engine's Pallas caps)
  launch K4, ``ops/fused_z2o.py``; the rest run ``z2o_staged_fast_step``, the
  torch counterpart of the JAX engine's XLA branch;
* the lockstep program (``z2o_step``) for shared-node queries, in torch (the
  JAX package has no kernel for it);
* queries past the programs' caps run the vectorized host lockstep
  (``models/zero_to_one.vectorized_query``).

``launches`` counts the torch programs' runs on a CUDA device (never on the
CPU), beside ``fused_z2o.launches`` for the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.device import (
    _MAX_CHAR,
    PendingBatch,
    _bucket,
    _bucket_vec,
    _host_fallback_policy,
    _segment_arange,
    chunk_tables,
    pack_result_rows,
    resolve_result_format,
)
from ..index.segment import probe_terms_fixed
from ..models import zero_to_one as _z2o
from ..utils.metrics import metrics
from .fused_z2o import (
    FUSED_Z2O_MAX_FIELDS,
    FUSED_Z2O_MAX_LANES,
    contribution,
    fused_z2o_topk,
    gather_lanes,
    pool_scores,
    topk_lanes,
)
from .merge import _shift_left, _shift_right, segmented_scan

_I32_MAX = 2**31 - 1
_LEN_BITS = 26
_QT_BITS = 4

launches = {"z2o_staged": 0, "z2o_lockstep": 0}


def _count(name: str, device) -> None:
    if device.type == "cuda":
        launches[name] += 1


def expand_chunks_z2o(jobs, chunk: int, num_chunks: int):
    """Expand 4-word z2o jobs int32[B, NJ, 4] (start, len | qterm << 26,
    node id or score rank, entry score f32 bits) into per-chunk tables:
    (c_start, c_skip, c_len, c_qterm, c_word2) int32[B, NC] and c_score
    f32[B, NC].  The integer tables equal the JAX prologue's bit for bit."""
    take, c_start, c_skip, c_len, c_qterm = chunk_tables(jobs, chunk, num_chunks)
    c_score = take(jobs[..., 3].contiguous().view(torch.float32))
    return c_start, c_skip, c_len, c_qterm, take(jobs[..., 2].contiguous()), c_score


def _desc_key(s):
    """int64 in [0, 2^32) that ascends as the f32 ``s`` descends (the low
    word of a composite sort key)."""
    b = s.contiguous().view(torch.int32).long()
    return _I32_MAX - torch.where(b >= 0, b, b ^ _I32_MAX)


def z2o_staged_fast_step(
    rec, c_start, c_skip, c_len, c_qterm, c_score, qlen, *, chunk: int, k: int, num_fields: int
):
    """The fast program's staged torch form (the JAX engine's XLA branch of
    ``z2o_fast_step``): one lane per posting, fields ride as F contribution
    values; a stable sort by (doc << 4 | qterm, s desc), then ``pool_scores``
    and the top-k.  Returns (f32[B, k'], int32[B, k']), k' = min(k, L)."""
    C, F = chunk, num_fields
    B, NC = c_start.shape
    L = NC * C
    doc, tf, flen, alive, pos = gather_lanes(rec, c_start, C, F)
    live = (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None]) & (alive > 0)
    s_l = c_score[..., None]
    contrib = torch.where(
        live & (tf > 0), contribution(s_l, tf, flen, qlen[:, None, None]), -1.0
    )  # [F, B, NC, C]
    k1 = torch.where(live, (doc << _QT_BITS) | c_qterm[..., None], _I32_MAX).reshape(B, L)
    # Stable sort by (k1, -s): k1 in the high word, the descending order of
    # s in the low word.
    neg_s = _desc_key(s_l.expand(B, NC, C)).reshape(B, L)
    order = torch.sort((k1.long() << 32) | neg_s, dim=-1, stable=True)[1]
    k1s = torch.gather(k1, 1, order)
    contribs = torch.gather(contrib.reshape(F, B, L), 2, order.expand(F, B, L))
    valid = k1s != _I32_MAX
    dock = torch.where(valid, k1s >> _QT_BITS, _I32_MAX)
    doc_best, tail_d = pool_scores(k1s, dock, valid, contribs)
    final = torch.where(tail_d & valid, torch.clamp(doc_best, min=0.0), float("-inf"))
    _count("z2o_staged", rec.device)
    return topk_lanes(final, dock, min(k, L))


def fused_route(num_chunks: int, chunk: int, num_fields: int, fused_ok: bool) -> bool:
    """True where a fast class launches K4: exactly where the JAX engine
    routes to Pallas — ``fused_ok`` (doc slots < 2^26, the kernel's key
    packs doc << 5), L a multiple of 128, C a power of two, L <= 8192 and
    1 <= F <= 4."""
    L = num_chunks * chunk
    return (
        fused_ok
        and L % 128 == 0
        and chunk & (chunk - 1) == 0
        and L <= FUSED_Z2O_MAX_LANES
        and 1 <= num_fields <= FUSED_Z2O_MAX_FIELDS
    )


def z2o_fast_step(rec, jobs, qlen, *, chunk: int, k: int, num_fields: int, num_chunks: int,
                  fused_ok: bool = True):
    """Fast zero-to-one program for queries with no shared expansion node.

    ``jobs`` int32[B, NJ, 4] carries the per-query dense score rank in word 2
    (packed by ``z2o_query_batch_async``), the kernel's stable-order
    substitute.  Classes that ``fused_route`` admits launch K4; every other
    class runs the staged program.  Returns (f32[B, k'], int32[B, k']),
    k' = min(k, L)."""
    C, NC, F = chunk, num_chunks, num_fields
    c_start, c_skip, c_len, c_qterm, c_rank, c_score = expand_chunks_z2o(jobs, C, NC)
    if fused_route(NC, C, F, fused_ok):
        return fused_z2o_topk(
            rec, c_start, c_skip, c_len, c_qterm, c_score, c_rank, qlen,
            chunk=C, k=min(k, NC * C), num_fields=F,
        )
    return z2o_staged_fast_step(
        rec, c_start, c_skip, c_len, c_qterm, c_score, qlen, chunk=C, k=k, num_fields=F
    )


def z2o_step(rec, jobs, qlen, *, chunk: int, k: int, num_fields: int, num_chunks: int,
             return_accepted: bool = False):
    """The exact general program (shared-node queries): one entry lane per
    (posting, field) with tf > 0, sorted stably by ((doc << 3 | field),
    s desc), then a lockstep loop of NJ steps in which step e processes the
    e-th entry of every (doc, field) segment (the pool rule "accept at most
    tf entries per (segment, node)"); pool sums per segment, max over each
    doc's segments, top-k.  ``jobs`` int32[B, NJ, 4] carries node ids in
    word 2.  Returns (f32[B, k'], int32[B, k']), k' = min(k, F * L), and with
    ``return_accepted`` also the accepted entry lanes bool[B, F * L] in
    sorted order."""
    C, NC, F = chunk, num_chunks, num_fields
    B, NJ, _ = jobs.shape
    L = NC * C
    FL = F * L
    dev = rec.device
    c_start, c_skip, c_len, c_qterm, c_node, c_score = expand_chunks_z2o(jobs, C, NC)
    doc, tf, flen, alive, pos = gather_lanes(rec, c_start, C, F)
    live = (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None]) & (alive > 0)

    # Entries [B, F, L], field-major: ties that need the stable enumeration
    # order only occur within one (doc, field) segment.
    def fexp(a):  # [B, NC, C] -> [B, F, L]
        return a.reshape(B, 1, L).expand(B, F, L)

    tf_e = tf.reshape(F, B, L).transpose(0, 1)
    flen_e = flen.reshape(F, B, L).transpose(0, 1)
    mask = fexp(live) & (tf_e > 0)
    fidx = torch.arange(F, dtype=torch.int32, device=dev)[None, :, None]
    k1 = torch.where(mask, (fexp(doc) << 3) | fidx, _I32_MAX)
    s_e = fexp(c_score[..., None].expand(B, NC, C))
    q_e = fexp(c_qterm[..., None].expand(B, NC, C))
    n_e = fexp(c_node[..., None].expand(B, NC, C))
    contrib = torch.where(mask, contribution(s_e, tf_e, flen_e, qlen[:, None, None]), 0.0)

    # Stable sort by (segment, s desc); qterm and node id ride packed.
    neg_s = _desc_key(s_e).reshape(B, FL)
    k1f = k1.reshape(B, FL)
    order = torch.sort((k1f.long() << 32) | neg_s, dim=-1, stable=True)[1]
    k1s = torch.gather(k1f, 1, order)
    qns = torch.gather(((q_e << 16) | n_e).reshape(B, FL), 1, order)
    tfs = torch.gather(tf_e.reshape(B, FL), 1, order)
    contribs = torch.gather(contrib.reshape(B, FL), 1, order)
    qs = qns >> 16
    ns = qns & 0xFFFF

    head = k1s != _shift_right(k1s, 1, -1)
    pos_in_seg = segmented_scan(torch.add, torch.ones_like(k1s), head, 0) - 1

    # pool_slot: sorted position of the FIRST lane with the same (segment,
    # node) — a stable sort by (segment, node) keeps positions ascending.
    order_b = torch.sort((k1s.long() << 32) | ns.long(), dim=-1, stable=True)[1]
    k1b = torch.gather(k1s, 1, order_b)
    nb = torch.gather(ns, 1, order_b)
    headb = (k1b != _shift_right(k1b, 1, -1)) | (nb != _shift_right(nb, 1, -1))
    pb = order_b.to(torch.int32)
    firstb = segmented_scan(torch.maximum, torch.where(headb, pb, -1), headb, -1)
    pool_slot = torch.empty_like(firstb).scatter_(1, order_b, firstb).long()

    valid = k1s != _I32_MAX
    consumed = torch.zeros((B, FL), dtype=torch.int32, device=dev)
    counts = torch.zeros((B, FL), dtype=torch.float32, device=dev)
    accepted = torch.zeros((B, FL), dtype=torch.bool, device=dev)
    bit = torch.bitwise_left_shift(torch.ones_like(qs), qs)
    for e in range(NJ):
        active = (pos_in_seg == e) & valid
        ok = active & ((consumed & bit) == 0)
        take = ok & (torch.gather(counts, 1, pool_slot) < tfs)
        counts = counts.scatter_add(1, pool_slot, take.to(torch.float32))
        delta = torch.where(take, bit, 0)
        consumed = consumed | segmented_scan(torch.bitwise_or, delta, head, 0)
        accepted = accepted | take

    val = torch.where(accepted, contribs, 0.0)
    seg_sum = segmented_scan(torch.add, val, head, 0.0)
    tail1 = k1s != _shift_left(k1s, 1, -1)
    dock = torch.where(valid, k1s >> 3, _I32_MAX)
    field_val = torch.where(tail1 & valid, torch.clamp(seg_sum, min=0.0), float("-inf"))
    head_d = (dock != _shift_right(dock, 1, -1)) & valid
    doc_max = segmented_scan(torch.maximum, field_val, head_d, float("-inf"))
    tail_d = dock != _shift_left(dock, 1, -1)
    final = torch.where(tail_d & valid, doc_max, float("-inf"))
    _count("z2o_lockstep", dev)
    top = topk_lanes(final, dock, min(k, FL))
    return (*top, accepted) if return_accepted else top


# --------------------------------------------------------------------- #
# planning (host, numpy)                                                 #
# --------------------------------------------------------------------- #


def plan_batch_z2o(dix, queries, tokenizer):
    """Plan a z2o batch into 4-word job tables (pooled per query string).

    Returns ``(jquery, words int32[NJOBS, 4], qlen f32[B], nchunks, njobs,
    fallback, shared)``.  The per-query plan is snapshot-static and
    query-local, so it pools per (DeviceIndex, tokenizer): a repeated query
    costs one dict lookup plus a CSR gather."""
    with dix._plan_lock:
        pools = dix._z2o_qplans
        pool = pools.get(tokenizer)
        if pool is None or (
            len(pool["ids"]) > dix._QPLAN_MAX_QUERIES
            or len(pool["words"]) > dix._QPLAN_MAX_ROWS
        ):
            pool = {
                "ids": {},  # query string -> dense qid
                "off": np.zeros(1, dtype=np.int64),
                "words": np.zeros((0, 4), dtype=np.int32),
                "qlen": np.zeros(0, dtype=np.float32),
                "nchunks": np.zeros(0, dtype=np.int64),
                "njobs": np.zeros(0, dtype=np.int64),
                "shared": np.zeros(0, dtype=bool),
                "fallback": np.zeros(0, dtype=bool),
            }
            pools[tokenizer] = pool
        ids = pool["ids"]
        B = len(queries)
        qids = np.fromiter((ids.get(q, -1) for q in queries), np.int64, count=B)
        if (qids < 0).any():
            miss = sorted({queries[i] for i in np.flatnonzero(qids < 0)})
            _z2o_qplan_insert(dix, pool, miss, tokenizer)
            qids = np.fromiter((ids[q] for q in queries), np.int64, count=B)
        qlen = pool["qlen"][qids]
        fallback = [int(i) for i in np.flatnonzero(pool["fallback"][qids])]
        nj = pool["njobs"][qids]
        if int(nj.sum()) == 0:
            return None, None, qlen, None, None, fallback, None
        jquery = np.repeat(np.arange(B, dtype=np.int64), nj)
        rows = np.repeat(pool["off"][qids], nj) + _segment_arange(nj)
        return (
            jquery,
            pool["words"][rows],
            qlen,
            pool["nchunks"][qids],
            nj,
            fallback,
            pool["shared"][qids],
        )


def _z2o_qplan_insert(dix, pool, miss, tokenizer):
    """Plan first-seen queries through the full path and pool the per-query
    job rows (a query's rows are contiguous: ``jquery`` ascends)."""
    jquery, words, qlen, nchunks, njobs, fb, shared = _plan_batch_z2o_impl(dix, miss, tokenizer)
    M = len(miss)
    fb_m = np.zeros(M, dtype=bool)
    fb_m[list(fb)] = True
    if jquery is None:
        njobs_m = np.zeros(M, dtype=np.int64)
        words_m = np.zeros((0, 4), dtype=np.int32)
        nchunks_m = np.zeros(M, dtype=np.int64)
        shared_m = np.zeros(M, dtype=bool)
    else:
        assert (np.diff(jquery) >= 0).all()
        njobs_m = njobs.astype(np.int64)
        words_m = words
        nchunks_m = nchunks
        shared_m = shared
    base = len(pool["off"]) - 1
    for i, q in enumerate(miss):
        pool["ids"][q] = base + i
    pool["off"] = np.concatenate([pool["off"], pool["off"][-1] + np.cumsum(njobs_m)])
    pool["words"] = np.concatenate([pool["words"], words_m])
    pool["qlen"] = np.concatenate([pool["qlen"], qlen.astype(np.float32)])
    pool["nchunks"] = np.concatenate([pool["nchunks"], nchunks_m])
    pool["njobs"] = np.concatenate([pool["njobs"], njobs_m])
    pool["shared"] = np.concatenate([pool["shared"], shared_m])
    pool["fallback"] = np.concatenate([pool["fallback"], fb_m])


def _plan_batch_z2o_impl(dix, queries, tokenizer):
    """The full (uncached) z2o planning pass — see ``plan_batch_z2o``."""
    cfg = dix.config
    B = len(queries)
    fallback = []

    tok_lists = [list(tokenizer(q)) for q in queries]
    qlen = np.array([len(t) for t in tok_lists], dtype=np.float32)  # incl. empties
    filt = [[t for t in toks if t] for toks in tok_lists]
    max_terms = min(cfg.max_query_terms, 1 << _QT_BITS)
    for qi, toks in enumerate(filt):
        if len(toks) > max_terms:
            fallback.append(qi)
            filt[qi] = []
    counts = np.array([len(t) for t in filt], dtype=np.int64)
    total_terms = int(counts.sum())
    if total_terms == 0 or dix.num_postings == 0:
        return None, None, qlen, None, None, fallback, None
    flat_query = np.repeat(np.arange(B, dtype=np.int64), counts)
    flat_qterm = _segment_arange(counts)
    flat_terms, flat_blen = probe_terms_fixed([t for toks in filt for t in toks])
    flat_upper = np.char.add(flat_terms, _MAX_CHAR)

    parts = []
    for si in range(len(dix.segments)):
        terms = dix.seg_terms[si]
        if len(terms) == 0:
            continue
        lo = np.searchsorted(terms, flat_terms, side="left")
        hi = np.searchsorted(terms, flat_upper, side="left")
        nexp = hi - lo
        if nexp.max(initial=0) == 0:
            continue
        tid = np.repeat(lo, nexp) + _segment_arange(nexp)
        jidx = np.repeat(np.arange(total_terms, dtype=np.int64), nexp)
        offs = dix.seg_offsets[si]
        local = offs[tid].astype(np.int64)
        length = (offs[tid + 1] - offs[tid]).astype(np.int64)
        cum = dix.seg_live_cum[si]
        ldf = cum[local + length] - cum[local]
        parts.append(
            (
                jidx,
                dix.seg_base[si] + local,
                length,
                terms[tid],
                dix.seg_term_lens[si][tid].astype(np.int64),
                ldf,
                np.full(len(tid), si, np.int64),
            )
        )
    if not parts:
        return None, None, qlen, None, None, fallback, None
    jidx, jstart, jlen, jexp, jblen, jldf, jseg = (
        np.concatenate([p[i] for p in parts]) for i in range(7)
    )
    keep = jlen > 0
    jidx, jstart, jlen, jexp, jblen, jldf, jseg = (
        a[keep] for a in (jidx, jstart, jlen, jexp, jblen, jldf, jseg)
    )
    if len(jidx) == 0:
        return None, None, qlen, None, None, fallback, None

    # df over segments per (query term, expansion); df == 0 never scored
    # (query.rs:48).
    order = np.lexsort((jseg, jexp, jidx))
    jidx, jstart, jlen, jexp, jblen, jldf, jseg = (
        a[order] for a in (jidx, jstart, jlen, jexp, jblen, jldf, jseg)
    )
    new_g = np.ones(len(jidx), dtype=bool)
    new_g[1:] = (jidx[1:] != jidx[:-1]) | (jexp[1:] != jexp[:-1])
    gid = np.cumsum(new_g) - 1
    gdf = np.bincount(gid, weights=jldf.astype(np.float64))
    keep2 = gdf[gid] > 0
    jidx, jstart, jlen, jexp, jblen = (a[keep2] for a in (jidx, jstart, jlen, jexp, jblen))
    new_g = new_g[keep2]
    if len(jidx) == 0:
        return None, None, qlen, None, None, fallback, None

    per_term_exp = np.bincount(jidx[new_g], minlength=total_terms)
    jquery = flat_query[jidx]
    bad = (
        set(int(q) for q in flat_query[np.flatnonzero(per_term_exp > cfg.max_expansions)])
        if cfg.max_expansions
        else set()
    )
    if bad:
        fallback.extend(sorted(bad))
        keepq = ~np.isin(jquery, np.fromiter(bad, dtype=np.int64))
        jidx, jstart, jlen, jexp, jblen, jquery = (
            a[keepq] for a in (jidx, jstart, jlen, jexp, jblen, jquery)
        )
        if len(jidx) == 0:
            return None, None, qlen, None, None, fallback, None

    # Node ids: one per distinct expansion per query (keyed by the expanded
    # term alone — shared across query terms, zero_to_one.rs:75).
    o2 = np.lexsort((jexp, jquery))
    newn = np.ones(len(jidx), dtype=bool)
    newn[1:] = (jquery[o2][1:] != jquery[o2][:-1]) | (jexp[o2][1:] != jexp[o2][:-1])
    nid_sorted = np.cumsum(newn) - 1
    qfirst = np.zeros(B + 1, dtype=np.int64)
    np.add.at(qfirst, jquery[o2][newn] + 1, 1)
    qfirst = np.cumsum(qfirst)
    node_local_sorted = nid_sorted - qfirst[jquery[o2]]
    node_local = np.empty(len(jidx), np.int64)
    node_local[o2] = node_local_sorted

    # The packed sort operand (q << 16 | node) recovers node ids with a
    # 16-bit mask: queries minting >= 2^16 node ids go to the host path.
    if node_local.max(initial=0) >= (1 << 16):
        wide = np.unique(jquery[node_local >= (1 << 16)])
        fallback.extend(int(q) for q in wide)
        keepw = ~np.isin(jquery, wide)
        jidx, jstart, jlen, jexp, jblen, jquery, node_local = (
            a[keepw] for a in (jidx, jstart, jlen, jexp, jblen, jquery, node_local)
        )
        if len(jidx) == 0:
            return None, None, qlen, None, None, fallback, None

    # Entry score: 1 - |len(exp) - len(term)| / len(exp), byte lengths
    # (zero_to_one.rs:57-58); expansions never shorten, so always in (0, 1].
    score = (1.0 - np.abs(jblen - flat_blen[jidx]) / jblen.astype(np.float64)).astype(np.float32)

    words = np.empty((len(jidx), 4), dtype=np.int32)
    words[:, 0] = jstart
    words[:, 1] = jlen | (flat_qterm[jidx] << _LEN_BITS)
    words[:, 2] = node_local
    words[:, 3] = score.view(np.int32)

    # Shared-node detection: a node claimed by >= 2 distinct query-term
    # instances makes the df-pool interaction real (lockstep program).
    jqt = flat_qterm[jidx]
    o3 = np.lexsort((jqt, jexp, jquery))
    samegrp = (jquery[o3][1:] == jquery[o3][:-1]) & (jexp[o3][1:] == jexp[o3][:-1])
    diffq = jqt[o3][1:] != jqt[o3][:-1]
    shared = np.zeros(B, dtype=bool)
    shared[jquery[o3][1:][samegrp & diffq]] = True

    # Stride-C contiguous chunks (must match the on-device expansion).
    C_ = dix.CHUNK
    job_chunks = np.where(jlen > 0, (jstart % 128 + jlen + C_ - 1) // C_, 0)
    nchunks = np.bincount(jquery, weights=job_chunks.astype(np.float64), minlength=B)
    njobs = np.bincount(jquery, minlength=B)
    return jquery, words, qlen, nchunks.astype(np.int64), njobs, fallback, shared


def score_rank(jquery, words):
    """Per-query dense rank of each job's entry score, descending, equal
    scores equal (computed on the f32 bits the oracle compares): the fused
    kernel's secondary sort key rides it in word 2 of fast-mode jobs."""
    sbits = words[:, 3].view(np.float32).astype(np.float64)
    o = np.lexsort((-sbits, jquery))
    jq_o, s_o = jquery[o], sbits[o]
    new = np.ones(len(o), bool)
    new[1:] = (jq_o[1:] != jq_o[:-1]) | (s_o[1:] != s_o[:-1])
    grp = np.cumsum(new) - 1
    qnew = np.ones(len(o), bool)
    qnew[1:] = jq_o[1:] != jq_o[:-1]
    qfirst = np.maximum.accumulate(np.where(qnew, grp, -1))
    srank = np.empty(len(o), np.int64)
    srank[o] = grp - qfirst
    return srank


def pack_classes(dix, B, jquery, words, qlen, nc_bucket, njobs, fastq, srank):
    """Pack every class's job table and qlen vector, fast classes first.

    Returns (class_specs, layout, word_parts, qlen_parts): a class spec is
    ``(b_pad, b_out, nj, nc, fast)``; ``layout`` pairs each class's query
    indices with its first packed result row."""
    C = dix.CHUNK
    F = max(dix.num_fields, 1)
    class_specs, layout, word_parts, qlen_parts = [], [], [], []
    row = 0
    for fast_mode in (True, False):
        mode_sel = fastq if fast_mode else ~fastq
        for nc in np.unique(nc_bucket[(nc_bucket > 0) & mode_sel]):
            nc = int(nc)
            members = np.flatnonzero((nc_bucket == nc) & (njobs > 0) & mode_sel)
            if len(members) == 0:
                continue
            nj = _bucket(int(njobs[members].max()), dix.NJ_BUCKETS, 4)
            lane_f = 1 if fast_mode else F  # fast lanes carry no field dim
            b_cap = max(8, int(dix.LANES_PER_DISPATCH // (nc * C * lane_f)))
            if getattr(dix.config, "pow2_row_split", True):
                spans = dix._pow2_spans(len(members), b_cap)
            else:
                spans = [
                    (m, max(8, 1 << (m - 1).bit_length()))
                    for m in (
                        len(members[s : s + b_cap]) for s in range(0, len(members), b_cap)
                    )
                ]
            s = 0
            for Bc, B_pad in spans:
                idxs = members[s : s + Bc]
                s += Bc
                b_out = min(B_pad, -(-Bc // 256) * 256)
                jobs_flat = np.zeros((B_pad, nj, 4), dtype=np.int32)
                sel = np.isin(jquery, idxs)
                jq = jquery[sel]
                pos = _segment_arange(np.bincount(jq, minlength=B)[idxs])
                r = np.searchsorted(idxs, jq)
                wsel = words[sel]
                if fast_mode and srank is not None:
                    wsel = wsel.copy()
                    wsel[:, 2] = srank[sel]  # node id unused on the fast path
                jobs_flat[r, pos] = wsel
                qlen_pad = np.ones(B_pad, np.float32)
                qlen_pad[:Bc] = qlen[idxs]
                word_parts.append(jobs_flat.reshape(-1))
                qlen_parts.append(qlen_pad)
                class_specs.append((B_pad, b_out, nj, nc, fast_mode))
                layout.append((idxs, row))
                row += b_out
    return class_specs, layout, word_parts, qlen_parts


def _z2o_window_step(
    rec, words_flat, qlen_flat, *, chunk: int, k: int, num_fields: int, class_specs,
    fused_ok: bool = True, fmt: str = "f32",
):
    """Every z2o shape class of a window, one after another on the device,
    into one packed result (see ``index.device.pack_result_rows``).  Only the
    first ``b_out`` rows of a class are computed (the rest are padding)."""
    outs = []
    off = 0
    qoff = 0
    for b_pad, b_out, nj, nc, fast in class_specs:
        n = b_pad * nj * 4
        jobs = words_flat[off : off + n].reshape(b_pad, nj, 4)[:b_out]
        off += n
        ql = qlen_flat[qoff : qoff + b_out]
        qoff += b_pad
        kk = min(k, nc * chunk * num_fields)
        kw = dict(chunk=chunk, k=kk, num_fields=num_fields, num_chunks=nc)
        if fast:
            s, d = z2o_fast_step(rec, jobs, ql, fused_ok=fused_ok, **kw)
        else:
            s, d = z2o_step(rec, jobs, ql, **kw)
        if s.shape[1] < k:
            s = torch.nn.functional.pad(s, (0, k - s.shape[1]), value=float("-inf"))
            d = torch.nn.functional.pad(d, (0, k - d.shape[1]), value=-1)
        outs.append(pack_result_rows(s, d, fmt))
    return torch.cat(outs, dim=0)


def z2o_query_batch(dix, queries, tokenizer, top_k, scorer=None):
    """Blocking convenience over :func:`z2o_query_batch_async`; honours
    ``IndexConfig.serving_window`` like the BM25 blocking path."""
    sw = getattr(dix.config, "serving_window", 0)
    if not sw or len(queries) <= sw:
        return z2o_query_batch_async(dix, queries, tokenizer, top_k, scorer=scorer).get()
    depth = max(1, getattr(dix.config, "serving_depth", 4))
    out = []
    inflight = []
    for s in range(0, len(queries), sw):
        inflight.append(
            z2o_query_batch_async(dix, queries[s : s + sw], tokenizer, top_k, scorer=scorer)
        )
        while len(inflight) >= depth:
            out.extend(inflight.pop(0).get())
    for h in inflight:
        out.extend(h.get())
    return out


def plan_window(dix, queries, tokenizer, k: int, scorer=None):
    """The host half of a z2o window: plan, host rows for the queries past
    the device caps, routing and class packing.  Returns (host_rows,
    class_specs, layout, word_parts, qlen_parts); see ``pack_classes``."""
    B = len(queries)
    host_rows = {}
    with metrics.timer("z2o/plan"):
        jquery, words, qlen, nchunks, njobs, fallback, shared = plan_batch_z2o(
            dix, queries, tokenizer
        )
    if fallback:
        # Cap-exceeding queries run the vectorized host lockstep (bit-equal
        # to the exact oracle); a z2o subclass keeps the exact path.
        metrics.inc("device_fallback_queries", len(fallback))
        _host_fallback_policy(dix.config, len(fallback), "z2o device plan caps exceeded")
        plain = scorer is None or type(scorer) is _z2o.ZeroToOne
        for qi in fallback:
            host_rows[qi] = (
                _z2o.ZeroToOne.vectorized_query(dix._index, queries[qi], tokenizer, top_k=k)
                if plain
                else dix._index.query(
                    queries[qi], scorer, tokenizer, [1.0] * dix.num_fields, top_k=k
                )
            )
    if jquery is None:
        return host_rows, [], [], [], []

    C = dix.CHUNK
    F = max(dix.num_fields, 1)
    nc_bucket = _bucket_vec(nchunks, dix.nc_buckets, dix.nc_min)
    # Routing (as the JAX engine): shared-node-free queries take the fast
    # program; shared-node queries the lockstep program, whose field packs
    # into 3 key bits (F <= 8) and whose lanes stay within 16,384; bigger or
    # wider ones, and fast queries past the class lane budget, run the
    # vectorized host lockstep.
    fast_ok = dix.num_slots < (1 << 27)
    fastq = (~shared) & fast_ok
    lanes = np.where(fastq, nc_bucket * C, nc_bucket * C * F)
    huge = (~fastq & ((lanes > 16384) | (F > 8))) | (fastq & (lanes > dix.LANES_PER_DISPATCH))
    if huge.any():
        metrics.inc("z2o_host_vectorized_queries", int(huge.sum()))
        _host_fallback_policy(
            dix.config, int(huge.sum()), "z2o shared-node queries past the lockstep compile cap"
        )
        for qi in np.flatnonzero(huge & (njobs > 0)):
            host_rows[int(qi)] = _z2o.ZeroToOne.vectorized_query(
                dix._index, queries[int(qi)], tokenizer, top_k=k
            )
        nc_bucket = np.where(huge, -1, nc_bucket)
    srank = score_rank(jquery, words) if fastq.any() and len(words) else None
    with metrics.timer("z2o/pack"):
        packed = pack_classes(dix, B, jquery, words, qlen, nc_bucket, njobs, fastq, srank)
    return (host_rows, *packed)


def z2o_query_batch_async(dix, queries, tokenizer, top_k, scorer=None, fmt=None):
    """Plan, upload and launch a zero-to-one window without blocking.

    Returns the BM25 engine's ``PendingBatch`` (shared packed formats, the
    D2H copy started at submit behind a CUDA event).  Queries past the
    device caps run the vectorized host lockstep.  ``fmt`` overrides
    ``IndexConfig.result_format`` ("f32" | "compact" | "slots" | "slots20");
    rankings are computed in f32 in every format."""
    B = len(queries)
    k = top_k or dix.config.default_top_k
    if fmt is None:
        fmt = dix.config.effective_result_format()
    fmt = resolve_result_format(fmt, dix.num_slots)
    host_rows, class_specs, layout, word_parts, qlen_parts = plan_window(
        dix, queries, tokenizer, k, scorer
    )
    if not class_specs:
        return PendingBatch(dix, B, host_rows=host_rows, k=k)
    with metrics.timer("z2o/h2d"):
        # The qlen vectors ride at the end of the one H2D buffer.
        n_words = sum(len(w) for w in word_parts)
        buf = dix._upload(np.concatenate(word_parts + [np.concatenate(qlen_parts).view(np.int32)]))
    with metrics.timer("z2o/dispatch"):
        packed = _z2o_window_step(
            dix.rec,
            buf[:n_words],
            buf[n_words:].view(torch.float32),
            chunk=dix.CHUNK,
            k=k,
            num_fields=dix.num_fields,
            class_specs=tuple(class_specs),
            fused_ok=dix.num_slots < (1 << 26),
            fmt=fmt,
        )
    return PendingBatch(
        dix, B, packed=packed, layout=layout, host_rows=host_rows, fmt=fmt, k=k,
        **dix._start_fetch(packed),
    )
