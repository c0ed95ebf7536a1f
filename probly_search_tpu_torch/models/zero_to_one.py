"""Zero-to-one scorer — normalized [0, 1] title/label matching.

The torch port's copy of ``probly_search_tpu/models/zero_to_one.py``: the
exact f64 host path (``score`` / ``finalize``) and the numpy
``vectorized_query``, which serves the queries the device engine sends to
the host.  The device path is ``ops/z2o_device.py``.

Reproduces `reference src/score/default/zero_to_one.rs` exactly.
Design goals from the reference header (zero_to_one.rs:1-9): penalize
repeated query terms; do not penalize repeated document terms; a perfect
score of 1 requires the query term count ~= the document term count and
matching term lengths.

This scorer is **stateful and two-phase**:

* ``score`` (zero_to_one.rs:44-82) does no scoring — it records a
  ``ScoreByTerm`` tuple per (document, field) with tf > 0 and returns a
  provisional ``0.0`` so the document lands in the result map.
  The recorded entry score is ``1 - |len(expanded) - len(term)| / len(expanded)``
  with *byte* lengths (Rust ``str::len()``).
* ``finalize`` (zero_to_one.rs:84-126) computes the real scores: per
  document, per field, sort the entries by score descending (stable) and
  consume them sequentially —

  - skip an entry whose ``query_term_index`` was already consumed,
  - maintain a "df pool" per index node, initialized lazily to
    ``term_frequency - 1`` on first touch and decremented on reuse; an
    exhausted pool skips the entry,
  - accumulate ``min(score/tf, 1) * tf / max(field_length, query_terms_len)``.

  The document score is the max over fields of the pool sums (and the
  provisional score).  State is cleared after each query.

Ordering note: entries are recorded in visit order.  The reference visits
expansions in trie DFS reverse-insertion order; this engine visits them in
lexicographic term order.  Equal-score ties in the stable sort can therefore
consume in a different order than the reference in pathological corpora; all
reference golden tests (zero_to_one.rs:129-405) pass identically — this
engine's ordering is deterministic (query term index asc, expansion
lexicographic asc, document slot asc).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .base import (
    BaseScoreCalculator,
    DocumentDetails,
    DocumentPointer,
    FieldData,
    QueryResult,
    TermData,
)


@dataclass
class ScoreByTerm:
    """One recorded (document, field, query-term, expansion) tuple
    (zero_to_one.rs:27-34)."""

    query_term_index: int
    all_query_terms_len: int
    field_length: int
    index_node_id: int
    term_frequency: int
    score: float


class ZeroToOne(BaseScoreCalculator):
    """Stateful zero-to-one scorer (zero_to_one.rs:24-127)."""

    device_needs_finalize = True
    # Two-phase device protocol: executed by ops/z2o_device.py (the fast
    # program with the fused kernel, or the lockstep consumption program
    # for shared-node queries).
    device_two_phase = True

    def __init__(self):
        # key -> per-field list of ScoreByTerm (zero_to_one.rs:25).
        self.score_by_document_and_field: Dict[Any, List[List[ScoreByTerm]]] = {}

    def score(
        self,
        before_output: Optional[Any],
        document_pointer: DocumentPointer,
        document_details: DocumentDetails,
        index_node: int,
        field_data: FieldData,
        term_expansion: TermData,
    ) -> Optional[float]:
        key = document_details.key
        num_fields = len(document_details.field_length)
        for x in range(num_fields):
            tf = int(document_pointer.term_frequency[x])
            if tf > 0:
                # Byte lengths, like Rust str::len() (zero_to_one.rs:57-58).
                term_exp_len = float(len(term_expansion.query_term_expanded.encode("utf-8")))
                term_len = float(len(term_expansion.query_term.encode("utf-8")))
                field_length = int(document_details.field_length[x])
                if key not in self.score_by_document_and_field:
                    self.score_by_document_and_field[key] = [[] for _ in range(num_fields)]
                self.score_by_document_and_field[key][x].append(
                    ScoreByTerm(
                        score=1.0 - abs(term_exp_len - term_len) / term_exp_len,
                        all_query_terms_len=term_expansion.query_terms_len,
                        query_term_index=term_expansion.query_term_index,
                        index_node_id=index_node,
                        term_frequency=tf,
                        field_length=field_length,
                    )
                )
        return 0.0  # dummy; real score computed in finalize (zero_to_one.rs:81)

    def finalize(self, results: List[QueryResult]) -> None:
        for result in results:
            for field_scores in self.score_by_document_and_field[result.key]:
                df_pool_by_id: Dict[int, int] = {}
                consumed_index = set()
                # Stable sort by score desc (zero_to_one.rs:98).
                field_scores.sort(key=lambda s: -s.score)
                score_by_pool = 0.0
                for s in field_scores:
                    if s.query_term_index in consumed_index:
                        continue
                    if s.index_node_id in df_pool_by_id:
                        if df_pool_by_id[s.index_node_id] <= 0:
                            # Pool consumed: no more points from this node
                            # (zero_to_one.rs:104-109).
                            continue
                        df_pool_by_id[s.index_node_id] -= 1
                    else:
                        df_pool_by_id[s.index_node_id] = s.term_frequency - 1
                    consumed_index.add(s.query_term_index)
                    df = float(s.term_frequency)
                    score_by_pool += (
                        min(s.score / df, 1.0)
                        * s.term_frequency
                        / max(s.field_length, s.all_query_terms_len)
                    )
                result.score = max(score_by_pool, result.score)
        # Clear statistics for reuse across queries (zero_to_one.rs:125).
        self.score_by_document_and_field = {}


def new() -> ZeroToOne:
    """Factory matching ``score::zero_to_one::new()`` (zero_to_one.rs:35)."""
    return ZeroToOne()


# --------------------------------------------------------------------- #
# Vectorized execution (SURVEY §7 M4)                                    #
# --------------------------------------------------------------------- #
#
# The finalize pass is inherently sequential per (doc, field) — a sorted
# consumption loop with two kinds of state (consumed query terms, per-node
# df pools).  The vectorized engine runs that loop ONCE over the padded
# maximum group size, with every (doc, field) group advancing in lockstep
# as numpy lanes; per-step work is O(groups), so a query over thousands of
# matched docs costs max_group_size (typically < 16) vectorized steps
# instead of a Python loop per posting.  Entry enumeration order matches
# the exact path (query term asc, expansion lexicographic, doc slot asc),
# so results are bit-identical to the oracle.


def vectorized_query(index, query: str, tokenizer=None, top_k=None, fields_boost=None):
    """Zero-to-one query over the segment SoA, vectorized with numpy.
    ``fields_boost`` is accepted for call-site symmetry with BM25's
    vectorized path and ignored — zero-to-one does not use field boosts
    (zero_to_one.rs never reads FieldData.fields_boost)."""
    import numpy as np

    from ..models.base import QueryResult
    from ..utils.tokenizers import whitespace_tokenizer

    tokenizer = tokenizer or whitespace_tokenizer
    index._flush_pending()
    query_terms = list(tokenizer(query))
    qlen_total = len(query_terms)  # includes empties (query.rs:32)
    F = index.num_fields

    # --- gather entries ---------------------------------------------------
    e_slot, e_field, e_qti, e_node, e_score, e_tf, e_flen = ([] for _ in range(7))
    node_ids = {}
    for qti, qterm in enumerate(query_terms):
        if not qterm:
            continue
        qbytes = float(len(qterm.encode("utf-8")))
        for exp in index._expand_term_sorted(qterm):
            slots, tfs, occs = index._gather_postings(exp)
            if len(slots) == 0:
                continue
            alive = index._alive[slots]
            df = int(occs[alive].sum())
            if df <= 0:
                continue  # query.rs:48
            nid = node_ids.setdefault(exp, len(node_ids))
            ebytes = float(len(exp.encode("utf-8")))
            sc = 1.0 - abs(ebytes - qbytes) / ebytes
            live_slots = slots[alive]
            live_tfs = tfs[alive]
            flens = index._doc_len[live_slots]  # [n, F]
            for f in range(F):
                m = live_tfs[:, f] > 0
                if not m.any():
                    continue
                n = int(m.sum())
                e_slot.append(live_slots[m].astype(np.int64))
                e_field.append(np.full(n, f, np.int64))
                e_qti.append(np.full(n, qti, np.int64))
                e_node.append(np.full(n, nid, np.int64))
                e_score.append(np.full(n, sc, np.float64))
                e_tf.append(live_tfs[m, f].astype(np.int64))
                e_flen.append(flens[m, f].astype(np.int64))
    if not e_slot:
        return []
    slot = np.concatenate(e_slot)
    fieldv = np.concatenate(e_field)
    qti = np.concatenate(e_qti)
    node = np.concatenate(e_node)
    score = np.concatenate(e_score)
    tf = np.concatenate(e_tf)
    flen = np.concatenate(e_flen)
    N = len(slot)
    seq = np.arange(N)

    # --- group by (slot, field), stable sort by score desc ----------------
    order = np.lexsort((seq, -score, fieldv, slot))
    slot, fieldv, qti, node, score, tf, flen = (
        a[order] for a in (slot, fieldv, qti, node, score, tf, flen)
    )
    ghead = np.ones(N, bool)
    ghead[1:] = (slot[1:] != slot[:-1]) | (fieldv[1:] != fieldv[:-1])
    gid = np.cumsum(ghead) - 1
    G = int(gid[-1]) + 1
    gstart = np.flatnonzero(ghead)
    gsize = np.diff(np.append(gstart, N))

    # pool slot: index of the FIRST entry with the same (group, node) — the
    # pool each entry consumes from.
    o2 = np.lexsort((np.arange(N), node, gid))
    h2 = np.ones(N, bool)
    h2[1:] = (gid[o2][1:] != gid[o2][:-1]) | (node[o2][1:] != node[o2][:-1])
    run2 = np.cumsum(h2) - 1
    pool_slot = np.empty(N, np.int64)
    pool_slot[o2] = o2[h2][run2]

    # --- lockstep consumption loop (zero_to_one.rs:98-121) ----------------
    E = int(gsize.max())
    # Consumed query-term indices per group as a [G, query_terms] boolean
    # matrix (a packed int64 bitmask silently overflows past 64 query terms).
    consumed = np.zeros((G, max(qlen_total, 1)), bool)
    grange = np.arange(G)
    pools = np.full(N, -1, np.int64)  # -1 = untouched
    acc = np.zeros(G, np.float64)
    for e in range(E):
        active = e < gsize
        idx = np.minimum(gstart + e, N - 1)
        q = qti[idx]
        ok = active & ~consumed[grange, q]
        ps = pool_slot[idx]
        pv = pools[ps]
        first = pv < 0
        take = ok & (first | (pv > 0))
        new_pv = np.where(first, tf[idx] - 1, pv - 1)
        # Only taken lanes write their pool: an inactive lane's clamped idx
        # could alias an active group's pool slot.
        tk = np.flatnonzero(take)
        pools[ps[tk]] = new_pv[tk]
        consumed[grange[take], q[take]] = True
        contrib = (
            np.minimum(score[idx] / tf[idx], 1.0)
            * tf[idx]
            / np.maximum(flen[idx], qlen_total)
        )
        acc += np.where(take, contrib, 0.0)

    # --- doc score = max over fields (zero_to_one.rs:122) -----------------
    g_slot = slot[gstart]
    uniq_slots, inv = np.unique(g_slot, return_inverse=True)
    doc_score = np.zeros(len(uniq_slots), np.float64)
    np.maximum.at(doc_score, inv, acc)

    results = [
        QueryResult(key=index._slot_to_key[int(s)], score=float(v))
        for s, v in zip(uniq_slots, doc_score)
    ]
    results.sort(key=lambda r: (-r.score, index._key_to_slot.get(r.key, 0)))
    if top_k is not None:
        results = results[:top_k]
    return results


ZeroToOne.vectorized_query = staticmethod(vectorized_query)
