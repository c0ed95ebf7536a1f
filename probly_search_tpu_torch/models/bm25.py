"""Okapi BM25 for the torch port.

The torch port's copy of ``probly_search_tpu/models/bm25.py``: the host
halves (``before_each``, ``score``, ``device_term_scale``,
``device_cache_key``, ``device_term_static``, the vectorized host query) are
the JAX scorer's, copied; the vectorized per-lane score
(``device_score_lanes``) and the range-job expansion boost
(``device_range_boost``) are torch.  On
a CUDA device the fused kernel (``ops/fused_query.py``) computes the same
formula from ``bm25k1`` / ``bm25b``.

Reproduces `reference src/score/default/bm25.rs` exactly (the golden
tests in that file and in `src/query.rs:166-389` are the spec):

* Defaults ``k1 = 1.2``, ``b = 0.75`` (bm25.rs:21-26).
* **df clamping** (bm25.rs:41): ``frequency = min(N_docs, df)`` then
  ``diff = N_docs - frequency``.  Required because the reference stores one
  posting per term *occurrence* (index.rs:119), so df can exceed the number
  of live documents; this engine stores de-duplicated postings but defines
  df identically as the number of live posting pointers = sum over live docs
  of total term occurrences across all fields (see index/core.py), so the
  clamp fires in the same situations and the numerics match bit-for-bit.
* **IDF** (bm25.rs:56): ``ln(1 + (diff + 0.5) / (frequency + 0.5))`` — the
  Lucene-style non-negative variant.
* **Expansion boost** (bm25.rs:44-55): exact match -> 1.0, otherwise
  ``ln(1 + 1 / (1 + len(expanded) - len(term)))`` with *byte* lengths
  (Rust ``str::len()`` counts bytes, not chars).
* **Per-posting score** (bm25.rs:71-92): for each field with tf > 0,
  ``tf_norm = ((k1+1)*tf) / (k1*((1-b) + b*(field_len/avg_field_len)) + tf)``
  and ``score += tf_norm * idf * boost[field] * expansion_boost``; returns
  ``None`` when the total is not > 0 so zero scores never enter the result
  map.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch

from .base import (
    BaseScoreCalculator,
    DocumentDetails,
    DocumentPointer,
    FieldData,
    TermData,
)


def bm25_score_lanes(lanes, bm25k1: float, bm25b: float):
    """``sum_f tf_norm(tf_f, len_f, avg_f) * boost_f * scale`` per lane.

    ``lanes`` is an ``index.device.ScoreLanes`` with ``tf`` and
    ``field_length`` f32[B, NC, F, C] and a per-lane ``scale``; the operation
    order is that of the JAX scorer, so the two differ only by f32 rounding
    of the field sum.  Returns f32[B, NC, C]."""
    import numpy as np

    tf = lanes.tf
    # The constants rounded to f32 as f32 tensors would hold them, but kept
    # Python scalars: a tensor made from a host value is a host-to-device
    # copy, which a CUDA graph capture refuses.
    k1, b = np.float32(bm25k1), np.float32(bm25b)
    avg = lanes.field_avg[:, None]  # [F, 1]
    denom = float(k1) * (float(np.float32(1.0) - b) + float(b) * (lanes.field_length / avg)) + tf
    tf_norm = torch.where(tf > 0, (float(k1 + np.float32(1.0)) * tf) / denom, 0.0)
    per_field = tf_norm * lanes.fields_boost[:, None]
    return per_field.sum(dim=-2) * lanes.scale


@dataclass
class BM25TermCalculations:
    """`before_each` output (bm25.rs:27-33)."""

    idf: float
    expansion_boost: float


class BM25(BaseScoreCalculator):
    """Okapi BM25 (bm25.rs:14-94).  Stateless; also runs on-device.  A
    subclass that overrides ``device_score_lanes`` runs on the CPU only (the
    CUDA kernel cannot call Python)."""

    device_needs_finalize = False
    # score() returns None for non-positive totals (bm25.rs:89-92); the
    # device path must drop those lanes before the merge.
    device_excludes_nonpositive = True

    def __init__(self, bm25k1: float = 1.2, bm25b: float = 0.75):
        self.bm25k1 = bm25k1
        self.bm25b = bm25b

    def device_cache_key(self):
        """Plan-pool key: scorers with equal params share pooled plans."""
        return ("bm25", self.bm25k1, self.bm25b)

    # --- host (exact f64) path --------------------------------------------

    def before_each(
        self,
        term_expansion: TermData,
        document_frequency: int,
        documents: Mapping[Any, DocumentDetails],
    ) -> Optional[BM25TermCalculations]:
        n_docs = len(documents)
        frequency = min(n_docs, document_frequency)  # bm25.rs:41
        diff = n_docs - frequency
        if term_expansion.query_term_expanded == term_expansion.query_term:
            expansion_boost = 1.0
        else:
            # Byte lengths, exactly like Rust str::len() (bm25.rs:51-52).
            len_expanded = len(term_expansion.query_term_expanded.encode("utf-8"))
            len_term = len(term_expansion.query_term.encode("utf-8"))
            # Literal ln(1 + x) like the reference (bm25.rs:48-54), not log1p.
            expansion_boost = math.log(1.0 + (1.0 / (1.0 + len_expanded - len_term)))
        idf = math.log(1.0 + (diff + 0.5) / (frequency + 0.5))  # bm25.rs:56
        return BM25TermCalculations(idf=idf, expansion_boost=expansion_boost)

    def score(
        self,
        before_output: Optional[BM25TermCalculations],
        document_pointer: DocumentPointer,
        document_details: DocumentDetails,
        index_node: int,
        field_data: FieldData,
        term_expansion: TermData,
    ) -> Optional[float]:
        pre = before_output  # always present for BM25 (bm25.rs:69)
        score = 0.0
        k1 = self.bm25k1
        b = self.bm25b
        for x in range(len(document_details.field_length)):
            tf = float(document_pointer.term_frequency[x])
            if tf > 0.0:
                field_length = float(document_details.field_length[x])
                avg_field_length = field_data.fields[x].avg
                tf_norm = ((k1 + 1.0) * tf) / (
                    k1 * ((1.0 - b) + b * (field_length / avg_field_length)) + tf
                )
                score += tf_norm * pre.idf * field_data.fields_boost[x] * pre.expansion_boost
        if score > 0.0:
            return score
        return None  # bm25.rs:89-92

    # --- device (vectorized f32) path --------------------------------------

    def device_term_scale(self, df, n_docs, expansion_boost):
        """Vectorized ``before_each`` over the planned job table (host f64):
        df-clamped Lucene idf (bm25.rs:41-56) times the expansion boost,
        premultiplied into one per-job scale."""
        import numpy as np

        freq = np.minimum(n_docs, df.astype(np.float64))  # bm25.rs:41
        idf = np.log(1.0 + (n_docs - freq + 0.5) / (freq + 0.5))  # bm25.rs:56
        return (idf * expansion_boost).astype(np.float32)

    def device_impact(self, tf, flen, avg):
        """Per-posting per-field impact for block-max pruning bounds
        (index/prune.py): the score factor with idf and boosts divided out,
        BM25's tf-norm (bm25.rs:71-87).  Host f64; a posting's full score is
        ``scale * sum_f boost_f * impact_f``, monotone in each impact for
        non-negative boosts, which makes per-chunk impact maxima valid score
        upper bounds."""
        import numpy as np

        k1 = float(self.bm25k1)
        b = float(self.bm25b)
        with np.errstate(invalid="ignore", divide="ignore"):
            denom = k1 * ((1.0 - b) + b * (flen / avg)) + tf
            return np.where(tf > 0.0, ((k1 + 1.0) * tf) / denom, 0.0)

    def device_score_lanes(self, lanes):
        """Vectorized per-lane score (see index/device.py ScoreLanes layout:
        [B, NC, F, C] with the posting lane dim C minor); f32[B, NC, C]."""
        return bm25_score_lanes(lanes, self.bm25k1, self.bm25b)

    def device_term_static(self, df, n_docs):
        """Per-term static part of the scale (host f64 -> f32): the
        df-clamped Lucene idf, written per posting into the aux record array
        that term-range jobs read on the device (``DeviceIndex._aux_rec``)."""
        import numpy as np

        freq = np.minimum(n_docs, df.astype(np.float64))
        idf = np.log(1.0 + (n_docs - freq + 0.5) / (freq + 0.5))
        return idf.astype(np.float32)

    # ln(1+x)/x on [0, 1] as a power series (degree-9 Chebyshev fit), the
    # JAX scorer's coefficients in the same order: the range boost is this
    # polynomial, not log1p, so both engines differ only by f32 rounding.
    _LOG1P_RATIO_COEFFS = (
        0.9999999869915193, -0.4999985092774396, 0.33329100870038264,
        -0.2494782132315905, 0.19651539184497904, -0.15251556640920744,
        0.10533368733399628, -0.05643612449615146, 0.019649622919934922,
        -0.003214113138228588,
    )

    def device_range_boost(self, term_len, qlen):
        """Expansion boost of range-job lanes (bm25.rs:44-55) in f32: 1.0
        where the byte lengths are equal (within a prefix range that is the
        exact term), else ``x * P(x)`` with ``x = 1 / (1 + term_len - qlen)``,
        a Horner pass over ``_LOG1P_RATIO_COEFFS``.  Plain torch ops (IEEE
        division, no fused multiply-add), as in the JAX scorer."""
        x = 1.0 / (1.0 + torch.clamp(term_len - qlen, min=0.0))
        acc = torch.full_like(x, self._LOG1P_RATIO_COEFFS[-1])
        for c in self._LOG1P_RATIO_COEFFS[-2::-1]:
            acc = acc * x + c
        return torch.where(term_len == qlen, 1.0, x * acc)


def new(bm25k1: float = 1.2, bm25b: float = 0.75) -> BM25:
    """Factory matching the reference's ``score::bm25::new()`` (bm25.rs:21)."""
    return BM25(bm25k1=bm25k1, bm25b=bm25b)


# --------------------------------------------------------------------- #
# Vectorized host execution                                              #
# --------------------------------------------------------------------- #
#
# The exact host path walks postings one Python call at a time — correct
# but a latency cliff when a device-cap-exceeding query lands inside a
# serving batch.  This NumPy path computes the identical f64 result
# (per-posting scores -> dense per-slot max within each query term -> sum
# across terms, the query.rs:150-164 merge rule) at array speed: an
# adversarial single-char prefix query over millions of postings costs
# milliseconds, not seconds.


def vectorized_query(self, index, query, tokenizer=None, top_k=None, fields_boost=None):
    import numpy as np

    from ..models.base import QueryResult
    from ..utils.tokenizers import whitespace_tokenizer

    tokenizer = tokenizer or whitespace_tokenizer
    # A subclass with overridden scoring keeps the exact per-posting path
    # (this vectorization replicates BM25's formulas, not the subclass's).
    if type(self).score is not BM25.score or type(self).before_each is not BM25.before_each:
        if fields_boost is None:
            fields_boost = [1.0] * index.num_fields
        return index.query(query, self, tokenizer, fields_boost, top_k=top_k)
    index._flush_pending()
    F = index.num_fields
    if fields_boost is None:
        fields_boost = [1.0] * F
    boost = np.asarray(fields_boost, dtype=np.float64)
    n_docs = len(index._docs)
    n_slots = index._next_slot
    k1 = float(self.bm25k1)
    b = float(self.bm25b)
    avg = np.array([fd.avg for fd in index._fields], dtype=np.float64)

    totals = np.zeros(n_slots, dtype=np.float64)
    matched = np.zeros(n_slots, dtype=bool)
    for qterm in tokenizer(query):
        if not qterm:
            continue
        qbytes = len(qterm.encode("utf-8"))
        term_best = np.full(n_slots, -np.inf, dtype=np.float64)
        any_term = False
        for exp in index._expand_term_sorted(qterm):
            slots, tfs, occs = index._gather_postings(exp)
            if len(slots) == 0:
                continue
            alive = index._alive[slots]
            df = int(occs[alive].sum())
            if df <= 0:
                continue  # query.rs:48
            # before_each, vectorized-identical math (bm25.rs:41-56).
            freq = min(n_docs, df)
            idf = math.log(1.0 + (n_docs - freq + 0.5) / (freq + 0.5))
            if exp == qterm:
                eboost = 1.0
            else:
                ebytes = len(exp.encode("utf-8"))
                eboost = math.log(1.0 + (1.0 / (1.0 + ebytes - qbytes)))
            slots_a = slots[alive]
            tf = tfs[alive].astype(np.float64)  # [n, F]
            flen = index._doc_len[slots_a].astype(np.float64)
            with np.errstate(invalid="ignore"):
                denom = k1 * ((1.0 - b) + b * (flen / avg)) + tf
                per_field = np.where(tf > 0.0, ((k1 + 1.0) * tf) / denom, 0.0)
            score = (per_field * boost).sum(axis=1) * (idf * eboost)
            pos = score > 0.0  # None-on-nonpositive (bm25.rs:89-92)
            if pos.any():
                any_term = True
                np.maximum.at(term_best, slots_a[pos], score[pos])
        if any_term:
            hit = term_best > -np.inf
            totals[hit] += term_best[hit]
            matched |= hit

    hit_slots = np.flatnonzero(matched)
    order = np.lexsort((hit_slots, -totals[hit_slots]))
    hit_slots = hit_slots[order]
    if top_k is not None:
        hit_slots = hit_slots[:top_k]
    return [
        QueryResult(key=index._slot_to_key[int(s)], score=float(totals[s]))
        for s in hit_slots
    ]


BM25.vectorized_query = vectorized_query
