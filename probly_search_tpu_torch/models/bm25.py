"""Okapi BM25 for the torch port.

Counterpart of ``probly_search_tpu/models/bm25.py``: the host halves
(``before_each``, ``score``, ``device_term_scale``, ``device_cache_key``, the
vectorized host query) are inherited from that scorer unchanged; only the
vectorized per-lane score (``device_score_lanes``) is written in torch.
"""

from __future__ import annotations

import torch

from probly_search_tpu.models.bm25 import BM25 as HostBM25


def bm25_score_lanes(lanes, bm25k1: float, bm25b: float):
    """``sum_f tf_norm(tf_f, len_f, avg_f) * boost_f * scale`` per lane.

    ``lanes`` is an ``index.device.ScoreLanes`` with ``tf`` and
    ``field_length`` f32[B, NC, F, C] and a per-lane ``scale``; the operation
    order is that of the JAX scorer, so the two differ only by f32 rounding
    of the field sum.  Returns f32[B, NC, C]."""
    tf = lanes.tf
    k1 = torch.tensor(bm25k1, dtype=tf.dtype, device=tf.device)
    b = torch.tensor(bm25b, dtype=tf.dtype, device=tf.device)
    avg = lanes.field_avg[:, None]  # [F, 1]
    denom = k1 * ((1.0 - b) + b * (lanes.field_length / avg)) + tf
    tf_norm = torch.where(tf > 0, ((k1 + 1.0) * tf) / denom, 0.0)
    per_field = tf_norm * lanes.fields_boost[:, None]
    return per_field.sum(dim=-2) * lanes.scale


class BM25(HostBM25):
    """Okapi BM25 with a torch ``device_score_lanes``.  On a CUDA device the
    fused kernel (``ops/fused_query.py``) computes the same formula from
    ``bm25k1`` / ``bm25b``; a subclass that overrides ``device_score_lanes``
    runs on the CPU only."""

    def device_score_lanes(self, lanes):
        return bm25_score_lanes(lanes, self.bm25k1, self.bm25b)

    def device_range_boost(self, term_len, qlen):
        raise NotImplementedError(
            "term-range jobs are not ported yet (ROADMAP Queue 1, M6); the "
            "port plans expansion-heavy terms as per-expansion jobs"
        )


def new(bm25k1: float = 1.2, bm25b: float = 0.75) -> BM25:
    """Factory matching the reference's ``score::bm25::new()``."""
    return BM25(bm25k1=bm25k1, bm25b=bm25b)
