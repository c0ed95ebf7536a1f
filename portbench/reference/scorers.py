"""BM25 over the reference index, from the semantics of the upstream library
(SURVEY.md section 2; ``src/query.rs``, ``src/score/default/bm25.rs``):

* a query is its words split on single spaces; each word expands to every
  term that starts with it;
* BM25: per expansion ``idf = ln(1 + (N - f + 0.5) / (f + 0.5))`` with
  ``f = min(N, occurrences)`` (the term's occurrences over every field and
  document), the expansion boost 1 for the word itself else
  ``ln(1 + 1 / (1 + len(term) - len(word)))`` (byte lengths), and per
  document ``sum_f tf_norm_f * idf * boost_f * expansion_boost`` with
  ``tf_norm = (k1 + 1) tf / (k1 ((1 - b) + b len_f / avg_f) + tf)``; only
  positive scores count; a document takes the best expansion of a word and
  the sum over the query's words.

Every arithmetic result passes through ``q`` (``index.rounder``): float64
for the reference, a lower precision for the control.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .index import ReferenceIndex, rounder


def bm25(ix: ReferenceIndex, words: List[str], k1: float, b: float,
         boosts=None, precision: str = "float64") -> Tuple[np.ndarray, np.ndarray]:
    """(docs, scores) of every document the query matches."""
    q = rounder(precision)
    F = ix.F
    boosts = np.ones(F) if boosts is None else np.asarray(boosts, np.float64)
    N = ix.n_docs
    # Dense over the documents: a word's best expansion, the query's sum and
    # which documents any word matched.
    tot = np.zeros(N, np.float64)
    hit = np.zeros(N, bool)
    for word in words:
        if not word:
            continue
        terms = ix.expand(word)
        if len(terms) == 0:
            continue
        wlen = len(word.encode("utf-8"))
        # Per expansion: idf of its occurrences and the expansion boost.
        freq = np.minimum(N, ix.occ[terms]).astype(np.float64)
        idf = q(np.log(q(1.0 + q(q(N - freq + 0.5) / q(freq + 0.5)))))
        tlen = ix.spell_len[terms].astype(np.float64)
        eb = np.where(tlen == wlen, 1.0, q(np.log(q(1.0 + q(1.0 / (1.0 + tlen - wlen))))))
        docs, tf, which = ix.gather(terms)
        tf = tf.astype(np.float64)
        flen = ix.flen[docs].astype(np.float64)
        score = np.zeros(len(docs), np.float64)
        for f in range(F):
            denom = q(q(k1 * q((1.0 - b) + q(b * q(flen[:, f] / ix.avg[f])))) + tf[:, f])
            norm = q(q((k1 + 1.0) * tf[:, f]) / denom)
            part = q(q(q(norm * idf[which]) * boosts[f]) * eb[which])
            score = np.where(tf[:, f] > 0, q(score + part), score)
        pos = score > 0.0
        if not pos.any():
            continue
        best = np.zeros(N, np.float64)
        np.maximum.at(best, docs[pos], score[pos])
        m = best > 0.0
        tot[m] = q(tot[m] + best[m])
        hit |= m
    matched = np.flatnonzero(hit)
    return matched, tot[matched]
