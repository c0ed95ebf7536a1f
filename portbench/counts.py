"""The least work of a window, counted from the workload alone: the bytes
and float32 operations that scoring its queries needs, and the least time
the card could take for them.  Nothing here reads the program, so the count
is the same whatever chunking, class layout or kernel serves the window.

Per query: every posting (one term in one document) of every term the
query's words expand to, read once, at the scorer's ``bytes_per_posting``
(its file under ``portbench/scorers/``), plus the result row written (``k``
document ids, 4 bytes each); the operations are the scorer's
``ops_per_posting``, float32 operations.  A query word that appears twice is
scored twice and counted twice.

Peaks (NVIDIA's H100 SXM data sheet, at 700 W): 3.35 TB/s of HBM, 67
TFLOP/s float32 outside the tensor cores.
"""

from __future__ import annotations

import numpy as np

from .corpus import take_rows
from .reference.index import unique

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

def postings_per_term(fields, n_docs: int, vocab_size: int) -> np.ndarray:
    """int64[V]: the documents that hold each term, in any field: its
    occurrences less its repeats inside a document.  The repeats come from
    sorting each document's words (all fields), documents of one length at
    a time, so no sort runs over the whole corpus."""
    if len(fields) == 1:
        ids, off = fields[0]
    else:
        # Every field's words of a document together: the fields' runs, each
        # already in document order, merged by a stable sort on the document.
        doc = np.concatenate([np.repeat(np.arange(n_docs), np.diff(o)) for _, o in fields])
        order = np.argsort(doc, kind="stable")
        ids = np.concatenate([i for i, _ in fields])[order]
        off = np.concatenate([[0], np.cumsum(sum(np.diff(o) for _, o in fields))])
    lens = np.diff(off)
    repeats = np.zeros(vocab_size, np.int64)
    for L in unique(lens).tolist():
        rows = ids[off[:-1][lens == L][:, None] + np.arange(L)[None, :]]
        rows.sort(axis=1)
        repeats += np.bincount(rows[:, 1:][rows[:, 1:] == rows[:, :-1]], minlength=vocab_size)
    return np.bincount(ids, minlength=vocab_size) - repeats


class WorkCounter:
    """Postings per query word by prefix, over the reference index's sorted
    terms (``ReferenceIndex.sorted_words`` / ``sorted_ids``)."""

    def __init__(self, ix, corpus):
        per_term = postings_per_term(corpus.fields, corpus.n_docs, corpus.vocab_size)
        self._cum = np.concatenate([[0], np.cumsum(per_term[ix.sorted_ids])])
        self._words = ix.sorted_words

    def word_postings(self, words) -> np.ndarray:
        w = np.asarray(list(words), dtype=self._words.dtype)
        lo = np.searchsorted(self._words, w, side="left")
        hi = np.searchsorted(self._words, np.char.add(w, "\U0010FFFF").astype(w.dtype), side="left")
        return self._cum[hi] - self._cum[lo]

    def query_postings(self, pool, corpus, rows) -> np.ndarray:
        """int64[len(rows)]: the postings each of the pool's requests
        ``rows`` expands its words to."""
        rows = np.asarray(rows, np.int64)
        ids, offsets = take_rows(pool.ids, pool.offsets, rows)
        uniq, inv = unique(ids, return_inverse=True)
        full = self.word_postings([corpus.term(int(t)) for t in uniq.tolist()])[inv]
        last = offsets[1:] - 1
        cut = np.flatnonzero(pool.cut[rows] > 0)
        if len(cut):
            pref = [corpus.term(int(ids[last[i]]))[: int(pool.cut[rows[i]])] for i in cut.tolist()]
            full = full.copy()
            full[last[cut]] = self.word_postings(pref)
        row = np.repeat(np.arange(len(rows)), np.diff(offsets))
        return np.bincount(row, weights=full, minlength=len(rows)).astype(np.int64)


def window_work(postings: np.ndarray, F: int, k: int, scorer):
    """(bytes, operations) of requests with ``postings`` each, scored by
    ``scorer`` (a ``manifest.Scorer``)."""
    p = float(np.sum(postings))
    nbytes = p * scorer.bytes_per_posting(F) + len(postings) * k * 4
    ops = p * scorer.ops_per_posting(F)
    return nbytes, ops


def least_seconds(nbytes: float, ops: float):
    """(seconds, bound): the larger of the bytes at peak bandwidth and the
    operations at peak float32 rate, and which it is."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return (tb, "memory") if tb >= to else (to, "compute")
