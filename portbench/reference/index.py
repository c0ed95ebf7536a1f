"""The reference's own inverted index, built with numpy from the generated
token ids (the same draws the program's texts spell out), and the rounding
of its arithmetic.

Terms are the distinct words of the corpus; a query word stands for every
term that starts with it (automatic prefix expansion), found by a binary
search of the sorted terms.  A posting is one (term, document) pair with the
term's count in each field.  Postings are built only for the terms a check
asks for (``load``), so the reference stays cheap on a large corpus.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_MAX_CHAR = "\U0010FFFF"


def unique(a: np.ndarray, return_inverse: bool = False, return_counts: bool = False):
    """``np.unique`` by one sort (some numpy versions take a far slower
    path for large arrays): the sorted distinct values, and optionally each
    element's index into them and their counts."""
    a = np.asarray(a)
    order = np.argsort(a, kind="stable")
    s = a[order]
    head = np.ones(len(s), bool)
    head[1:] = s[1:] != s[:-1]
    out = [s[head]]
    if return_inverse:
        inv = np.empty(len(a), np.int64)
        inv[order] = np.cumsum(head) - 1
        out.append(inv)
    if return_counts:
        out.append(np.diff(np.append(np.flatnonzero(head), len(s))))
    return out[0] if len(out) == 1 else tuple(out)


def _sorted_counts(a: np.ndarray):
    """The sorted distinct values of ``a`` and their counts."""
    s = np.sort(a)
    head = np.ones(len(s), bool)
    head[1:] = s[1:] != s[:-1]
    return s[head], np.diff(np.append(np.flatnonzero(head), len(s)))


def rounder(precision: str):
    """``q(x)``: x rounded to ``precision`` after each operation of the
    reference (float64: unchanged; bfloat16: round to nearest even on the
    top 16 bits of the float32 value), returned as float64."""
    if precision == "float64":
        return lambda x: x
    if precision == "float32":
        return lambda x: np.asarray(x, np.float64).astype(np.float32).astype(np.float64)
    if precision == "bfloat16":

        def q(x):
            f = np.asarray(x, np.float64).astype(np.float32)
            bits = f.view(np.uint32).astype(np.uint64)
            bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
            return bits.astype(np.uint32).view(np.float32).astype(np.float64)

        return q
    raise ValueError(f"unknown precision {precision!r}")


class ReferenceIndex:
    def __init__(self, fields: Sequence, n_docs: int, spell: np.ndarray, spell_len: np.ndarray):
        self.fields = list(fields)  # per field: (term ids int32[T], offsets int64[N + 1])
        self.n_docs = int(n_docs)
        self.F = len(self.fields)
        V = len(spell_len)
        self.occ = np.zeros(V, np.int64)  # occurrences of each term, all fields
        for ids, _ in self.fields:
            self.occ += np.bincount(ids, minlength=V)
        self.flen = np.stack([np.diff(off) for _, off in self.fields], axis=1).astype(np.int64)
        self.avg = self.flen.sum(axis=0) / float(self.n_docs)
        present = np.flatnonzero(self.occ > 0)
        lmax = spell.shape[1]
        # Wide enough for a probe one character past the longest term, so a
        # search never recasts the table.
        words = np.ascontiguousarray(spell[present]).view(f"S{lmax}").ravel().astype(f"U{lmax + 1}")
        order = np.argsort(words, kind="stable")
        self.sorted_words = words[order]
        self.sorted_ids = present[order]
        self.spell_len = spell_len
        self.loaded = np.zeros(V, bool)

    def expand(self, word: str) -> np.ndarray:
        """Term ids of every present term that starts with ``word``, in
        lexicographic order."""
        dt = self.sorted_words.dtype
        lo = np.searchsorted(self.sorted_words, np.asarray(word, dt), side="left")
        hi = np.searchsorted(self.sorted_words, np.asarray(word + _MAX_CHAR, dt), side="left")
        return self.sorted_ids[lo:hi]

    def load(self, term_ids) -> None:
        """Build the postings of ``term_ids`` (replacing any built before):
        per term a run of (document, tf per field) pairs, documents
        ascending."""
        want = unique(np.asarray(term_ids, np.int64))
        V = len(self.occ)
        table = np.zeros(V, bool)
        table[want] = True
        N = self.n_docs
        keys, counts = [], []
        for ids, off in self.fields:
            pos = np.flatnonzero(table[ids])
            doc = np.repeat(np.arange(N, dtype=np.int64), np.diff(off))[pos]
            k, c = _sorted_counts(ids[pos].astype(np.int64) * N + doc)
            keys.append(k)
            counts.append(c)
        uk = keys[0] if self.F == 1 else _sorted_counts(np.concatenate(keys))[0]
        tf = np.zeros((len(uk), self.F), np.int64)
        for f, (k, c) in enumerate(zip(keys, counts)):
            tf[np.searchsorted(uk, k), f] = c
        term = uk // N
        self.p_doc, self.p_tf = uk % N, tf
        self.p_beg = np.searchsorted(term, np.arange(V), side="left")
        self.p_end = np.searchsorted(term, np.arange(V), side="right")
        self.loaded = table

    def gather(self, term_ids: np.ndarray):
        """The postings of loaded ``term_ids``, one term after another:
        (docs, tf int64[n, F], index into term_ids of each posting)."""
        term_ids = np.asarray(term_ids, np.int64)
        if not self.loaded[term_ids].all():
            raise KeyError("postings of a term that was not loaded")
        beg, end = self.p_beg[term_ids], self.p_end[term_ids]
        n = end - beg
        which = np.repeat(np.arange(len(term_ids)), n)
        starts = np.repeat(beg - np.concatenate([[0], np.cumsum(n)[:-1]]), n)
        idx = starts + np.arange(int(n.sum()))
        return self.p_doc[idx], self.p_tf[idx], which

    def load_queries(self, queries: List[List[str]]) -> None:
        need = [self.expand(w) for q in queries for w in q if w]
        self.load(np.concatenate(need) if need else np.zeros(0, np.int64))


def rank(docs: np.ndarray, scores: np.ndarray, k: int, ties: str = "low"):
    """The top ``k`` of (docs, scores) by score descending, ties to the
    lowest doc (``ties="high"``: to the highest, the control that breaks the
    tie guarantee)."""
    if len(docs) > k:
        # Only documents scoring at least the k-th best can be ranked.
        kth = np.partition(scores, len(scores) - k)[len(scores) - k]
        keep = scores >= kth
        docs, scores = docs[keep], scores[keep]
    order = np.lexsort((docs if ties == "low" else -docs, -scores))[:k]
    return docs[order], scores[order]
