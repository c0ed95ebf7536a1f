"""The one generator of corpora and query traffic, driven by a configuration
file and a traffic file (their ``corpus``, ``queries`` and traffic keys).
Everything is drawn from the run's seed with numpy; nothing here knows the
program.

A corpus is kept as token ids (``Corpus.fields``: per field a flat int32
array of term ids and int64 offsets, one row a document), the spelling of
every term id (``Corpus.spell``) and the documents' texts as the program
ingests them (words joined by one space).  Traffic is kept the same way
(``QueryPool``): the term ids of each request, the number of letters kept of
its last word (0: the whole word) and the request strings; its first
``warm`` requests are the warm-up set, the rest the stream the measured
window serves in order.

Term spellings (``corpus.vocab.spelling``, ``letters``): lowercase letter
strings whose length grows with rank: the ranks fill every string of
``min_len`` letters, then spread over the strings of the next length,
evenly (a code ``j`` of ``n`` in a class of ``26**L`` strings is
``j * 26**L // n``), each class in an order scrambled by a fixed
multiplier, so that neither a string's letters nor a prefix band track its
rank.  The spelling is fixed: seeds change the draws only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
# The multiplier that scrambles a class's order (taken mod the class's used
# count, and stepped up to the next value coprime with it).
_SCRAMBLE = 1_000_003


@dataclass
class Corpus:
    n_docs: int
    spell: np.ndarray  # uint8[V, Lmax]: letters of term id, 0-padded
    spell_len: np.ndarray  # int64[V]
    fields: List[Tuple[np.ndarray, np.ndarray]]  # per field: (ids int32[T], offsets int64[N + 1])
    texts: List[List[str]]  # per field: the documents' texts

    @property
    def vocab_size(self) -> int:
        return len(self.spell_len)

    def term(self, tid: int) -> str:
        return self.spell[tid, : self.spell_len[tid]].tobytes().decode("ascii")


@dataclass
class QueryPool:
    ids: np.ndarray  # int32[Q]: the words' term ids, request after request
    offsets: np.ndarray  # int64[n + 1]
    cut: np.ndarray  # int64[n]: letters kept of the last word (0: all)
    strings: List[str]
    warm: int  # requests [0, warm) warm up; [warm, n) are the stream

    def __len__(self) -> int:
        return len(self.strings)

    def words(self, corpus: Corpus, qi: int) -> List[str]:
        """The request's words as the program tokenizes them."""
        a, b = int(self.offsets[qi]), int(self.offsets[qi + 1])
        words = [corpus.term(int(t)) for t in self.ids[a:b]]
        if self.cut[qi]:
            words[-1] = words[-1][: int(self.cut[qi])]
        return words


def _coprime(a: int, n: int) -> int:
    a = max(a, 1)
    while math.gcd(a, n) != 1:
        a += 1
    return a


def spell_letters(n_terms: int, min_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Spellings of ranks 0 .. n_terms - 1 under the ``letters`` scheme."""
    lens, codes = [], []
    left, L = n_terms, min_len
    while left > 0:
        cap = 26**L
        n = min(left, cap)
        j = np.arange(n, dtype=np.int64)
        a = _coprime(_SCRAMBLE % n, n) if n > 1 else 1
        scrambled = (j * a) % n
        codes.append((scrambled * cap) // n)
        lens.append(np.full(n, L, np.int64))
        left -= n
        L += 1
    code = np.concatenate(codes)
    length = np.concatenate(lens)
    lmax = int(length.max())
    spell = np.zeros((n_terms, lmax), np.uint8)
    for p in range(lmax):
        # Letter p from the left of an L-letter code: digit L - 1 - p.
        live = p < length
        digit = (code[live] // (26 ** (length[live] - 1 - p))) % 26
        spell[live, p] = LETTERS[digit]
    return spell, length


def spellings(vocab: dict) -> Tuple[np.ndarray, np.ndarray]:
    if vocab["spelling"] != "letters":
        raise ValueError(f"unknown spelling {vocab['spelling']!r}")
    return spell_letters(int(vocab["terms"]), int(vocab["min_len"]))


def zipf_cdf(n_terms: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n_terms + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def draw_ranks(rng, cdf: np.ndarray, n: int, stop: int = 0) -> np.ndarray:
    """``n`` independent draws of ranks from the distribution of ``cdf``
    (ranks below ``stop`` excluded and the rest renormalised): the count of
    each rank from one multinomial draw, laid out and shuffled, which is the
    same distribution as ``n`` inverse-CDF draws at a fraction of the cost."""
    p = np.diff(np.concatenate([[0.0], cdf]))
    p[:stop] = 0.0
    p /= p.sum()
    counts = rng.multinomial(n, p)
    ids = np.repeat(np.arange(len(cdf), dtype=np.int32), counts)
    rng.shuffle(ids)
    return ids


def draw_lengths(rng, spec: dict, n: int) -> np.ndarray:
    dist = spec["dist"]
    if dist == "lognormal":
        x = rng.lognormal(float(spec["mu"]), float(spec["sigma"]), n)
        return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    if dist == "one_plus_poisson":
        x = 1 + rng.poisson(float(spec["mean"]) - 1.0, n)
        return np.clip(x, spec.get("min", 1), spec["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist!r}")


def segment_arange(n: np.ndarray) -> np.ndarray:
    """0 .. n[i] - 1 for every i, laid end to end."""
    n = np.asarray(n, np.int64)
    starts = np.cumsum(n) - n
    return np.arange(int(n.sum()), dtype=np.int64) - np.repeat(starts, n)


def take_rows(ids: np.ndarray, offsets: np.ndarray, rows: np.ndarray):
    """The ``rows`` of a ragged array (ids, offsets), in that order."""
    rows = np.asarray(rows, np.int64)
    n = offsets[rows + 1] - offsets[rows]
    out = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(n, out=out[1:])
    return ids[np.repeat(offsets[rows], n) + segment_arange(n)], out


def join_words(spell, spell_len, ids, offsets, cut=None) -> List[str]:
    """Rows of term ids -> strings of their spellings joined by one space;
    ``cut[r] > 0`` keeps that many letters of row r's last word."""
    lmax = spell.shape[1]
    # Each word's letters and a space, zero-padded; zeros are then dropped.
    ext = np.zeros((len(spell_len), lmax + 1), np.uint8)
    ext[:, :lmax] = spell
    ext[np.arange(len(spell_len)), spell_len] = ord(" ")
    words = np.take(ext, ids, axis=0)
    wl = np.take(spell_len, ids)
    if cut is not None and len(ids):
        has = (cut > 0) & (offsets[1:] > offsets[:-1])
        last = offsets[1:][has] - 1
        wl[last] = np.minimum(wl[last], cut[has])
        row = np.zeros((len(last), lmax + 1), np.uint8)
        row[:, :lmax] = np.where(np.arange(lmax)[None, :] < wl[last][:, None], words[last, :lmax], 0)
        row[np.arange(len(last)), wl[last]] = ord(" ")
        words[last] = row
    text = words[words != 0].tobytes().decode("ascii")
    start = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(wl + 1, out=start[1:])
    a = start[offsets[:-1]]
    b = np.maximum(start[offsets[1:]] - 1, a)
    return [text[i:j] for i, j in zip(a.tolist(), b.tolist())]


def make_corpus(cfg: dict, seed: int) -> Corpus:
    """The configuration's corpus (``cfg["corpus"]``) drawn from ``seed``."""
    spec = cfg["corpus"]
    rng = np.random.default_rng([int(seed), 0])
    spell, spell_len = spellings(spec["vocab"])
    cdf = zipf_cdf(len(spell_len), float(spec["zipf_s"]))
    n = int(spec["docs"])
    fields, texts = [], []
    for fspec in spec["fields"]:
        lens = draw_lengths(rng, fspec["length"], n)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        ids = draw_ranks(rng, cdf, int(offsets[-1]))
        fields.append((ids, offsets))
        texts.append(join_words(spell, spell_len, ids, offsets))
    return Corpus(n_docs=n, spell=spell, spell_len=spell_len, fields=fields, texts=texts)


def draw_queries(cfg: dict, corpus: Corpus, rng, n: int):
    """``n`` queries of the configuration's shape (``cfg["queries"]``): word
    counts, Zipf draws over the corpus's vocabulary, and the words among the
    ``stop_ranks`` most frequent dropped (a query left without words keeps
    one drawn past them).  Returns (ids, offsets)."""
    q = cfg["queries"]
    cdf = zipf_cdf(corpus.vocab_size, float(cfg["corpus"]["zipf_s"]))
    stop = int(q.get("stop_ranks", 0))
    counts = draw_lengths(rng, q["words"], n)
    ids = draw_ranks(rng, cdf, int(counts.sum()))
    keep = ids >= stop
    row = np.repeat(np.arange(n), counts)
    empty = np.bincount(row[keep], minlength=n) == 0
    refill = draw_ranks(rng, cdf, int(empty.sum()), stop)
    row = np.concatenate([row[keep], np.flatnonzero(empty)])
    ids = np.concatenate([ids[keep], refill])
    order = np.argsort(row, kind="stable")
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=offsets[1:])
    return ids[order], offsets


def keystrokes(ids: np.ndarray, offsets: np.ndarray, spell_len: np.ndarray):
    """Every request a search box sends while each query is typed: for each
    word, the words before it and the word's first 1, 2, ... letters up to
    the whole word.  Returns (ids, offsets, cut), query after query."""
    wl = spell_len[ids]
    word = np.repeat(np.arange(len(ids)), wl)  # the word each request types
    typed = segment_arange(wl) + 1  # its letters typed so far
    start = np.repeat(np.repeat(offsets[:-1], np.diff(offsets)), wl)
    n = word + 1 - start
    out = np.zeros(len(word) + 1, np.int64)
    np.cumsum(n, out=out[1:])
    cut = np.where(typed < wl[word], typed, 0)
    return ids[np.repeat(start, n) + segment_arange(n)], out, cut


def make_traffic(cfg: dict, traffic: dict, corpus: Corpus, seed: int) -> QueryPool:
    """The traffic drawn from ``seed``: ``warm_queries`` + ``stream_queries``
    distinct queries of the configuration's shape (a query string drawn
    twice is kept once, so the stream repeats no query and none of the warm
    set), the first ``warm_queries`` for the warm-up, the rest for the
    measured window.  With ``keystrokes`` each query becomes every request a
    search box sends while it is typed (``keystrokes``), the warm set's and
    the stream's each in a seeded order, as many users type at once."""
    rng = np.random.default_rng([int(seed), 1])
    n_warm, n_stream = int(traffic["warm_queries"]), int(traffic["stream_queries"])
    ids, offsets = draw_queries(cfg, corpus, rng, n_warm + n_stream)
    strings = join_words(corpus.spell, corpus.spell_len, ids, offsets)
    seen: dict = {}
    for i, s in enumerate(strings):
        seen.setdefault(s, i)
    first = np.fromiter(seen.values(), np.int64)  # each string's first draw, in draw order
    parts = []
    for rows in (first[:n_warm], first[n_warm:]):
        p_ids, p_off = take_rows(ids, offsets, rows)
        if traffic.get("keystrokes"):
            p_ids, p_off, cut = keystrokes(p_ids, p_off, corpus.spell_len)
            order = rng.permutation(len(cut))
            p_ids, p_off = take_rows(p_ids, p_off, order)
            parts.append((p_ids, p_off, cut[order]))
        else:
            parts.append((p_ids, p_off, np.zeros(len(rows), np.int64)))
    (w_ids, w_off, w_cut), (s_ids, s_off, s_cut) = parts
    all_ids = np.concatenate([w_ids, s_ids])
    all_off = np.concatenate([w_off, s_off[1:] + w_off[-1]])
    cut = np.concatenate([w_cut, s_cut])
    out = join_words(corpus.spell, corpus.spell_len, all_ids, all_off, cut)
    return QueryPool(ids=all_ids, offsets=all_off, cut=cut, strings=out, warm=len(w_cut))


def warm_order(seed: int, pass_index: int, n_warm: int) -> np.ndarray:
    """The warm set's order in one warm-up pass."""
    return np.random.default_rng([int(seed), 2, int(pass_index)]).permutation(n_warm)
