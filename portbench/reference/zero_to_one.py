"""Zero-to-one over the reference index, from the semantics of the upstream
library (SURVEY.md section 2.2; ``src/score/default/zero_to_one.rs:53-126``,
``src/query.rs:21-147``).  The scorer is stateful and runs in two phases:

* recording (``zero_to_one.rs:53-80``): for every query word (its index
  among the query's tokens), every term it expands to (every term that
  starts with it) and every document holding that term, one entry per field
  in which the term occurs, with the entry score
  ``1 - |len(expanded) - len(word)| / len(expanded)`` (byte lengths), the
  term's count ``tf`` in that field, the field's length and the term's trie
  node;
* finalize (``zero_to_one.rs:84-126``): per document and field, the entries
  sorted by score, descending and stable, then consumed one by one: an entry
  whose query word is already consumed is skipped; each node keeps a df pool,
  set to ``tf - 1`` at its first accepted entry and taken down by one at
  each later one, and an entry whose pool is at 0 is skipped; an accepted
  entry consumes its query word and adds
  ``min(score / tf, 1) * tf / max(field_length, query_terms_len)``, where
  ``query_terms_len`` counts every token of the query.  A document scores
  the largest of its fields' sums.

The order in which equal-scored entries of one (document, field) are
consumed is the order they were recorded in, since the sort is stable:
query words in query order (``query.rs:34-38`` walks the tokens by index),
then each word's expansions in the order of the upstream trie's walk
(``query.rs:109-147``): a depth-first walk from the word's node that yields
a node before its children (``query.rs:136-138``) and visits children
newest first, since each new child is put at the head of its parent's list
(``query.rs:362-363`` pins that order).  A node is made by the first term
inserted below it: documents are added in key order, and a document's
terms are inserted field after field, word after word (``index.rs:90-156``).
``trie_order`` rebuilds that order from the generated token ids.  With
scores ``len(word) / len(expanded)``, equal scores within one query word's
entries fall on expansions of one length, so which of them a word consumes
moves only which pool is drawn down, not what any later word can take: a
shorter word that can draw on one of them can draw on all.  The order then
changes no sum beyond the rounding of ``min(score / tf, 1) * tf``
(``portbench/tests/test_portbench_z2o.py`` holds this on the CPU cut).

The upstream index keeps one posting a term occurrence; a repeated word
only repeats an entry whose query word the first copy consumes, so one
posting per (term, document) with the per-field counts gives the same
scores.

Every arithmetic result passes through ``q`` (``index.rounder``): float64
for the reference, a lower precision for the control.
"""

from __future__ import annotations

import weakref
from typing import List, Tuple

import numpy as np

from .index import ReferenceIndex, rounder

# Per reference index: the position of each term's first occurrence in the
# insertion stream (documents by key, then fields, then words).
_FIRST: "weakref.WeakKeyDictionary[ReferenceIndex, np.ndarray]" = weakref.WeakKeyDictionary()
_NEVER = np.iinfo(np.int64).max
_MAX_CHAR = "\U0010FFFF"


def first_insertion(ix: ReferenceIndex) -> np.ndarray:
    """int64[V]: each term's first position in the upstream insertion
    stream, as one sortable number (document, field, word)."""
    got = _FIRST.get(ix)
    if got is not None:
        return got
    V = len(ix.occ)
    width = int(ix.flen.max(initial=0)) + 1
    first = np.full(V, _NEVER, np.int64)
    for f, (ids, off) in enumerate(ix.fields):
        n = np.diff(off)
        doc = np.repeat(np.arange(ix.n_docs, dtype=np.int64), n)
        word = np.arange(len(ids), dtype=np.int64) - np.repeat(off[:-1], n)
        order = np.argsort(ids, kind="stable")
        s = ids[order]
        head = np.ones(len(s), bool)
        head[1:] = s[1:] != s[:-1]
        at = order[head]  # each term's first token of this field
        pos = (doc[at] * ix.F + f) * width + word[at]
        first[s[head]] = np.minimum(first[s[head]], pos)
    _FIRST[ix] = first
    return first


def trie_order(ix: ReferenceIndex, word: str, terms: np.ndarray) -> np.ndarray:
    """``terms`` (every present term starting with ``word``) in the order the
    upstream trie's walk from ``word``'s node yields them: a node before its
    children, children newest first, a node made when the first term below
    it was inserted."""
    if len(terms) < 2:
        return terms
    first = first_insertion(ix)
    dt = ix.sorted_words.dtype
    lo = np.searchsorted(ix.sorted_words, np.asarray(word, dt), side="left")
    hi = lo + np.searchsorted(ix.sorted_words[lo:], np.asarray(word + _MAX_CHAR, dt), side="left")
    spelled = dict(zip(ix.sorted_ids[lo:hi].tolist(), ix.sorted_words[lo:hi].tolist()))
    made = {}

    def made_at(prefix: str) -> int:
        if prefix not in made:
            a = np.searchsorted(ix.sorted_words, np.asarray(prefix, dt), side="left")
            b = np.searchsorted(ix.sorted_words, np.asarray(prefix + _MAX_CHAR, dt), side="left")
            made[prefix] = int(first[ix.sorted_ids[a:b]].min())
        return made[prefix]

    def key(t):
        # Along the path below the word's node: newer nodes first; a node's
        # own term (a shorter path) before its children.
        s = spelled[t]
        return [-made_at(s[:j]) for j in range(len(word) + 1, len(s) + 1)]

    return np.asarray(sorted(terms.tolist(), key=key), np.int64)


def zero_to_one(ix: ReferenceIndex, words: List[str], precision: str = "float64",
                order=trie_order) -> Tuple[np.ndarray, np.ndarray]:
    """(docs, scores) of every document the query matches; ``order(ix,
    word, terms)`` gives the order a word's expansions are recorded in."""
    q = rounder(precision)
    F = ix.F
    qlen = len(words)  # every token, empty ones too (query.rs:32)
    # The recorded entries, query word by word, expansion by expansion.
    e_doc, e_field, e_word, e_seq, e_node, e_score, e_tf = ([] for _ in range(7))
    seq = 0
    for wi, word in enumerate(words):
        if not word:
            continue
        terms = ix.expand(word)  # every term there is one a document holds
        if len(terms) == 0:
            continue
        terms = order(ix, word, terms)
        wlen = float(len(word.encode("utf-8")))
        tlen = ix.spell_len[terms].astype(np.float64)
        score = q(1.0 - q(q(np.abs(tlen - wlen)) / tlen))
        docs, tf, which = ix.gather(terms)
        for f in range(F):
            m = tf[:, f] > 0
            e_doc.append(docs[m])
            e_field.append(np.full(int(m.sum()), f, np.int64))
            e_word.append(np.full(int(m.sum()), wi, np.int64))
            e_seq.append(seq + which[m])
            e_node.append(terms[which[m]])
            e_score.append(score[which[m]])
            e_tf.append(tf[m, f])
        seq += len(terms)
    if not e_doc:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    doc, field, wrd, sq, node, score, tf = (
        np.concatenate(a) for a in (e_doc, e_field, e_word, e_seq, e_node, e_score, e_tf)
    )
    tf = tf.astype(np.float64)
    flen = ix.flen[doc, field].astype(np.float64)
    contrib = q(q(q(np.minimum(q(score / tf), 1.0)) * tf) / np.maximum(flen, float(qlen)))

    # Each (document, field): its entries by score descending, recorded
    # order among equals (the stable sort, zero_to_one.rs:98).
    o = np.lexsort((sq, -score, field, doc))
    doc, field, wrd, node, tf, contrib = (a[o] for a in (doc, field, wrd, node, tf, contrib))
    head = np.ones(len(doc), bool)
    head[1:] = (doc[1:] != doc[:-1]) | (field[1:] != field[:-1])
    starts = np.flatnonzero(head)
    ends = np.append(starts[1:], len(doc))
    total = contrib[starts].copy()  # a group's first entry is always accepted
    for g in np.flatnonzero(ends - starts > 1).tolist():
        a, b = int(starts[g]), int(ends[g])
        consumed, pool = set(), {}
        acc = 0.0
        for i in range(a, b):
            w = int(wrd[i])
            if w in consumed:
                continue
            n = int(node[i])
            if n in pool:
                if pool[n] <= 0:
                    continue  # this node's pool is used up (zero_to_one.rs:104-109)
                pool[n] -= 1
            else:
                pool[n] = int(tf[i]) - 1
            consumed.add(w)
            acc = float(q(acc + contrib[i]))
        total[g] = acc
    # A document's score: the largest of its fields' sums (zero_to_one.rs:122).
    g_doc = doc[starts]
    docs = np.unique(g_doc)
    best = np.zeros(len(docs), np.float64)
    np.maximum.at(best, np.searchsorted(docs, g_doc), total)
    return docs, best
