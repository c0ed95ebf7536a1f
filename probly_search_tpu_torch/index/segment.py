"""Immutable index segments — the TPU-native replacement for the trie.

The reference stores its inverted index as a per-char trie of arena-allocated
nodes with intrusive linked lists (`reference src/index.rs:363-452`).
That layout is pointer-chasing and scalar — hostile to XLA.  This engine
replaces it wholesale with an LSM-style list of immutable **segments**, each a
structure-of-arrays:

* ``terms``      — lexicographically sorted unique term strings (host side).
  Sorting is by Unicode code point, which equals Rust's byte-wise ``String``
  ordering for UTF-8.  Prefix expansion (`query.rs:109-147`) becomes two
  binary searches yielding a contiguous ``[lo, hi)`` range.
* ``term_lens``  — per-term byte length (BM25's expansion boost and
  zero-to-one's length matching use byte lengths, `bm25.rs:51`,
  `zero_to_one.rs:57`).
* ``offsets``    — CSR offsets, ``int64[T + 1]``.
* ``post_doc``   — posting doc slots, ``int32[P]``, sorted within each term.
* ``post_tf``    — per-field term frequency, ``int32[P, F]`` (mirrors
  ``DocumentPointer.term_frequency``, `index.rs:360`).
* ``post_occ``   — total occurrences per posting = row-sum of ``post_tf``.
  The reference inserts one posting pointer per term *occurrence*
  (`index.rs:119`), so its ``count_documents`` (`index.rs:282-297`) returns
  the number of live pointers = sum over live docs of occurrence counts.
  This engine de-duplicates postings per (term, doc) — semantically equal
  because duplicate pointers carry identical tf vectors and the query's
  max-merge collapses them (`query.rs:150-164`) — and defines
  ``df(term) = sum(post_occ[range][alive])`` to reproduce the reference's
  df numerics bit-for-bit (this matters for BM25's clamp, `bm25.rs:41`).

Mutation model (mirrors fast-insert / latent-delete, `index.rs:15-16`):
adds accumulate in a host-side pending buffer and flush into a new delta
segment; removals only flip a liveness bit; ``vacuum`` merges all segments
with dead postings dropped (the analogue of ``vacuum_node`` pruning,
`index.rs:202-241`).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _needs_escape(terms) -> bool:
    # One join + two C-level scans beats a per-term python loop (probe
    # batches reach ~50k terms per serving window).
    s = "\x02".join(terms)
    return "\x00" in s or "\x01" in s


def _escape_one(t: str) -> str:
    return t.replace("\x01", "\x01\x02").replace("\x00", "\x01\x01")


def _unescape_one(t: str) -> str:
    # "\x01\x01" substrings always align to escape-unit boundaries (a \x01
    # only ever starts a unit), so pairwise left-to-right replace decodes.
    return t.replace("\x01\x01", "\x00").replace("\x01\x02", "\x01")


def escape_terms_list(terms):
    """Order-preserving NUL escape, applied only when needed.

    NumPy fixed-width unicode (``<U``) arrays treat trailing NULs as
    padding, so two terms differing only by trailing ``\\x00`` would alias
    after conversion (and their postings would merge).  The escape maps
    ``\\x00 -> \\x01\\x01`` and ``\\x01 -> \\x01\\x02`` — an order-preserving,
    prefix-preserving injection whose output never contains NUL, making the
    ``<U`` conversion lossless.  For terms without ``\\x00``/``\\x01`` the
    escape is the identity, so escaped tables and raw probes (or vice versa)
    stay mutually consistent — each side applies the escape independently,
    gated on a cheap containment check.
    """
    if _needs_escape(terms):
        return [_escape_one(t) for t in terms]
    return list(terms) if not isinstance(terms, list) else terms


def escape_terms_fixed(terms) -> np.ndarray:
    """``escape_terms_list`` + sorted-order-preserving ``<U`` conversion —
    the safe way to build a vectorized (searchsorted-able) term table."""
    return np.asarray(escape_terms_list(terms), dtype=np.str_)


def probe_terms_fixed(terms):
    """(escaped ``<U`` probe array, utf-8 byte length per term) for a list
    of raw probe terms.  Byte lengths are always of the RAW terms (scoring
    uses them); vectorized on the common no-escape path."""
    if _needs_escape(terms):
        blen = np.fromiter(
            (len(t.encode("utf-8")) for t in terms), np.int64, count=len(terms)
        )
        arr = np.asarray([_escape_one(t) for t in terms], dtype=np.str_)
    else:
        arr = np.asarray(terms, dtype=np.str_)
        blen = (
            np.char.str_len(np.char.encode(arr, "utf-8")).astype(np.int64)
            if len(terms)
            else np.zeros(0, np.int64)
        )
    return arr, blen


@dataclass
class Segment:
    """One immutable sorted-term + CSR-postings segment."""

    terms: List[str]  # sorted unique terms
    term_lens: np.ndarray  # int32[T] — utf-8 byte length per term
    offsets: np.ndarray  # int64[T+1]
    post_doc: np.ndarray  # int32[P] — doc slot per posting
    post_tf: np.ndarray  # int32[P, F]
    post_occ: np.ndarray  # int32[P] — total occurrences (sum of tf over fields)

    @property
    def num_terms(self) -> int:
        return len(self.terms)

    @property
    def num_postings(self) -> int:
        return int(self.post_doc.shape[0])

    @property
    def num_fields(self) -> int:
        return int(self.post_tf.shape[1])

    # -- lookups -------------------------------------------------------------

    def find_term(self, term: str) -> int:
        """Exact-term lookup; -1 if absent (replaces
        ``find_inverted_index_node``, index.rs:300-318)."""
        i = bisect_left(self.terms, term)
        if i < len(self.terms) and self.terms[i] == term:
            return i
        return -1

    def prefix_range(self, prefix: str) -> Tuple[int, int]:
        """Contiguous [lo, hi) range of terms with the given prefix — the
        trie-DFS expansion (`query.rs:109-147`) as two binary searches."""
        n = len(prefix)
        lo = bisect_left(self.terms, prefix, key=lambda t: t[:n])
        hi = bisect_right(self.terms, prefix, key=lambda t: t[:n])
        return lo, hi

    def postings(self, tid: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(doc_slots, tf, occ) arrays for one term id."""
        s, e = int(self.offsets[tid]), int(self.offsets[tid + 1])
        return self.post_doc[s:e], self.post_tf[s:e], self.post_occ[s:e]


def build_segment(
    rows_term: Sequence[str],
    rows_doc: np.ndarray,
    rows_tf: np.ndarray,
    num_fields: int,
) -> Segment:
    """Build a segment from unsorted (term, doc_slot, tf[F]) rows.

    This is the host reference implementation of the build pipeline
    (tokenize -> sort by (term, doc) -> CSR pack).

    INVARIANT: ``post_doc`` is ascending within every term's posting range
    (the lexsort below; bulk.py's sorted-unique pack and merge_segments ->
    build_segment preserve it).  The device merge kernel relies on this —
    gathered posting chunks are pre-sorted runs, so the fused kernel merges
    rather than sorts (ops/pallas_merge.py).
    """
    P = len(rows_term)
    if P == 0:
        return empty_segment(num_fields)
    rows_doc = np.asarray(rows_doc, dtype=np.int32)
    rows_tf = np.asarray(rows_tf, dtype=np.int32).reshape(P, num_fields)

    # Sort rows by (term, doc).  Terms are interned to sorted unique ids first
    # so the heavy sort runs on integers (numpy), not Python strings.
    uniq_terms, term_ids = np.unique(np.asarray(rows_term, dtype=object), return_inverse=True)
    order = np.lexsort((rows_doc, term_ids))
    term_ids = term_ids[order]
    post_doc = rows_doc[order]
    post_tf = rows_tf[order]

    # CSR offsets via counting each term's postings.
    T = len(uniq_terms)
    counts = np.bincount(term_ids, minlength=T)
    offsets = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    terms = [str(t) for t in uniq_terms]
    term_lens = np.array([len(t.encode("utf-8")) for t in terms], dtype=np.int32)
    post_occ = post_tf.sum(axis=1, dtype=np.int32)
    return Segment(
        terms=terms,
        term_lens=term_lens,
        offsets=offsets,
        post_doc=post_doc,
        post_tf=post_tf,
        post_occ=post_occ,
    )


def empty_segment(num_fields: int) -> Segment:
    return Segment(
        terms=[],
        term_lens=np.zeros(0, dtype=np.int32),
        offsets=np.zeros(1, dtype=np.int64),
        post_doc=np.zeros(0, dtype=np.int32),
        post_tf=np.zeros((0, num_fields), dtype=np.int32),
        post_occ=np.zeros(0, dtype=np.int32),
    )


def merge_segments(
    segments: Sequence[Segment],
    num_fields: int,
    alive: Optional[np.ndarray] = None,
    slot_remap: Optional[np.ndarray] = None,
) -> Segment:
    """Merge segments into one; optionally drop postings of dead doc slots
    and remap doc slots (used by ``vacuum``; `index.rs:194-241` analogue).

    Routine (non-vacuum) merges pass ``alive=None`` so latently-deleted
    postings are retained — the reference keeps removed docs' postings in the
    trie until vacuum, which is observable through term expansion
    (`query.rs:136` checks ``first_doc.is_some()`` regardless of removal).

    Fully vectorized on integer ids: strings are touched only at the
    term-dictionary level (T entries), never per posting — a (term, doc)
    pair exists in exactly one segment (a doc's postings live in one
    segment; within a segment they are unique), so the merge is a
    concatenate + integer lexsort + CSR re-pack.
    """
    live_segs = [s for s in segments if s.num_postings]
    if not live_segs:
        return empty_segment(num_fields)
    if len(live_segs) == 1 and alive is None and slot_remap is None:
        s = live_segs[0]
        return Segment(
            terms=list(s.terms),
            term_lens=s.term_lens.copy(),
            offsets=s.offsets.copy(),
            post_doc=s.post_doc.copy(),
            post_tf=s.post_tf.copy(),
            post_occ=s.post_occ.copy(),
        )

    # Escaped interning: a plain <U conversion would alias terms differing
    # only by trailing NULs and merge their postings (see escape_terms_list).
    escaped = any(_needs_escape(s.terms) for s in live_segs)
    seg_term_arrs = [
        np.asarray([_escape_one(t) for t in s.terms] if escaped else s.terms, dtype=np.str_)
        for s in live_segs
    ]
    terms_g = np.unique(np.concatenate(seg_term_arrs))
    T = len(terms_g)

    gtid_parts: List[np.ndarray] = []
    doc_parts: List[np.ndarray] = []
    tf_parts: List[np.ndarray] = []
    for s, term_arr in zip(live_segs, seg_term_arrs):
        local_to_global = np.searchsorted(terms_g, term_arr)
        reps = np.diff(s.offsets).astype(np.int64)
        gtid = np.repeat(local_to_global, reps)
        doc = s.post_doc
        tf = s.post_tf
        if alive is not None:
            keep = alive[doc]
            gtid, doc, tf = gtid[keep], doc[keep], tf[keep]
        if slot_remap is not None:
            doc = slot_remap[doc].astype(np.int32)
        gtid_parts.append(gtid)
        doc_parts.append(doc)
        tf_parts.append(tf)

    gtid = np.concatenate(gtid_parts)
    if len(gtid) == 0:
        return empty_segment(num_fields)
    post_doc = np.concatenate(doc_parts)
    post_tf = np.concatenate(tf_parts)
    order = np.lexsort((post_doc, gtid))
    gtid = gtid[order]
    post_doc = post_doc[order]
    post_tf = post_tf[order]

    counts = np.bincount(gtid, minlength=T)
    offsets = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    # Terms with every posting dropped (vacuumed-away) are pruned, like the
    # reference's vacuum_node subtree removal (index.rs:216-239).
    if (counts == 0).any():
        keep_t = counts > 0
        terms_g = terms_g[keep_t]
        offsets = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts[keep_t])]
        )
    terms = [_unescape_one(str(t)) if escaped else str(t) for t in terms_g]
    return Segment(
        terms=terms,
        term_lens=np.fromiter(
            (len(t.encode("utf-8")) for t in terms), dtype=np.int32, count=len(terms)
        ),
        offsets=offsets,
        post_doc=post_doc.astype(np.int32, copy=False),
        post_tf=post_tf.astype(np.int32, copy=False).reshape(len(post_doc), num_fields),
        post_occ=post_tf.sum(axis=1, dtype=np.int32).reshape(-1),
    )
