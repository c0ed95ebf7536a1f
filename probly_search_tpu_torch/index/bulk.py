"""Bulk (columnar) document ingestion.

The reference indexes one document at a time by walking the trie per term
occurrence (`reference src/index.rs:77-158`).  The TPU-native build is
a batched pipeline (SURVEY §7): tokenize -> intern -> sort by (term, doc) ->
segment-sum term frequencies -> CSR pack, vectorized on host (NumPy) with a
native C++ tokenize+intern fast path (native/psearch_native.cpp).

End-state equivalence with sequential ``add_document`` calls: field stats
are overwritten per add (index.rs:112-114), so after N adds
``sum = total tokens`` and ``avg = sum / n_docs`` — exactly what this bulk
path computes.  Golden lifecycle behavior is therefore identical, which
tests/test_bulk.py asserts directly against the sequential path.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from ..models.base import DocumentDetails
from .segment import Segment, _unescape_one, escape_terms_fixed


def _alloc_doc_rows(index, keys, field_length, is_last) -> int:
    """Allocate doc slots for a batch: grow the slot arrays, write
    field_length/liveness rows, register keys and live DocumentDetails.
    ``is_last=None`` means every key is live (no intra-batch duplicates —
    the sequential flush path's contract).  Returns the base slot."""
    n_new = len(keys)
    F = field_length.shape[1]
    base_slot = index._next_slot
    need = base_slot + n_new
    if need > len(index._alive):
        new_cap = max(need, len(index._alive) * 2)
        doc_len = np.zeros((new_cap, F), dtype=np.int64)
        doc_len[: len(index._doc_len)] = index._doc_len
        alive = np.zeros(new_cap, dtype=bool)
        alive[: len(index._alive)] = index._alive
        index._doc_len = doc_len
        index._alive = alive
    index._doc_len[base_slot : base_slot + n_new] = field_length
    index._alive[base_slot : base_slot + n_new] = True if is_last is None else is_last
    index._next_slot = base_slot + n_new
    index._slot_to_key.extend(keys)
    docs = index._docs
    # field_length rows are views into the doc matrix (values are copied
    # forward on growth, so views stay correct); list() pre-extracts the
    # row views in C instead of one numpy __getitem__ per doc.
    rows = list(field_length)
    if is_last is None:
        index._key_to_slot.update(zip(keys, range(base_slot, base_slot + n_new)))
        for k, row in zip(keys, rows):
            docs[k] = DocumentDetails(k, row)
    else:
        for i, k in enumerate(keys):
            if is_last[i]:
                index._key_to_slot[k] = base_slot + i
                docs[k] = DocumentDetails(k, rows[i])
    return base_slot


def bulk_add(index, keys: Sequence[Any], field_texts: Sequence[Sequence[str]], tokenizer) -> None:
    """Add many documents at once from columnar text.

    Args:
      index: the Index (mutated in place).
      keys: document keys, one per doc; keys already present are removed
        first (same semantics as ``add_document`` re-add).
      field_texts: ``field_texts[f][d]`` is the text of field ``f`` for doc
        ``d`` — either one string (the common case) or a sequence of strings
        for multi-valued fields (the ``Vec<&str>`` accessor shape,
        index.rs:90-96).  Multi-value cells reproduce the reference's exact
        bookkeeping: term frequencies accumulate across values, ``sum`` adds
        every value's token count, but ``field_length`` is overwritten per
        value and ends at the LAST value's count (index.rs:112-114).
      tokenizer: the usual callable; empty tokens filtered (index.rs:100-110).
    """
    F = index._num_fields
    n_new = len(keys)
    if F and any(len(col) != n_new for col in field_texts):
        raise ValueError("field_texts columns must match len(keys)")
    if len(field_texts) != F:
        raise ValueError(f"expected {F} field columns, got {len(field_texts)}")

    if n_new == 0:
        return
    # Flush the sequential write buffer FIRST: buffered keys are not yet in
    # _key_to_slot, so the existing-key scan below would miss them.
    index._flush_pending()
    existing = [k for k in keys if k in index._key_to_slot]
    for k in existing:
        index.remove_document(k)

    # Intra-batch duplicate keys: sequential ``add_document`` semantics are
    # "remove then re-add" (core.py), so earlier occurrences become latently
    # dead slots — their postings stay until vacuum, their stats net to
    # zero, and the key lands in the removed set (matching the sequential
    # path's remove_document call on re-add).
    last_of = {k: i for i, k in enumerate(keys)}
    is_last = np.fromiter((last_of[k] == i for i, k in enumerate(keys)), bool, n_new)
    if not is_last.all():
        for i, k in enumerate(keys):
            if not is_last[i]:
                index._removed_keys.add(k)

    _bulk_ingest(index, keys, field_texts, tokenizer, is_last)


def _bulk_ingest(index, keys, field_texts, tokenizer, is_last) -> None:
    """Tokenize-to-segment core shared by ``bulk_add`` and the sequential
    write buffer (``Index._flush_pending``).  Preconditions: doc slots not
    yet allocated, existing keys already removed, ``is_last`` marks
    intra-batch duplicate keys (``None`` = no duplicates, all live).
    Appends one segment, updates field stats, bumps the index version."""
    F = index._num_fields
    n_new = len(keys)

    # --- tokenize + intern per field --------------------------------------
    # Native fast path (C++ tokenizer + interner, native/psearch_native.cpp)
    # applies only to the default whitespace tokenizer; any user-pluggable
    # tokenizer takes the Python path (mirroring the reference's fn-pointer
    # tokenizer extension point, lib.rs:14).
    from ..utils.tokenizers import whitespace_tokenizer as _default_tok

    use_native = tokenizer is _default_tok
    from ..native import (
        intern_csr_multi_native,
        native_available,
        tokenize_csr_multi_native,
        tokenize_index_native,
    )

    # --- native one-shot CSR fast path (any F, any tokenizer) -------------
    # tokenize + intern + tf counting + CSR pack all in one C++ pass
    # (O(tokens + postings)); the numpy pair machinery below costs several
    # 8M-element packed sorts per 1M docs (PERFORMANCE.md r4).  Default
    # tokenizer + single-value cells tokenize natively; custom tokenizers
    # and multi-value cells tokenize in Python (the fn-pointer extension
    # point, lib.rs:14) and feed the pre-tokenized intern+pack pass.
    if F >= 1 and native_available():
        all_str = all(
            isinstance(x, str) for col in field_texts for x in col
        )
        if use_native and all_str:
            out = tokenize_csr_multi_native([list(col) for col in field_texts])
            lens_m = tots_m = out[5] if out is not None else None
        else:
            tokens_per_cell: List[List[bytes]] = []
            lens_m = np.zeros((n_new, F), dtype=np.int64)
            tots_m = np.zeros((n_new, F), dtype=np.int64)
            for d in range(n_new):
                for f in range(F):
                    cell = field_texts[f][d]
                    vals = [cell] if isinstance(cell, str) else list(cell)
                    toks_b: List[bytes] = []
                    last = 0
                    for v in vals:
                        vt = [t for t in tokenizer(v) if t]
                        toks_b.extend(t.encode("utf-8") for t in vt)
                        last = len(vt)
                    tokens_per_cell.append(toks_b)
                    # field_length is overwritten per value -> LAST value's
                    # count (index.rs:112-114); sum accumulates every value.
                    lens_m[d, f] = last if vals else 0
                    tots_m[d, f] = len(toks_b)
            out = intern_csr_multi_native(tokens_per_cell, n_new, F)
        if out is not None:
            terms, term_lens, offsets, post_doc_local, post_tf_m, _counts = out
            field_length = np.asarray(lens_m, np.int64).reshape(n_new, F)
            base_slot = _alloc_doc_rows(index, keys, field_length, is_last)
            n_docs_after = len(index._docs)
            for f in range(F):
                fd = index._fields[f]
                fd.sum += int(tots_m[:, f].sum()) - (
                    0 if is_last is None else int(field_length[~is_last, f].sum())
                )
                fd.avg = fd.sum / float(n_docs_after)
            if len(post_doc_local):
                index._segments.append(
                    Segment(
                        terms=terms,
                        term_lens=np.asarray(term_lens, np.int32),
                        offsets=np.asarray(offsets, np.int64),
                        post_doc=(post_doc_local.astype(np.int64) + base_slot).astype(
                            np.int32
                        ),
                        post_tf=post_tf_m.astype(np.int32),
                        post_occ=post_tf_m.sum(axis=1, dtype=np.int32),
                    )
                )
            index._version += 1
            return

    per_field_occ: List[np.ndarray] = []  # field-local sorted-table ids per occurrence
    per_field_table: List[np.ndarray] = []  # field-local sorted term tables
    per_field_docrep: List[np.ndarray] = []
    field_len_cols: List[np.ndarray] = []  # field_length: LAST value's count
    field_tot_cols: List[np.ndarray] = []  # total tokens over ALL values
    for f in range(F):
        col = field_texts[f]
        multi = any(not isinstance(x, str) for x in col)
        native_out = (
            tokenize_index_native(list(col)) if use_native and not multi else None
        )
        if native_out is not None:
            occ_ids, lens, terms_f, _term_lens = native_out
            # Escaped <U interning: plain conversion would strip trailing
            # NULs and alias distinct terms (segment.escape_terms_fixed).
            table = escape_terms_fixed(terms_f) if terms_f else np.zeros(0, np.str_)
            tots = lens
        else:
            if multi:
                # Normalize cells to value lists; tokenize per value so the
                # per-value bookkeeping (last-value field_length) is exact.
                vals_per_doc = [
                    [cell] if isinstance(cell, str) else list(cell) for cell in col
                ]
                toks_per_doc = []
                lens = np.zeros(n_new, dtype=np.int64)
                tots = np.zeros(n_new, dtype=np.int64)
                for d, vals in enumerate(vals_per_doc):
                    toks: List[str] = []
                    last = 0
                    for v in vals:
                        vt = [t for t in tokenizer(v) if t]
                        toks.extend(vt)
                        last = len(vt)
                    toks_per_doc.append(toks)
                    lens[d] = last if vals else 0
                    tots[d] = len(toks)
            else:
                toks_per_doc = [[t for t in tokenizer(text) if t] for text in col]
                lens = np.fromiter(
                    (len(ts) for ts in toks_per_doc), dtype=np.int64, count=n_new
                )
                tots = lens
            flat = [t for ts in toks_per_doc for t in ts]
            if flat:
                table, occ_ids = np.unique(escape_terms_fixed(flat), return_inverse=True)
            else:
                table = np.zeros(0, np.str_)
                occ_ids = np.zeros(0, np.int64)
        per_field_occ.append(np.asarray(occ_ids, dtype=np.int64))
        per_field_table.append(table)
        per_field_docrep.append(
            np.repeat(np.arange(n_new, dtype=np.int64), np.asarray(tots, np.int64))
        )
        field_len_cols.append(np.asarray(lens, dtype=np.int64))
        field_tot_cols.append(np.asarray(tots, dtype=np.int64))

    field_length = (
        np.stack(field_len_cols, axis=1) if F else np.zeros((n_new, 0), dtype=np.int64)
    )

    # --- allocate doc slots ----------------------------------------------
    base_slot = _alloc_doc_rows(index, keys, field_length, is_last)
    slots = np.arange(base_slot, base_slot + n_new, dtype=np.int64)

    # --- field stats (end-state of sequential bookkeeping; duplicates'
    # earlier occurrences net to zero through the remove) ------------------
    n_docs_after = len(index._docs)
    for f in range(F):
        fd = index._fields[f]
        # Sequential end-state: every add contributes its TOTAL token count
        # (one += per value, index.rs:112-114); each intra-batch duplicate's
        # earlier occurrence is then removed, which subtracts only its
        # (last-value) field_length (index.rs:175-185).
        fd.sum += int(field_tot_cols[f].sum()) - (
            0 if is_last is None else int(field_len_cols[f][~is_last].sum())
        )
        fd.avg = fd.sum / float(n_docs_after)

    # --- merge field-local term tables into one global sorted table -------
    if sum(len(o) for o in per_field_occ) == 0:
        index._version += 1
        return
    if F == 1:
        uniq = per_field_table[0]
        table_maps = [np.arange(len(uniq), dtype=np.int64)]
    else:
        cat = np.concatenate([t for t in per_field_table]) if any(
            len(t) for t in per_field_table
        ) else np.zeros(0, np.str_)
        uniq, inv_tables = np.unique(cat, return_inverse=True)
        table_maps = []
        pos = 0
        for t in per_field_table:
            table_maps.append(inv_tables[pos : pos + len(t)].astype(np.int64))
            pos += len(t)
    T = len(uniq)

    # --- count (term, doc) pairs per field --------------------------------
    pair_keys_parts = []
    pair_field_parts = []
    pair_tf_parts = []
    for f in range(F):
        if len(per_field_occ[f]) == 0:
            continue
        gids = table_maps[f][per_field_occ[f]]
        packed = gids * n_new + per_field_docrep[f]
        u, counts = np.unique(packed, return_counts=True)
        pair_keys_parts.append(u)
        pair_field_parts.append(np.full(len(u), f, dtype=np.int64))
        pair_tf_parts.append(counts.astype(np.int32))

    pair_keys = np.concatenate(pair_keys_parts)
    pair_fields = np.concatenate(pair_field_parts)
    pair_tf = np.concatenate(pair_tf_parts)

    # Group across fields: one posting row per distinct (term, doc).  With
    # one field the per-field keys are already sorted-unique (np.unique
    # output) — re-uniquing 8M keys measured ~6s/1M docs for nothing.
    if len(pair_keys_parts) == 1:
        row_keys = pair_keys
        row_idx = np.arange(len(row_keys), dtype=np.int64)
    else:
        row_keys, row_idx = np.unique(pair_keys, return_inverse=True)
    P = len(row_keys)
    post_tf = np.zeros((P, F), dtype=np.int32)
    post_tf[row_idx, pair_fields] = pair_tf
    post_term = (row_keys // n_new).astype(np.int64)
    post_doc = (slots[row_keys % n_new]).astype(np.int32)

    # row_keys sorted => rows already ordered by (term, doc).
    counts_per_term = np.bincount(post_term, minlength=T)
    offsets = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(counts_per_term, out=offsets[1:])

    # Unescape only when some table actually escaped (clean tables contain
    # no \x01 at all — a vectorized scan beats 100k+ python replace calls),
    # and byte lengths vectorized on the clean path (np.char.encode).
    escaped = bool((np.char.find(uniq, "\x01") >= 0).any()) if T else False
    if escaped:
        terms = [_unescape_one(str(t)) for t in uniq]
        term_lens = np.fromiter(
            (len(t.encode("utf-8")) for t in terms), dtype=np.int32, count=T
        )
    else:
        terms = [str(t) for t in uniq]
        term_lens = (
            np.char.str_len(np.char.encode(uniq, "utf-8")).astype(np.int32)
            if T
            else np.zeros(0, np.int32)
        )
    seg = Segment(
        terms=terms,
        term_lens=term_lens,
        offsets=offsets,
        post_doc=post_doc,
        post_tf=post_tf,
        post_occ=post_tf.sum(axis=1, dtype=np.int32),
    )
    index._segments.append(seg)
    index._version += 1
