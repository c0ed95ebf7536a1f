"""Lazy g++ build + ctypes bindings for the native host runtime.

The torch port's copy of ``probly_search_tpu/native/build.py``.  The library
is built at first use into ``build/torch_native/`` beside the package and
named by a hash of its source and flags, so an unchanged tree reuses it and
an edited one rebuilds.  It is compiled without ``-march=native``: a library
built on one host must load on another (the code does integer and byte work
only, so results do not depend on the instruction set).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().with_name("psearch_native.cpp")
BUILD_DIR = _SRC.parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libpsearch_native_{h.hexdigest()[:16]}.so"


class _TokenizeResult(ctypes.Structure):
    _fields_ = [
        ("term_ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_tokens", ctypes.c_int64),
        ("doc_token_counts", ctypes.POINTER(ctypes.c_int64)),
        ("terms_blob", ctypes.POINTER(ctypes.c_char)),
        ("terms_blob_len", ctypes.c_int64),
        ("term_byte_lens", ctypes.POINTER(ctypes.c_int32)),
        ("n_terms", ctypes.c_int64),
    ]


class _CsrResult(ctypes.Structure):
    _fields_ = [
        ("terms_blob", ctypes.POINTER(ctypes.c_char)),
        ("terms_blob_len", ctypes.c_int64),
        ("term_byte_lens", ctypes.POINTER(ctypes.c_int32)),
        ("n_terms", ctypes.c_int64),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("post_doc", ctypes.POINTER(ctypes.c_int32)),
        ("post_tf", ctypes.POINTER(ctypes.c_int32)),
        ("n_postings", ctypes.c_int64),
        ("doc_token_counts", ctypes.POINTER(ctypes.c_int64)),
    ]


class _CsrMultiResult(ctypes.Structure):
    _fields_ = [
        ("terms_blob", ctypes.POINTER(ctypes.c_char)),
        ("terms_blob_len", ctypes.c_int64),
        ("term_byte_lens", ctypes.POINTER(ctypes.c_int32)),
        ("n_terms", ctypes.c_int64),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("post_doc", ctypes.POINTER(ctypes.c_int32)),
        ("post_tf", ctypes.POINTER(ctypes.c_int32)),
        ("n_postings", ctypes.c_int64),
        ("cell_token_counts", ctypes.POINTER(ctypes.c_int64)),
    ]


def _compile(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        return False
    os.replace(tmp, so)
    return True


def _build() -> Optional[ctypes.CDLL]:
    so = library_path()
    if not so.exists() and not _compile(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        # Built elsewhere against another C++ runtime: rebuild here once.
        if not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
    lib.psearch_tokenize_index.restype = ctypes.POINTER(_TokenizeResult)
    lib.psearch_tokenize_index.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.psearch_free_result.argtypes = [ctypes.POINTER(_TokenizeResult)]
    lib.psearch_free_result.restype = None
    lib.psearch_tokenize_csr.restype = ctypes.POINTER(_CsrResult)
    lib.psearch_tokenize_csr.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.psearch_free_csr.argtypes = [ctypes.POINTER(_CsrResult)]
    lib.psearch_free_csr.restype = None
    lib.psearch_tokenize_csr_multi.restype = ctypes.POINTER(_CsrMultiResult)
    lib.psearch_tokenize_csr_multi.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.psearch_intern_csr_multi.restype = ctypes.POINTER(_CsrMultiResult)
    lib.psearch_intern_csr_multi.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.psearch_free_csr_multi.argtypes = [ctypes.POINTER(_CsrMultiResult)]
    lib.psearch_free_csr_multi.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is None and not _failed:
            _lib = _build()
            _failed = _lib is None
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def tokenize_index_native(
    texts: List[str],
) -> Optional[Tuple[np.ndarray, np.ndarray, List[str], np.ndarray]]:
    """Tokenize + intern a column of texts natively.

    Returns (term_ids_per_occurrence int32[N] — ids into the SORTED unique
    term table, tokens_per_doc int64[D], sorted_terms list[str],
    term_byte_lens int32[T]), or None when the native lib is unavailable.
    Tokenization is the default single-space split with empty-token
    filtering; callers must only use this for the default tokenizer.
    """
    lib = get_lib()
    if lib is None:
        return None
    # Concatenate WITHOUT separators; offsets delimit docs (a separator char
    # could collide with text content).
    encoded = [t.encode("utf-8") for t in texts]
    offs = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offs[1:])
    blob = b"".join(encoded)

    res = lib.psearch_tokenize_index(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(texts)
    )
    try:
        r = res.contents
        n_tok = int(r.n_tokens)
        n_terms = int(r.n_terms)
        term_ids = np.ctypeslib.as_array(r.term_ids, shape=(max(n_tok, 1),))[:n_tok].copy()
        counts = np.ctypeslib.as_array(r.doc_token_counts, shape=(max(len(texts), 1),))[
            : len(texts)
        ].copy()
        blob_out = ctypes.string_at(r.terms_blob, int(r.terms_blob_len))
        term_lens = np.ctypeslib.as_array(r.term_byte_lens, shape=(max(n_terms, 1),))[
            :n_terms
        ].copy()
        # Slice the blob by the explicit byte lengths (one NUL separator
        # after each term) — splitting on NUL would corrupt terms that
        # legally CONTAIN a NUL byte (the tokenizer only splits on spaces).
        starts = np.zeros(n_terms, dtype=np.int64)
        if n_terms:
            np.cumsum(term_lens[:-1] + 1, out=starts[1:])
        terms = [
            blob_out[s : s + l].decode("utf-8")
            for s, l in zip(starts.tolist(), term_lens.tolist())
        ]
    finally:
        lib.psearch_free_result(res)
    return term_ids, counts, terms, term_lens


def tokenize_csr_native(texts: List[str]):
    """One-shot native CSR build for a single-field column: tokenize +
    intern + per-(term, doc) tf + counting-sort CSR pack, O(tokens +
    postings) in C++ (the numpy pair-packing path costs multiple
    8M-element sorts per 1M docs).

    Returns ``(terms list[str] (sorted), term_lens int32[T],
    offsets int64[T+1], post_doc int32[P] (batch doc index),
    post_tf int32[P], tokens_per_doc int64[D])`` or None when the native
    lib is unavailable.  Default whitespace tokenizer semantics only.
    """
    lib = get_lib()
    if lib is None:
        return None
    encoded = [t.encode("utf-8") for t in texts]
    offs = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offs[1:])
    blob = b"".join(encoded)

    res = lib.psearch_tokenize_csr(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(texts)
    )
    try:
        r = res.contents
        T = int(r.n_terms)
        P = int(r.n_postings)
        term_lens = np.ctypeslib.as_array(r.term_byte_lens, shape=(max(T, 1),))[:T].copy()
        offsets = np.ctypeslib.as_array(r.offsets, shape=(T + 1,)).copy()
        post_doc = np.ctypeslib.as_array(r.post_doc, shape=(max(P, 1),))[:P].copy()
        post_tf = np.ctypeslib.as_array(r.post_tf, shape=(max(P, 1),))[:P].copy()
        counts = np.ctypeslib.as_array(r.doc_token_counts, shape=(max(len(texts), 1),))[
            : len(texts)
        ].copy()
        blob_out = ctypes.string_at(r.terms_blob, int(r.terms_blob_len))
        starts = np.zeros(T, dtype=np.int64)
        if T:
            np.cumsum(term_lens[:-1] + 1, out=starts[1:])
        terms = [
            blob_out[s : s + l].decode("utf-8")
            for s, l in zip(starts.tolist(), term_lens.tolist())
        ]
    finally:
        lib.psearch_free_csr(res)
    return terms, term_lens, offsets, post_doc, post_tf, counts


def _unpack_csr_multi(lib, res, n_docs: int, n_fields: int):
    try:
        r = res.contents
        T = int(r.n_terms)
        P = int(r.n_postings)
        F = n_fields
        term_lens = np.ctypeslib.as_array(r.term_byte_lens, shape=(max(T, 1),))[:T].copy()
        offsets = np.ctypeslib.as_array(r.offsets, shape=(T + 1,)).copy()
        post_doc = np.ctypeslib.as_array(r.post_doc, shape=(max(P, 1),))[:P].copy()
        post_tf = (
            np.ctypeslib.as_array(r.post_tf, shape=(max(P * F, 1),))[: P * F]
            .copy()
            .reshape(P, F)
        )
        n_cells = n_docs * n_fields
        counts = np.ctypeslib.as_array(
            r.cell_token_counts, shape=(max(n_cells, 1),)
        )[:n_cells].copy().reshape(n_docs, n_fields)
        blob_out = ctypes.string_at(r.terms_blob, int(r.terms_blob_len))
        # Terms may legally contain NULs (the tokenizer only splits on
        # spaces), but the blob has exactly T separator NULs when none do —
        # then one decode + split beats T per-term decodes ~3x.
        if blob_out.count(b"\x00") == T:
            terms = blob_out.decode("utf-8").split("\x00")[:-1]
        else:
            starts = np.zeros(T, dtype=np.int64)
            if T:
                np.cumsum(term_lens[:-1] + 1, out=starts[1:])
            terms = [
                blob_out[s : s + l].decode("utf-8")
                for s, l in zip(starts.tolist(), term_lens.tolist())
            ]
    finally:
        lib.psearch_free_csr_multi(res)
    return terms, term_lens, offsets, post_doc, post_tf, counts


def tokenize_csr_multi_native(columns: List[List[str]]):
    """One-shot native CSR build over F field columns of single-value text
    cells: tokenize + shared intern + per-(term, doc) F-wide tf vectors +
    counting-sort CSR pack (O(tokens + postings), doc order preserved per
    term — the CSR invariant).  Default whitespace tokenizer semantics only.

    Returns ``(terms list[str] (sorted), term_lens int32[T],
    offsets int64[T+1], post_doc int32[P] (batch doc index),
    post_tf int32[P, F], cell_token_counts int64[D, F])`` or None when the
    native lib is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    F = len(columns)
    n_docs = len(columns[0]) if F else 0
    # Doc-major cells: cell(d, f) — the native pass needs each doc's fields
    # adjacent to emit one posting row per (term, doc).
    if F == 1:
        encoded = [t.encode("utf-8") for t in columns[0]]
    else:
        encoded = [
            columns[f][d].encode("utf-8") for d in range(n_docs) for f in range(F)
        ]
    offs = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum(
        np.fromiter((len(e) for e in encoded), np.int64, len(encoded)),
        out=offs[1:],
    )
    blob = b"".join(encoded)
    res = lib.psearch_tokenize_csr_multi(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_docs, F
    )
    return _unpack_csr_multi(lib, res, n_docs, F)


def intern_csr_multi_native(tokens_per_cell: List[List[bytes]], n_docs: int, n_fields: int):
    """Native intern + count + CSR pack over PRE-TOKENIZED cells (custom
    tokenizers tokenize in Python; everything downstream stays native).

    ``tokens_per_cell`` is doc-major (cell(d, f) = d * F + f) and each
    token is utf-8 bytes with empty tokens already filtered (the callers'
    contract, index.rs:100-110).  Returns the same tuple as
    ``tokenize_csr_multi_native`` — note cell_token_counts are the TOTAL
    tokens per cell (multi-value cells concatenate their values' tokens;
    the caller tracks last-value lengths itself).
    """
    lib = get_lib()
    if lib is None:
        return None
    flat = [t for cell in tokens_per_cell for t in cell]
    tok_offs = np.zeros(len(flat) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in flat], out=tok_offs[1:])
    blob = b"".join(flat)
    cell_counts = np.fromiter(
        (len(c) for c in tokens_per_cell), dtype=np.int64, count=len(tokens_per_cell)
    )
    res = lib.psearch_intern_csr_multi(
        blob,
        tok_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cell_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_docs,
        n_fields,
    )
    return _unpack_csr_multi(lib, res, n_docs, n_fields)
