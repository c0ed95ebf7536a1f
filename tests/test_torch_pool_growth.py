"""The port's planner pools grow in place (``index/device._append_rows``).

Each column of the term pool and of the query-plan pool is a view of the
used prefix of a buffer with spare rows; an append writes past it and only
a full buffer is reallocated.  Three things must hold, on the CPU:

* the pools equal one concatenation of the rows appended to them, bit for
  bit, and the grown pools plan what a fresh engine plans in one window;
* a term is found by its raw string in the pool's dict as the escaped
  ``<U`` probe found it: NULs, ``\\x01``, non-ASCII letters and prefixes of
  other terms included, against the JAX package's planner;
* a row once written never changes, so a view a reader took earlier keeps
  its rows across a reallocation.
"""

import random

import numpy as np
import pytest

import probly_search_tpu.index.device as jdev
from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu import bm25 as jbm25
import probly_search_tpu_torch as pt
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.index.segment import escape_terms_fixed
from probly_search_tpu_torch.utils.metrics import metrics

from .test_torch_planner import port_index
from .util import tokenizer

TABLES = ("jquery", "words", "nchunks", "njobs", "has_range")
# Term-pool columns with one row per job (the rest: one per term, or per chunk).
JOB_COLUMNS = ("start", "len", "scale", "range", "prune_ub", "prune_topv", "prune_cub_min")


def _vocab(rng, n):
    return ["".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 4))) for _ in range(n)]


def _engine(seed=5, n_docs=400):
    rng = random.Random(seed)
    vocab = _vocab(rng, 400)
    texts = [" ".join(rng.choice(vocab) for _ in range(rng.randint(2, 10))) for _ in range(n_docs)]
    ix = pt.Index(1, config=pt.IndexConfig(chunk_size=128), device="cpu")
    ix.add_documents_columnar(list(range(n_docs)), [texts])
    return pt.DeviceIndex(ix, device="cpu"), vocab


def _windows(vocab, n_windows=24, size=40, seed=9):
    """Windows of queries never seen before, each bringing terms of its own
    (a fresh slice of the vocabulary) beside ones seen before."""
    rng = random.Random(seed)
    per = len(vocab) // n_windows
    out, seen = [], set()
    for w in range(n_windows):
        fresh = vocab[w * per:(w + 1) * per]
        window = []
        while len(window) < size:
            seen_terms = vocab[: (w + 1) * per]
            q = " ".join([rng.choice(fresh)] + rng.sample(seen_terms, rng.randint(0, 2)))
            if q not in seen:
                seen.add(q)
                window.append(q)
        out.append(window)
    return out


def _pools(dix):
    (pool,) = dix._plan_pools.values()
    (qp,) = dix._qplan_pools.values()
    return pool, qp


def _grows():
    return metrics.snapshot()["histograms"].get("plan/pool_grow", {"count": 0, "items": 0})


def test_pools_equal_one_concatenation_and_one_window(monkeypatch):
    dix, vocab = _engine()
    appended = {}  # (pool id, column) -> [rows before the first append, rows appended...]
    calls = []
    real = pdev._append_rows

    def spy(pool, name, rows, limit=0):
        appended.setdefault((id(pool), name), [pool[name].copy()]).append(np.array(rows))
        calls.append(len(rows))
        real(pool, name, rows, limit)

    monkeypatch.setattr(pdev, "_append_rows", spy)
    windows = _windows(vocab)
    metrics.reset()
    for window in windows:
        dix.plan_batch(window, tokenizer, pt.bm25.new())
    pool, qp = _pools(dix)
    assert pool["prune_enabled"]
    for p in (pool, qp):
        cols = list(p["bufs"])
        assert len(cols) == (12 if p is pool else 7), cols
        for name in cols:
            want = np.concatenate(appended[(id(p), name)])
            got = p[name]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert got.base is p["bufs"][name]  # a view of the buffer's used prefix
    g = _grows()
    appends = sum(1 for n in calls if n)
    assert 1 <= g["count"] < appends, (g, appends)

    everything = [q for w in windows for q in w]
    grown, _ = dix.plan_batch(everything, tokenizer, pt.bm25.new())
    fresh_dix, _ = _engine()
    fresh, _ = fresh_dix.plan_batch(everything, tokenizer, pt.bm25.new())
    for name in TABLES:
        np.testing.assert_array_equal(getattr(grown, name), getattr(fresh, name), err_msg=name)
    # Term ids follow first sight, so the pool rows differ; the rows they
    # index carry the same jobs and bounds.
    fpool, _ = _pools(fresh_dix)
    for name in JOB_COLUMNS:
        np.testing.assert_array_equal(
            pool[name][grown.pool_rows], fpool[name][fresh.pool_rows], err_msg=name
        )

    def chunk_bounds(p, rows):
        ends = np.append(p["prune_cub_off"][1:], len(p["prune_cub"]))
        return [p["prune_cub"][p["prune_cub_off"][r]:ends[r]] for r in rows]

    for a, b in zip(chunk_bounds(pool, grown.pool_rows), chunk_bounds(fpool, fresh.pool_rows)):
        np.testing.assert_array_equal(a, b)


EDGE_TERMS = [
    "ab", "ab\x00", "ab\x00\x00", "a\x00b", "ab\x01", "ab\x01\x02", "\x01", "\x00z",
    "abc", "abcd", "é", "éa", "ä\x00", "über", "ü", "日本", "日本語",
]


def test_dict_lookup_finds_edge_terms_as_the_escaped_probe():
    rng = random.Random(11)
    filler = _vocab(rng, 60)
    texts = [
        " ".join(rng.sample(EDGE_TERMS, rng.randint(1, 4)) + rng.sample(filler, rng.randint(0, 3)))
        for _ in range(300)
    ]
    jix = JIndex(1, config=JConfig(chunk_size=128))
    jix.add_documents_columnar(list(range(len(texts))), [texts])
    p, j = pt.DeviceIndex(port_index(jix), device="cpu"), jdev.DeviceIndex(jix)
    # Each term alone, then pairs and unseen terms, over several windows so
    # the pool's ids grow between lookups.
    windows = [
        EDGE_TERMS[:6], EDGE_TERMS[6:],
        [f"{a} {b}" for a, b in zip(EDGE_TERMS, EDGE_TERMS[::-1])],
        ["ab\x00\x00\x00", "zz\x00", "ab\x01\x01", "a", "é\x00", "日"] + EDGE_TERMS[::2],
    ]
    for window in windows:
        pp, pfb = p.plan_batch(window, tokenizer, pt.bm25.new())
        jp, jfb = j.plan_batch(window, tokenizer, jbm25.new())
        assert pfb == jfb
        for name in TABLES + ("pool_rows",):
            np.testing.assert_array_equal(getattr(pp, name), getattr(jp, name), err_msg=name)
    ids = _pools(p)[0]["ids"]
    assert ids == j._plan_pools[jdev._scorer_cache_key(jbm25.new())]["ids"]
    # The escaped <U probe over the same pool finds every term at its id.
    terms = list(ids)
    esc = escape_terms_fixed(terms)
    order = np.argsort(esc)
    probe = escape_terms_fixed(EDGE_TERMS)
    at = np.searchsorted(esc[order], probe)
    assert (esc[order][at] == probe).all()
    np.testing.assert_array_equal(
        np.array([ids[terms[i]] for i in order[at]]), [ids[t] for t in EDGE_TERMS]
    )


def test_written_rows_stay_across_a_reallocation():
    dix, vocab = _engine(seed=6)
    windows = _windows(vocab, n_windows=8, size=30, seed=3)
    dix.plan_batch(windows[0], tokenizer, pt.bm25.new())
    pools = _pools(dix)
    columns = [(p, name) for p in pools for name in p["bufs"]]
    views = [p[name] for p, name in columns]
    copies = [v.copy() for v in views]
    bufs = [p["bufs"][name] for p, name in columns]
    # One window larger than every buffer's spare rows: each column moves.
    dix.plan_batch([q for w in windows[1:] for q in w], tokenizer, pt.bm25.new())
    for (p, name), view, copy, buf in zip(columns, views, copies, bufs):
        assert p["bufs"][name] is not buf, name
        np.testing.assert_array_equal(view, copy, err_msg=name)
        np.testing.assert_array_equal(p[name][: len(view)], view, err_msg=name)


@pytest.mark.parametrize("limit", [0, 5])
def test_append_rows_grows_by_twice_the_rows_used_up_to_a_limit(limit):
    col = {"bufs": {}, "x": np.zeros((0, 2), np.int32)}
    first = np.arange(6, dtype=np.int32).reshape(3, 2)
    pdev._append_rows(col, "x", first, limit)
    assert len(col["bufs"]["x"]) == (5 if limit else 6)
    view = col["x"]
    pdev._append_rows(col, "x", first[:1] + 10, limit)  # fits: written in place
    assert col["x"].base is view.base and len(col["x"]) == 4
    pdev._append_rows(col, "x", first + 20, limit)  # 7 rows: a new buffer
    assert col["x"].base is not view.base and len(col["bufs"]["x"]) == (7 if limit else 14)
    np.testing.assert_array_equal(view, first)
    np.testing.assert_array_equal(col["x"], np.concatenate([first, first[:1] + 10, first + 20]))
