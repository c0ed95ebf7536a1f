"""Term-range jobs of the torch port against the JAX engine, on the CPU.

A query term with at least ``range_min_expansions`` expansions plans as one
job per segment over its whole CSR range (word 1 bit 30; word 2 the query
term's UTF-8 byte length), and the device builds each lane's scale from the
aux record array.  Integer work is held bit for bit: job tables (words,
``has_range``, ``njobs``, ``nchunks``), the dispatch tuples and the aux
records.  The range boost is held bit for bit too (both engines evaluate the
same polynomial with the same f32 operations).  Scores and slots follow the
repo's tolerance rule (``probly_search_tpu_torch.testing``: ``rtol=2e-5,
atol=1e-6``; neighbours within it may swap), against the JAX staged step,
the JAX engine and the f64 oracle.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probly_search_tpu.index.device as jdev
from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.ops import fused_merge as fm
from probly_search_tpu_torch.testing import assert_topk_agree

from .util import tokenizer

K = 10


def _pair(segments, deletes=(), **cfg):
    """The JAX Index and the port's (on the CPU) over the same documents, one
    flushed segment per entry of ``segments`` (a list of text lists)."""
    jix = JIndex(1, config=JConfig(**cfg))
    ix = Index(1, config=IndexConfig(**cfg), device="cpu")
    base = 0
    for texts in segments:
        keys = list(range(base, base + len(texts)))
        base += len(texts)
        for x in (jix, ix):
            x.add_documents_columnar(keys, [texts])
            x._flush_pending()
    for key in deletes:
        for x in (jix, ix):
            x.remove_document(key)
    return jix, ix


def _wide_prefix_corpus(seed=5, n=600, segments=1):
    """Terms t000..t299: the prefixes t0, t1, t2 have 100 expansions each,
    past the default range_min_expansions (64); t01 has 10."""
    rng = random.Random(seed)
    vocab = ["t%03d" % i for i in range(300)] + ["x%d" % i for i in range(20)]
    texts = [" ".join(rng.choice(vocab) for _ in range(rng.randint(2, 8))) for _ in range(n)]
    per = n // segments
    return [texts[s * per : (s + 1) * per] for s in range(segments)]


WIDE_QUERIES = ["t0", "t01 t123", "t", "t1 t2", "t005", "t0 t0", "x3 t2", "x4", "zz"]


def _fallback_corpus(segments=1, n=400, seed=11):
    """tests/test_fallback_paths.py TestTermRangeJobs: 30 terms sharing the
    "aa" prefix and unrelated terms, ``segments`` flushed segments."""
    rng = random.Random(seed)
    prefixed = ["aa" + "".join(rng.choice("bcde") for _ in range(j % 3 + 1)) for j in range(30)]
    vocab = sorted(set(prefixed)) + ["zz" + str(j) for j in range(10)] + ["aa"]
    per = n // segments
    return [
        [" ".join(rng.choice(vocab) for _ in range(rng.randint(2, 6))) for _ in range(per)]
        for _ in range(segments)
    ]


FALLBACK_QUERIES = ["aa", "a", "aab", "aa zz1", "zz1", "aa aab zz2", "aa zz3", "zz9 aa a"]


def _plans(jix, ix, queries):
    p, j = DeviceIndex(ix, device="cpu"), jdev.DeviceIndex(jix)
    pp, pfb = p.plan_batch(queries, tokenizer, bm25.new())
    jp, jfb = j.plan_batch(queries, tokenizer, jbm25.new())
    return p, j, pp, pfb, jp, jfb


def _assert_plans_equal(pp, pfb, jp, jfb):
    assert pfb == jfb
    for name in ("jquery", "words", "nchunks", "njobs", "has_range"):
        np.testing.assert_array_equal(getattr(pp, name), getattr(jp, name), err_msg=name)


@pytest.mark.parametrize("segments", [1, 2])
def test_default_config_plans_match_jax(segments):
    """At the default config (range_min_expansions 64) the port plans a
    term of at least 64 expansions as range jobs, as the JAX engine does."""
    jix, ix = _pair(_wide_prefix_corpus(segments=segments))
    assert ix.config.range_min_expansions == 64
    _p, _j, pp, pfb, jp, jfb = _plans(jix, ix, WIDE_QUERIES)
    _assert_plans_equal(pp, pfb, jp, jfb)
    rng_jobs = (pp.words[:, 1] >> 30) & 1
    assert rng_jobs.any() and not rng_jobs.all()
    assert list(pp.has_range) == [True, False, True, True, False, True, True, False, False]


@pytest.mark.parametrize("segments,deletes", [(1, False), (3, False), (3, True)])
def test_fallback_corpus_plans_and_dispatches_match_jax(segments, deletes):
    dels = range(0, 120, 7) if deletes else ()
    jix, ix = _pair(_fallback_corpus(segments), dels, range_min_expansions=4)
    p, j, pp, pfb, jp, jfb = _plans(jix, ix, FALLBACK_QUERIES * 3)
    _assert_plans_equal(pp, pfb, jp, jfb)
    pd = p.pack_dispatches(len(FALLBACK_QUERIES) * 3, pp)
    jd = j.pack_dispatches(len(FALLBACK_QUERIES) * 3, jp)
    assert len(pd) == len(jd)
    assert any(d[4] for d in pd) and not all(d[4] for d in pd)
    for (pi, pj, pnc, pnj, prng), (ji, jj, jnc, jnj, jrng, jcw) in zip(pd, jd):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pj, jj)
        assert (pnc, pnj, prng, p.CHUNK) == (jnc, jnj, jrng, jcw)
        if prng:
            assert pj.shape[0] <= 2  # range classes: at most 2 rows, unpadded


@pytest.mark.parametrize("segments,deletes", [(1, False), (3, True)])
def test_aux_records_match_jax(segments, deletes):
    dels = range(0, 120, 7) if deletes else ()
    jix, ix = _pair(_fallback_corpus(segments), dels, range_min_expansions=4)
    p, j = DeviceIndex(ix, device="cpu"), jdev.DeviceIndex(jix)
    aux = p._aux_rec(bm25.new())
    assert aux.dtype == torch.int32 and aux.device.type == "cpu"
    np.testing.assert_array_equal(aux.numpy(), np.asarray(j._aux_rec(jbm25.new())))
    assert p._aux_rec(bm25.new()) is aux  # built once per scorer


@pytest.mark.parametrize("lo,hi", [(1, 10), (11, 25), (26, 40)])
def test_range_boost_matches_jax(lo, hi):
    """Tolerance: none, bit-equal (same coefficients, same order, f32)."""
    tl, ql = np.meshgrid(np.arange(lo, hi + 1), np.arange(1, 41), indexing="ij")
    keep = ql <= tl
    tl, ql = tl[keep].astype(np.float32), ql[keep].astype(np.float32)
    got = bm25.new().device_range_boost(torch.from_numpy(tl), torch.from_numpy(ql))
    want = np.asarray(jbm25.new().device_range_boost(jnp.asarray(tl), jnp.asarray(ql)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[tl == ql] == 1.0).all()
    # against the boost it replaces: ln(1 + 1 / (1 + delta)), f64
    d = tl - ql
    exact = np.where(d == 0, 1.0, np.log1p(1.0 / (1.0 + d)))
    np.testing.assert_allclose(got.numpy(), exact, rtol=3e-7)


@pytest.mark.parametrize("qlen", [1.0, 3.0])
def test_range_boost_takes_a_conversion_of_word2(qlen):
    """Word 2 of a range job is the query term's byte length as an int; the
    step converts it (3 -> 3.0), never reinterprets its bits."""
    qb = np.array([[int(qlen)]], np.int32)
    jobs = torch.from_numpy(np.array([[[0, 4 | (1 << 30), qb[0, 0]]]], np.int32))
    take, c_start, *_ = pdev.chunk_tables(jobs, 128, 2)
    aux = torch.zeros((4, 256), dtype=torch.int32)
    aux[0] = torch.tensor(2.0).view(torch.int32)
    aux[1] = 5
    scale = pdev._range_scale(
        bm25.new(), aux, jobs, take, c_start, torch.zeros((1, 2)), 128
    )
    want = 2.0 * bm25.new().device_range_boost(torch.tensor(5.0), torch.tensor(qlen))
    assert torch.equal(scale[0, 0], torch.full((128,), float(want)))


def _range_class(j, jp, n_queries):
    return [d for d in j.pack_dispatches(n_queries, jp) if d[4]]


@pytest.mark.parametrize("segments,deletes", [(1, False), (3, True)])
def test_staged_range_step_matches_jax(segments, deletes):
    dels = range(0, 120, 7) if deletes else ()
    jix, ix = _pair(_fallback_corpus(segments), dels, range_min_expansions=4, chunk_size=128)
    p, j, _pp, _pfb, jp, _jfb = _plans(jix, ix, FALLBACK_QUERIES)
    jaux, paux = j._aux_rec(jbm25.new()), p._aux_rec(bm25.new())
    boost = np.ones(1, np.float32)
    classes = _range_class(j, jp, len(FALLBACK_QUERIES))
    assert classes
    for _idxs, jobs_flat, nc, _nj, rng, _cw in classes:
        kw = dict(chunk=p.CHUNK, k=K, qterm_bits=4, num_fields=1, num_chunks=nc)
        jstep = jax.jit(  # one XLA program, as the JAX engine runs it
            lambda *arrays, kw=kw: jdev._query_step_impl(
                jbm25.new(), *kw.values(), *arrays, use_ranges=True
            )
        )
        js, jd = jstep(j.rec, j.field_avg, jnp.asarray(boost), jnp.asarray(jobs_flat), jaux)
        ps, pd = pdev._query_step(
            bm25.new(), p.rec, p.field_avg, torch.from_numpy(boost),
            torch.from_numpy(jobs_flat), paux, use_ranges=True, **kw,
        )
        assert_topk_agree(ps.numpy(), pd.numpy(), np.asarray(js), np.asarray(jd))
        assert (pd >= 0).any()


def _oracle(ix, queries, k=K):
    s = np.full((len(queries), k), -np.inf, np.float32)
    d = np.full((len(queries), k), -1, np.int32)
    for qi, q in enumerate(queries):
        for j, r in enumerate(ix.query(q, bm25.new(), tokenizer, [1.0], top_k=k)):
            s[qi, j] = r.score
            d[qi, j] = ix._key_to_slot[r.key]
    return s, d


@pytest.mark.parametrize("segments,deletes", [(1, False), (3, True)])
def test_query_batch_matches_jax_and_oracle(segments, deletes):
    dels = range(0, 120, 7) if deletes else ()
    jix, ix = _pair(_fallback_corpus(segments), dels, range_min_expansions=4)
    calls = []
    real = pdev.merge_scores_topk_fused

    def spy(*a, **kw):
        calls.append(kw.get("run", 0))
        return real(*a, **kw)

    pdev.merge_scores_topk_fused = spy
    try:
        rows = ix.query_batch(FALLBACK_QUERIES, bm25.new(), tokenizer, top_k=K)
    finally:
        pdev.merge_scores_topk_fused = real
    assert 0 in calls  # the range classes merged through K5's full sort
    jrows = jix.query_batch(FALLBACK_QUERIES, jbm25.new(), tokenizer, top_k=K)
    os_, od = _oracle(ix, FALLBACK_QUERIES)
    for qi, (row, jrow) in enumerate(zip(rows, jrows)):
        ps = np.array([r.score for r in row], np.float32)
        js = np.array([r.score for r in jrow], np.float32)
        pk = np.array([ix._key_to_slot[r.key] for r in row], np.int32)
        jk = np.array([ix._key_to_slot[r.key] for r in jrow], np.int32)
        assert len(row) == len(jrow) == int((od[qi] >= 0).sum()), FALLBACK_QUERIES[qi]
        n = len(row)
        assert_topk_agree(ps[None], pk[None], js[None], jk[None])
        assert_topk_agree(ps[None], pk[None], os_[qi : qi + 1, :n], od[qi : qi + 1, :n])


@pytest.mark.parametrize("query", ["aa", "aab zz1", "a", "aa aab zz2"])
def test_range_and_per_expansion_give_the_same_keys(query):
    """The same corpus planned with and without range jobs agrees."""
    corpus = _fallback_corpus(seed=21)
    _j1, ix1 = _pair(corpus, range_min_expansions=4)
    _j2, ix2 = _pair(corpus, range_min_expansions=0)
    d1, d2 = DeviceIndex(ix1, device="cpu"), DeviceIndex(ix2, device="cpu")
    plan1, _ = d1.plan_batch([query], tokenizer, bm25.new())
    plan2, _ = d2.plan_batch([query], tokenizer, bm25.new())
    assert plan1.has_range[0] and not plan2.has_range[0]
    r1 = d1.query_batch([query], bm25.new(), tokenizer, top_k=K)[0]
    r2 = d2.query_batch([query], bm25.new(), tokenizer, top_k=K)[0]
    assert [r.key for r in r1] == [r.key for r in r2]
    for a, b in zip(r1, r2):
        assert abs(a.score - b.score) < 2e-5 * max(1.0, abs(b.score))


def test_range_window_skips_the_template_and_uses_the_merge_kernel_path(monkeypatch):
    """A window with a range query takes the composed path (pack_dispatches),
    never the frozen template; its range class runs the staged step."""
    _jix, ix = _pair(_wide_prefix_corpus(), chunk_size=128)
    dix = DeviceIndex(ix, device="cpu")
    assert dix.config.template_compositions
    monkeypatch.setattr(
        dix, "_pack_dispatches_template",
        lambda *a, **kw: pytest.fail("range window took the template path"),
    )
    seen = []
    real = pdev._query_step

    def spy(*a, **kw):
        seen.append(kw["use_ranges"])
        return real(*a, **kw)

    monkeypatch.setattr(pdev, "_query_step", spy)
    assert fm.launches["merge_topk"] == 0  # CPU: the plain version only
    s, sl, _k = dix.query_batch_async(WIDE_QUERIES, bm25.new(), top_k=K).get_arrays()
    assert True in seen and False in seen
    os_, od = _oracle(ix, WIDE_QUERIES)
    assert_topk_agree(s, sl, os_, od)
    assert fm.launches["merge_topk"] == 0
