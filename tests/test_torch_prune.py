"""Block-max pruning of the torch port (``index/prune.py``) on the CPU.

Three parts:

* The port against the JAX package on the same documents (the JAX index
  carried into the port by ``snapshot.save`` / the port's ``snapshot.load``;
  two fields, a delta segment, deletes, with and without a vacuum).  The bar
  is bit-equality: the pooled bound arrays, the pruned job tables
  (``words``, ``jquery``, ``nchunks``, ``njobs``, ``pool_rows``) of the
  direct pass ``prune_plan`` and of the memoized ``prune_plan_cached``
  (first pass: fills; second: splices), and the ``prune/*`` counters, for k
  in {1, 3, 10, 16, 17} and boosts {1, 1}, {2, 0}, {1, -1}.
* Each case of the JAX package's ``tests/test_prune.py`` and
  ``tests/test_prune_cache.py`` on the port: every window is served twice
  through one snapshot, pruning on and off, and the rows must be identical
  (same keys, bit-equal f32 scores); every doc the f64 host oracle puts
  clearly inside the top-k must be returned (the oracle rule of
  ``test_oracle_recall_under_pruning``: score above the k-th's by the
  device tolerance, 2e-5 relative).
* A medium case: ``benchmarks/prune_probe.py``'s ``single`` and ``skewed``
  mixes (rng seed 7; ``chip_smoke.prune_mixes``) over 20,000 docs of ``bench.py``'s generator (chunk
  128, so that mid-rank terms span several chunks), 4,096 queries a mix,
  top-1, 3 and 10: the two packages' pruned tables job for job, and the
  port's pruned rows equal to its unpruned rows on 512 of them.
"""

import random

import numpy as np
import pytest

import probly_search_tpu.index.device as jdev
from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu.index import prune as jprune
from probly_search_tpu.utils.metrics import metrics as jmetrics
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25, zero_to_one
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.index import prune as pprune
from probly_search_tpu_torch.testing import RTOL
from probly_search_tpu_torch.utils.metrics import metrics

from .test_torch_planner import port_index
from .torch_util import TfBoost
from .util import Doc, text_extract, title_extract, tokenizer

PRUNE_COUNTERS = ("prune/pruned_chunks", "prune/pruned_jobs", "prune/cache_fills")


def _counts(m):
    c = m.snapshot()["counters"]
    return np.array([c.get(n, 0) for n in PRUNE_COUNTERS], dtype=np.float64)


# --------------------------------------------------------------------- #
# the port against the JAX package                                       #
# --------------------------------------------------------------------- #


def _two_field_index(vacuum):
    """Two fields at chunk 128: three short high-impact runs of ``common``
    (docs 0-7, 440-445 and the last five: the middle chunks prune, jobs
    split), filler terms f0..f119 (``f`` is a term-range prefix), a delta
    segment and deletes of hot docs; optionally vacuumed."""
    rng = random.Random(3)
    n = 900
    titles, bodies = [], []
    for i in range(n):
        hot = i < 8 or 440 <= i < 446 or i >= n - 5
        titles.append("common common common" if hot else f"common t{i % 31}")
        bodies.append(" ".join(
            ["common"] * (3 if hot else 1)
            + [f"f{rng.randrange(120)}" for _ in range(rng.randint(2, 9))]
        ))
    jix = JIndex(2, config=JConfig(chunk_size=128))
    jix.add_documents_columnar(list(range(n)), [titles, bodies])
    for i in range(n, n + 60):
        jix.add_document(
            [title_extract, text_extract], tokenizer, i,
            Doc(id=i, title=f"common t{i % 7}", text=f"common f{i % 13} f{i % 17}"),
        )
    assert jix.num_segments >= 2
    for key in (1, 2, 441, 905):
        jix.remove_document(key)
    if vacuum:
        jix.vacuum()
    queries = [
        "common", "common t1", "t3", "f7 common", "f1", "f", "common f", "zzz", "",
        "t1 t2 t3", "common common", "t30 common f99", "f11 f12", "common t",
    ]
    return jix, queries


@pytest.fixture(scope="module", params=[False, True], ids=["no_vacuum", "vacuum"])
def engines(request):
    jix, queries = _two_field_index(request.param)
    return queries, DeviceIndex(port_index(jix), device="cpu"), jdev.DeviceIndex(jix)


def _plans(engines):
    queries, p, j = engines
    pp, _ = p.plan_batch(queries, tokenizer, bm25.new())
    jp, _ = j.plan_batch(queries, tokenizer, jbm25.new())
    ppool = p._plan_pools[pdev._scorer_cache_key(bm25.new())]
    jpool = j._plan_pools[jdev._scorer_cache_key(jbm25.new())]
    return pp, jp, ppool, jpool


def _assert_same_tables(got, want, label):
    for name in ("jquery", "words", "nchunks", "njobs", "has_range", "pool_rows"):
        np.testing.assert_array_equal(
            getattr(got, name), getattr(want, name), err_msg=f"{label}: {name}"
        )


def test_bounds_equal_jax(engines):
    pp, jp, ppool, jpool = _plans(engines)
    assert ppool["prune_enabled"] and jpool["prune_enabled"]
    for name in ("prune_ub", "prune_topv", "prune_cub_off", "prune_cub", "prune_cub_min"):
        assert ppool[name].dtype == jpool[name].dtype, name
        np.testing.assert_array_equal(ppool[name], jpool[name], err_msg=name)
    np.testing.assert_array_equal(pp.pool_rows, jp.pool_rows)
    np.testing.assert_array_equal(pp.qids, jp.qids)


@pytest.mark.parametrize(
    "boosts", [(1.0, 1.0), (2.0, 0.0), (1.0, -1.0)], ids=["1,1", "2,0", "1,-1"]
)
@pytest.mark.parametrize("k", [1, 3, 10, 16, 17])
def test_pruned_tables_equal_jax(engines, k, boosts):
    pp, jp, ppool, jpool = _plans(engines)
    prunable = k <= 16 and min(boosts) >= 0
    c0, j0 = _counts(metrics), _counts(jmetrics)
    pd = pprune.prune_plan(engines[1], pp, ppool, k, list(boosts))
    jd = jprune.prune_plan(engines[2], jp, jpool, k, list(boosts))
    _assert_same_tables(pd, jd, "direct")
    np.testing.assert_array_equal(_counts(metrics) - c0, _counts(jmetrics) - j0)
    if not prunable:
        assert pd is pp and jd is jp
    elif k == 3 and boosts == (1.0, 1.0):
        assert (_counts(metrics) - c0)[0] > 0, "the hot runs must prune chunks"
    for turn in ("fill", "splice"):
        c0, j0 = _counts(metrics), _counts(jmetrics)
        pc = pprune.prune_plan_cached(engines[1], pp, ppool, k, list(boosts))
        jc = jprune.prune_plan_cached(engines[2], jp, jpool, k, list(boosts))
        _assert_same_tables(pc, jc, turn)
        _assert_same_tables(pc, pd, f"{turn} vs direct")
        np.testing.assert_array_equal(_counts(metrics) - c0, _counts(jmetrics) - j0, err_msg=turn)


# --------------------------------------------------------------------- #
# the JAX package's pruning cases on the port                            #
# --------------------------------------------------------------------- #


def _pruned_chunks() -> int:
    return int(metrics.counters.get("prune/pruned_chunks", 0))


def _fills() -> int:
    return int(metrics.counters.get("prune/cache_fills", 0))


def _serve_ab(ix, queries, k=3, fields_boost=None, scorer=None):
    """Serve the window pruned and unpruned through ONE snapshot; return
    (pruned_rows, unpruned_rows, chunks_pruned)."""
    scorer = scorer or bm25.new()
    ix.config.prune_blocks = True
    before = _pruned_chunks()
    pruned = ix.query_batch(queries, scorer, tokenizer, fields_boost, top_k=k, backend="device")
    n_pruned = _pruned_chunks() - before
    ix.config.prune_blocks = False
    base = ix.query_batch(queries, scorer, tokenizer, fields_boost, top_k=k, backend="device")
    ix.config.prune_blocks = True
    return pruned, base, n_pruned


def _assert_rows_equal(pruned, base, queries):
    assert len(pruned) == len(base)
    for q, a, b in zip(queries, pruned, base):
        assert [r.key for r in a] == [r.key for r in b], (q, a, b)
        np.testing.assert_array_equal(
            np.array([r.score for r in a], np.float32),
            np.array([r.score for r in b], np.float32),
            err_msg=q,
        )


def _assert_oracle_recall(ix, queries, rows, k, fields_boost=None):
    """Every doc the f64 host oracle puts clearly inside the top-k (above
    the k-th score by the device tolerance) is among the device's rows."""
    boosts = list(fields_boost) if fields_boost is not None else [1.0] * ix.num_fields
    for q, got in zip(queries, rows):
        oracle = ix.query(q, bm25.new(), tokenizer, boosts)[:k]
        if not oracle:
            assert not got, (q, got)
            continue
        kth = oracle[-1].score
        must = {r.key for r in oracle if r.score > kth * (1 + 2 * RTOL) + 1e-6}
        assert must <= {r.key for r in got}, (q, must, got)


def _skewed_index(n=600, hot=(0, 10), chunk=128, fields=1):
    """`common` in every doc; docs in [hot) repeat it 4x in a short field
    (high tf-norm impact), the rest once among filler (low impact).  At
    chunk 128 the hot docs land in the leading chunk(s) and the long
    low-impact tail is provably below the top-k."""
    ix = Index(fields, config=IndexConfig(chunk_size=chunk, prune_blocks=True), device="cpu")
    col = [
        "common common common common" if hot[0] <= i < hot[1]
        else f"common f{i % 97} g{i % 89} h{i % 83} j{i % 79}"
        for i in range(n)
    ]
    ix.add_documents_columnar(list(range(n)), [col] + [["x"] * n] * (fields - 1))
    return ix


def _split_index():
    """High impacts at BOTH ends of the posting range: the surviving chunks
    form two runs, so the job SPLITS into two rows."""
    ix = Index(1, config=IndexConfig(chunk_size=128, prune_blocks=True), device="cpu")
    col = [
        "common common common common" if (i < 5 or i >= 595)
        else f"common f{i % 97} g{i % 89} h{i % 83} j{i % 79}"
        for i in range(600)
    ]
    ix.add_documents_columnar(list(range(600)), [col])
    return ix


def _case_multi_term():
    ix = _skewed_index()
    ix.add_document([lambda d: [d]], tokenizer, 600, "rare common filler words here")
    ix.add_document([lambda d: [d]], tokenizer, 601, "rare other text")
    return ix


def _case_range():
    ix = Index(1, config=IndexConfig(chunk_size=128, prune_blocks=True, range_min_expansions=4),
               device="cpu")
    ix.add_documents_columnar(list(range(400)), [[f"common w{i}x w{i}y w{i}z" for i in range(400)]])
    return ix


def _case_dead_top():
    ix = _skewed_index(n=600, hot=(0, 10))
    for i in range(10):  # dead before the snapshot: zeroed in the bounds
        ix.remove_document(i)
    return ix


def _case_vacuum():
    ix = _skewed_index(n=400, hot=(0, 8))
    for i in range(4, 12):
        ix.remove_document(i)
    ix.vacuum()
    return ix


def _case_delta():
    ix = _skewed_index(n=300, hot=(0, 6))
    for i in range(300, 340):
        ix.add_document([lambda d: [d]], tokenizer, i, f"common t{i} u{i} v{i} w{i}")
    assert ix.num_segments > 1
    return ix


def _case_k_cap():
    ix = _skewed_index()
    ix.config.prune_max_top_k = 4
    return ix


# (index, queries, k, fields_boost, expect): expect "fires" asserts chunks
# pruned, "off" asserts none (a safety gate), None asserts equality only.
CASES = {
    "single_term_prunes_tail_chunks": (_skewed_index, ["common"], 3, None, "fires"),
    "mid_job_chunk_split": (_split_index, ["common"], 3, None, "fires"),
    "multi_term_disjunction": (
        _case_multi_term, ["common rare", "rare", "common common"], 3, None, None),
    "window_mixes_pruned_and_unpruned_queries": (
        _skewed_index, ["common", "f1", "g2 h3", "zzz", "", "common f1"], 3, None, "fires"),
    "k_above_cap_disables": (_case_k_cap, ["common"], 5, None, "off"),
    "negative_boost_disables": (lambda: _skewed_index(fields=2), ["common"], 3, [1.0, -0.5], "off"),
    "range_queries_never_pruned": (_case_range, ["w", "common"], 3, None, None),
    "zero_boost_field": (lambda: _skewed_index(fields=2), ["common", "f1"], 3, [1.0, 0.0], None),
    "dead_top_docs_excluded_from_bounds": (_case_dead_top, ["common"], 3, None, None),
    "vacuum_then_prune": (_case_vacuum, ["common", "f1 common"], 3, None, None),
    "delta_segment_jobs": (_case_delta, ["common"], 3, None, None),
    "oracle_recall_under_pruning": (_skewed_index, ["common"], 5, None, "fires"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pruned_rows_equal_unpruned(case):
    make, queries, k, boosts, expect = CASES[case]
    ix = make()
    pruned, base, n = _serve_ab(ix, queries, k=k, fields_boost=boosts)
    if expect == "fires":
        assert n > 0, "pruning must fire on this corpus"
    elif expect == "off":
        assert n == 0, "a safety gate must disable pruning"
    _assert_rows_equal(pruned, base, queries)
    if boosts is None or min(boosts) >= 0:
        _assert_oracle_recall(ix, queries, pruned, k, boosts)


def test_range_window_keeps_range_jobs():
    ix = _case_range()
    plan, _ = ix.device_index().plan_batch(["w", "common"], tokenizer, bm25.new())
    assert plan.has_range.tolist() == [True, False]
    out = ix.device_index().prune(plan, bm25.new(), 3, [1.0])
    rows = out.words[out.jquery == 0]
    np.testing.assert_array_equal(rows, plan.words[plan.jquery == 0])  # never pruned


@pytest.mark.parametrize("scorer", [zero_to_one.new(), TfBoost()], ids=["zero_to_one", "TfBoost"])
def test_scorer_without_impact_never_pruned(scorer):
    ix = _skewed_index(n=200)
    before = _pruned_chunks()
    rows = ix.query_batch(["common"], scorer, tokenizer, top_k=3, backend="device")
    assert _pruned_chunks() == before and rows and rows[0]
    pools = ix.device_index()._plan_pools.values()
    assert not any(p.get("prune_enabled") for p in pools)


def test_random_corpora_exactness():
    rng = random.Random(4242)
    for _trial in range(4):
        vocab = ["".join(rng.choice("abcdef") for _ in range(rng.randint(1, 4))) for _ in range(30)]
        col = []
        for _i in range(350):
            words = [rng.choice(vocab) for _ in range(rng.randint(1, 8))]
            if rng.random() < 0.6:
                words += ["hot"] * rng.randint(1, 4)
            col.append(" ".join(words))
        ix = Index(1, config=IndexConfig(chunk_size=128, prune_blocks=True), device="cpu")
        ix.add_documents_columnar(list(range(350)), [col])
        for i in rng.sample(range(350), 25):
            ix.remove_document(i)
        queries = ["hot"] + [
            " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(12)
        ]
        queries += [rng.choice(vocab)[:1], "hot " + rng.choice(vocab)]
        for k in (1, 3, 10):
            pruned, base, _ = _serve_ab(ix, queries, k=k)
            _assert_rows_equal(pruned, base, queries)
            _assert_oracle_recall(ix, queries, pruned, k)


# ---- the memo (tests/test_prune_cache.py) ---------------------------- #


def test_repeat_window_fills_once():
    ix = _skewed_index()
    queries = ["common", "f1", "g2 h3", "common f1"]
    dix = ix.device_index()
    before = _fills()
    first = dix.query_batch_async(queries, bm25.new(), top_k=3).get()
    filled = _fills() - before
    assert filled == len(set(queries)), "every first-seen query fills"
    second = dix.query_batch_async(queries, bm25.new(), top_k=3).get()
    assert _fills() - before == filled, "a repeat window must not refill"
    _assert_rows_equal(second, first, queries)


def test_cached_equals_direct_and_unpruned():
    ix = _skewed_index()
    queries = ["common", "common f1", "f1 g2"]
    ix.query_batch(queries, bm25.new(), tokenizer, top_k=3, backend="device")  # warm the memo
    pruned, base, n = _serve_ab(ix, queries, k=3)
    assert n > 0
    _assert_rows_equal(pruned, base, queries)
    dix = ix.device_index()
    plan, _ = dix.plan_batch(queries, tokenizer, bm25.new())
    pool = dix._plan_pools[pdev._scorer_cache_key(bm25.new())]
    direct = pprune.prune_plan(dix, plan, pool, 3, [1.0])
    cached = pprune.prune_plan_cached(dix, plan, pool, 3, [1.0])
    _assert_same_tables(cached, direct, "cached vs direct")


def test_new_queries_extend_cache():
    ix = _skewed_index()
    dix = ix.device_index()
    dix.query_batch_async(["common"], bm25.new(), top_k=3).get()
    before = _fills()
    mixed = ["common", "f1", "common"]
    rows = dix.query_batch_async(mixed, bm25.new(), top_k=3).get()
    assert _fills() - before == 1, "only the unseen query fills"
    ix.config.prune_blocks = False
    base = dix.query_batch_async(mixed, bm25.new(), top_k=3).get()
    ix.config.prune_blocks = True
    _assert_rows_equal(rows, base, mixed)


@pytest.mark.parametrize("k,boosts", [(3, [1.0, 1.0]), (5, [1.0, 1.0]), (3, [1.0, 0.0])])
def test_k_and_boosts_key_separately(k, boosts):
    ix = _skewed_index(fields=2)
    queries = ["common", "common f1"]
    pruned, base, _ = _serve_ab(ix, queries, k=k, fields_boost=boosts)
    _assert_rows_equal(pruned, base, queries)
    again, base2, _ = _serve_ab(ix, queries, k=k, fields_boost=boosts)  # the cached splice
    _assert_rows_equal(again, base, queries)
    _assert_rows_equal(base2, base, queries)
    _assert_oracle_recall(ix, queries, again, k, boosts)


def test_split_jobs_cached():
    ix = _split_index()
    queries = ["common"]
    first, base, n = _serve_ab(ix, queries, k=3)
    assert n > 0
    plan, _ = ix.device_index().plan_batch(queries, tokenizer, bm25.new())
    out = ix.device_index().prune(plan, bm25.new(), 3, [1.0])
    assert out.njobs[0] == plan.njobs[0] + 1, "the job splits into two rows"
    again, base2, n2 = _serve_ab(ix, queries, k=3)
    assert n2 > 0, "the cached splice still reports pruned chunks"
    _assert_rows_equal(first, base, queries)
    _assert_rows_equal(again, base, queries)


def test_cache_dies_with_snapshot():
    ix = _skewed_index(n=400)
    q = ["common"]
    ix.query_batch(q, bm25.new(), tokenizer, top_k=3, backend="device")
    for i in range(4):
        ix.remove_document(i)
    pruned, base, _ = _serve_ab(ix, q, k=3)
    _assert_rows_equal(pruned, base, q)
    _assert_oracle_recall(ix, q, pruned, 3)


def test_heavy_splice_interplay():
    ix = _skewed_index()
    ix.config.heavy_cache_min_chunks = 2  # "common"'s 600 docs qualify
    queries = ["common", "f1", "common f1"]
    before = metrics.counters.get("heavy_cache_hits", 0)
    for _ in range(2):  # the second pass rides both caches
        pruned, base, _ = _serve_ab(ix, queries, k=3)
        _assert_rows_equal(pruned, base, queries)
    assert metrics.counters.get("heavy_cache_hits", 0) > before, "the heavy query rides its cache"


def test_fuzz_repeat_windows():
    rng = random.Random(77)
    vocab = ["hot", "aa", "ab", "ba", "bb", "c"]
    col = []
    for _i in range(300):
        words = [rng.choice(vocab) for _ in range(rng.randint(1, 6))]
        if rng.random() < 0.5:
            words += ["hot"] * rng.randint(1, 4)
        col.append(" ".join(words))
    ix = Index(1, config=IndexConfig(chunk_size=128, prune_blocks=True), device="cpu")
    ix.add_documents_columnar(list(range(300)), [col])
    queries = [
        " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(10)
    ] + ["hot", "hot aa"]
    for k in (1, 3):
        for _ in range(3):  # repeated windows ride the memo
            pruned, base, _ = _serve_ab(ix, queries, k=k)
            _assert_rows_equal(pruned, base, queries)


# --------------------------------------------------------------------- #
# the probe's mixes at 20,000 docs                                       #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def medium():
    from bench import make_corpus
    from chip_smoke import prune_mixes

    vocab, cdf, texts = make_corpus(20_000, 50_000, 8)
    jix = JIndex(1, config=JConfig(chunk_size=128, result_format="f32"))
    jix.add_documents_columnar(list(range(len(texts))), [texts])
    pix = port_index(jix)
    return prune_mixes(vocab, cdf, 4096), pix, DeviceIndex(pix, device="cpu"), jdev.DeviceIndex(jix)


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("mix", ["single", "skewed"])
def test_probe_mixes_equal_jax(medium, mix, k):
    mixes, pix, p, j = medium
    queries = mixes[mix]
    pp, _ = p.plan_batch(queries, tokenizer, bm25.new())
    jp, _ = j.plan_batch(queries, tokenizer, jbm25.new())
    ppool = p._plan_pools[pdev._scorer_cache_key(bm25.new())]
    jpool = j._plan_pools[jdev._scorer_cache_key(jbm25.new())]
    for turn in ("fill", "splice"):
        c0, j0 = _counts(metrics), _counts(jmetrics)
        pc = pprune.prune_plan_cached(p, pp, ppool, k, [1.0])
        jc = jprune.prune_plan_cached(j, jp, jpool, k, [1.0])
        _assert_same_tables(pc, jc, f"{mix} {turn}")
        dp, dj = _counts(metrics) - c0, _counts(jmetrics) - j0
        np.testing.assert_array_equal(dp, dj, err_msg=turn)
        # Uniform 8-token docs at this scale: a mid-rank term's k-th best
        # posting has tf 1 from k = 10 on, and then no chunk can drop.
        assert (dp[0] > 0) == (k < 10), f"{mix} k={k}: {dp}"
    sample = queries[:512]
    on = p.query_batch_async(sample, bm25.new(), top_k=k).get_arrays()
    pix.config.prune_blocks = False
    try:
        off = p.query_batch_async(sample, bm25.new(), top_k=k).get_arrays()
    finally:
        pix.config.prune_blocks = True
    np.testing.assert_array_equal(on[1], off[1])
    np.testing.assert_array_equal(on[0], off[0])
