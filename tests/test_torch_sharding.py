"""The port's doc-sharded BM25 engine (``parallel/``) on CPU meshes.

The port's meshes are grids of torch devices driven from one process; here
every cell names the CPU: ``make_mesh(2, 4, devices=["cpu"] * 8)`` and
``(1, 8)``.  The JAX engine runs on the 8 virtual CPU devices of
``tests/conftest.py``.

* Against the JAX package (the same documents, carried across by
  ``index.snapshot``): bit-equal host tables on both mesh shapes (the
  snapshot's CSR and cumsum tables, each shard's record payload and aux
  rows, the plan words ``[n, J, 3]``, ``_pack_window``'s class specs, layout
  and buffer, the pruning trim's bounds and trimmed words with and without
  a vacuum); the rows of one window holding every class kind (per-expansion
  classes of several widths, term-range classes, a host-fallback query,
  cross-shard ties) within ``probly_search_tpu_torch.testing``'s rule.
  JAX compiles one ``shard_map`` program per window shape on the CPU, so
  it serves that one window only.
* Each case of the JAX package's ``tests/test_sharding.py`` (BM25 half) on
  the port, held to the port's single-device engine and the f64 oracle
  ``Index.query`` by the same rule; each test names the case it mirrors.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu.index import prune as jprune
from probly_search_tpu.parallel import ShardedDeviceIndex as JSharded
from probly_search_tpu.parallel import make_mesh as jmake_mesh
from probly_search_tpu.utils.metrics import metrics as jmetrics
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25
from probly_search_tpu_torch.index import core as pcore
from probly_search_tpu_torch.index import prune as pprune
from probly_search_tpu_torch.parallel import ShardedDeviceIndex, dist_query, make_mesh
from probly_search_tpu_torch.parallel import mesh as pmesh
from probly_search_tpu_torch.ops.fused_merge import key_bits_for
from probly_search_tpu_torch.testing import assert_topk_agree
from probly_search_tpu_torch.utils.metrics import metrics

from .test_torch_planner import port_index
from .torch_util import TfBoost
from .util import tokenizer

K = 10
MESHES = [(2, 4), (1, 8)]
N_DOCS = 2049  # shard 0's largest local slot is 512 on 4 shards, 256 on 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many small torch ops on the CPU.  Where several test
    workers share the cores, OpenMP's spinning worker threads slow such
    ops by an order of magnitude, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(data, docs):
    return make_mesh(data, docs, devices=["cpu"] * (data * docs))


def _corpus():
    """Two fields at chunk 128, ranges from 24 expansions, at most 6 query
    terms: random words (short prefixes expand to many of them; one letter
    and ``qq`` plan as term-range jobs), ``heavy`` in two docs of three (several chunks a shard), ``qq*``
    terms, 24 identical ``tie`` docs spread over every shard, ``last`` only
    in the last doc (the largest local slot of shard 0), latent deletes.
    Returns the JAX Index, the port's (carried across) and a window."""
    rng = random.Random(5)
    vocab = ["".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 5))) for _ in range(150)]
    tie = set(range(0, 12)) | set(range(2037, 2049))
    titles, bodies = [], []
    for i in range(N_DOCS):
        if i in tie:
            titles.append("tie" + (" last" if i == N_DOCS - 1 else ""))
            bodies.append("tie")
            continue
        titles.append(" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 4)))
                      + (" heavy" if i % 3 else ""))
        bodies.append(" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 8)))
                      + f" qq{rng.choice('rstu')}{rng.randint(0, 9)}")
    jix = JIndex(2, config=JConfig(chunk_size=128, range_min_expansions=24, max_query_terms=6))
    jix.add_documents_columnar(list(range(N_DOCS)), [titles, bodies])
    for key in range(20, N_DOCS - 20, 37):
        jix.remove_document(key)
    window = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(40)]
    window += [rng.choice(vocab)[:2] for _ in range(2)] + [rng.choice(vocab)[:1]]
    window += ["heavy", f"heavy {vocab[3]}", "tie", "tie last", "last", "qq", "qqr", f"qq {vocab[9]}",
               "", "zzzz", " ".join(vocab[:7])]
    return jix, port_index(jix), window


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _oracle(ix, queries, k=K, boost=None, scorer=None):
    """The f64 host oracle's top-k as (scores f32, slots) arrays."""
    boost = boost or [1.0] * ix.num_fields
    s = np.full((len(queries), k), -np.inf, np.float32)
    d = np.full((len(queries), k), -1, np.int32)
    for qi, q in enumerate(queries):
        for r, res in enumerate(ix.query(q, scorer or bm25.new(), tokenizer, boost, top_k=k)):
            s[qi, r] = res.score
            d[qi, r] = ix._key_to_slot[res.key]
    return s, d


def _single(ix, queries, k=K, boost=None, scorer=None, **cfg):
    """The port's single-device engine on the same index."""
    dix = DeviceIndex(ix, device="cpu")
    dix.config = dataclasses.replace(ix.config, **cfg)
    h = dix.query_batch_async(queries, scorer or bm25.new(), tokenizer, boost, top_k=k)
    return h.get_arrays()


def _agree_all(ix, queries, got, k=K, boost=None, scorer=None):
    """Sharded f32 rows against the single-device engine and the oracle."""
    s, sl, _keys = got
    ss, ssl, _ = _single(ix, queries, k, boost, scorer)
    assert_topk_agree(s, sl, ss, ssl)
    os_, osl = _oracle(ix, queries, k, boost, scorer)
    assert_topk_agree(s, sl, os_, osl)


# --------------------------------------------------------------------- #
# the port against the JAX package                                       #
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(str, m)))
def pair(request, corpus):
    jix, ix, window = corpus
    d, n = request.param
    return jix, ix, window, JSharded(jix, jmake_mesh(d, n)), ShardedDeviceIndex(ix, cpu_mesh(d, n))


def test_snapshot_tables_equal_jax(pair):
    """The sharded snapshot: CSR offsets, the live cumsum, the term table,
    each shard's record payload (rows 0 .. 1 + 2F) and aux rows."""
    _jix, ix, _w, j, p = pair
    for name in ("offsets_sh", "g_live_cum", "g_offsets", "terms", "term_lens"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name), err_msg=name)
    assert (p.local_slots, p._pmax, p.num_slots) == (j.local_slots, j._pmax, j.num_slots)
    F = ix.num_fields
    jrec = np.asarray(j.rec)
    jaux = np.asarray(j._aux_rec(jbm25.new()))
    paux = p._aux_rec(bm25.new())
    for s in range(p.n_shards):
        np.testing.assert_array_equal(p.rec[s].numpy()[: 2 + 2 * F], jrec[s][: 2 + 2 * F])
        np.testing.assert_array_equal(paux[0][s].numpy()[:2], jaux[s][:2])
        for d in range(p.mesh.shape["data"]):
            assert p._rec_cells[d][s] is p.rec[s]  # one copy per distinct device
    # Each shard's merge keys at its own width; shard 0 holds a local slot
    # that is a power of two.
    counts = [len(range(s, ix._next_slot, p.n_shards)) for s in range(p.n_shards)]
    assert counts[0] - 1 == 1 << (counts[0] - 1).bit_length() - 1
    assert p.key_bits == [key_bits_for(c, 4) for c in counts]
    assert p.key_bits[0] == p.key_bits[1] + 1


def test_plans_and_packed_window_equal_jax(pair):
    """Plan words [n, J, 3] (with range jobs and a fallback query) and
    ``_pack_window``'s class specs, layout and buffer."""
    _jix, _ix, window, j, p = pair
    jplan, jfb = j.plan_batch(window, tokenizer, jbm25.new())
    pplan, pfb = p.plan_batch(window, tokenizer, bm25.new())
    assert pfb == jfb and pfb
    for name, a, b in zip(("jquery", "words", "nchunks", "njobs", "has_range"), pplan, jplan):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert pplan[4].any() and not pplan[4].all()
    pspecs, playout, pbuf = p._pack_window(pplan, len(window))
    jspecs, jlayout, jbuf = j._pack_window(jplan, len(window))
    assert pspecs == jspecs
    assert len({spec[3] for spec in pspecs}) >= 3 and any(spec[4] for spec in pspecs)
    np.testing.assert_array_equal(pbuf, jbuf)
    for a, b in zip(playout, jlayout):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]


@pytest.fixture(scope="module")
def jax_window(corpus):
    jix, _ix, window = corpus
    j = JSharded(jix, jmake_mesh(2, 4))
    return j.query_batch_async(window, jbm25.new(), tokenizer, top_k=K).get_arrays()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_window_matches_jax_single_device_and_oracle(corpus, jax_window, mesh):
    """One window of every class kind (mirrors ``test_sharded_matches_oracle``
    and ``test_sharded_with_deletes``): against the JAX engine on mesh
    (2, 4), the port's single-device engine and the oracle."""
    _jix, ix, window = corpus
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    got = p.query_batch_async(window, bm25.new(), tokenizer, top_k=K).get_arrays()
    js, jsl, _ = jax_window
    assert_topk_agree(got[0], got[1], js, jsl)
    _agree_all(ix, window, got)
    np.testing.assert_array_equal(got[2], np.asarray(ix._slot_to_key)[np.maximum(got[1], 0)])


def _skewed(vacuum="none", fields=2, prune=True, n=1200):
    """``tests/test_sharding.py``'s skewed corpus (chunk 128: ``common``
    three times in its first ten docs), two fields, latent deletes;
    ``vacuum`` "before" compacts before the snapshot.  Returns the JAX
    Index and the port's."""
    jix = JIndex(fields, config=JConfig(chunk_size=128, prune_blocks=prune))
    col = [
        "common common common common" if i < 10 else f"common f{i % 97} g{i % 89} h{i % 83} j{i % 79}"
        for i in range(n)
    ]
    jix.add_documents_columnar(list(range(n)), [col] + [["x"] * n for _ in range(fields - 1)])
    for key in (3, 500, 501):
        jix.remove_document(key)
    if vacuum == "before":
        jix.vacuum()
    return jix, port_index(jix)


PRUNE_QUERIES = ["common", "common f10", "f11 g12", "zzz", "", "common h3 j4", "common common"]
PRUNE_COUNTERS = ("prune/sharded_trimmed_chunks", "prune/sharded_cache_fills",
                  "prune/sharded_cache_splices")


@pytest.fixture(scope="module", params=["none", "before", "after"])
def pruned_pair(request):
    """JAX's and the port's sharded snapshots of the skewed corpus on mesh
    (2, 4); "after": both indexes vacuumed after the snapshot, before the
    first plan builds the bounds."""
    jix, ix = _skewed(request.param)
    j, p = JSharded(jix, jmake_mesh(2, 4)), ShardedDeviceIndex(ix, cpu_mesh(2, 4))
    if request.param == "after":
        jix.vacuum()
        ix.vacuum()
    jplan = j.plan_batch(PRUNE_QUERIES, tokenizer, jbm25.new(), with_rows=True)[0]
    pplan = p.plan_batch(PRUNE_QUERIES, tokenizer, bm25.new(), with_rows=True)[0]
    return request.param, j, p, jplan, pplan


def _counts(m):
    c = m.snapshot()["counters"]
    return [c.get(name, 0) for name in PRUNE_COUNTERS]


@pytest.mark.parametrize("boost", [(1.0, 1.0), (2.0, 0.5), (0.0, 1.0)], ids=str)
@pytest.mark.parametrize("k", [1, 3, 10, 17])
def test_trim_tables_equal_jax(pruned_pair, k, boost):
    """The pooled per-shard bounds (``prune_sh``) and the trimmed words of
    ``prune_plan_sharded`` and of the memoized form (first call fills,
    second splices), with their counters; a vacuum after the snapshot does
    not reach the bounds (``dist_query.py:136-150``)."""
    vacuum, j, p, jplan, pplan = pruned_pair
    for s in range(p.n_shards):
        for name in ("ub", "topv", "cub_off", "cub", "cub_min"):
            np.testing.assert_array_equal(
                pplan[5][1]["prune_sh"][s][name], jplan[5][1]["prune_sh"][s][name], err_msg=name
            )
    if vacuum == "after":
        _jx, fresh = _skewed()
        ref = ShardedDeviceIndex(fresh, cpu_mesh(2, 4)).plan_batch(
            PRUNE_QUERIES, tokenizer, bm25.new(), with_rows=True)[0]
        for name in ("ub", "cub"):
            np.testing.assert_array_equal(
                pplan[5][1]["prune_sh"][0][name], ref[5][1]["prune_sh"][0][name])
    prow, pqp, pqids = pplan[5]
    jrow, jqp, jqids = jplan[5]
    m0, j0 = _counts(metrics), _counts(jmetrics)
    outs = [(pprune.prune_plan_sharded(p, pplan[:5], prow, pqp, k, boost),
             jprune.prune_plan_sharded(j, jplan[:5], jrow, jqp, k, boost))]
    for _ in range(2):
        outs.append((
            pprune.prune_plan_sharded_cached(p, pplan[:5], prow, pqp, pqids, k, boost),
            jprune.prune_plan_sharded_cached(j, jplan[:5], jrow, jqp, jqids, k, boost),
        ))
    for got, want in outs:
        for name, a, b in zip(("jquery", "words", "nchunks", "njobs", "has_range"), got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert np.subtract(_counts(metrics), m0).tolist() == np.subtract(_counts(jmetrics), j0).tolist()
    trimmed = bool((outs[0][0][1] != pplan[1]).any())
    if k == 3 and boost == (1.0, 1.0):
        assert trimmed
    if k > p.config.prune_max_top_k:
        assert not trimmed


# --------------------------------------------------------------------- #
# tests/test_sharding.py on the port                                     #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_ties_across_shards_take_the_lowest_slots(corpus, mesh):
    """Equal scores on every shard come out by global slot ascending, as on
    the single device and in the oracle: exactly the same slots."""
    _jix, ix, _w = corpus
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    queries = ["tie", "tie last", "last tie"]
    s, sl, _ = p.query_batch_async(queries, bm25.new(), tokenizer, top_k=K).get_arrays()
    ss, ssl, _ = _single(ix, queries)
    np.testing.assert_array_equal(sl, ssl)
    np.testing.assert_array_equal(s, ss)
    assert (s[0] == s[0, 0]).all() and sl[0].tolist() == list(range(10))
    assert sl[1, 0] == N_DOCS - 1 and sl[1, 1:].tolist() == list(range(9))
    np.testing.assert_array_equal(sl, _oracle(ix, queries)[1])


def test_empty_and_nomatch():
    """``test_sharded_empty_and_nomatch``."""
    ix = Index(1, device="cpu")
    ix.add_documents_columnar([0, 1], [["abc def", "ghi"]])
    rows = ShardedDeviceIndex(ix, cpu_mesh(1, 8)).query_batch(["", "zzz", "abc"], bm25.new(), top_k=5)
    assert rows[0] == [] and rows[1] == []
    assert len(rows[2]) == 1 and rows[2][0].key == 0


def test_host_fallback_in_batch():
    """``test_sharded_host_fallback_in_batch``: a query past
    ``max_query_terms`` runs on the host, the rest on the mesh."""
    ix = Index(1, config=IndexConfig(max_query_terms=4), device="cpu")
    ix.add_documents_columnar(list(range(50)), [[f"w{i % 10} shared" for i in range(50)]])
    p = ShardedDeviceIndex(ix, cpu_mesh(1, 8))
    big_q = " ".join(f"w{i % 10}" for i in range(6))
    metrics.reset()
    rows = p.query_batch([big_q, "shared"], bm25.new(), top_k=5)
    assert metrics.snapshot()["counters"]["device_fallback_queries"] == 1
    oracle0 = ix.query(big_q, bm25.new(), tokenizer, [1.0], top_k=5)
    assert [r.key for r in rows[0]] == [r.key for r in oracle0]
    assert len(rows[1]) == 5


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_get_arrays_columnar(corpus, mesh):
    """``test_sharded_get_arrays_columnar``: the columnar drain matches the
    object rows; host-fallback rows keep ``slots >= 0``."""
    _jix, ix, window = corpus
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    queries = window[:3] + ["zzz", "", window[-1]]
    scores, slots, keys = p.query_batch_async(queries, bm25.new(), tokenizer, top_k=5).get_arrays()
    rows = p.query_batch(queries, bm25.new(), tokenizer, top_k=5)
    assert rows[-1]  # the fallback query
    for qi, row in enumerate(rows):
        assert int((slots[qi] >= 0).sum()) == len(row) == int(np.isfinite(scores[qi]).sum())
        for j, r in enumerate(row):
            assert keys[qi, j] == r.key and abs(scores[qi, j] - r.score) < 1e-6
            assert slots[qi, j] == ix._key_to_slot[r.key]


def test_long_jobs_split_instead_of_raise(monkeypatch):
    """``test_long_jobs_split_instead_of_raise``: a term whose per-shard
    postings exceed the packed job length is split into parts."""
    monkeypatch.setattr(dist_query, "_MAX_JOB_LEN", 8)
    ix = Index(1, device="cpu")
    ix.add_documents_columnar(list(range(200)), [["tt xx" if i % 2 else "tt" for i in range(200)]])
    p = ShardedDeviceIndex(ix, cpu_mesh(1, 8))
    queries = ["tt", "tt xx", "xx"]
    planned, _fb = p.plan_batch(queries, tokenizer, bm25.new())
    assert planned[3][0] > 1  # "tt" split into parts
    got = p.query_batch_async(queries, bm25.new(), tokenizer, top_k=K).get_arrays()
    _agree_all(ix, queries, got)


@pytest.mark.parametrize("fmt", ["f32", "compact", "slots", "slots20"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_result_formats(corpus, mesh, fmt):
    """``TestShardedResultFormats::test_format_matches_oracle``: each format
    against the single-device engine in the same format (slots formats
    carry no scores; compact's f16 scores within 1e-3)."""
    _jix, ix, window = corpus
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    p.config = dataclasses.replace(ix.config, result_format=fmt)
    s, sl, keys = p.query_batch_async(window, bm25.new(), tokenizer, top_k=K).get_arrays()
    ss, ssl, skeys = _single(ix, window, result_format=fmt)
    assert sl.shape == (len(window), K)
    if fmt.startswith("slots"):
        assert s is None and ss is None
        np.testing.assert_array_equal(sl, ssl)
        np.testing.assert_array_equal(keys, skeys)
    else:
        assert_topk_agree(s, sl, ss, ssl, rtol=1e-3 if fmt == "compact" else 2e-5)


def test_slots_get_raises(corpus):
    """``TestShardedResultFormats::test_slots_get_raises``."""
    _jix, ix, window = corpus
    p = ShardedDeviceIndex(ix, cpu_mesh(1, 8))
    p.config = dataclasses.replace(ix.config, result_format="slots")
    with pytest.raises(ValueError, match="slots"):
        p.query_batch_async(window[:4], bm25.new(), tokenizer, top_k=5).get()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_repeated_queries_skip_replanning(corpus, mesh, monkeypatch):
    """``TestShardedPlanCache``: a repeated window assembles from the pool
    (no planning pass), and a window mixing new and pooled queries is
    right."""
    _jix, ix, window = corpus
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    half = window[: len(window) // 2]
    r1 = p.query_batch_async(half, bm25.new(), tokenizer, top_k=5).get_arrays()
    r_mixed = p.query_batch_async(window, bm25.new(), tokenizer, top_k=5).get_arrays()
    _agree_all(ix, window, r_mixed, k=5)

    def boom(*a, **kw):
        raise AssertionError("replanned a pooled query")

    monkeypatch.setattr(p, "_plan_batch_impl", boom)
    r2 = p.query_batch_async(half, bm25.new(), tokenizer, top_k=5).get_arrays()
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a, b)


def test_pad_row_trim():
    """``test_sharded_pad_row_trim``: 590 queries in one class, b_pad 1024,
    b_out 768: fewer packed rows than the power-of-two pads."""
    rng = random.Random(31)
    vocab = ["w%02d" % i for i in range(40)]
    ix = Index(1, device="cpu")
    ix.add_documents_columnar(list(range(400)), [[" ".join(rng.choice(vocab) for _ in range(4))
                                                  for _ in range(400)]])
    queries = [rng.choice(vocab) + "x" for _ in range(10)] + [rng.choice(vocab) for _ in range(590)]
    p = ShardedDeviceIndex(ix, cpu_mesh(1, 8))
    h = p.query_batch_async(queries, bm25.new(), tokenizer, top_k=5)
    assert h._packed[0][0].shape[0] == 768
    got = h.get_arrays()
    sample = list(range(0, len(queries), 37))
    ss, ssl, _ = _single(ix, [queries[i] for i in sample], k=5)
    np.testing.assert_array_equal(got[1][sample], ssl)
    np.testing.assert_array_equal(got[0][sample], ss)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_term_range_jobs(mesh):
    """``test_sharded_term_range_jobs``: expansion-heavy queries run on the
    mesh as per-shard range jobs (staged lanes + K5's plain version)."""
    rng = random.Random(41)
    prefixed = ["qq" + "".join(rng.choice("rstu") for _ in range(j % 3 + 1)) for j in range(30)]
    vocab = sorted(set(prefixed)) + ["zz1", "zz2"]
    ix = Index(1, config=IndexConfig(range_min_expansions=4), device="cpu")
    ix.add_documents_columnar(list(range(400)), [[" ".join(rng.choice(vocab) for _ in range(4))
                                                  for _ in range(400)]])
    for i in range(0, 400, 23):
        ix.remove_document(i)
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    queries = ["qq", "qqr", "qq zz1", "zz2", "q"]
    planned, fb = p.plan_batch(queries, tokenizer, bm25.new())
    assert fb == [] and list(planned[4]) == [True, True, True, False, True]
    metrics.reset()
    got = p.query_batch_async(queries, bm25.new(), tokenizer, top_k=K).get_arrays()
    assert "device_fallback_queries" not in metrics.snapshot()["counters"]
    _agree_all(ix, queries, got)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_wide_class_lanes_phase_and_user_scorer(mesh):
    """A class past 16,384 lanes a shard (K3 + K5 per shard) beside narrow
    ones (``test_sharded_multiple_shape_classes_one_window``), and a user's
    one-phase scorer (``TfBoost``: staged lanes + K5 per shard)."""
    ix = Index(1, config=IndexConfig(chunk_size=128, range_min_expansions=0), device="cpu")
    # 200 terms p000..p199, each twice on every one of 8 shards.
    texts = [f"p{(i // 8) % 200:03d} common" for i in range(3200)]
    ix.add_documents_columnar(list(range(3200)), [texts])
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    queries = ["p", "p01", "p150 common", "p007"]
    planned, _fb = p.plan_batch(queries, tokenizer, bm25.new())
    specs, _l, _b = p._pack_window(planned, len(queries))
    assert max(nc for _bp, _bo, _nj, nc, _r in specs) * 128 > 16384 and len(specs) >= 3
    got = p.query_batch_async(queries, bm25.new(), tokenizer, top_k=K).get_arrays()
    _agree_all(ix, queries, got)
    p.config = dataclasses.replace(ix.config, result_format="f32")
    got = p.query_batch_async(queries[1:], TfBoost(), tokenizer, top_k=K).get_arrays()
    _agree_all(ix, queries[1:], got, scorer=TfBoost())


class TestShardedPruning:
    """``TestShardedPruning``: trim-only and exact; rows identical (keys and
    bit-equal f32 scores) with pruning on and off."""

    def _trimmed(self):
        return metrics.snapshot()["counters"].get("prune/sharded_trimmed_chunks", 0)

    def test_trims_and_stays_bit_equal(self):
        _j, ix_on = _skewed(prune=True)
        _j, ix_off = _skewed(prune=False)
        s_on = ShardedDeviceIndex(ix_on, cpu_mesh(2, 4))
        s_off = ShardedDeviceIndex(ix_off, cpu_mesh(2, 4))
        before = self._trimmed()
        r_on = s_on.query_batch_async(PRUNE_QUERIES, bm25.new(), tokenizer, top_k=3).get_arrays()
        assert self._trimmed() > before, "the skewed mix must trim chunks"
        r_off = s_off.query_batch_async(PRUNE_QUERIES, bm25.new(), tokenizer, top_k=3).get_arrays()
        for a, b in zip(r_on, r_off):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r_on[1], _oracle(ix_on, PRUNE_QUERIES, k=3)[1])

    def test_per_call_toggle_and_boosts(self):
        _j, ix = _skewed()
        p = ShardedDeviceIndex(ix, cpu_mesh(1, 8))
        queries = ["common", "common f10"]
        for boost in ([1.0, 1.0], [2.0, 0.5], [0.0, 1.0]):
            r_on = p.query_batch_async(queries, bm25.new(), tokenizer, boost, top_k=3).get_arrays()
            p.config.prune_blocks = False
            try:
                r_off = p.query_batch_async(queries, bm25.new(), tokenizer, boost, top_k=3).get_arrays()
            finally:
                p.config.prune_blocks = True
            for a, b in zip(r_on, r_off):
                np.testing.assert_array_equal(a, b, err_msg=str(boost))

    def test_pool_frozen_at_creation(self):
        """A pool made with pruning off carries no bounds; turning pruning on
        mid-life leaves it unpruned and aligned (``dist_query.py:292-305``)."""
        _j, ix = _skewed()
        p = ShardedDeviceIndex(ix, cpu_mesh(2, 4))
        p.config.prune_blocks = False
        try:
            first = p.query_batch_async(PRUNE_QUERIES, bm25.new(), tokenizer, top_k=3).get_arrays()
        finally:
            p.config.prune_blocks = True
        before = self._trimmed()
        again = p.query_batch_async(PRUNE_QUERIES + ["f3"], bm25.new(), tokenizer, top_k=3).get_arrays()
        assert self._trimmed() == before
        assert all("prune_sh" not in qp for qp in p._qplan_pools.values())
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a[: len(PRUNE_QUERIES)], b[: len(PRUNE_QUERIES)])

    def test_repeat_window_rides_cache(self):
        def count(name):
            return metrics.snapshot()["counters"].get(name, 0)

        _j, ix = _skewed()
        p = ShardedDeviceIndex(ix, cpu_mesh(2, 4))
        queries = ["common", "common f10", "f11 g12", "common"]
        first = p.query_batch_async(queries, bm25.new(), tokenizer, top_k=3).get_arrays()
        filled = count("prune/sharded_cache_fills")
        assert filled > 0
        splices = count("prune/sharded_cache_splices")
        again = p.query_batch_async(queries, bm25.new(), tokenizer, top_k=3).get_arrays()
        assert count("prune/sharded_cache_fills") == filled, "a repeat window must not refill"
        assert count("prune/sharded_cache_splices") > splices
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a, b)

    def test_k_gate_and_mutation_resnapshot(self):
        _j, ix = _skewed()
        p = ShardedDeviceIndex(ix, cpu_mesh(2, 4))
        before = self._trimmed()
        p.query_batch(["common"], bm25.new(), tokenizer, top_k=ix.config.prune_max_top_k + 1)
        assert self._trimmed() == before, "k above the cap must not prune"
        ix.remove_document(4)
        ix.add_document([lambda d: [d], lambda d: ["x"]], tokenizer, 5000, "common common common")
        p2 = ShardedDeviceIndex(ix, cpu_mesh(2, 4))
        r = p2.query_batch_async(["common", "common f10"], bm25.new(), tokenizer, top_k=3).get_arrays()
        np.testing.assert_array_equal(r[1], _oracle(ix, ["common", "common f10"], k=3)[1])


class TestRouting:
    """``TestUnifiedRouting`` on the port."""

    def test_attach_mesh_routes_query_batch(self, monkeypatch):
        ix = port_index(_corpus_jax_small())
        mesh = cpu_mesh(2, 4)
        ix.attach_mesh(mesh)
        monkeypatch.setattr(pcore.Index, "device_index", _no_single_device)
        h = ix.query_batch_async(SMALL_QUERIES, bm25.new(), tokenizer, top_k=K)
        assert type(h).__name__ == "ShardedPendingBatch"
        _agree_all(ix, SMALL_QUERIES, h.get_arrays())
        rows = ix.query_batch(SMALL_QUERIES, bm25.new(), tokenizer, top_k=K)
        assert ix.sharded_index().mesh is mesh
        assert_topk_agree(*_rows_arrays(ix, rows), *_oracle(ix, SMALL_QUERIES))
        monkeypatch.undo()
        ix.attach_mesh(None)  # back to single-device serving
        assert ix._sharded_cache is None
        assert type(ix.query_batch_async(SMALL_QUERIES, bm25.new(), top_k=K)).__name__ == "PendingBatch"

    def test_snapshot_cache_and_invalidation(self):
        ix = port_index(_corpus_jax_small())
        ix.attach_mesh(cpu_mesh(1, 8))
        s1 = ix.sharded_index()
        assert ix.sharded_index() is s1  # cache hit, no rebuild
        victim = next(iter(ix.docs))
        ix.remove_document(victim)
        s2 = ix.sharded_index()
        assert s2 is not s1
        rows = ix.query_batch(["a"], bm25.new(), tokenizer, top_k=50)
        assert rows[0] and all(r.key != victim for r in rows[0])
        ix.config = dataclasses.replace(ix.config, chunk_size=256)
        assert ix.sharded_index() is not s2 and ix.sharded_index().CHUNK == 256

    def test_capacity_overflow_autoshards(self, monkeypatch):
        """``test_capacity_overflow_autoshards``: the single-device snapshot
        refuses the slot count and several devices are visible -> the
        sharded engine over every visible device; one device -> host."""
        ix = port_index(_corpus_jax_small())
        queries = SMALL_QUERIES
        monkeypatch.setattr(pcore.Index, "device_index", _over_capacity)
        metrics.reset()
        host = ix.query_batch(queries, bm25.new(), tokenizer, top_k=K)  # one device
        assert metrics.snapshot()["counters"]["device_snapshot_fallbacks"] == 1
        monkeypatch.setattr(pcore, "_device_count", lambda device: 8)
        monkeypatch.setattr(pmesh, "visible_devices", lambda: [torch.device("cpu")] * 8)
        rows = ix.query_batch(queries, bm25.new(), tokenizer, top_k=K)
        assert metrics.snapshot()["counters"]["auto_sharded_batches"] == 1
        assert ix.sharded_index().mesh.shape == {"data": 1, "docs": 8}
        assert_topk_agree(*_rows_arrays(ix, rows), *_rows_arrays(ix, host))


SMALL_QUERIES = ["a", "ab c", "heavy", "b heavy", "c", "zzz", ""]


def _rows_arrays(ix, rows, k=K):
    s = np.full((len(rows), k), -np.inf, np.float32)
    d = np.full((len(rows), k), -1, np.int32)
    for i, row in enumerate(rows):
        for r, res in enumerate(row[:k]):
            s[i, r] = res.score
            d[i, r] = ix._key_to_slot[res.key]
    return s, d


def _corpus_jax_small():
    rng = random.Random(9)
    vocab = ["".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 4))) for _ in range(60)]
    jix = JIndex(2, config=JConfig(chunk_size=128))
    jix.add_documents_columnar(list(range(120)), [
        [" ".join(rng.choice(vocab) for _ in range(3)) + " heavy" for _ in range(120)],
        [" ".join(rng.choice(vocab) for _ in range(5)) for _ in range(120)],
    ])
    return jix


def _no_single_device(self):
    raise AssertionError("an attached mesh must route past the single-device snapshot")


def _over_capacity(self):
    raise ValueError("doc slots exceed the packed int32 merge-key capacity")


def test_make_mesh():
    """``make_mesh``: JAX's defaults and errors; the default devices are
    the visible CUDA devices, and without one it raises."""
    m = make_mesh(2, devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "docs": 4} and m.axis_names == ("data", "docs")
    assert m.devices.shape == (2, 4) and all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError, match="8 devices not divisible by data=3"):
        make_mesh(3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="mesh 2x3 != 8 devices"):
        make_mesh(2, 3, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        ix = Index(1, device="cpu")
        ix.add_documents_columnar([0], [["a"]])
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedDeviceIndex(ix, make_mesh(1, 2, devices=["cuda:0"] * 2))
