"""The torch port's dispatch modes: light classes (``light_chunk_size``),
per-class dispatch and per-dispatch windows (``single_dispatch_windows=False``).

Against the JAX engine on host tables only (bit-exact, no device program):
``pack_dispatches`` 6-tuples and the template packer's specs and frozen
entries, light classes on and off, block-max pruning on and off;
``_light_width`` on invalid widths; manifests with light entries written by
each package and loaded by the other.  One JAX window served end to end
(templates and light classes on) against the port's rows.

The rest holds the port against itself and the f64 oracle
(``Index.query``): per-class windows bit-equal to the composed window in
all four result formats, range classes included; per-dispatch ``get()``
rows and ``get_arrays`` (also at a ``top_k`` past the smallest class's
lanes, where the JAX engine's drain fails) equal to the composed window's;
light on bit-equal to light off on the composed, template and per-class
paths, and with pruning; a per-dispatch window after a heavy-cache row
cached without scores; ``prewarm`` of a light template; zero-to-one
windows, which ignore all three options, as in JAX.

Tolerance against the oracle: ``probly_search_tpu_torch.testing`` (scores
``rtol=2e-5, atol=1e-6``, near-ties may swap); two routes of the port on the
same window agree bit for bit.
"""

import dataclasses
import random

import numpy as np
import pytest

import probly_search_tpu.index.device as jdev
from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu.index import prune as jprune
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25, zero_to_one
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.testing import assert_topk_agree
from probly_search_tpu_torch.utils.metrics import metrics

TOK = pdev.whitespace_tokenizer
LIGHT = 256
FORMATS = ("f32", "compact", "slots", "slots20")


def _texts(n=3000, seed=7):
    """The JAX light-class tests' corpus (60 terms of 30-600 postings: most
    posting lists sit in one mostly empty 1,024-lane chunk), plus a term in
    every doc, so that block-max pruning has chunks to drop."""
    rng = random.Random(seed)
    vocab = [f"t{i:03d}" for i in range(60)]
    texts = [" ".join(rng.choice(vocab) for _ in range(5)) for _ in range(n)]
    texts = ["common common common common" if i < 8 else t + " common" for i, t in enumerate(texts)]
    return vocab, texts


def _window(vocab):
    w = [f"{vocab[i % 30]} {vocab[(i * 7) % 30]}" for i in range(48)]
    w += [f"{vocab[3]} {vocab[4]} {vocab[5]}", vocab[10], "common", f"common {vocab[4]}", "zzz", ""]
    w += [" ".join(vocab[i : i + 6]) for i in range(0, 48, 6)]
    return w


def _port(texts, **cfg):
    ix = Index(1, config=IndexConfig(**{"light_chunk_size": LIGHT, **cfg}), device="cpu")
    ix.add_documents_columnar(list(range(len(texts))), [texts])
    return ix


@pytest.fixture(scope="module")
def corpus():
    vocab, texts = _texts()
    ix = _port(texts, result_format="f32")
    return vocab, texts, ix, DeviceIndex(ix, device="cpu"), _window(vocab)


@pytest.fixture(scope="module")
def engines(corpus):
    """The port's DeviceIndex and the JAX engine's over the same documents
    (host planning only on the JAX side)."""
    vocab, texts, _ix, _p, window = corpus
    jix = JIndex(1, config=JConfig(light_chunk_size=LIGHT))
    jix.add_documents_columnar(list(range(len(texts))), [texts])
    pix = _port(texts)
    return DeviceIndex(pix, device="cpu"), jdev.DeviceIndex(jix), window


def _set(dix, **cfg):
    dix.config = dataclasses.replace(dix.config, **cfg)


def _plans(p, j, queries, k, prune):
    """Both engines' plans of ``queries``, block-max pruned when ``prune``."""
    for d in (p, j):
        _set(d, prune_blocks=prune)
    pp, _ = p.plan_batch(queries, TOK, bm25.new())
    jp, _ = j.plan_batch(queries, TOK, jbm25.new())
    if prune:
        pp = p.prune(pp, bm25.new(), k, [1.0])
        jpool = j._plan_pools[jdev._scorer_cache_key(jbm25.new())]
        jp = jprune.prune_plan_cached(j, jp, jpool, k, [1.0])
        np.testing.assert_array_equal(pp.words, jp.words)
    return pp, jp


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("light", [0, LIGHT])
def test_pack_dispatches_match_jax(engines, light, prune):
    p, j, window = engines
    for d in (p, j):
        _set(d, light_chunk_size=light)
    queries = window * 12  # a class of more than 512 rows splits in pow2 spans
    pp, jp = _plans(p, j, queries, 3, prune)
    pd = p.pack_dispatches(len(queries), pp)
    jd = j.pack_dispatches(len(queries), jp)
    assert len(pd) == len(jd) > 2
    assert ({d[5] for d in pd} == {LIGHT, p.CHUNK}) == bool(light)
    for (pi, pj, *pcls), (ji, jj, *jcls) in zip(pd, jd):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pj, jj)
        assert pcls == jcls  # (nc, nj, rng, cw)
    p_nc = pdev._bucket_vec(pp.nchunks, p.nc_buckets, p.nc_min)
    j_nc = jdev._bucket_vec(jp.nchunks, j.nc_buckets, j.nc_min)
    for got, want in zip(p._light_classes(len(queries), pp, p_nc),
                         j._light_classes(len(queries), jp, j_nc)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("light", [0, LIGHT])
def test_template_entries_match_jax(engines, light, prune):
    """The template packer's dispatches, specs and frozen entries, over a
    small window (freeze), the full one (refreeze) and the small one again
    (fits the grown template)."""
    p, j, window = engines
    for d in (p, j):
        _set(d, light_chunk_size=light)
    tkey = ("t", light, prune)
    for w in (window[:20], window * 3, window[:20]):
        pp, jp = _plans(p, j, w, 3, prune)
        pd, pspecs = p._pack_dispatches_template(len(w), pp, tkey)
        jd, jspecs = j._pack_dispatches_template(len(w), jp, tkey)
        assert pspecs == tuple(tuple(s) for s in jspecs)
        assert p._comp_templates[tkey] == j._comp_templates[tkey]
        for (pi, pj, *pcls), (ji, jj, *jcls) in zip(pd, jd):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pj, jj)
            assert pcls == jcls
    entries = p._comp_templates[tkey]
    assert all(len(e) == 4 for e in entries)
    widths = [e[3] for e in entries]
    assert widths == sorted(widths, reverse=False) and (LIGHT in widths) == bool(light)


def test_light_width_matches_jax(engines):
    """Invalid widths (not a power of two, not a multiple of 128, not below
    the index's chunk width) turn light classes off, in both engines."""
    p, j, _w = engines
    for cw in (0, -256, 100, 128, 256, 300, 384, 512, 1024, 2048):
        for d in (p, j):
            _set(d, light_chunk_size=cw)
        assert p._light_width() == j._light_width() == (cw if cw in (128, 256, 512) else 0), cw
    small = DeviceIndex(_port(["a b", "b c"], chunk_size=128), device="cpu")
    assert small._light_width() == 0


def _light_template(dix, window, k=5):
    """Serve ``window`` on ``dix`` with templates and light classes on (it
    freezes a template with light entries); returns its key."""
    _set(dix, light_chunk_size=LIGHT, template_compositions=True, prune_blocks=True)
    dix._comp_templates.clear()
    dix.query_batch_async(window, bm25.new() if isinstance(dix, DeviceIndex) else jbm25.new(),
                          top_k=k).get_arrays()
    (tkey,) = dix._comp_templates
    assert any(e[3] == LIGHT for e in dix._comp_templates[tkey])
    return tkey


def _pack(dix, window, scorer, tkey, k=5):
    plan, _fb = dix.plan_batch(window, TOK, scorer)
    if isinstance(dix, DeviceIndex):
        plan = dix.prune(plan, scorer, k, [1.0])
    else:
        pool = dix._plan_pools[jdev._scorer_cache_key(scorer)]
        plan = jprune.prune_plan_cached(dix, plan, pool, k, [1.0])
    return dix._pack_dispatches_template(len(window), plan, tkey)[1]


def test_port_manifest_with_light_entries_loads_into_jax(engines, corpus, tmp_path):
    """The port's light template loads into the JAX engine as written and
    holds the same window there with no refreeze (host packing only)."""
    p, j, window = engines
    tkey = _light_template(p, window[:40])
    path = str(tmp_path / "port.json")
    assert p.save_templates(path) == 1
    _set(j, light_chunk_size=LIGHT, prune_blocks=True)
    j._comp_templates.clear()
    assert j.load_templates(path) == 1
    assert j._comp_templates == p._comp_templates
    from probly_search_tpu.utils.metrics import metrics as jmetrics

    before = jmetrics.counters["template_refreezes"]
    jspecs = _pack(j, window[:40], jbm25.new(), tkey)
    assert tuple(tuple(s) for s in jspecs) == p._template_specs(p._comp_templates[tkey])
    assert j._comp_templates == p._comp_templates
    assert jmetrics.counters["template_refreezes"] == before


def test_jax_manifest_with_light_entries_loads_into_port(engines, tmp_path):
    """A JAX light template (frozen by its host packer) loads into the port
    as written; the port holds the same window in it with no refreeze."""
    p, j, window = engines
    _set(j, light_chunk_size=LIGHT, prune_blocks=True)
    j._comp_templates.clear()
    tkey = (jdev._scorer_cache_key(jbm25.new()), 5, "f32", 40)
    jspecs = _pack(j, window[:40], jbm25.new(), tkey)
    assert any(s[5] == LIGHT for s in jspecs)
    path = str(tmp_path / "jax.json")
    assert j.save_templates(path) == 1
    _set(p, light_chunk_size=LIGHT, prune_blocks=True)
    p._comp_templates.clear()
    assert p.load_templates(path) == 1
    assert p._comp_templates == {tkey: [tuple(e) for e in j._comp_templates[tkey]]}
    before = metrics.counters["template_refreezes"]
    assert _pack(p, window[:40], bm25.new(), tkey) == tuple(tuple(s) for s in jspecs)
    assert metrics.counters["template_refreezes"] == before


def _oracle(ix, queries, k):
    s = np.full((len(queries), k), -np.inf, np.float32)
    d = np.full((len(queries), k), -1, np.int32)
    for qi, q in enumerate(queries):
        for r, res in enumerate(ix.query(q, bm25.new(), TOK, [1.0], top_k=k)):
            s[qi, r] = res.score
            d[qi, r] = ix._key_to_slot[res.key]
    return s, d


def test_light_template_window_matches_jax(corpus):
    """One JAX window served end to end (templates and light classes on)
    against the port's rows and the oracle."""
    vocab, texts, ix, _p, window = corpus
    jix = JIndex(1, config=JConfig(light_chunk_size=LIGHT, result_format="f32"))
    jix.add_documents_columnar(list(range(len(texts))), [texts])
    rows = jix.query_batch(window, jbm25.new(), TOK, top_k=5, backend="device")
    js = np.full((len(window), 5), -np.inf, np.float32)
    jd = np.full((len(window), 5), -1, np.int32)
    for qi, row in enumerate(rows):
        for r, res in enumerate(row):
            js[qi, r], jd[qi, r] = res.score, ix._key_to_slot[res.key]
    dix = DeviceIndex(_port(texts, result_format="f32"), device="cpu")
    s, sl, _k = dix.query_batch_async(window, bm25.new(), top_k=5).get_arrays()
    assert any(e[3] == LIGHT for e in next(iter(dix._comp_templates.values())))
    assert_topk_agree(s, sl, js, jd)
    assert_topk_agree(s, sl, *_oracle(ix, window, 5))


def _serve(dix, window, k=5, **cfg):
    saved = dix.config
    _set(dix, **cfg)
    try:
        return dix.query_batch_async(window, bm25.new(), top_k=k)
    finally:
        dix.config = saved


def _equal(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is y
        else:
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def ranges():
    """An index whose prefix queries plan term-range jobs (two expansions
    suffice), a window that mixes them with plain queries."""
    vocab, texts = _texts(n=1200, seed=3)
    ix = _port(texts, range_min_expansions=2, template_compositions=False)
    window = _window(vocab)[:40] + ["t00", "t01 t020", "t0", "common t05"]
    return ix, DeviceIndex(ix, device="cpu"), window


@pytest.mark.parametrize("fmt", FORMATS)
def test_per_class_matches_composed(ranges, fmt):
    ix, dix, window = ranges
    plan, _fb = dix.plan_batch(window, TOK, bm25.new())
    assert plan.has_range.any() and not plan.has_range.all()
    want = _serve(dix, window, result_format=fmt).get_arrays()
    got = _serve(dix, window, result_format=fmt, per_class_dispatch=True).get_arrays()
    _equal(got, want)
    if fmt == "f32":
        assert_topk_agree(got[0], got[1], *_oracle(ix, window, 5))


def test_per_dispatch_rows_match_composed(ranges):
    ix, dix, window = ranges
    want = _serve(dix, window, result_format="f32").get()
    h = _serve(dix, window, result_format="f32", single_dispatch_windows=False)
    assert h._packed is None and len(h._parts) > 1
    assert [[(r.key, r.score) for r in row] for row in h.get()] == [
        [(r.key, r.score) for r in row] for row in want
    ]
    # a slots format: the parts still carry f32 scores, and get() serves rows
    h = _serve(dix, window, result_format="slots20", single_dispatch_windows=False)
    s, sl, keys = h.get_arrays()
    _equal((s, sl, keys), _serve(dix, window, result_format="f32").get_arrays())
    assert len(h.get()) == len(window)


def test_per_dispatch_top_k_past_the_smallest_class():
    """top_k above the lanes of the smallest class (chunk 128: a 50-posting
    term's class has 256 lanes): every part padded to k columns, equal to
    the composed window.  The JAX engine's drain sizes its arrays from the
    first part and fails here."""
    rng = random.Random(5)
    texts = ["rare " + " ".join(f"w{rng.randint(0, 40)}" for _ in range(6)) if i < 50
             else " ".join(f"w{rng.randint(0, 40)}" for _ in range(6)) for i in range(900)]
    ix = _port(texts, chunk_size=128, light_chunk_size=0, result_format="f32")
    dix = DeviceIndex(ix, device="cpu")
    window = ["rare", " ".join(f"w{i}" for i in range(12))]
    k = 600
    h = _serve(dix, window, k=k, single_dispatch_windows=False)
    assert len(h._parts) == 2 and all(part[1].shape[1] == k for part in h._parts)
    got = h.get_arrays()
    assert got[1].shape == (2, k) and (got[1][0, 50:] == -1).all() and (got[1][1] >= 0).sum() > 256
    _equal(got, _serve(dix, window, k=k).get_arrays())
    pdev.fetch_windows_jointly([h, _serve(dix, window, k=k)])
    assert h._packed_host is None  # a parts window drains on its own


def test_per_dispatch_refills_a_scoreless_heavy_row(corpus):
    """A heavy-cache row cached by a composed slots20 window carries no
    scores; a per-dispatch window (f32 scores under every format) refills it
    at f32 instead of serving it without scores."""
    _v, _t, ix, _d, window = corpus
    w = window[:8] + ["common"]
    heavy = dict(heavy_cache_min_chunks=3, template_compositions=False)
    dix = DeviceIndex(ix, device="cpu")
    assert _serve(dix, w, result_format="slots20", **heavy).get_arrays()[0] is None
    assert [row[0] for row in dix._heavy_cache.values()] == [None]
    h = _serve(dix, w, result_format="slots20", single_dispatch_windows=False, **heavy)
    assert h._parts and h._array_rows
    want = _serve(DeviceIndex(ix, device="cpu"), w, result_format="f32", **heavy)
    _equal(h.get_arrays(), want.get_arrays())
    assert [[(r.key, r.score) for r in row] for row in h.get()] == [
        [(r.key, r.score) for r in row] for row in want.get()
    ]


@pytest.mark.parametrize("path", ["composed", "template", "per_class"])
def test_light_on_matches_off(corpus, path, monkeypatch):
    _v, _t, ix, dix, window = corpus
    chunks = []
    real = pdev._query_step

    def spy(*a, **kw):
        chunks.append(kw["chunk"])
        return real(*a, **kw)

    monkeypatch.setattr(pdev, "_query_step", spy)
    cfg = {
        "composed": dict(template_compositions=False),
        "template": dict(template_compositions=True),
        "per_class": dict(per_class_dispatch=True),
    }[path]
    dix._comp_templates.clear()
    plan, _fb = dix.plan_batch(window, TOK, bm25.new())
    if path == "template":
        _serve(dix, window, k=10, light_chunk_size=LIGHT, **cfg).get_arrays()  # freeze
    chunks.clear()
    on = _serve(dix, window, k=10, light_chunk_size=LIGHT, **cfg).get_arrays()
    assert set(chunks) == {LIGHT, dix.CHUNK}  # light classes run at their own width
    if path == "template":  # a frozen template keeps its light entries
        light_entries = dict(dix._comp_templates)
        dix._comp_templates.clear()
        _serve(dix, window, k=10, light_chunk_size=0, **cfg).get_arrays()
    chunks.clear()
    off = _serve(dix, window, k=10, light_chunk_size=0, **cfg).get_arrays()
    assert set(chunks) == {dix.CHUNK}
    _equal(on, off)
    assert_topk_agree(on[0], on[1], *_oracle(ix, window, 10))
    if path == "template":
        (entries,) = light_entries.values()
        assert any(e[3] == LIGHT for e in entries)
    else:
        widths = {d[5] for d in dix.pack_dispatches(len(window), dix.prune(plan, bm25.new(), 10, [1.0]))}
        assert LIGHT in widths


def test_light_with_pruning(corpus):
    """Pruned (trimmed or split) jobs decompose at the light width: rows of
    light on with pruning equal those of light on without it."""
    _v, _t, ix, dix, window = corpus
    before = metrics.counters.get("prune/pruned_chunks", 0)
    on = _serve(dix, window, k=3, light_chunk_size=LIGHT, prune_blocks=True).get_arrays()
    assert metrics.counters.get("prune/pruned_chunks", 0) > before
    off = _serve(dix, window, k=3, light_chunk_size=LIGHT, prune_blocks=False).get_arrays()
    _equal(on, off)
    assert_topk_agree(on[0], on[1], *_oracle(ix, window, 3))


def test_prewarm_light_template(corpus, tmp_path):
    """A light template frozen, saved, loaded into a fresh DeviceIndex and
    prewarmed (on the CPU prewarm only runs the step); the fresh index then
    serves the window in it with no refreeze, rows equal to the first's."""
    _v, _t, ix, dix, window = corpus
    tkey = _light_template(dix, window)
    want = _serve(dix, window).get_arrays()
    path = str(tmp_path / "light.json")
    assert dix.save_templates(path) == 1
    fresh = DeviceIndex(ix, device="cpu")
    _set(fresh, light_chunk_size=LIGHT)
    assert fresh.load_templates(path) == 1 and fresh._comp_templates[tkey] == dix._comp_templates[tkey]
    assert fresh.prewarm(bm25.new()) == 1
    before = metrics.counters["template_refreezes"]
    _equal(_serve(fresh, window).get_arrays(), want)
    assert metrics.counters["template_refreezes"] == before


@pytest.mark.parametrize("option", [
    {"light_chunk_size": LIGHT}, {"per_class_dispatch": True}, {"single_dispatch_windows": False},
])
def test_z2o_ignores_the_options(corpus, option):
    """A zero-to-one window serves the same rows under each option as with
    none of them (the JAX engine's z2o path reads none of the three;
    tests/test_torch_z2o.py holds these rows against JAX's)."""
    _v, _t, _ix, dix, window = corpus
    want = dix.query_batch_async(window, zero_to_one.new(), top_k=5).get_arrays()
    saved = dix.config
    _set(dix, **option)
    try:
        got = dix.query_batch_async(window, zero_to_one.new(), top_k=5).get_arrays()
    finally:
        dix.config = saved
    _equal(got, want)
    assert (want[1] >= 0).any()
