"""The torch port's serving path, end to end on the CPU, against the JAX
engine (staged XLA path, ``_FUSED_MODE = "off"``) and the f64 oracle.

Covers two windows that reuse one frozen template, the f32 and slots20
result formats, ``get()`` rows, a wide class through the lanes phase, the
heavy-query cache, host fallback for a query of more than 16 terms, empty
and unknown-term queries, latent deletes and the blocking serving loop.

Tolerance: scores ``rtol=2e-5, atol=1e-6`` (the repo's device-vs-oracle
bar); slots equal except that neighbours within that score tolerance may
swap (``probly_search_tpu_torch.testing``).  Two formats or two routes of
the port on the same window agree bit for bit.
"""

import dataclasses
import random

import numpy as np
import pytest

import probly_search_tpu.index.device as jdev
from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu_torch.utils.metrics import metrics
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25, zero_to_one
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.testing import assert_topk_agree

from .util import Doc, text_extract, title_extract, tokenizer

BOOST = [1.5, 0.5]
K = 10


def _corpus(seed=21):
    """The JAX Index and the port's, built from the same documents."""
    rng = random.Random(seed)
    vocab = ["".join(rng.choice("abcdefg") for _ in range(rng.randint(2, 4))) for _ in range(90)]
    hot = ["hot%d" % i for i in range(4)]
    jix = JIndex(2, config=JConfig(chunk_size=128))
    ix = Index(2, config=IndexConfig(chunk_size=128), device="cpu")
    for i in range(420):
        title = " ".join([rng.choice(hot)] + [rng.choice(vocab) for _ in range(rng.randint(0, 3))])
        body = " ".join(rng.choice(hot + vocab) for _ in range(rng.randint(1, 8)))
        doc = Doc(id=i, title=title, text=body)
        for x in (jix, ix):
            x.add_document([title_extract, text_extract], tokenizer, i, doc)
    for key in (3, 50, 51, 200):
        for x in (jix, ix):
            x.remove_document(key)  # latent deletes: no vacuum
    window = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(30)]
    window += [
        "hot0", "hot0 hot1 hot2", "hot1 hot3 %s" % vocab[4], "a", "bc", "",
        "zzzz", "zzzz %s" % vocab[7], " ".join(vocab[:17]),
    ]
    return jix, ix, window


@pytest.fixture(scope="module")
def served():
    jix, ix, w1 = _corpus()
    w2 = list(reversed(w1))  # same composition: reuses w1's template
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdev, "_FUSED_MODE", "off")
        jdev._STEP_CACHE.clear()
        j = jdev.DeviceIndex(jix)
        jout = [j.query_batch_async(w, jbm25.new(), fields_boost=BOOST, top_k=K) for w in (w1, w2)]
        jarr = [h.get_arrays() for h in jout]
        jrows = j.query_batch_async(w1, jbm25.new(), fields_boost=BOOST, top_k=K).get()
        jdev._STEP_CACHE.clear()
    p = DeviceIndex(ix, device="cpu")
    return jix, p, (w1, w2), jarr, jrows


def _port(p, w, **cfg):
    p.config = dataclasses.replace(p._index.config, **cfg)
    try:
        return p.query_batch_async(w, bm25.new(), fields_boost=BOOST, top_k=K)
    finally:
        p.config = p._index.config


def _oracle(ix, w):
    s = np.full((len(w), K), -np.inf, np.float32)
    d = np.full((len(w), K), -1, np.int32)
    for qi, q in enumerate(w):
        for r, res in enumerate(ix.query(q, jbm25.new(), tokenizer, BOOST, top_k=K)):
            s[qi, r] = res.score
            d[qi, r] = ix._key_to_slot[res.key]
    return s, d


def test_windows_match_jax_and_oracle(served):
    ix, p, windows, jarr, _ = served
    outs = []
    for w, (js, jsl, jk) in zip(windows, jarr):
        before = {k: list(v) for k, v in p._comp_templates.items()}
        ps, psl, pk = p.query_batch_async(w, bm25.new(), fields_boost=BOOST, top_k=K).get_arrays()
        assert_topk_agree(ps, psl, js, jsl)
        assert_topk_agree(ps, psl, *_oracle(ix, w))
        np.testing.assert_array_equal(pk[psl >= 0], p.key_arr[psl[psl >= 0]])
        outs.append((ps, psl))
    assert len(p._comp_templates) == 1 and before == p._comp_templates  # one template, reused
    # the reversed window gives the same rows, reversed
    np.testing.assert_array_equal(outs[1][1], outs[0][1][::-1])
    w1 = windows[0]
    for q in ("", "zzzz"):
        assert (outs[0][1][w1.index(q)] == -1).all()
    assert (outs[0][1][w1.index("hot0")] >= 0).all()


def test_get_rows_match_jax(served):
    ix, p, windows, _, jrows = served
    rows = p.query_batch_async(windows[0], bm25.new(), fields_boost=BOOST, top_k=K).get()
    for q, prow, jrow in zip(windows[0], rows, jrows):
        s = lambda row: np.array([[r.score for r in row] + [-np.inf] * (K - len(row))], np.float32)
        d = lambda row: np.array([[ix._key_to_slot[r.key] for r in row] + [-1] * (K - len(row))])
        assert_topk_agree(s(prow), d(prow), s(jrow), d(jrow))


@pytest.mark.parametrize("fmt", ["slots20", "slots", "compact"])
def test_formats_match_f32(served, fmt):
    _ix, p, windows, _, _ = served
    h = p.query_batch_async(windows[0], bm25.new(), fields_boost=BOOST, top_k=K)
    want_s, want, _k = h.get_arrays()
    h = _port(p, windows[0], result_format=fmt)
    scores, slots, keys = h.get_arrays()
    np.testing.assert_array_equal(slots, want)
    if fmt == "compact":  # f16 score report of the same f32 ranking ...
        dev = slice(0, -1)  # ... except the last query's, served on the host
        want_f16 = want_s[dev].astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(scores[dev], want_f16)
        np.testing.assert_array_equal(scores[-1], want_s[-1])
        return
    assert scores is None
    with pytest.raises(ValueError):
        h.get()


def test_wide_class_takes_the_lanes_phase(served, monkeypatch):
    ix, p, windows, jarr, _ = served
    w = windows[0]
    plan, _fb = p.plan_batch(w, tokenizer, bm25.new())
    ncs = {d[2] for d in p.pack_dispatches(len(w), plan)}
    assert max(ncs) * p.CHUNK > 256 >= min(ncs) * p.CHUNK, ncs
    want = p.query_batch_async(w, bm25.new(), fields_boost=BOOST, top_k=K).get_arrays()
    monkeypatch.setattr(pdev, "_FUSED_MAX_LANES", 256)
    calls = []
    real = pdev.fused_query_topk

    def spy(*a, **kw):
        calls.append(kw.get("phase", "full"))
        return real(*a, **kw)

    monkeypatch.setattr(pdev, "fused_query_topk", spy)
    got = p.query_batch_async(w, bm25.new(), fields_boost=BOOST, top_k=K).get_arrays()
    assert "lanes" in calls and "full" in calls
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert_topk_agree(got[0], got[1], jarr[0][0], jarr[0][1])


def test_heavy_cache(served):
    _ix, p, windows, jarr, _ = served
    hits0 = metrics.snapshot()["counters"].get("heavy_cache_hits", 0)
    for _ in range(2):  # misses fill the cache, the repeat hits it
        s, sl, _k = _port(p, windows[0], heavy_cache_min_chunks=3).get_arrays()
        assert_topk_agree(s, sl, jarr[0][0], jarr[0][1])
    assert p._heavy_cache
    assert metrics.snapshot()["counters"].get("heavy_cache_hits", 0) > hits0


def test_host_fallback_row(served):
    ix, p, windows, _, _ = served
    q = windows[0][-1]  # 17 terms: past max_query_terms, served on the host
    plan, fallback = p.plan_batch([q], tokenizer, bm25.new())
    assert plan is None and fallback == [0]
    s, sl, _k = p.query_batch_async([q], bm25.new(), fields_boost=BOOST, top_k=K).get_arrays()
    assert_topk_agree(s, sl, *_oracle(ix, [q]))


def test_blocking_serving_loop(served):
    _ix, p, windows, _, _ = served
    want = p.query_batch_async(windows[0], bm25.new(), fields_boost=BOOST, top_k=K).get()
    p.config = dataclasses.replace(p._index.config, serving_window=8, serving_depth=2)
    try:
        got = p.query_batch(windows[0], bm25.new(), fields_boost=BOOST, top_k=K)
    finally:
        p.config = p._index.config
    assert [[(r.key, r.score) for r in row] for row in got] == [
        [(r.key, r.score) for r in row] for row in want
    ]


def test_not_ported_options_raise(served):
    _ix, p, windows, _, _ = served
    for cfg in ({"per_class_dispatch": True}, {"single_dispatch_windows": False}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port(p, windows[0], **cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeviceIndex(Index(1, config=IndexConfig(light_chunk_size=128)), device="cpu")
    # zero-to-one is served now (tests/test_torch_z2o.py holds its results)
    z2o = p.query_batch_async(windows[0], zero_to_one.new(), top_k=K).get_arrays()
    assert z2o[1].shape == (len(windows[0]), K) and (z2o[1] >= 0).any()
    for call in (p.save_templates, p.load_templates):
        with pytest.raises(NotImplementedError, match="M8"):
            call("templates.json")
    with pytest.raises(NotImplementedError, match="M8"):
        p.prewarm(bm25.new())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pdev.fetch_windows_jointly([p.query_batch_async(windows[0], bm25.new())])
    with pytest.raises(NotImplementedError, match="M9"):
        Index(1, device="cpu").attach_mesh(object())  # the port refuses any mesh


def test_chunk_width_not_a_power_of_two(monkeypatch):
    """A chunk width that is not a power of two takes the staged torch path
    with the general sort merge, never the fused kernel's wrapper."""
    jix, ix, w = _corpus(seed=5)
    ix.config.chunk_size = 384
    p = DeviceIndex(ix, device="cpu")
    monkeypatch.setattr(pdev, "fused_query_topk", None)
    s, sl, _k = p.query_batch_async(w, bm25.new(), fields_boost=BOOST, top_k=K).get_arrays()
    assert_topk_agree(s, sl, *_oracle(jix, w))
