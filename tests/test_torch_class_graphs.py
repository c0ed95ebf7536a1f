"""The port's shape-keyed class graphs (``index.device.ClassGraphs``), on
the CPU.

A CUDA device replays one cached CUDA graph per class shape for every
window without a frozen template; the capture itself runs only on the card
(``tests/test_torch_cuda.py``).  Here ``EagerClasses`` (tests/torch_util.py)
stands in for the cache, so each window takes the class-graph path's keys,
static inputs and steps on the CPU:

- the keys hold every static that the JAX engine's program caches take as
  ``static_argnames`` (``_get_step``, ``_get_class_step``,
  ``_get_window_step``, ``_get_z2o_window_step``), plus the scorer's cache
  key, the result format and ``key_bits``; a change of any of them changes
  the key, and windows of other compositions whose classes share shapes
  share keys;
- over a drifting sequence of windows the keys stay within the nc, NJ and
  row buckets, and a second pass adds none;
- per-class, per-dispatch, term-range and zero-to-one windows on the path
  are bit-equal to the plain step and agree with the JAX engine on the same
  inputs (the testing rule of ``probly_search_tpu_torch.testing``).
"""

import dataclasses
import gc
import inspect
import re
import weakref

import numpy as np
import pytest

import probly_search_tpu.index.device as jdev
import probly_search_tpu.ops.z2o_device as jz
from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu import zero_to_one as jz2o
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25, zero_to_one
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.ops import z2o_device as pz
from probly_search_tpu_torch.testing import assert_topk_agree

from .test_torch_dispatch_modes import LIGHT, TOK, _port, _texts, _window
from .test_torch_z2o import _mixed_window, _rows_arrays
from .torch_util import EagerClasses

K = 5

# Each static of the JAX engine's program caches -> the key fields that
# carry it.  ``class_specs`` is a window's tuple of class shapes (a key holds
# one class's); ``fused_mode`` has no counterpart in the port: K4's route
# follows from the chunk, the class's lanes, the fields and ``fused_ok``.
BM25_STATICS = {
    "chunk": ("chunk",), "k": ("k",), "qterm_bits": ("qterm_bits",),
    "num_fields": ("num_fields",), "num_chunks": ("num_chunks",), "nj": ("nj",),
    "use_ranges": ("use_ranges",), "b_pad": ("b_out",), "fmt": ("fmt",),
    "class_specs": ("b_out", "nj", "num_chunks", "use_ranges", "chunk"),
}
Z2O_STATICS = {
    "chunk": ("chunk",), "k": ("k", "kk"), "num_fields": ("num_fields",),
    "class_specs": ("b_out", "nj", "num_chunks", "fast"), "fused_ok": ("fused_ok",),
    "fused_mode": ("chunk", "num_chunks", "num_fields", "fused_ok"), "fmt": ("fmt",),
}


def _static_argnames(fn):
    names = re.search(r"static_argnames=\(([^)]*)\)", inspect.getsource(fn)).group(1)
    return re.findall(r'"(\w+)"', names)


@pytest.mark.parametrize("jax_fn,statics,key", [
    (jdev._get_step, BM25_STATICS, pdev.ClassKey),
    (jdev._get_class_step, BM25_STATICS, pdev.ClassKey),
    (jdev._get_window_step, BM25_STATICS, pdev.ClassKey),
    (jz._get_z2o_window_step, Z2O_STATICS, pz.Z2OClassKey),
], ids=["_get_step", "_get_class_step", "_get_window_step", "_get_z2o_window_step"])
def test_key_holds_every_jax_static(jax_fn, statics, key):
    names = _static_argnames(jax_fn)
    assert names and set(names) <= set(statics), set(names) - set(statics)
    for name in names:
        assert set(statics[name]) <= set(key._fields), (name, statics[name])
    assert "key_bits" in key._fields and "fmt" in key._fields


@pytest.fixture(scope="module")
def corpus():
    vocab, texts = _texts(n=1200, seed=3)
    return vocab, texts, _window(vocab)


def _keys(ix, queries, scorer=None, k=K, dix=None, **cfg):
    """The class keys of one window served through the class-graph path on
    the CPU (``EagerClasses``), and that window's arrays."""
    dix = dix or DeviceIndex(ix, device="cpu")
    dix.config = dataclasses.replace(ix.config, **cfg)
    if dix._class_graphs is None:
        dix._class_graphs = EagerClasses("cpu")
    out = dix.query_batch_async(queries, scorer or bm25.new(), top_k=k).get_arrays()
    return dix._class_graphs.windows[-1], out


def _index(texts, n_fields=1, **cfg):
    """The port's index of ``texts`` (templates off, light classes on);
    with two fields the second holds the texts in reverse order."""
    cfg = IndexConfig(**{"light_chunk_size": LIGHT, "template_compositions": False, **cfg})
    ix = Index(n_fields, config=cfg, device="cpu")
    ix.add_documents_columnar(list(range(len(texts))), [texts, texts[::-1]][:n_fields])
    return ix


# field -> (base setting, changed setting): (index kwargs, queries, serve kwargs)
def _variants(vocab):
    q = [f"{vocab[i]} {vocab[i + 1]}" for i in range(0, 20, 2)]
    return {
        "scorer": ({}, q, {}), "scorer'": ({}, q, {"scorer": bm25.new(1.5, 0.5)}),
        "chunk": ({}, q, {"light_chunk_size": 0}), "chunk'": ({}, q, {}),
        "num_chunks": ({}, q[:4], {"light_chunk_size": 0}),
        "num_chunks'": ({}, [" ".join(vocab[:3])] * 4, {"light_chunk_size": 0}),
        "nj": ({}, [vocab[1]] * 4, {}), "nj'": ({}, [" ".join(vocab[:5])] * 4, {}),
        "b_out": ({}, q[:1] * 4, {}), "b_out'": ({}, q[:1] * 40, {}),
        "use_ranges": ({"range_min_expansions": 2}, ["t00"], {}),
        "use_ranges'": ({"range_min_expansions": 0}, ["t00"], {}),
        "k": ({}, q, {}), "k'": ({}, q, {"k": K + 2}),
        "fmt": ({}, q, {}), "fmt'": ({}, q, {"result_format": "compact"}),
        "fmt''": ({}, q, {"single_dispatch_windows": False}),
        "num_fields": ({}, q, {}), "num_fields'": ({"n_fields": 2}, q, {}),
        "key_bits": ({}, q, {}), "key_bits'": ({"n_docs": 40}, q, {}),
        "qterm_bits": ({}, q, {}), "qterm_bits'": ({}, q, {"qterm_bits": 3}),
    }


def _variant_keys(texts, setting):
    ix_kw, queries, kw = setting
    ix_kw, kw = dict(ix_kw), dict(kw)
    n_docs = ix_kw.pop("n_docs", len(texts))
    ix = _index(texts[:n_docs], ix_kw.pop("n_fields", 1), result_format="f32", **ix_kw)
    dix = DeviceIndex(ix, device="cpu")
    if "qterm_bits" in kw:
        dix._qterm_bits = kw.pop("qterm_bits")
    scorer, k = kw.pop("scorer", None), kw.pop("k", K)
    return _keys(ix, queries, scorer, k, dix=dix, **kw)[0]


@pytest.mark.parametrize("field", [f for f in pdev.ClassKey._fields if f != "program"])
def test_a_change_of_any_static_changes_the_key(corpus, field):
    vocab, texts, _w = corpus
    variants = _variants(vocab)
    base = _variant_keys(texts, variants[field])
    for name in (n for n in variants if n.rstrip("'") == field and n != field):
        other = _variant_keys(texts, variants[name])
        assert {getattr(x, field) for x in base}.isdisjoint({getattr(x, field) for x in other}), name
        assert set(base).isdisjoint(other), name


def test_windows_of_another_composition_share_keys(corpus):
    """A window reordered, or with one class's queries dropped, takes the
    keys of the classes it shares with the first; a query of a new shape
    adds exactly one key."""
    vocab, texts, window = corpus
    ix = _index(texts, result_format="f32", prune_blocks=False)
    dix = DeviceIndex(ix, device="cpu")
    first, want = _keys(ix, window, dix=dix)
    again, got = _keys(ix, window[::-1], dix=dix)
    assert sorted(first) == sorted(again) and len(dix._class_graphs) == len(set(first))
    np.testing.assert_array_equal(got[1], want[1][::-1])
    plan, _fb = dix.plan_batch(window, TOK, bm25.new())
    dropped = {window[i] for i in dix.pack_dispatches(len(window), plan)[0][0]}
    fewer, _ = _keys(ix, [q for q in window if q not in dropped], dix=dix)
    assert set(fewer) < set(first)
    more, _ = _keys(ix, window + [" ".join(vocab[:12])], dix=dix)
    assert len(set(more) - set(first)) == 1 == len(dix._class_graphs) - len(set(first))


def test_keys_stay_within_the_buckets_over_drifting_windows(corpus):
    """Windows of 20 to 300 queries drawn from a drifting vocabulary slice:
    every key's nc, NJ and row count lie in their buckets, the key count
    stays far below the windows' class count, and a second pass over the
    same windows adds no key."""
    vocab, texts, _w = corpus
    ix = _index(texts, result_format="f32", range_min_expansions=2, prune_blocks=False)
    dix = DeviceIndex(ix, device="cpu")
    rng = np.random.default_rng(5)
    windows = []
    for i in range(5):
        size = int(rng.integers(20, 300))
        lo = 4 * i
        windows.append([" ".join(vocab[j] for j in rng.integers(lo, lo + 20, rng.integers(1, 4)))
                        for _ in range(size)] + ["t0", "t00"][: i % 3])
    seen = 0
    for w in windows:
        seen += len(_keys(ix, w, dix=dix)[0])
    keys = set(dix._class_graphs.keys())
    ncs = set(dix.nc_buckets) | set(dix._LIGHT_NC_BUCKETS)
    for key in keys:
        assert key.num_chunks in ncs and key.nj in dix.NJ_BUCKETS, key
        assert key.b_out % 256 == 0 or key.b_out & (key.b_out - 1) == 0, key
        assert key.chunk in (dix.CHUNK, LIGHT)
    assert len(keys) < seen
    for w in windows:
        _keys(ix, w, dix=dix)
    assert set(dix._class_graphs.keys()) == keys


def test_heavy_sub_window_keys_apart_from_the_window(corpus):
    """The heavy-cache sub-window (one query, k = heavy_cache_top_k) goes
    through the same cache under keys of its own k."""
    vocab, texts, window = corpus
    ix = _index(texts, result_format="f32", heavy_cache_min_chunks=3)
    dix = DeviceIndex(ix, device="cpu")
    keys, got = _keys(ix, window, dix=dix)
    windows = dix._class_graphs.windows
    assert len(windows) > 1 and {x.k for x in windows[0]} == {ix.config.heavy_cache_top_k}
    assert {x.k for x in keys} == {K} and set(windows[0]).isdisjoint(keys)
    plain = DeviceIndex(ix, device="cpu").query_batch_async(window, bm25.new(), top_k=K)
    for a, b in zip(got, plain.get_arrays()):
        np.testing.assert_array_equal(a, b)


def test_a_dropped_snapshot_frees_without_a_collection(corpus):
    """The cache keeps each class's step (a CUDA graph keeps its capture),
    and a step holds the index's tensors, not the DeviceIndex: with the
    collector off, dropping the snapshot frees it (on a card: its records
    and its graphs' pool) by reference count alone."""
    vocab, texts, window = corpus
    ix = _index(texts, result_format="f32", range_min_expansions=2)
    gc.disable()
    try:
        dix = DeviceIndex(ix, device="cpu")
        keys, _out = _keys(ix, window + ["t00"], dix=dix)
        assert any(key.use_ranges for key in keys)
        assert all(callable(step) for step in dix._class_graphs._graphs.values())
        ref = weakref.ref(dix)
        del dix
        assert ref() is None
    finally:
        gc.enable()


@pytest.fixture(scope="module")
def ranges():
    """A cut of the range window of tests/test_torch_dispatch_modes.py
    (six plain queries, three with range terms: a small JAX compile) on
    both engines, and the JAX engine's rows of it (light classes,
    term-range jobs from two expansions, templates off)."""
    vocab, texts = _texts(n=1200, seed=3)
    window = _window(vocab)[:6] + ["t00", "t01 t020", "common t05"]
    ix = _port(texts, range_min_expansions=2, template_compositions=False, result_format="f32")
    jix = JIndex(1, config=JConfig(range_min_expansions=2, template_compositions=False,
                                   light_chunk_size=LIGHT, result_format="f32"))
    jix.add_documents_columnar(list(range(len(texts))), [texts])
    rows = jix.query_batch(window, jbm25.new(), TOK, top_k=K, backend="device")
    js = np.full((len(window), K), -np.inf, np.float32)
    jd = np.full((len(window), K), -1, np.int32)
    for qi, row in enumerate(rows):
        for r, res in enumerate(row):
            js[qi, r], jd[qi, r] = res.score, ix._key_to_slot[res.key]
    return ix, window, js, jd


@pytest.mark.parametrize("mode", ["composed", "per_class", "per_dispatch"])
def test_routed_bm25_windows_match_plain_and_jax(ranges, mode):
    """The range window through the class-graph path in each dispatch mode:
    bit-equal to the plain step, and equal to the JAX engine's rows."""
    ix, window, js, jd = ranges
    cfg = {"composed": {}, "per_class": {"per_class_dispatch": True},
           "per_dispatch": {"single_dispatch_windows": False}}[mode]
    keys, got = _keys(ix, window, **cfg)
    assert any(x.use_ranges for x in keys) and not all(x.use_ranges for x in keys)
    assert {x.fmt for x in keys} == {"parts" if mode == "per_dispatch" else "f32"}
    plain = DeviceIndex(ix, device="cpu")
    plain.config = dataclasses.replace(ix.config, **cfg)
    want = plain.query_batch_async(window, bm25.new(), top_k=K).get_arrays()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert_topk_agree(got[0], got[1], js, jd)


def test_routed_z2o_window_matches_plain_and_jax():
    """A zero-to-one window of fast and lockstep classes (the narrow ones
    the JAX engine compiles quickly) through the class-graph path:
    bit-equal to the plain ``_z2o_window_step``, and equal to the JAX
    engine's rows."""
    j, p, queries = _mixed_window()
    dix = p.device_index()
    nc = pz._bucket_vec(pz.plan_batch_z2o(dix, queries, TOK)[3], (2, 3, 4), 2)
    narrow = [q for q, n in zip(queries, nc) if n <= 2]
    keys, got = _keys(p, narrow, zero_to_one.new(), k=10, dix=DeviceIndex(p, device="cpu"))
    assert {x.fast for x in keys} == {True, False}
    want = dix.query_batch_async(narrow, zero_to_one.new(), top_k=10).get_arrays()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    jrows = j.query_batch(narrow, jz2o.new(), top_k=10, backend="device")
    assert_topk_agree(got[0], got[1], *_rows_arrays(j, jrows))
