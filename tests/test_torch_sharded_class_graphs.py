"""The doc-sharded engine's class graphs (``parallel/dist_query.py``) on
CPU meshes (2, 4) and (1, 8).

On a CUDA mesh every sharded window replays one cached CUDA graph per
(group, class shape), a group being the cells of one data row on one
device; the capture itself runs only on the card
(``tests/test_torch_cuda.py -k sharded_class_graph``).  Here
``EagerClasses`` (tests/torch_util.py), one per device of the mesh, stands
in for the caches, so each window takes the graph path's keys, static
inputs, group steps and copies out on the CPU:

- the keys hold every static of the JAX engine's sharded program cache
  (the elements of the key tuples of ``_get_window_step`` and
  ``_get_z2o_window_step``, parsed from the JAX source, and the snapshot
  statics their programs read), and a change of any of them changes the
  key;
- the two data rows of a mesh on one device share keys, and over a
  drifting sequence of windows the keys stay within the nc, NJ and row
  buckets and a second pass adds none;
- a BM25 window of every class kind, a ``TfBoost`` window and a
  zero-to-one window of fast and lockstep classes are bit-equal (packed
  rows) to the eager step on the same words, and agree with the JAX
  engine's sharded rows (``TfBoost``: with the f64 host oracle, which keeps
  this file at two JAX programs) by ``probly_search_tpu_torch.testing``'s
  rule.
"""

import ast
import dataclasses
import gc
import inspect
import textwrap
import weakref

import numpy as np
import pytest
import torch

from probly_search_tpu import bm25 as jbm25
from probly_search_tpu.parallel import ShardedDeviceIndex as JSharded
from probly_search_tpu.parallel import make_mesh as jmake_mesh
from probly_search_tpu_torch import Index, IndexConfig, bm25
from probly_search_tpu_torch.index.device import ClassKey
from probly_search_tpu_torch.ops.z2o_device import Z2OClassKey
from probly_search_tpu_torch.parallel import ShardedDeviceIndex
from probly_search_tpu_torch.parallel.dist_query import ShardedClassKey, ShardedZ2OClassKey
from probly_search_tpu_torch.testing import assert_topk_agree

from .test_torch_planner import port_index
from .test_torch_sharding import K, MESHES, _corpus, _oracle, cpu_mesh
from .test_torch_sharding_z2o import _index as _z2o_index
from .test_torch_sharding_z2o import _queries as _z2o_queries
from .torch_util import EagerClasses, TfBoost
from .util import tokenizer

# Each element of the JAX engine's sharded key tuples (source text) -> the
# port's key fields that carry it.  ``_FUSED_MODE`` has no counterpart: the
# kernels' routes follow from the fields named.  ``fmt`` maps to no field:
# JAX's program packs its rows, the port's graph returns f32 scores and
# global slots under every format (the merge packs them outside it), so
# windows of every format share graphs (test_formats_share_keys).
BM25_KEY = {
    "getattr(scorer, 'device_cache_key', lambda: ('id', id(scorer)))()": ("scorer",),
    "class_specs": ("b_out", "nj", "num_chunks", "use_ranges"),
    "k": ("k",),
    "fmt": (),
    "_dev._FUSED_MODE": ("scorer", "chunk", "num_chunks", "use_ranges"),
}
Z2O_KEY = {
    "'z2o_lock' if lockstep else 'z2o'": ("fast",),
    "class_specs": ("b_out", "nj", "num_chunks"),
    "k": ("k", "kk"),
    "fmt": (),
    "_dev._FUSED_MODE": ("chunk", "num_chunks", "num_fields", "fused_ok"),
}
# The snapshot statics the JAX programs read (source text) -> key fields.
BM25_SNAPSHOT = {
    "self.CHUNK": ("chunk",), "self._qterm_bits": ("qterm_bits",),
    "self.num_fields": ("num_fields",), "self.n_shards": ("shards",),
}
Z2O_SNAPSHOT = {
    "self.CHUNK": ("chunk",), "self.num_fields": ("num_fields",),
    "self.n_shards": ("shards",), "self.local_slots < (1 << 26)": ("fused_ok",),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops on the CPU: where several test workers share the
    cores, OpenMP's spinning threads slow them by an order of magnitude, so
    this module runs torch on one thread (as test_torch_sharding.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_key(fn):
    """The elements of the key tuple that the JAX program cache ``fn``
    builds, as source text."""
    for node in ast.walk(ast.parse(textwrap.dedent(inspect.getsource(fn)))):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "key":
            items = node.value.elts if isinstance(node.value, ast.Tuple) else [node.value]
            return [ast.unparse(e) for e in items]
    raise AssertionError(f"no key tuple in {fn.__name__}")


@pytest.mark.parametrize("jax_fn,key_map,snapshot,key,single", [
    (JSharded._get_window_step, BM25_KEY, BM25_SNAPSHOT, ShardedClassKey, ClassKey),
    (JSharded._get_z2o_window_step, Z2O_KEY, Z2O_SNAPSHOT, ShardedZ2OClassKey, Z2OClassKey),
], ids=["_get_window_step", "_get_z2o_window_step"])
def test_key_holds_every_jax_static(jax_fn, key_map, snapshot, key, single):
    items = _jax_key(jax_fn)
    assert set(items) == set(key_map), set(items) ^ set(key_map)
    source = inspect.getsource(jax_fn)
    for name, fields in {**key_map, **snapshot}.items():
        assert name in source or name in items, name
        assert set(fields) <= set(key._fields), (name, fields)
    # Every field of the single-device key but its format, plus the group's
    # shards.
    assert set(single._fields) - {"fmt"} | {"shards"} == set(key._fields)


def _graphs(p):
    """``p`` on the class-graph path on the CPU: ``EagerClasses`` for each
    device of its mesh."""
    p._class_graphs = {dev: EagerClasses(dev) for dev in dict.fromkeys(p.mesh.devices.reshape(-1))}
    return p


def _serve(p, queries, scorer, k=K):
    """One window of ``scorer`` (None: zero-to-one) -> (handle, arrays)."""
    if scorer is None:
        h = p.query_batch_z2o(queries, tokenizer=tokenizer, top_k=k)
    else:
        h = p.query_batch_async(queries, scorer, tokenizer, top_k=k)
    return h, h.get_arrays()


def _runs(p):
    """The keys of every ``ClassGraphs.run`` so far, one list a run."""
    return [w for g in p._class_graphs.values() for w in g.windows]


def _small(n_docs=400, n_fields=1, chunk=128, **cfg):
    """The port's index of ``n_docs`` docs of six words of t000..t119
    (``t00`` expands to ten terms)."""
    rng = np.random.default_rng(3)
    texts = [" ".join(f"t{j:03d}" for j in rng.integers(0, 120, 6)) for _ in range(n_docs)]
    cfg = {"range_min_expansions": 0, "result_format": "f32", **cfg}
    ix = Index(n_fields, config=IndexConfig(chunk_size=chunk, **cfg), device="cpu")
    ix.add_documents_columnar(list(range(n_docs)), [texts, texts[::-1]][:n_fields])
    return ix


Q = ["t001 t002", "t003", "t010 t011 t012", "t020"]
# key field -> two settings, the base first, each a dict of "ix" (``_small``
# kwargs), "mesh", "q" (the window), "scorer" (None: zero-to-one), "k",
# "qterm_bits" and "local_slots" (set on the snapshot).
VARIANTS = {
    "scorer": [{}, {"scorer": bm25.new(1.5, 0.5)}],
    "chunk": [{}, {"ix": {"chunk": 256}}],
    "num_chunks": [{"q": ["t001"] * 4}, {"q": [" ".join(f"t{j:03d}" for j in range(6))] * 4}],
    "nj": [{"q": ["t001"] * 4}, {"q": ["t001 t002 t003 t004 t005"] * 4}],
    "b_out": [{"q": Q[:1] * 4}, {"q": Q[:1] * 40}],
    "use_ranges": [{"ix": {"range_min_expansions": 2}, "q": ["t00"]}, {"q": ["t00"]}],
    "k": [{}, {"k": K + 2}],
    "qterm_bits": [{}, {"qterm_bits": 3}],
    "num_fields": [{}, {"ix": {"n_fields": 2}}],
    "key_bits": [{}, {"ix": {"n_docs": 40}}],
    "shards": [{}, {"mesh": (1, 2)}],
    "fast": [{"scorer": None}, {"scorer": None, "q": ["t001 t001", "t00 t001"]}],
    "kk": [{"scorer": None}, {"scorer": None, "k": K + 2}],
    "fused_ok": [{"scorer": None}, {"scorer": None, "local_slots": 1 << 26}],
}


def _variant_keys(setting):
    ix = _small(**setting.get("ix", {}))
    p = _graphs(ShardedDeviceIndex(ix, cpu_mesh(*setting.get("mesh", (1, 4)))))
    if "qterm_bits" in setting:
        p._qterm_bits = setting["qterm_bits"]
    if "local_slots" in setting:
        p.local_slots = setting["local_slots"]
    _serve(p, setting.get("q", Q), setting.get("scorer", bm25.new()), setting.get("k", K))
    return {key for run in _runs(p) for key in run}


@pytest.mark.parametrize("field", list(VARIANTS))
def test_a_change_of_any_static_changes_the_key(field):
    base, other = (_variant_keys(s) for s in VARIANTS[field])
    assert base and other
    assert {getattr(x, field) for x in base}.isdisjoint({getattr(x, field) for x in other})
    assert base.isdisjoint(other)


def test_variants_cover_every_key_field():
    fields = (set(ShardedClassKey._fields) | set(ShardedZ2OClassKey._fields)) - {"program"}
    assert fields == set(VARIANTS)


@pytest.mark.parametrize("scorer", [bm25.new(), None], ids=["bm25", "z2o"])
def test_formats_share_keys(scorer):
    """The group graphs return f32 scores and global slots under every
    format: an f32 window and then a slots20 and a compact window of the
    same queries run the same keys, capture nothing new, and serve the
    same slots."""
    p = _graphs(ShardedDeviceIndex(_small(), cpu_mesh(2, 2)))
    (cache,) = p._class_graphs.values()
    slots = []
    for fmt in ("f32", "slots20", "compact"):
        p.config = dataclasses.replace(p.config, result_format=fmt)
        n_runs = len(_runs(p))
        slots.append(_serve(p, Q, scorer)[1][1])
        if fmt == "f32":
            keys, n_keys = _runs(p)[n_runs:], len(cache)
        else:
            assert _runs(p)[n_runs:] == keys and len(cache) == n_keys, fmt
        np.testing.assert_array_equal(slots[-1], slots[0])


@pytest.fixture(scope="module")
def corpus():
    """test_torch_sharding's corpus (ranges from 24 expansions, at most 6
    query terms, 24 tie docs over every shard, latent deletes) and a cut of
    its window with every class kind: per-expansion classes of six widths,
    a term-range class (``qq``), a host-fallback query (seven terms) and
    ties across shards (``tie``)."""
    jix, ix, window = _corpus()
    ix.config = dataclasses.replace(ix.config, result_format="f32")
    return jix, ix, window[:6] + window[40:43] + ["heavy", "tie", "tie last", "qq", window[-1]]


@pytest.fixture(scope="module")
def z2o():
    """test_torch_sharding_z2o's two-field corpus and a cut of its window
    with fast classes (nc 2 and 4) and a lockstep class (``ab ab``)."""
    jix, vocab = _z2o_index(2, 480, 17)
    queries = _z2o_queries(vocab)
    ix = port_index(jix)
    ix.config = dataclasses.replace(ix.config, result_format="f32")
    return jix, ix, [queries[i] for i in (0, 3, 6, 10, 12, 13, 15)]


@pytest.fixture(scope="module")
def jax_rows(corpus, z2o):
    """The JAX engine's sharded rows on mesh (2, 4): the BM25 window and
    the zero-to-one window (its two programs, fast and lockstep)."""
    jix, _ix, window = corpus
    bm = JSharded(jix, jmake_mesh(2, 4)).query_batch_async(window, jbm25.new(), tokenizer, top_k=K)
    zjix, _zix, zwindow = z2o
    zz = JSharded(zjix, jmake_mesh(2, 4)).query_batch_z2o(zwindow, tokenizer=tokenizer, top_k=K)
    return {"bm25": bm.get_arrays(), "z2o": zz.get_arrays()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("kind", ["bm25", "tfboost", "z2o"])
def test_window_bit_equal_to_eager_and_agrees_with_jax(corpus, z2o, jax_rows, kind, mesh):
    """The window on the class-graph path against the eager step (the same
    ShardedDeviceIndex with no caches) on the same words: packed rows and
    arrays bit-equal; then against the JAX engine (``TfBoost``: the f64
    host oracle) by the testing rule."""
    _jix, ix, window = z2o if kind == "z2o" else corpus
    scorer = {"bm25": bm25.new(), "tfboost": TfBoost(), "z2o": None}[kind]
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    want_h, want = _serve(p, window, scorer)
    got_h, got = _serve(_graphs(p), window, scorer)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got_h._packed) == len(want_h._packed) == (2 if kind == "z2o" else 1)
    for rows_g, rows_w in zip(got_h._packed, want_h._packed):
        assert len(rows_g) == mesh[0]
        for a, b in zip(rows_g, rows_w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    keys = {key for run in _runs(p) for key in run}
    if kind == "z2o":
        assert {key.fast for key in keys} == {True, False}
        assert_topk_agree(got[0], got[1], *jax_rows["z2o"][:2])
        return
    assert len({key.num_chunks for key in keys}) >= 5 and got_h._host_rows
    if kind == "bm25":
        assert {key.use_ranges for key in keys} == {True, False}
        assert_topk_agree(got[0], got[1], *jax_rows["bm25"][:2])
        tie = window.index("tie")
        assert list(got[1][tie]) == sorted(got[1][tie])  # ties take the lowest global slots
    else:  # a scorer without range support: staged lanes + K5 on every class
        assert {key.scorer for key in keys} == {("tfboost",)}
        assert_topk_agree(got[0], got[1], *_oracle(ix, window, scorer=scorer))


@pytest.mark.parametrize("kind", ["bm25", "z2o"])
def test_data_rows_on_one_device_share_keys(corpus, z2o, kind):
    """Mesh (2, 4) on one device: both data rows run the same keys, so the
    cache holds one set; a second window captures nothing new."""
    _jix, ix, window = z2o if kind == "z2o" else corpus
    scorer = None if kind == "z2o" else bm25.new()
    p = _graphs(ShardedDeviceIndex(ix, cpu_mesh(2, 4)))
    _serve(p, window, scorer)
    runs = _runs(p)
    assert len(runs) == 2 * (2 if kind == "z2o" else 1)  # a run a data row (a dispatch)
    assert runs[0] == runs[1] and all(key.shards == (0, 1, 2, 3) for key in runs[0])
    (cache,) = p._class_graphs.values()
    n_keys = len(cache)
    assert n_keys == len({key for run in runs for key in run})
    _serve(p, window[::-1], scorer)
    assert len(cache) == n_keys


def test_keys_stay_within_the_buckets_over_drifting_windows():
    """Windows of 20 to 300 queries drawn from a drifting vocabulary slice,
    some with a range term: every key's nc, NJ and row count lie in their
    buckets, the keys stay far fewer than the class runs, and a second pass
    over the same windows adds no key."""
    ix = _small(n_docs=2000, range_min_expansions=4, prune_blocks=False)
    p = _graphs(ShardedDeviceIndex(ix, cpu_mesh(1, 4)))
    rng = np.random.default_rng(5)
    windows = []
    for i in range(5):
        size = int(rng.integers(20, 300))
        lo = 8 * i
        windows.append([" ".join(f"t{j:03d}" for j in rng.integers(lo, lo + 30, rng.integers(1, 4)))
                        for _ in range(size)] + ["t0", "t00", "t01 t05"][: i % 4])
    for w in windows:
        _serve(p, w, bm25.new())
    (cache,) = p._class_graphs.values()
    keys = set(cache.keys())
    for key in keys:
        assert key.num_chunks in p.nc_buckets and key.nj in p.NJ_BUCKETS, key
        assert key.b_out % 256 == 0 or key.b_out & (key.b_out - 1) == 0, key
        assert key.b_out <= 2 or not key.use_ranges, key
    assert any(key.use_ranges for key in keys)
    assert len(keys) < sum(len(run) for run in _runs(p))
    for w in windows:
        _serve(p, w, bm25.new())
    assert set(cache.keys()) == keys


@pytest.mark.parametrize("kind", ["bm25", "z2o"])
def test_a_dropped_snapshot_frees_without_a_collection(corpus, z2o, kind):
    """The caches keep each class's step (a CUDA graph keeps its capture),
    and a group step holds the snapshot's tensors, not the snapshot: with
    the collector off, dropping the ShardedDeviceIndex frees it (on a card:
    its records and its graphs' pools) by reference count alone."""
    _jix, ix, window = z2o if kind == "z2o" else corpus
    gc.disable()
    try:
        p = _graphs(ShardedDeviceIndex(ix, cpu_mesh(2, 4)))
        _serve(p, window, None if kind == "z2o" else bm25.new())
        (cache,) = p._class_graphs.values()
        assert len(cache) and all(callable(step) for step in cache._graphs.values())
        ref = weakref.ref(p)
        del p
        assert ref() is None
    finally:
        gc.enable()
