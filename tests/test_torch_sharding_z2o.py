"""The port's doc-sharded zero-to-one engine (``parallel/``) on CPU meshes.

Meshes as in ``tests/test_torch_sharding.py``: the port's on
``make_mesh(2, 4, devices=["cpu"] * 8)`` and ``(1, 8)``, the JAX engine's on
the 8 virtual CPU devices.

* Against the JAX package (documents carried across by ``index.snapshot``):
  the z2o plan (fast words ``[n, NJ, 4]`` with their score ranks, qlen,
  chunk and job counts, fallback, and the lockstep tables of shared-node
  queries) bit for bit on both mesh shapes and two schemas; the rows of one
  window holding fast classes (K4's plain version) and lockstep classes,
  within ``probly_search_tpu_torch.testing``'s rule (JAX serves that one
  window only: it compiles a ``shard_map`` program per window shape).
* The zero-to-one cases of the JAX package's ``tests/test_sharding.py`` on
  the port, held to the port's single-device z2o engine and the f64 oracle;
  each test names the case it mirrors.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu.parallel import ShardedDeviceIndex as JSharded
from probly_search_tpu.parallel import make_mesh as jmake_mesh
from probly_search_tpu_torch import DeviceIndex, zero_to_one
from probly_search_tpu_torch.ops import fused_z2o as fz
from probly_search_tpu_torch.ops import z2o_device as pz
from probly_search_tpu_torch.ops.fused_merge import key_bits_for
from probly_search_tpu_torch.parallel import ShardedDeviceIndex, make_mesh
from probly_search_tpu_torch.testing import assert_topk_agree
from probly_search_tpu_torch.utils.metrics import metrics

from .test_torch_planner import port_index
from .util import tokenizer

K = 10
MESHES = [(2, 4), (1, 8)]


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


def _index(F, n, seed, letters="abcd", maxw=(3, 5)):
    """A JAX Index of ``F`` random fields (``tests/test_sharding.py``'s z2o
    corpora) with every 13th doc latently deleted, and its vocabulary."""
    rng = random.Random(seed)
    vocab = ["".join(rng.choice(letters) for _ in range(rng.randint(1, 4))) for _ in range(50)]
    cols = [
        [" ".join(rng.choice(vocab) for _ in range(rng.randint(1 if f == 0 else 0, maxw[min(f, 1)])))
         for _ in range(n)]
        for f in range(F)
    ]
    jix = JIndex(F, config=JConfig(chunk_size=128))
    jix.add_documents_columnar(list(range(n)), cols)
    for i in range(0, n, 13):
        jix.remove_document(i)
    return jix, vocab


def _queries(vocab, seed=23):
    rng = random.Random(seed)
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(12)]
    t, u = vocab[3], vocab[5]
    queries += ["", "zzzz", vocab[0][:1], f"{t} {t}", f"{t[:1]} {t}", f"{t} {u} {t}"]
    return queries


@pytest.fixture(scope="module")
def two_field():
    jix, vocab = _index(2, 480, 17)
    return jix, port_index(jix), _queries(vocab)


@pytest.fixture(scope="module")
def wide():
    jix, vocab = _index(12, 90, 41)
    return jix, port_index(jix), [vocab[0], f"{vocab[1]} {vocab[2]}", vocab[3][:1], "",
                                  f"{vocab[4]} {vocab[4]}"]


def _oracle(ix, queries, k=K):
    s = np.full((len(queries), k), -np.inf, np.float32)
    d = np.full((len(queries), k), -1, np.int32)
    for qi, q in enumerate(queries):
        for r, res in enumerate(ix.query(q, zero_to_one.new(), tokenizer, [1.0] * ix.num_fields)[:k]):
            s[qi, r] = res.score
            d[qi, r] = ix._key_to_slot[res.key]
    return s, d


def _single(ix, queries, k=K, fmt="f32"):
    return pz.z2o_query_batch_async(DeviceIndex(ix, device="cpu"), queries, tokenizer, k,
                                    fmt=fmt).get_arrays()


def _agree_all(ix, queries, got, k=K):
    s, sl, _keys = got
    ss, ssl, _ = _single(ix, queries, k)
    assert_topk_agree(s, sl, ss, ssl)
    assert_topk_agree(s, sl, *_oracle(ix, queries, k))


# --------------------------------------------------------------------- #
# the port against the JAX package                                       #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("schema", ["two_field", "wide"])
def test_z2o_plans_equal_jax(request, schema, mesh):
    """``plan_batch_z2o``: fast words, qlen, chunks, jobs, fallback and the
    lockstep tables, bit for bit (on the wide schema the shared-node query
    takes the host, past the lockstep's 8 fields)."""
    jix, ix, queries = request.getfixturevalue(schema)
    j = JSharded(jix, jmake_mesh(*mesh))
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    jplan = j.plan_batch_z2o(queries, tokenizer)
    pplan = p.plan_batch_z2o(queries, tokenizer)
    names = ("jquery", "words", "qlen", "max_chunks", "njobs")
    for name, a, b in zip(names, pplan, jplan):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert pplan[5] == jplan[5]
    assert (pplan[6] is None) == (jplan[6] is None) == (schema == "wide")
    if schema == "wide":
        assert pplan[5] == [4]
    else:
        assert not pplan[5]
        for a, b in zip(pplan[6], jplan[6]):
            np.testing.assert_array_equal(a, b)
    assert p.z2o_key_bits == [
        key_bits_for(len(range(s, ix._next_slot, p.n_shards)), fz.DOC_SHIFT) for s in range(p.n_shards)
    ]


@pytest.fixture(scope="module")
def jax_window(two_field):
    jix, _ix, queries = two_field
    j = JSharded(jix, jmake_mesh(2, 4))
    return j.query_batch_z2o(queries, tokenizer=tokenizer, top_k=K).get_arrays()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_z2o_window_matches_jax_single_device_and_oracle(two_field, jax_window, mesh, monkeypatch):
    """``TestShardedZeroToOne::test_sharded_z2o_matches_oracle``: fast
    classes through K4 (its plain version here; the JAX engine's XLA
    branch) and shared-node queries through the lockstep program, against
    the JAX engine on mesh (2, 4), the single-device engine and the
    oracle."""
    _jix, ix, queries = two_field
    calls = []
    real = pz.fused_z2o_topk
    monkeypatch.setattr(pz, "fused_z2o_topk", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    p = ShardedDeviceIndex(ix, cpu_mesh(*mesh))
    metrics.reset()
    got = p.query_batch_z2o(queries, tokenizer=tokenizer, top_k=K).get_arrays()
    c = metrics.snapshot()["counters"]
    assert c["z2o_sharded_lockstep_queries"] >= 3 and "device_fallback_queries" not in c, c
    assert calls and {kw["key_bits"] for kw in calls} <= set(p.z2o_key_bits)
    js, jsl, _ = jax_window
    assert_topk_agree(got[0], got[1], js, jsl)
    _agree_all(ix, queries, got)


# --------------------------------------------------------------------- #
# tests/test_sharding.py (zero-to-one) on the port                       #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_wide_schema_runs_on_device(wide, mesh):
    """``test_sharded_z2o_wide_schema_runs_on_device``: F = 12 serves on the
    mesh (fields ride as sort values); only the shared-node query, past the
    lockstep's 8 fields, takes the host."""
    _jix, ix, queries = wide
    metrics.reset()
    got = ShardedDeviceIndex(ix, cpu_mesh(*mesh)).query_batch_z2o(
        queries, tokenizer=tokenizer, top_k=K).get_arrays()
    c = metrics.snapshot()["counters"]
    assert c.get("device_fallback_queries", 0) == 1 and "z2o_host_vectorized_queries" not in c, c
    _agree_all(ix, queries, got)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_shared_node_runs_lockstep_on_device(mesh):
    """``test_sharded_z2o_shared_node_runs_lockstep_on_device``."""
    jix, vocab = _index(2, 160, 37)
    ix = port_index(jix)
    t = vocab[2]
    queries = [f"{t} {t}", f"{t[:1]} {t}", f"{t} {vocab[5]} {t}", vocab[7]]
    metrics.reset()
    got = ShardedDeviceIndex(ix, cpu_mesh(*mesh)).query_batch_z2o(
        queries, tokenizer=tokenizer, top_k=K).get_arrays()
    c = metrics.snapshot()["counters"]
    assert c.get("z2o_sharded_lockstep_queries", 0) >= 3 and "device_fallback_queries" not in c, c
    _agree_all(ix, queries, got)


def test_attach_mesh_routes_z2o(two_field):
    """``test_attach_mesh_routes_z2o``: blocking and async."""
    queries = two_field[2]
    ix = port_index(_index(2, 120, 29)[0])
    ix.attach_mesh(cpu_mesh(1, 8))
    h = ix.query_batch_async(queries, zero_to_one.new(), tokenizer, top_k=K)
    assert type(h).__name__ == "ShardedPendingBatch"
    got = h.get_arrays()
    _agree_all(ix, queries, got)
    rows = ix.query_batch(queries, zero_to_one.new(), tokenizer, top_k=K)
    for qi, row in enumerate(rows):
        assert [ix._key_to_slot[r.key] for r in row] == [x for x in got[1][qi] if x >= 0]


@pytest.mark.parametrize("fmt", ["f32", "compact", "slots", "slots20"])
def test_formats_and_get_arrays(two_field, fmt):
    """``test_z2o_sharded_formats`` and ``test_sharded_z2o_get_arrays``:
    each format against the single-device engine in that format; the
    columnar drain against ``get()`` (which raises under the slots
    formats)."""
    _jix, ix, queries = two_field
    p = ShardedDeviceIndex(ix, cpu_mesh(2, 4))
    p.config = dataclasses.replace(ix.config, result_format=fmt)
    h = p.query_batch_z2o(queries, tokenizer=tokenizer, top_k=5)
    s, sl, keys = h.get_arrays()
    ss, ssl, skeys = _single(ix, queries, 5, fmt)
    if fmt.startswith("slots"):
        assert s is None
        np.testing.assert_array_equal(sl, ssl)
        np.testing.assert_array_equal(keys, skeys)
        with pytest.raises(ValueError, match="slots"):
            h.get()
        return
    assert_topk_agree(s, sl, ss, ssl, rtol=1e-3 if fmt == "compact" else 2e-5)
    rows = p.query_batch_z2o(queries, tokenizer=tokenizer, top_k=5).get()
    for qi, row in enumerate(rows):
        assert int((sl[qi] >= 0).sum()) == len(row)
        for j, r in enumerate(row):
            assert keys[qi, j] == r.key and abs(s[qi, j] - r.score) < 1e-6


def test_doc_slot_capacities(two_field, monkeypatch):
    """K4 runs only while every shard's local slots stay below 2^26 (its key
    packs doc << 5); from there the staged program; from 2^27 every query
    takes the host lockstep, as in the JAX engine."""
    _jix, ix, queries = two_field
    calls = []
    real = pz.fused_z2o_topk
    monkeypatch.setattr(pz, "fused_z2o_topk", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    p = ShardedDeviceIndex(ix, cpu_mesh(1, 8))
    want = p.query_batch_z2o(queries, tokenizer=tokenizer, top_k=K).get_arrays()
    assert calls
    calls.clear()
    p.local_slots = 1 << 26
    got = p.query_batch_z2o(queries, tokenizer=tokenizer, top_k=K).get_arrays()
    assert not calls
    assert_topk_agree(got[0], got[1], want[0], want[1])
    p.local_slots = 1 << 27
    metrics.reset()
    got = p.query_batch_z2o(queries, tokenizer=tokenizer, top_k=K).get_arrays()
    assert metrics.snapshot()["counters"]["device_fallback_queries"] == len(queries)
    assert_topk_agree(got[0], got[1], want[0], want[1])
