"""The port's doc-sharded engine at the four-card layouts, on CPU meshes.

On four cards the port serves ``make_mesh(1, 4)`` (four doc shards, one a
card) and ``make_mesh(2, 2)`` (two data rows of two shards).  The other
sharding files hold meshes (2, 4) and (1, 8); this one holds those two
shapes, with every cell on the CPU (``make_mesh(1, 4, devices=["cpu"] * 4)``),
against the JAX engine on 4 of the 8 virtual CPU devices of
``tests/conftest.py``:

* bit for bit: the snapshot's tables (CSR offsets, live cumsum, term table,
  each shard's record payload and aux rows, per-shard key widths), the
  BM25 plan words and ``_pack_window``'s class specs, layout and buffer
  (range jobs and a host-fallback query among them), and the zero-to-one
  plan (fast words, qlen, chunk and job counts, the lockstep tables);
* by ``probly_search_tpu_torch.testing``'s rule: one BM25 window (JAX on
  mesh (1, 4)) and one zero-to-one window (JAX on mesh (2, 2)), each
  against the port on both meshes.  JAX compiles a ``shard_map`` program
  per window shape on the CPU, so it serves one window of each kind.
"""

import jax
import numpy as np
import pytest
import torch

from probly_search_tpu import bm25 as jbm25
from probly_search_tpu.parallel import ShardedDeviceIndex as JSharded
from probly_search_tpu.parallel import make_mesh as jmake_mesh
from probly_search_tpu_torch import bm25
from probly_search_tpu_torch.ops import fused_z2o as fz
from probly_search_tpu_torch.ops.fused_merge import key_bits_for
from probly_search_tpu_torch.parallel import ShardedDeviceIndex, make_mesh
from probly_search_tpu_torch.testing import assert_topk_agree

from .test_torch_planner import port_index
from .test_torch_sharding import _corpus
from .test_torch_sharding_z2o import _index, _queries
from .util import tokenizer

K = 10
MESHES = [(1, 4), (2, 2)]
IDS = ["1x4", "2x2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops on the CPU: one thread, as in the other
    sharding files (OpenMP's spinning workers slow such ops where test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh(data, docs):
    return jmake_mesh(data, docs, devices=jax.devices()[: data * docs])


def cpu_mesh(data, docs):
    return make_mesh(data, docs, devices=["cpu"] * (data * docs))


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


@pytest.fixture(scope="module")
def z2o_corpus():
    jix, vocab = _index(2, 480, 17)
    return jix, port_index(jix), _queries(vocab)


@pytest.fixture(scope="module", params=MESHES, ids=IDS)
def pair(request, corpus):
    jix, ix, window = corpus
    return ix, window, JSharded(jix, jax_mesh(*request.param)), ShardedDeviceIndex(
        ix, cpu_mesh(*request.param))


def test_snapshot_tables_equal_jax(pair):
    ix, _w, j, p = pair
    assert j.mesh.devices.shape == p.mesh.devices.shape
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
    counts = [len(range(s, ix._next_slot, p.n_shards)) for s in range(p.n_shards)]
    assert p.key_bits == [key_bits_for(c, 4) for c in counts]
    assert p.z2o_key_bits == [key_bits_for(c, fz.DOC_SHIFT) for c in counts]


def test_plans_and_packed_window_equal_jax(pair):
    _ix, window, j, p = pair
    jplan, jfb = j.plan_batch(window, tokenizer, jbm25.new())
    pplan, pfb = p.plan_batch(window, tokenizer, bm25.new())
    assert pfb == jfb and pfb
    for name, a, b in zip(("jquery", "words", "nchunks", "njobs", "has_range"), pplan, jplan):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert pplan[4].any()
    pspecs, playout, pbuf = p._pack_window(pplan, len(window))
    jspecs, jlayout, jbuf = j._pack_window(jplan, len(window))
    assert pspecs == jspecs and any(spec[4] for spec in pspecs)
    np.testing.assert_array_equal(pbuf, jbuf)
    for a, b in zip(playout, jlayout):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_z2o_plans_equal_jax(z2o_corpus, mesh):
    jix, ix, queries = z2o_corpus
    jplan = JSharded(jix, jax_mesh(*mesh)).plan_batch_z2o(queries, tokenizer)
    pplan = ShardedDeviceIndex(ix, cpu_mesh(*mesh)).plan_batch_z2o(queries, tokenizer)
    for name, a, b in zip(("jquery", "words", "qlen", "max_chunks", "njobs"), pplan, jplan):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert pplan[5] == jplan[5] == []
    for a, b in zip(pplan[6], jplan[6]):  # the lockstep tables of shared-node queries
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_bm25_window(corpus):
    jix, _ix, window = corpus
    return JSharded(jix, jax_mesh(1, 4)).query_batch_async(
        window[40:], jbm25.new(), tokenizer, top_k=K).get_arrays()


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_bm25_window_matches_jax(corpus, jax_bm25_window, mesh):
    """The corpus window's last 15 queries: prefixes of one and two
    letters and ``qq`` (term-range classes), ``heavy`` (several chunks a
    shard), ties across shards, a host-fallback query."""
    _jix, ix, window = corpus
    got = ShardedDeviceIndex(ix, cpu_mesh(*mesh)).query_batch_async(
        window[40:], bm25.new(), tokenizer, top_k=K).get_arrays()
    js, jsl, _ = jax_bm25_window
    assert_topk_agree(got[0], got[1], js, jsl)
    np.testing.assert_array_equal(got[2], np.asarray(ix._slot_to_key)[np.maximum(got[1], 0)])


@pytest.fixture(scope="module")
def jax_z2o_window(z2o_corpus):
    jix, _ix, queries = z2o_corpus
    return JSharded(jix, jax_mesh(2, 2)).query_batch_z2o(
        queries[12:], tokenizer=tokenizer, top_k=K).get_arrays()


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_z2o_window_matches_jax(z2o_corpus, jax_z2o_window, mesh):
    """The last 6 queries: a one-letter prefix (a fast class, K4's plain
    version), shared-node queries (the lockstep program), an empty and an
    unknown query."""
    _jix, ix, queries = z2o_corpus
    got = ShardedDeviceIndex(ix, cpu_mesh(*mesh)).query_batch_z2o(
        queries[12:], tokenizer=tokenizer, top_k=K).get_arrays()
    js, jsl, _ = jax_z2o_window
    assert_topk_agree(got[0], got[1], js, jsl)
    assert (got[1] >= 0).any()
