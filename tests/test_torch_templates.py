"""Template manifests, prewarm and the graph path of the torch port.

``save_templates`` / ``load_templates`` carry frozen window compositions
across processes in the JAX engine's manifest format, both ways;
``prewarm`` runs each matching template's window step once (the JAX engine
compiles its window program there) and, on a CUDA device, captures the step
as a CUDA graph that later windows of that template replay.  Also
``fetch_windows_jointly``: several windows drained in one D2H copy.

On the CPU: the JAX engine's template tests on the port, manifests across
the two packages (equal templates, equal prewarm counts, no refreeze when
serving afterwards; block-max pruning off in both engines, and on in both),
light-class entries (any chunk width), the joint drain against
per-window drains.  On a card (``cuda``): graph replays bit-equal to the
eager step over two alternating windows in a depth-4 pipeline, with
``prefetch_results`` on and off; the launch tally of capture and replay; a
refreeze dropping the graph.
"""

import ast
import dataclasses
import json
import os
import random
import warnings

import numpy as np
import pytest
import torch

from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.models.bm25 import BM25
from probly_search_tpu_torch.ops import fused_merge as fm
from probly_search_tpu_torch.ops import fused_query as fq
from probly_search_tpu_torch.testing import assert_topk_agree
from probly_search_tpu_torch.utils.metrics import metrics

BENCH_MANIFEST = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "bench_templates.json")


def _corpus(n=300, seed=77):
    """The JAX template tests' corpus and queries (no prefix queries)."""
    rng = random.Random(seed)
    vocab = ["".join(rng.choice("abcdefg") for _ in range(rng.randint(1, 5))) for _ in range(150)]
    texts = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 10))) for _ in range(n)]
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(24)]
    return texts, queries


def _port_index(texts, device="cpu", **cfg):
    ix = Index(1, config=IndexConfig(template_compositions=True, **cfg), device=device)
    ix.add_documents_columnar(list(range(len(texts))), [texts])
    return ix


def _jax_index(texts, prune_blocks):
    """The JAX engine's index of ``texts``.  Block-max pruning moves queries
    into smaller classes, so both engines of a cross-package case run with
    the same ``prune_blocks``."""
    from probly_search_tpu import Index as JIndex
    from probly_search_tpu import IndexConfig as JConfig

    ix = JIndex(1, config=JConfig(template_compositions=True, prune_blocks=prune_blocks))
    ix.add_documents_columnar(list(range(len(texts))), [texts])
    return ix


def _pruned_chunks(m):
    return m.snapshot()["counters"].get("prune/pruned_chunks", 0)


def _refreezes():
    return metrics.counters["template_refreezes"]


def test_manifest_roundtrip_and_prewarm(tmp_path):
    texts, queries = _corpus()
    dix = _port_index(texts).device_index()
    scorer = bm25.new()
    want = dix.query_batch(queries[:16], scorer, top_k=5)
    path = str(tmp_path / "templates.json")
    assert dix.save_templates(path) == 1

    dix2 = _port_index(texts).device_index()
    assert dix2.load_templates(path) == 1
    assert dix2._comp_templates == dix._comp_templates
    assert dix2.prewarm(scorer) == 1
    assert dix2.prewarm(BM25(bm25k1=1.5)) == 0  # another scorer key
    before = _refreezes()
    rows = dix2.query_batch(queries[:16], scorer, top_k=5)
    assert _refreezes() == before
    for a, b in zip(rows, want):
        assert [r.key for r in a] == [r.key for r in b]
    assert not dix2._graphs  # graphs are captured on a CUDA device only


def test_save_templates_skips_process_local_scorer_keys(tmp_path):
    class _NoKey(BM25):
        device_cache_key = None  # -> ('id', id(scorer)) cache key

    texts, queries = _corpus()
    dix = _port_index(texts).device_index()
    dix.query_batch(queries[:16], _NoKey(), top_k=5)
    assert len(dix._comp_templates) == 1
    path = str(tmp_path / "t.json")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert dix.save_templates(path) == 0
    assert any("device_cache_key" in str(x.message) for x in w)
    with open(path) as f:
        assert json.load(f) == {}


def _jax_manifest_into_port(tmp_path, prune):
    from probly_search_tpu import bm25 as jbm25
    from probly_search_tpu.utils.metrics import metrics as jmetrics

    texts, queries = _corpus()
    jdix = _jax_index(texts, prune).device_index()
    j0 = _pruned_chunks(jmetrics)
    jrows = jdix.query_batch(queries[:16], jbm25.new(), top_k=5)
    assert (_pruned_chunks(jmetrics) > j0) == prune
    path = str(tmp_path / "jax.json")
    assert jdix.save_templates(path) == 1

    # The port freezes the same template from the same window.
    own = _port_index(texts, prune_blocks=prune).device_index()
    p0 = _pruned_chunks(metrics)
    own.query_batch(queries[:16], bm25.new(), top_k=5)
    assert (_pruned_chunks(metrics) > p0) == prune
    with open(path) as f:
        raw = json.load(f)
    assert {repr(k): [list(e) for e in v] for k, v in own._comp_templates.items()} == raw
    assert {len(e) for v in raw.values() for e in v} == {4}  # (nc, nj, cap, cw)

    dix = _port_index(texts, prune_blocks=prune).device_index()
    assert dix.load_templates(path) == 1
    jdix2 = _jax_index(texts, prune).device_index()
    assert jdix2.load_templates(path) == 1
    assert dix.prewarm(bm25.new()) == jdix2.prewarm(jbm25.new()) == 1
    before = _refreezes()
    rows = dix.query_batch(queries[:16], bm25.new(), top_k=5)
    assert _refreezes() == before
    for a, b in zip(rows, jrows):
        assert [r.key for r in a] == [r.key for r in b]


def test_jax_manifest_loads_into_port(tmp_path):
    _jax_manifest_into_port(tmp_path, prune=False)


def test_jax_manifest_loads_into_port_pruned(tmp_path):
    """Pruning on in both engines: the same (pruned) composition."""
    _jax_manifest_into_port(tmp_path, prune=True)


def _port_manifest_into_jax(tmp_path, prune):
    from probly_search_tpu import bm25 as jbm25
    from probly_search_tpu.utils.metrics import metrics as jmetrics

    texts, queries = _corpus()
    dix = _port_index(texts, prune_blocks=prune).device_index()
    rows = dix.query_batch(queries[:16], bm25.new(), top_k=5)
    path = str(tmp_path / "port.json")
    assert dix.save_templates(path) == 1

    jdix = _jax_index(texts, prune).device_index()
    assert jdix.load_templates(path) == 1
    dix2 = _port_index(texts, prune_blocks=prune).device_index()
    assert dix2.load_templates(path) == 1
    assert jdix.prewarm(jbm25.new()) == dix2.prewarm(bm25.new()) == 1
    before = jmetrics.counters["template_refreezes"]
    jrows = jdix.query_batch(queries[:16], jbm25.new(), top_k=5)
    assert jmetrics.counters["template_refreezes"] == before
    for a, b in zip(rows, jrows):
        assert [r.key for r in a] == [r.key for r in b]


def test_port_manifest_loads_into_jax(tmp_path):
    _port_manifest_into_jax(tmp_path, prune=False)


def test_port_manifest_loads_into_jax_pruned(tmp_path):
    """Pruning on in both engines: JAX serves the port's pruned composition
    without a refreeze."""
    _port_manifest_into_jax(tmp_path, prune=True)


def test_bench_manifest_loads():
    with open(BENCH_MANIFEST) as f:
        raw = json.load(f)
    dix = _port_index(_corpus()[0]).device_index()
    assert dix.load_templates(BENCH_MANIFEST) == len(raw) == 1
    (key, entries), = dix._comp_templates.items()
    assert key == (("bm25", 1.2, 0.75), 10, "slots20", 16384)
    assert entries == [tuple(e) for e in next(iter(raw.values()))]
    assert sum(cap for _nc, _nj, cap in entries) == 18864


def test_manifest_chunk_widths(tmp_path):
    """A JAX entry (nc, nj, cap, cw) loads as that 4-tuple, whatever its
    width (another width is a light class); a 3-tuple entry still has this
    index's width.  A malformed entry is refused before anything loads."""
    dix = _port_index(_corpus()[0]).device_index()
    key = repr((("bm25", 1.2, 0.75), 5, "f32", 16))
    path = str(tmp_path / "m.json")
    with open(path, "w") as f:
        json.dump({key: [[2, 4, 8, dix.CHUNK], [4, 4, 8]]}, f)
    assert dix.load_templates(path) == 1
    assert list(dix._comp_templates.values()) == [[(2, 4, 8, dix.CHUNK), (4, 4, 8)]]
    (entries,) = dix._comp_templates.values()
    assert [s[5] for s in dix._template_specs(entries)] == [dix.CHUNK, dix.CHUNK]
    other = repr((("bm25", 1.2, 0.75), 5, "f32", 32))
    with open(path, "w") as f:
        json.dump({other: [[2, 4, 8]], key: [[2, 4, 8], [3, 4, 8, 256]]}, f)
    assert dix.load_templates(path) == 2
    assert dix._comp_templates[ast.literal_eval(key)] == [(2, 4, 8), (3, 4, 8, 256)]
    assert dix._template_specs(dix._comp_templates[ast.literal_eval(key)]) == (
        (8, 8, 4, 2, False, dix.CHUNK), (8, 8, 4, 3, False, 256),
    )
    before = dict(dix._comp_templates)
    with open(path, "w") as f:
        json.dump({other: [[2, 4, 8, 128]], key: [[2, 4]]}, f)
    with pytest.raises(ValueError, match="nc, nj, cap"):
        dix.load_templates(path)
    assert dix._comp_templates == before


def test_fetch_windows_jointly_matches_separate_drains():
    texts, queries = _corpus()
    dix = _port_index(texts).device_index()
    windows = [queries[:16], queries[8:24], queries[:16][::-1]]
    want = [dix.query_batch_async(w, bm25.new(), top_k=5).get_arrays() for w in windows]
    handles = [dix.query_batch_async(w, bm25.new(), top_k=5) for w in windows]
    pdev.fetch_windows_jointly(handles)
    assert all(h._packed_host is not None for h in handles)
    for h, (s, sl, k) in zip(handles, want):
        got = h.get_arrays()
        for a, b in zip(got, (s, sl, k)):
            np.testing.assert_array_equal(a, b)
    rows = dix.query_batch_async(windows[0], bm25.new(), top_k=5)
    pdev.fetch_windows_jointly([rows, dix.query_batch_async(windows[1], bm25.new(), top_k=5)])
    assert [[r.key for r in row] for row in rows.get()] == [
        [r.key for r in row] for row in dix.query_batch(windows[0], bm25.new(), top_k=5)
    ]


def test_fetch_windows_jointly_leaves_others_alone():
    texts, queries = _corpus()
    dix = _port_index(texts).device_index()
    empty = dix.query_batch_async(["", "zzzzz"], bm25.new(), top_k=5)  # no packed rows
    one = dix.query_batch_async(queries[:16], bm25.new(), top_k=5)
    pdev.fetch_windows_jointly([empty, one])  # a single live window: nothing to join
    assert one._packed_host is None
    dix.config = dataclasses.replace(dix.config, result_format="compact")
    mixed = dix.query_batch_async(queries[:16], bm25.new(), top_k=5)  # int16 rows
    pdev.fetch_windows_jointly([one, mixed])
    assert one._packed_host is None and mixed._packed_host is None
    assert (empty.get_arrays()[1] == -1).all()


# --------------------------------------------------------------------- #
# on a card                                                              #
# --------------------------------------------------------------------- #


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _graph_corpus():
    """A corpus with classes for K1 and, at chunk 128, a lanes class (a term
    in every doc: 157 chunks -> 256 x 128 lanes > 16,384) merged by K5's
    radix path; two windows of the same composition in different orders."""
    rng = random.Random(5)
    vocab = ["w%03d" % i for i in range(400)]
    texts = [
        " ".join(["all"] + [rng.choice(vocab) for _ in range(rng.randint(1, 6))])
        for _ in range(20000)
    ]
    w1 = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(60)]
    w1 += ["all", "all w001", "all w002 w003", "zzz", ""]
    w2 = w1[::-1]
    return texts, (w1, w2)


def _prewarmed(texts, windows, tmp_path, **cfg):
    """(eager DeviceIndex, graph DeviceIndex): the eager one froze the
    template from ``windows[0]``; the other loaded it and prewarmed."""
    ix = _port_index(texts, device="cuda", chunk_size=128, result_format="f32", **cfg)
    eager = DeviceIndex(ix, device="cuda")
    eager.query_batch_async(windows[0], bm25.new(), top_k=10).get_arrays()
    path = str(tmp_path / "g.json")
    eager.save_templates(path)
    graph = DeviceIndex(ix, device="cuda")
    graph.load_templates(path)
    assert graph.prewarm(bm25.new()) == 1 and len(graph._graphs) == 1
    return eager, graph


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_graph_replay_matches_eager_on_cuda(tmp_path, prefetch):
    _cuda()
    texts, windows = _graph_corpus()
    eager, graph = _prewarmed(texts, windows, tmp_path, prefetch_results=prefetch)
    want = [eager.query_batch_async(w, bm25.new(), top_k=10).get_arrays() for w in windows]
    before = dict(metrics.counters)
    inflight, got = [], []
    for i in range(8):  # depth-4 pipeline of the two windows in turn
        inflight.append(graph.query_batch_async(windows[i % 2], bm25.new(), top_k=10))
        if len(inflight) == 4:
            got.append(inflight.pop(0).get_arrays())
    got += [h.get_arrays() for h in inflight]
    assert metrics.counters["template_graph_replays"] - before.get("template_graph_replays", 0) == 8
    assert _refreezes() == before.get("template_refreezes", 0)
    for i, arrays in enumerate(got):
        for a, b in zip(arrays, want[i % 2]):
            np.testing.assert_array_equal(a, b)
    # and the joint drain on the graph path's private copies
    pair = [graph.query_batch_async(w, bm25.new(), top_k=10) for w in windows]
    pdev.fetch_windows_jointly(pair)
    for h, w in zip(pair, want):
        np.testing.assert_array_equal(h.get_arrays()[1], w[1])


@pytest.mark.cuda
def test_graph_launch_tally_on_cuda(tmp_path):
    _cuda()
    texts, windows = _graph_corpus()
    eager, graph = _prewarmed(texts, windows, tmp_path)
    counts = lambda: {**fq.launches, **fm.launches, **{f"path_{k}": v for k, v in fm.path_calls.items()}}
    c0 = counts()
    eager.query_batch_async(windows[0], bm25.new(), top_k=10).get_arrays()
    c1 = counts()
    step = {k: c1[k] - c0[k] for k in c0}  # one eager window of the template
    assert step["full"] > 0 and step["lanes"] > 0 and step["merge_topk"] > 0 and step["path_radix"] > 0
    fresh = DeviceIndex(graph._index, device="cuda")
    fresh._comp_templates = dict(graph._comp_templates)
    assert fresh.prewarm(bm25.new()) == 1
    c2 = counts()
    assert {k: c2[k] - c1[k] for k in c0} == step  # the eager run only; the capture ran nothing
    fresh.query_batch_async(windows[1], bm25.new(), top_k=10).get_arrays()
    c3 = counts()
    assert {k: c3[k] - c2[k] for k in c0} == step  # a replay counts the graph's launches


@pytest.mark.cuda
def test_refreeze_drops_graph_on_cuda(tmp_path):
    _cuda()
    texts, windows = _graph_corpus()
    eager, graph = _prewarmed(texts, windows, tmp_path)
    (tkey,) = graph._graphs
    heavy = ["all w%03d w%03d" % (i, i + 1) for i in range(len(windows[0]))]  # outgrows it
    before = dict(metrics.counters)
    got = graph.query_batch_async(heavy, bm25.new(), top_k=10).get_arrays()
    assert _refreezes() == before.get("template_refreezes", 0) + 1
    assert tkey not in graph._graphs
    assert metrics.counters["template_graph_replays"] == before.get("template_graph_replays", 0)
    want = DeviceIndex(graph._index, device="cuda").query_batch_async(heavy, bm25.new(), top_k=10)
    assert_topk_agree(got[0], got[1], *want.get_arrays()[:2])  # its own layout
    assert graph.prewarm(bm25.new()) == 1 and tkey in graph._graphs  # captured again
    again = graph.query_batch_async(heavy, bm25.new(), top_k=10).get_arrays()
    assert metrics.counters["template_graph_replays"] == before.get("template_graph_replays", 0) + 1
    np.testing.assert_array_equal(again[1], got[1])
