"""A user-written one-phase device scorer on the torch port.

``TfBoost`` (tests/torch_util.py, the port of the scorer in
tests/test_custom_device_scorer.py) computes its per-lane score in torch, so
the fused BM25 kernel cannot run it: its classes take the staged gather +
score, then the merge kernel K5 with a full sort (``_query_step``).  On the
CPU the port's rows are held against the JAX engine's
``Index.query_batch(..., backend="device")`` and the f64 host oracle; on a
card the same window must launch K5 and never the fused kernel.

Tolerance: the same keys in the same order; scores within 1e-5 relative
(the JAX test's bar), the device summing in f32.
"""

import numpy as np
import pytest
import torch

from probly_search_tpu_torch import Index
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.ops import fused_merge as fm
from probly_search_tpu_torch.ops import fused_query as fq
from probly_search_tpu_torch.utils.tokenizers import whitespace_tokenizer as tokenizer

from .torch_util import TfBoost

QUERIES = ["a3 b1", "c", "a", "zzz", ""]


def _texts():
    return [f"a{i % 7} b{i % 3} c" for i in range(120)]


def _assert_rows_agree(rows, want):
    for row, ref in zip(rows, want):
        assert [r.key for r in row] == [r.key for r in ref]
        for a, b in zip(row, ref):
            assert abs(a.score - b.score) < 1e-5 * max(1.0, abs(b.score))


def _two_field_docs():
    """(key, (title, body)) of the JAX test's two-field corpus; 10-19 are
    then removed (latent deletes)."""
    return [(i, (f"t{i % 5} x", f"t{i % 5} t{i % 5} y")) for i in range(40)]


@pytest.mark.parametrize("fmt", ["f32", "compact"])
def test_custom_scorer_matches_jax_and_oracle(fmt):
    from probly_search_tpu import Index as JIndex
    from probly_search_tpu import whitespace_tokenizer as jtok

    from .test_custom_device_scorer import TfBoost as JTfBoost

    from probly_search_tpu_torch import IndexConfig

    ix = Index(1, config=IndexConfig(result_format=fmt), device="cpu")
    jix = JIndex(1)
    for x in (ix, jix):
        x.add_documents_columnar(list(range(120)), [_texts()])
    rows = ix.query_batch(QUERIES, TfBoost(), tokenizer, top_k=10, backend="device")
    jrows = jix.query_batch(QUERIES, JTfBoost(), jtok, top_k=10, backend="device")
    oracle = [ix.query(q, TfBoost(), tokenizer, [1.0], top_k=10) for q in QUERIES]
    jax_oracle = [jix.query(q, JTfBoost(), jtok, [1.0], top_k=10) for q in QUERIES]
    _assert_rows_agree(oracle, jax_oracle)  # the two host oracles agree
    tol = 1e-5 if fmt == "f32" else 1e-3  # compact reports f16 scores
    for row, ref in ((rows, jrows), (rows, oracle)):
        for a_row, b_row in zip(row, ref):
            assert [r.key for r in a_row] == [r.key for r in b_row]
            for a, b in zip(a_row, b_row):
                assert abs(a.score - b.score) < tol * max(1.0, abs(b.score))
    assert [len(r) for r in rows[3:]] == [0, 0]  # unknown term, empty query


def test_custom_scorer_with_boosts_and_deletes_matches_jax():
    from probly_search_tpu import Index as JIndex
    from probly_search_tpu import whitespace_tokenizer as jtok

    from .test_custom_device_scorer import TfBoost as JTfBoost

    ix, jix = Index(2, device="cpu"), JIndex(2)
    fields = [lambda d: [d[0]], lambda d: [d[1]]]
    for key, doc in _two_field_docs():
        ix.add_document(fields, tokenizer, key, doc)
        jix.add_document(fields, jtok, key, doc)
    for key in range(10, 20):
        ix.remove_document(key)
        jix.remove_document(key)
    boost = [3.0, 0.5]
    rows = ix.query_batch(["t3 y", "t1 x"], TfBoost(), tokenizer, boost, top_k=10)
    jrows = jix.query_batch(["t3 y", "t1 x"], JTfBoost(), jtok, boost, top_k=10)
    oracle = [ix.query(q, TfBoost(), tokenizer, boost, top_k=10) for q in ("t3 y", "t1 x")]
    _assert_rows_agree(rows, jrows)
    _assert_rows_agree(rows, oracle)
    assert all(r.key not in range(10, 20) for row in rows for r in row)


def test_custom_scorer_takes_staged_lanes_and_merge(monkeypatch):
    """The class of a scorer the kernel does not compute never reaches the
    fused kernel's wrapper: staged lanes, then the merge with a full sort."""
    ix = Index(1, device="cpu")
    ix.add_documents_columnar(list(range(120)), [_texts()])
    calls = []
    real = pdev.merge_scores_topk_fused

    def spy(key, score, k, qterm_bits, *a, **kw):
        calls.append(kw.get("run", 0))
        return real(key, score, k, qterm_bits, *a, **kw)

    monkeypatch.setattr(pdev, "fused_query_topk", None)  # would raise if called
    monkeypatch.setattr(pdev, "merge_scores_topk_fused", spy)
    _s, slots, _k = ix.device_index().query_batch_async(QUERIES, TfBoost(), top_k=10).get_arrays()
    assert calls and set(calls) == {0}
    assert (slots[0] >= 0).all() and (slots[3] == -1).all()


@pytest.mark.cuda
def test_custom_scorer_on_cuda_launches_merge_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    texts = [f"a{i % 7} b{i % 3} c w{i % 211}" for i in range(5000)]
    ix = Index(1, device="cuda")
    ix.add_documents_columnar(list(range(5000)), [texts])
    queries = QUERIES + ["w17 a3", "c b2", "w5 w6 w7"]
    k5, k1 = fm.launches["merge_topk"], fq.launches["full"] + fq.launches["lanes"]
    rows = ix.query_batch(queries, TfBoost(), tokenizer, top_k=10)
    assert fm.launches["merge_topk"] > k5
    assert fq.launches["full"] + fq.launches["lanes"] == k1
    _assert_rows_agree(rows, [ix.query(q, TfBoost(), tokenizer, [1.0], top_k=10) for q in queries])
