"""The reference against the port's CPU paths at a small size: the exact
float64 host query (``Index.query``) and the timed entry
(``Index.query_batch_async``, the plain torch versions of the kernels).
Only this test imports both."""

import numpy as np
import pytest

from portbench import check, corpus
from portbench.reference import ReferenceIndex, rank

from conftest import tiny_cell

SEED = 2**31 + 7


def _setup(name, n_queries=300):
    """The first ``n_queries`` requests of a tiny cell's stream."""
    cell = tiny_cell(name)
    data = corpus.make_corpus(cell.config, SEED)
    tr = dict(cell.traffic, warm_queries=0, stream_queries=n_queries)
    pool = corpus.make_traffic(cell.config, tr, data, SEED)
    strings = pool.strings[:n_queries]
    ref = ReferenceIndex(data.fields, data.n_docs, data.spell, data.spell_len)
    queries = [pool.words(data, i) for i in range(len(strings))]
    ref.load_queries(queries)
    return cell, data, strings, ref, queries


def _port_index(cell, data, **config):
    from probly_search_tpu_torch import Index, IndexConfig

    kw = dict(cell.config["index_config"], **config)
    ix = Index(len(data.fields), config=IndexConfig(**kw), device="cpu")
    ix.add_documents_columnar(list(range(data.n_docs)), data.texts)
    return ix


@pytest.mark.parametrize("name", ["msmarco-1m.bm25", "msmarco-1m.typeahead"])
def test_reference_equals_port_host_oracle(name):
    """Every matched document and its score, against the port's exact f64
    host path, on queries with prefix expansion and repeated words."""
    cell, data, strings, ref, queries = _setup(name, 120)
    ix = _port_index(cell, data)
    F = len(data.fields)
    scorer = cell.scorer.program(cell.scorer.spec)
    expanded = 0
    for q, words in zip(strings, queries):
        oracle = ix.query(q, scorer, fields_boost=[1.0] * F)
        docs, scores = cell.scorer.reference(ref, words, cell.scorer.spec)
        assert sorted(r.key for r in oracle) == docs.tolist(), q
        got = dict(zip(docs.tolist(), scores.tolist()))
        for r in oracle:
            assert got[r.key] == pytest.approx(r.score, rel=1e-12, abs=0), q
        expanded += sum(len(ref.expand(w)) > 1 for w in words)
    assert expanded > 20  # the queries do exercise prefix expansion


@pytest.mark.parametrize("name", ["msmarco-1m.bm25", "msmarco-1m.typeahead"])
def test_port_timed_path_passes_the_check(name):
    """The rows of the port's timed entry on the CPU pass the cell's check."""
    cell, data, strings, ref, queries = _setup(name, 256)
    ix = _port_index(cell, data)
    k = cell.config["top_k"]
    scorer = cell.scorer.program(cell.scorer.spec)
    _, slots, keys = ix.query_batch_async(strings, scorer, top_k=k).get_arrays()
    rows = np.where(slots >= 0, keys, -1)
    numbers = check.judge(ref, cell.scorer, queries, list(rows), k)
    assert numbers["bad_rows"] == 0
    assert check.passed(check.verdict(numbers, cell.config["check"]["limits"])), numbers


def test_rank_breaks_ties_by_document():
    docs = np.array([5, 2, 9, 1])
    scores = np.array([1.0, 2.0, 1.0, 1.0])
    assert rank(docs, scores, 3)[0].tolist() == [2, 1, 5]
    assert rank(docs, scores, 3, ties="high")[0].tolist() == [2, 9, 5]


def test_bfloat16_rounding():
    from portbench.reference import rounder

    q = rounder("bfloat16")
    x = np.array([1.0, 1.0 + 2**-9, 1.0 + 2**-7, 3.14159265])
    assert q(x).tolist() == [1.0, 1.0, 1.0 + 2**-7, 3.140625]
