"""The least work behind ``step_roofline_pct.*`` is counted from the
workload: it equals the postings the port's own index expands the queries
to, and it does not move when the port's chunk width does, though the
port's lanes do."""

import numpy as np
import pytest

from portbench import corpus, counts
from portbench.reference import ReferenceIndex

from conftest import tiny_cell

SEED = 20261017


@pytest.mark.parametrize("name", ["msmarco-1m.bm25", "msmarco-1m.typeahead"])
def test_work_is_independent_of_the_chunk_width(name):
    from probly_search_tpu_torch import Index, IndexConfig, bm25, whitespace_tokenizer

    cell = tiny_cell(name)
    data = corpus.make_corpus(cell.config, SEED)
    tr = dict(cell.traffic, warm_queries=0, stream_queries=40)
    pool = corpus.make_traffic(cell.config, tr, data, SEED)
    rows = np.arange(min(200, len(pool)))
    strings = [pool.strings[i] for i in rows]
    ref = ReferenceIndex(data.fields, data.n_docs, data.spell, data.spell_len)
    postings = counts.WorkCounter(ref, data).query_postings(pool, data, rows)
    F, k = len(data.fields), cell.config["top_k"]
    work = counts.window_work(postings, F, k, cell.scorer)

    lanes = {}
    for chunk in (256, 1024):
        kw = dict(cell.config["index_config"], chunk_size=chunk)
        ix = Index(F, config=IndexConfig(**kw), device="cpu")
        ix.add_documents_columnar(list(range(data.n_docs)), data.texts)
        # The port's own postings of every expansion of every query word.
        theirs = np.array([
            sum(len(ix._gather_postings(t)[0]) for w in q.split(" ") for t in ix.expand_term(w))
            for q in strings
        ])
        assert theirs.tolist() == postings.tolist()
        assert counts.window_work(theirs, F, k, cell.scorer) == work
        dix = ix.device_index()
        plan, _ = dix.plan_batch(strings, whitespace_tokenizer, bm25.new())
        lanes[chunk] = int(plan.nchunks.sum()) * dix.CHUNK
    assert lanes[256] != lanes[1024]  # the port's layout moved, the count did not


def test_least_time_takes_the_larger_bound():
    s, bound = counts.least_seconds(3.35e12, 1.0)
    assert (s, bound) == (1.0, "memory")
    s, bound = counts.least_seconds(1.0, 67e12)
    assert (s, bound) == (1.0, "compute")


def test_postings_count_documents_not_occurrences():
    ids = np.array([3, 3, 1, 3, 0], np.int32)
    off = np.array([0, 3, 5], np.int64)  # doc 0: 3 3 1; doc 1: 3 0
    assert counts.postings_per_term([(ids, off)], 2, 4).tolist() == [1, 1, 0, 2]
