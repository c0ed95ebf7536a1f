"""The yardstick's readings of the two tiny BM25 cells at a fixed seed, held
to constants: the comparison's numbers (``check.judge``) on rows with
planted faults, each control's numbers (``control.controls``) and the least
work of a window (``counts.window_work``).  A change to the harness that
moves one of them changes what the benchmark measures.  Counts compare
exactly; a float reading to 1e-12 relative, as numpy's logarithm may differ
in its last bit between CPUs."""

import numpy as np
import pytest

from portbench import check, corpus, counts
from portbench.control import controls
from portbench.reference import ReferenceIndex, rank

from conftest import tiny_cell

SEED = 2**31 + 19
CELLS = ["msmarco-1m.bm25", "msmarco-1m.typeahead"]

# (bad_rows, rank_gap, tie_rows, rows) of the 256 first stream requests'
# float64 rows, every fourth from the second with its best answer moved to
# the next document, every fifth from the third in reverse order.
JUDGED = {
    "msmarco-1m.bm25": (51, 1.5416820723330686, 24, 256),
    "msmarco-1m.typeahead": (34, 0.9999920265893637, 26, 256),
}
# The same numbers of each control: bfloat16, ties to the highest document,
# and the float64 reference itself.
CONTROLS = {
    "msmarco-1m.bm25": [(0, 0.015115113366024321, 0, 208), (0, 0.0, 76, 208), (0, 0.0, 0, 208)],
    "msmarco-1m.typeahead": [(0, 0.01367563024017138, 0, 208), (0, 0.0, 72, 208), (0, 0.0, 0, 208)],
}
# (bytes, operations) of the 512 first stream requests.
WORK = {
    "msmarco-1m.bm25": (802496.0, 1173024.0),
    "msmarco-1m.typeahead": (8755720.0, 13102860.0),
}


def _draw(name):
    cell = tiny_cell(name)
    data = corpus.make_corpus(cell.config, SEED)
    pool = corpus.make_traffic(cell.config, cell.traffic, data, SEED)
    ref = ReferenceIndex(data.fields, data.n_docs, data.spell, data.spell_len)
    return cell, data, pool, ref


def _same(numbers, expected):
    bad, gap, ties, rows = expected
    assert (numbers["bad_rows"], numbers["tie_rows"], numbers["rows"]) == (bad, ties, rows)
    assert numbers["rank_gap"] == pytest.approx(gap, rel=1e-12, abs=0)


@pytest.mark.parametrize("name", CELLS)
def test_judge_reads_the_recorded_numbers(name):
    cell, data, pool, ref = _draw(name)
    queries = [pool.words(data, i) for i in range(pool.warm, pool.warm + 256)]
    ref.load_queries(queries)
    k = cell.config["top_k"]
    rows = []
    for i, words in enumerate(queries):
        docs, scores = cell.scorer.reference(ref, words, cell.scorer.spec)
        top, _ = rank(docs, scores, k)
        row = np.concatenate([top, np.full(k - len(top), -1)])
        if i % 4 == 1 and len(top):
            row[0] = (row[0] + 1) % data.n_docs
        if i % 5 == 2:
            row[: len(top)] = top[::-1]
        rows.append(row)
    _same(check.judge(ref, cell.scorer, queries, rows, k), JUDGED[name])


@pytest.mark.parametrize("name", CELLS)
def test_controls_read_the_recorded_numbers(name):
    modes = [("bfloat16", "low"), ("float64", "high"), ("float64", "low")]
    out = controls(tiny_cell(name), SEED, modes)
    for numbers, expected in zip(out, CONTROLS[name]):
        _same(numbers, expected)


@pytest.mark.parametrize("name", CELLS)
def test_window_work_reads_the_recorded_count(name):
    cell, data, pool, ref = _draw(name)
    rows = np.arange(pool.warm, pool.warm + 512)
    postings = counts.WorkCounter(ref, data).query_postings(pool, data, rows)
    work = counts.window_work(postings, len(data.fields), cell.config["top_k"], cell.scorer)
    assert work == WORK[name]
