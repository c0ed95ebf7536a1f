"""The port's timed zero-to-one path against the benchmark's plain float64
reference (``portbench/reference/zero_to_one.py``, written from the upstream
semantics and independent of the port), on the benchmark's cell
``recipes-1m.z2o`` cut to its CPU size (``portbench/tests/tiny/``): the
stream's queries, and those rows again with a fault planted; the same queries
with a word repeated, which shares its expansions' nodes and takes the
lockstep program; and each word beside its own prefix, where the word takes
its exact term's df pool and the prefix then finds that pool used up.  Rows
go through ``Index.query_batch_async(...).get_arrays()`` with the cell's
``slots20`` results and are judged by the configuration's own check and
limits."""

import numpy as np
import pytest

from portbench import check, corpus
from portbench.reference import ReferenceIndex
from portbench.tests.conftest import tiny_cell

import probly_search_tpu_torch as pt
from probly_search_tpu_torch.ops import z2o_device as pz
from probly_search_tpu_torch.utils.tokenizers import whitespace_tokenizer

SEED = 2**31 + 57
N = 48


@pytest.fixture(scope="module")
def cut():
    """The cell at its CPU size (``portbench/tests/tiny/``), its corpus, the
    reference's index, the port's device index and the stream's first
    queries (as word lists)."""
    cell = tiny_cell("recipes-1m.z2o")
    cfg = cell.config
    data = corpus.make_corpus(cfg, SEED)
    pool = corpus.make_traffic(cfg, dict(cell.traffic, warm_queries=0, stream_queries=2 * N),
                               data, SEED)
    ref = ReferenceIndex(data.fields, data.n_docs, data.spell, data.spell_len)
    ix = pt.Index(len(data.fields), config=pt.IndexConfig(**cfg["index_config"]), device="cpu")
    ix.add_documents_columnar(list(range(data.n_docs)), data.texts)
    # Queries whose first word a document holds (the cut's corpus lacks
    # some of the rarer terms), so a repeat of it shares its nodes.
    held = ref.occ[pool.ids[pool.offsets[:-1]]] > 0
    queries = [pool.words(data, i) for i in np.flatnonzero(held)[:N].tolist()]
    assert len(queries) == N
    return cell, cfg, ref, ix, queries


def _repeated(queries):
    return [q + q[:1] for q in queries]


def _with_prefix(queries):
    return [[q[0], q[0][:-1]] for q in queries if len(q[0]) > 1]


@pytest.mark.parametrize("case", ["stream", "repeated", "prefix"])
def test_timed_path_meets_the_plain_reference(cut, case):
    cell, cfg, ref, ix, stream = cut
    queries = {"stream": stream, "repeated": _repeated(stream), "prefix": _with_prefix(stream)}[case]
    strings = [" ".join(q) for q in queries]
    k = cfg["top_k"]
    _, slots, keys = ix.query_batch_async(strings, pt.zero_to_one.new(), top_k=k).get_arrays()
    rows = np.where(slots >= 0, keys, -1)
    numbers = check.judge(ref, cell.scorer, queries, list(rows), k)
    assert numbers["rows"] == len(queries) and numbers["bad_rows"] == 0, numbers
    assert check.passed(check.verdict(numbers, cfg["check"]["limits"])), numbers
    if case == "stream":
        # A planted fault: one row's best answer replaced by another document.
        bad = rows.copy()
        r = int(np.flatnonzero(bad[:, 0] >= 0)[0])
        bad[r, 0] = (bad[r, 0] + 1) % ref.n_docs
        assert check.judge(ref, cell.scorer, queries, list(bad), k)["bad_rows"] > 0
        return
    # Every query that matches shares an expansion's node between two of its
    # words, so the planner routes it to the lockstep program, not the fast
    # one.
    plan = pz.plan_batch_z2o(ix.device_index(), strings, whitespace_tokenizer)
    njobs, shared = plan[4], plan[6]
    assert (njobs > 0).all() and shared.all()
    if case == "prefix":
        # In the documents whose field holds the word once, the word's entry
        # takes its df pool (tf - 1 = 0) and the prefix's entry on the same
        # term finds it used up.
        ref.load_queries(queries)
        once = 0
        for words in queries:
            (term,) = [t for t in ref.expand(words[0]) if ref.spell_len[t] == len(words[0])]
            _, tf, _ = ref.gather([term])
            once += int((tf == 1).sum())
        assert once > 100
