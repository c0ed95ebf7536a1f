"""The zero-to-one reference (``portbench/reference/zero_to_one.py``): the
upstream library's golden scores (``zero_to_one.rs:129-405``,
``integrations_tests.rs:95-149``; the numbers copied, no program imported),
the upstream trie's order of expansions, that this order moves no score, the
tie control, and a traced run of the CPU cut of ``recipes-1m.z2o``.  The
port's timed entry against this reference, sound and with a fault planted, is
held in ``tests/test_torch_z2o_plain_reference.py``."""

import numpy as np
import pytest

from portbench import corpus, run
from portbench.control import controls
from portbench.reference import ReferenceIndex
from portbench.reference import zero_to_one as z2o

from conftest import tiny_cell

SEED = 2**31 + 23
NAME = "recipes-1m.z2o"


def _index(*fields):
    """A reference index of documents given as one list of texts a field
    (document i is the i-th text of every field), words split on spaces."""
    vocab = sorted({w for texts in fields for t in texts for w in t.split(" ") if w})
    tid = {w: i for i, w in enumerate(vocab)}
    lmax = max(len(w) for w in vocab)
    spell = np.zeros((len(vocab), lmax), np.uint8)
    for w, i in tid.items():
        spell[i, : len(w)] = np.frombuffer(w.encode(), np.uint8)
    spell_len = np.array([len(w) for w in vocab], np.int64)
    cols = []
    for texts in fields:
        rows = [[tid[w] for w in t.split(" ") if w] for t in texts]
        off = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=off[1:])
        cols.append((np.array([i for r in rows for i in r], np.int32), off))
    return ReferenceIndex(cols, len(fields[0]), spell, spell_len)


def _scores(ix, query):
    words = query.split(" ")
    ix.load_queries([words])
    docs, scores = z2o.zero_to_one(ix, words)
    return sorted(zip(docs.tolist(), scores.tolist()), key=lambda x: (-x[1], x[0]))


GOLDEN = [
    # (titles, query, [(doc, score)]), zero_to_one.rs:129-306
    (["abc", "abcefg", "abcefghij"], "abc", [(0, 1.0), (1, 0.5), (2, 0.33333333333333337)]),
    (["abcdef abcdefghi"], "abc abc", [(0, 0.4166666666666667)]),
    (["abc"], "abc abc", [(0, 0.5)]),
    (["abc abc"], "abc", [(0, 0.5)]),
    (["abc abc"], "abc ab", [(0, 0.8333333333333334)]),
    (["abc ab"], "abc abc", [(0, 0.5)]),
    (["oy oy oysters"], "oy oy oysters", [(0, 1.0)]),
    (["abcdef", "abc abcdef", "abcdef abcdef", "abcdef abcdefghi", "def abcdef"], "abc",
     [(0, 0.5), (1, 0.5), (2, 0.25), (3, 0.25), (4, 0.25)]),
    (["abcdef", "abc abcdef", "abcdef abcdef", "abcdef abcdefghi", "def abcdef"], "abc abc",
     [(1, 0.75), (2, 0.5), (3, 0.4166666666666667), (0, 0.25), (4, 0.25)]),
]


@pytest.mark.parametrize("titles,query,expected", GOLDEN)
def test_upstream_golden_scores(titles, query, expected):
    got = _scores(_index(titles), query)
    assert [d for d, _ in got] == [d for d, _ in expected]
    for (_, s), (_, e) in zip(got, expected):
        assert s == pytest.approx(e, abs=1e-8)  # the upstream tests' 8 decimal places


@pytest.mark.parametrize("descriptions", [["abc", "abcefg", "abcefghij"], ["a", "a", "a"]])
def test_upstream_golden_two_fields(descriptions):
    """zero_to_one.rs:308-404: a document scores its best field."""
    got = _scores(_index(["abc", "abcefg", "abcefghij"], descriptions), "abc")
    assert got == pytest.approx([(0, 1.0), (1, 0.5), (2, 0.33333333333333337)], abs=1e-8)


def test_upstream_lifecycle_scores():
    """integrations_tests.rs:95-149, before the removal."""
    got = _scores(_index(["abc", "dfgh"], ["dfg", "abcd"]), "abc")
    assert got == [(0, 1.0), (1, 0.75)]


def test_trie_order_is_preorder_newest_child_first():
    """The node "ab" exists from document 0 (as the path to "abd") and holds
    a term from document 2; "abc" is the newer child of "ab"."""
    ix = _index(["abd", "abc", "ab", "abcz abca"])
    ix.load_queries([["ab"]])
    order = [str(ix.sorted_words[np.flatnonzero(ix.sorted_ids == t)[0]])
             for t in z2o.trie_order(ix, "ab", ix.expand("ab"))]
    # "abc": the newer child first, then below it "abcz" (inserted before
    # "abca", so older); then "abd".
    assert order == ["ab", "abc", "abca", "abcz", "abd"]


def _draw(n_queries=256):
    cell = tiny_cell(NAME)
    data = corpus.make_corpus(cell.config, SEED)
    pool = corpus.make_traffic(cell.config, cell.traffic, data, SEED)
    ref = ReferenceIndex(data.fields, data.n_docs, data.spell, data.spell_len)
    qi = range(pool.warm, pool.warm + n_queries)
    return cell, data, ref, [pool.strings[i] for i in qi], [pool.words(data, i) for i in qi]


def test_expansion_order_moves_no_score():
    """The trie's order against lexicographic order, on the CPU cut's
    queries and each again with its first word repeated (shared nodes,
    pools run out): the same documents, scores within float64 rounding."""
    _, _, ref, _, queries = _draw(128)
    queries = queries + [w + w[:1] for w in queries]
    ref.load_queries(queries)
    for words in queries:
        d1, s1 = z2o.zero_to_one(ref, words)
        d2, s2 = z2o.zero_to_one(ref, words, order=lambda ix, w, t: t)
        assert d1.tolist() == d2.tolist()
        np.testing.assert_allclose(s1, s2, rtol=1e-15, atol=0)
    # The two orders do differ on these queries' words.
    words = {w for q in queries for w in q}
    differ = [w for w in words if z2o.trie_order(ref, w, ref.expand(w)).tolist() != ref.expand(w).tolist()]
    assert len(differ) > 10


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_controls(seed):
    """The float64 reference with ties to the highest document fails the
    tie limit; in the program's place with ties to the lowest it reads 0."""
    high, low = controls(tiny_cell(NAME), seed, [("float64", "high"), ("float64", "low")])
    assert high["tie_rows"] > high["checks"]["tie_rows"]["limit"], high
    assert low["rank_gap"] == 0.0 and low["bad_rows"] == 0 and low["tie_rows"] == 0, low


def test_traced_run_reads_the_span_metrics():
    """A traced run of the CPU cut: correct, and every metric read from the
    program's spans present (the device's need a card)."""
    res = run.run_cell(tiny_cell(NAME), 2**31 + 5, 1.0, True, "cpu")
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    spans = {"plan_ms.z2o", "plan_terms_ms.z2o", "plan_pool_ms.z2o", "host_rows_ms.z2o",
             "pack_ms.z2o", "dispatch_ms.z2o", "drain_self_ms.z2o", "plan_offcpu_ms.z2o"}
    assert spans <= got, got
    assert res["metrics"]["plan_terms_ms.z2o"]["queries"] == 256  # every query first seen
    assert res["metrics"]["plan_pool_ms.z2o"]["rows"] > 0
