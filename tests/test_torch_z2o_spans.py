"""The zero-to-one planner's spans (``ops/z2o_device.py``) on a tiny CPU
index: ``z2o/plan_terms`` (first-sight planning, items = the queries) and
``z2o/plan_pool`` (the pool's appends, items = the job rows) nested in
``z2o/plan``, which reads the thread's CPU time, and ``z2o/host_rows`` (items
= the queries whose rows the host computed past the device caps)."""

import contextlib

import pytest

import probly_search_tpu_torch as pt
from portbench import trace
from probly_search_tpu_torch.ops import z2o_device as pz
from probly_search_tpu_torch.utils.metrics import metrics
from probly_search_tpu_torch.utils.tokenizers import whitespace_tokenizer

# Past the device caps: more words than max_query_terms (4 below).
LONG = "abc abd x1 x2 abcd"
WINDOW = ["abc", "abd x3", "abc abc", LONG, "y2 ab", "abc", "zzz"]


def _dix(**config):
    ix = pt.Index(2, config=pt.IndexConfig(max_query_terms=4, **config), device="cpu")
    titles = ["abc abd x%d" % (i % 9) for i in range(40)]
    texts = ["abcd y%d abc" % (i % 5) for i in range(40)]
    ix.add_documents_columnar(list(range(40)), [titles, texts])
    return ix.device_index()


def _window(dix, window, marked=False):
    """Serve ``window``; its spans and its host rows.  ``marked``: with the
    benchmark's wrapper of ``metrics.timer`` on (a traced run's, which
    passes a span its name alone)."""
    metrics.reset()
    with trace.mark_program_timers(metrics, trace.Names()) if marked else contextlib.nullcontext():
        pending = pz.z2o_query_batch_async(dix, window, whitespace_tokenizer, 5)
        pending.get_arrays()
    return metrics.snapshot()["histograms"], pending._host_rows


def _total(h):
    return h["count"] * h["mean_us"]


@pytest.mark.parametrize("marked", [False, True])
def test_first_sight_spans_nest_in_the_plan(marked):
    dix = _dix()
    h, host = _window(dix, WINDOW, marked)
    plan, terms, pool = h["z2o/plan"], h["z2o/plan_terms"], h["z2o/plan_pool"]
    assert plan["count"] == terms["count"] == pool["count"] == 1
    assert terms["items"] == len(set(WINDOW))  # each distinct query planned once
    (qp,) = dix._z2o_qplans.values()
    assert pool["items"] == len(qp["words"]) > 0  # every job row appended
    assert _total(terms) + _total(pool) <= _total(plan)
    assert plan["self_us"] == pytest.approx(_total(plan) - _total(terms) - _total(pool), abs=1e-3)
    assert plan["cpu_us"] > 0 and terms["cpu_us"] == pool["cpu_us"] == 0.0
    # The long query's rows came from the host.
    assert list(host) == [WINDOW.index(LONG)]
    assert h["z2o/host_rows"]["count"] == 1 and h["z2o/host_rows"]["items"] == 1
    # Seen again, every query comes from the pool: no first-sight spans.
    h, _ = _window(dix, WINDOW)
    assert "z2o/plan_terms" not in h and "z2o/plan_pool" not in h
    assert h["z2o/plan"]["count"] == 1 and h["z2o/host_rows"]["items"] == 1


def test_host_rows_items_count_the_rows_the_host_computed():
    """Besides the planner's caps, a class past its lane budget sends its
    queries to the host: ``items`` over the window's ``z2o/host_rows``
    spans is the number of host rows."""
    dix = _dix()
    dix.LANES_PER_DISPATCH = 1  # every fast query past the budget
    h, host = _window(dix, WINDOW)
    rows = h["z2o/host_rows"]
    assert rows["count"] == 2  # the planner's caps, then the lane budget
    assert rows["items"] == len(host) > 1
    assert h["z2o/plan_terms"]["items"] == len(set(WINDOW))
