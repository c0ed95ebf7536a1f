"""The port's spans (``probly_search_tpu_torch.utils.metrics``): self time,
work items and, where asked for, thread CPU time beside each span's count
and mean; a ``record_function`` range only while a profiler records; and the
planner's and the heavy-query cache's spans where the work happens, on a
tiny CPU index."""

import json
import os
import threading
import time

import pytest
import torch

import probly_search_tpu_torch as pt
from probly_search_tpu_torch.utils import metrics as metrics_mod
from probly_search_tpu_torch.utils import profiling
from probly_search_tpu_torch.utils.metrics import Registry, metrics


def _index(**config):
    ix = pt.Index(1, config=pt.IndexConfig(**config), device="cpu")
    texts = ["w%d w%d common x%d" % (i % 7, i % 11, i % 13) for i in range(60)]
    ix.add_documents_columnar(list(range(60)), [texts])
    return pt.DeviceIndex(ix, device="cpu")


def _spans():
    return metrics.snapshot()["histograms"]


def _total(h):
    return h["count"] * h["mean_us"]


def test_nested_spans_self_time_cpu_time_and_items():
    reg = Registry()
    ready, done = threading.Event(), threading.Event()

    def other_thread():  # open while "outer" is: no child of it
        with reg.timer("other"):
            ready.set()
            done.wait(5)

    th = threading.Thread(target=other_thread)
    with reg.timer("outer", items=2):
        th.start()
        assert ready.wait(5)
        with reg.timer("inner", items=1):
            reg.time_cpu()
            time.sleep(0.01)
            reg.add_items(4)
        with reg.timer("inner"):
            reg.time_cpu()
            t_end = time.perf_counter() + 0.005
            while time.perf_counter() < t_end:  # on the CPU
                pass
        done.set()
        th.join(5)
    assert not th.is_alive()
    with reg.timer("outer", items=3):
        pass
    h = reg.snapshot()["histograms"]
    outer, inner, other = h["outer"], h["inner"], h["other"]
    assert outer["count"] == 2 and inner["count"] == 2 and other["count"] == 1
    assert outer["mean_us"] == pytest.approx(reg.histograms["outer"].sum_us / 2)
    # self = total - the spans opened inside it on the same thread
    assert outer["self_us"] == pytest.approx(_total(outer) - _total(inner), abs=1e-3)
    assert inner["self_us"] == pytest.approx(_total(inner), abs=1e-3)
    assert other["self_us"] == pytest.approx(_total(other), abs=1e-3)
    assert _total(inner) >= 1.5e4  # the 10 ms sleep and the 5 ms loop
    # CPU time where asked for: the loop's, not the sleep's; none elsewhere
    assert 2e3 <= inner["cpu_us"] <= _total(inner) - 9e3
    assert inner["offcpu_us"] == pytest.approx(_total(inner) - inner["cpu_us"], abs=50)
    assert outer["cpu_us"] == other["cpu_us"] == outer["offcpu_us"] == 0.0
    assert (outer["items"], inner["items"], other["items"]) == (5, 5, 0)
    reg.reset()
    assert reg.snapshot()["histograms"] == {}


def test_no_record_function_without_a_profiler(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(metrics_mod, "record_function", boom)
    dix = _index()
    metrics.reset()
    dix.query_batch_async(["w1 common", "x3"], pt.bm25.new(), top_k=5).get_arrays()
    assert _spans()["query/plan"]["count"] == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function"):
            with metrics.timer("traced"):
                pass


def test_device_trace_holds_the_planner_spans(tmp_path):
    dix = _index()
    with profiling.device_trace(str(tmp_path)):
        dix.query_batch_async(["w2 x5", "common"], pt.bm25.new(), top_k=5).get_arrays()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"query/plan", "plan/terms", "plan/pool", "plan/pool_grow"} <= names


def test_first_sight_planning_spans_and_the_plan_split():
    dix = _index()
    window = ["w1 common", "x3 w4", "w1", "x1"]  # x1 expands to x1, x10-x12
    metrics.reset()
    dix.query_batch_async(window, pt.bm25.new(), top_k=5).get_arrays()
    h = _spans()
    new_terms = len({t for q in window for t in q.split()})
    assert h["plan/terms"]["count"] == 1 and h["plan/terms"]["items"] == new_terms
    (pool,) = dix._plan_pools.values()
    (qp,) = dix._qplan_pools.values()
    assert h["plan/pool"]["count"] == 2  # the term pool, the query-plan pool
    assert h["plan/pool"]["items"] == len(pool["start"]) + len(qp["words"])
    # Every column's first append reallocates its empty buffer, nested in
    # plan/pool; the rows copied are the two pools' leading "off" zero.
    grow = h["plan/pool_grow"]
    assert grow["count"] == len(pool["bufs"]) + len(qp["bufs"]) and grow["items"] == 2
    children = _total(h["plan/pool"]) - h["plan/pool"]["self_us"]
    assert _total(grow) == pytest.approx(children, abs=1e-3)
    # query/plan = its self + plan/terms' self + prune bounds + pool growth
    parts = (
        h["query/plan"]["self_us"] + h["plan/terms"]["self_us"]
        + _total(h["query/prune_bounds"]) + _total(h["plan/pool"])
    )
    assert parts == pytest.approx(_total(h["query/plan"]), rel=1e-6)
    plan = h["query/plan"]
    assert plan["cpu_us"] > 0 and 0 <= plan["offcpu_us"] < _total(plan)

    metrics.reset()
    dix.query_batch_async(window, pt.bm25.new(), top_k=5).get_arrays()
    h = _spans()
    assert h["query/plan"]["count"] == 1
    assert "plan/terms" not in h and "plan/pool" not in h and "plan/pool_grow" not in h


def test_heavy_cache_miss_opens_one_span():
    dix = _index(heavy_cache_min_chunks=1)
    window = ["w1 common", "x3", "w5 x7"]
    metrics.reset()
    dix.query_batch_async(window, pt.bm25.new(), top_k=5).get_arrays()
    snap = metrics.snapshot()
    misses = snap["counters"]["heavy_cache_misses"]
    assert misses == len(window)
    assert snap["histograms"]["query/heavy_miss"]["count"] == misses
    assert snap["histograms"]["query/heavy_miss"]["items"] == misses

    metrics.reset()
    dix.query_batch_async(window, pt.bm25.new(), top_k=5).get_arrays()
    snap = metrics.snapshot()
    assert snap["counters"]["heavy_cache_hits"] == len(window)
    assert "heavy_cache_misses" not in snap["counters"]
    assert "query/heavy_miss" not in snap["histograms"]
