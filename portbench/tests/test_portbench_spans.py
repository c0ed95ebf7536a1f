"""The readers of the program's span sums (``portbench/spans.py``), on made-up
contexts: 0.0 where the window opened none of a span, None where no window
was drained or the program keeps no self time, the keys beside each value,
and the plan split adding up to ``plan_ms.bm25``."""

import pytest

from conftest import ROOT
from portbench import manifest

NEW = [
    "plan_terms_ms.bm25", "plan_pool_ms.bm25", "plan_offcpu_ms.bm25",
    "drain_self_ms.bm25", "heavy_miss_ms.bm25", "capture_ms.bm25",
]
BESIDE = {
    "plan_terms_ms.bm25": {"terms", "bounds_ms", "plan_self_ms"},
    "plan_pool_ms.bm25": {"rows"},
    "heavy_miss_ms.bm25": {"misses"},
    "capture_ms.bm25": {"captures"},
}


def _span(count, total_us, self_us=None, cpu_us=0.0, offcpu_us=0.0, items=0):
    return {
        "count": count, "mean_us": total_us / count,
        "self_us": total_us if self_us is None else self_us, "cpu_us": cpu_us,
        "offcpu_us": offcpu_us, "items": items,
    }


def _ctx(windows=4):
    # query/plan 4000 us = self 1000 + plan/terms self 1500 + bounds 700 + pool 800
    timers = {
        "query/plan": _span(4, 4000.0, self_us=1000.0, cpu_us=3000.0, offcpu_us=1000.0),
        "plan/terms": _span(4, 2900.0, self_us=1500.0, items=40),
        "query/prune_bounds": _span(4, 700.0),
        "plan/pool": _span(8, 800.0, items=1000),
        "query/drain": _span(4, 600.0, self_us=200.0),
        "query/fetch": _span(4, 400.0),
        "query/heavy_miss": _span(2, 500.0, items=2),
        "query/capture": _span(3, 90.0, items=3),
    }
    return {"timers": timers, "windows": windows}


def _readers(names):
    cell = manifest.resolve(ROOT, "msmarco-1m.typeahead")
    by_name = {m.name: m.read for m in cell.per_layer}
    return {n: by_name[n] for n in names}


def test_each_cell_lists_the_new_metrics():
    old = ["plan_ms.bm25", "pack_ms.bm25", "dispatch_ms.bm25", "glue_device_ms.bm25",
           "step_roofline_pct.bm25", "device_idle_pct.bm25"]
    bm25 = [m.name for m in manifest.resolve(ROOT, "msmarco-1m.bm25").per_layer]
    typeahead = [m.name for m in manifest.resolve(ROOT, "msmarco-1m.typeahead").per_layer]
    assert typeahead == old + NEW
    # The passage cell reads the same under its own names (they move its
    # window_p95_ms); it has no heavy-query cache.
    passage = [n.replace(".bm25", ".passage") for n in old + NEW if n != "heavy_miss_ms.bm25"]
    assert bm25 == passage + ["traced_qps.passage"]


@pytest.mark.parametrize("name", NEW + ["plan_ms.bm25", "pack_ms.bm25", "dispatch_ms.bm25"])
def test_a_passage_reader_reads_what_its_twin_reads(name):
    twin = name.replace(".bm25", ".passage")
    passage = {m.name: m.read for m in manifest.resolve(ROOT, "msmarco-1m.bm25").per_layer}
    if name == "heavy_miss_ms.bm25":
        assert twin not in passage
        return
    for ctx in (_ctx(), _ctx(windows=0)):
        assert passage[twin](ctx) == _readers([name])[name](ctx)


def test_traced_qps_reads_what_qps_reads():
    passage = {m.name: m.read for m in manifest.resolve(ROOT, "msmarco-1m.bm25").per_layer}
    qps = {m.name: m.read for m in manifest.resolve(ROOT, "msmarco-1m.typeahead").end_to_end}["qps"]
    for timed in ({"queries": 16384 * 61, "wall_s": 25.4}, {"queries": 0, "wall_s": 0.0}):
        ctx = {"timed": timed}
        assert passage["traced_qps.passage"](ctx) == qps(ctx)


def test_values_and_the_keys_beside_them():
    ctx = _ctx()
    got = {n: r(ctx) for n, r in _readers(NEW).items()}
    for name, keys in BESIDE.items():
        assert set(got[name]) == keys | {"value"}, name
    assert got["plan_terms_ms.bm25"]["value"] == pytest.approx(1500.0 / 1e3 / 4)
    assert got["plan_terms_ms.bm25"]["terms"] == 10
    assert got["plan_pool_ms.bm25"]["rows"] == 250
    assert got["plan_offcpu_ms.bm25"] == pytest.approx(1000.0 / 1e3 / 4)
    assert got["drain_self_ms.bm25"] == pytest.approx(200.0 / 1e3 / 4)
    assert got["heavy_miss_ms.bm25"] == {"value": pytest.approx(0.125), "misses": 0.5}
    assert got["capture_ms.bm25"]["captures"] == 3


def test_the_plan_split_adds_up_to_plan_ms():
    ctx = _ctx()
    r = _readers(NEW + ["plan_ms.bm25"])
    terms, pool = r["plan_terms_ms.bm25"](ctx), r["plan_pool_ms.bm25"](ctx)
    split = terms["plan_self_ms"] + terms["value"] + terms["bounds_ms"] + pool["value"]
    assert split == pytest.approx(r["plan_ms.bm25"](ctx))


def test_zero_without_the_span_none_without_windows_or_sums():
    r = _readers(NEW)
    ctx = _ctx()
    for name in ("plan/terms", "plan/pool", "query/heavy_miss", "query/capture"):
        del ctx["timers"][name]
    assert r["plan_terms_ms.bm25"](ctx)["value"] == 0.0
    assert r["plan_terms_ms.bm25"](ctx)["terms"] == 0.0
    assert r["plan_pool_ms.bm25"](ctx) == {"value": 0.0, "rows": 0.0}
    assert r["heavy_miss_ms.bm25"](ctx) == {"value": 0.0, "misses": 0.0}
    assert r["capture_ms.bm25"](ctx) == {"value": 0.0, "captures": 0}
    for read in r.values():
        assert read(_ctx(windows=0)) is None
    # A program whose timers keep only count and mean (no self time): nothing to read.
    older = {"timers": {"query/plan": {"count": 4, "mean_us": 1000.0}}, "windows": 4}
    for read in r.values():
        assert read(older) is None
