"""The harness is driven by data: a configuration, a scorer, a traffic mix
and a metric added as new files with their manifest entries resolve without
any file that is there being edited; and a run that finds no card fails
instead of falling back to the CPU."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def _digests(root):
    return {
        p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted((root / "portbench").rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


@pytest.fixture
def tree(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def _add_cell(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/msmarco-1m.json").read_text())
    cfg["corpus"]["docs"] = 20000
    (root / "portbench/configs/msmarco-20k.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/bm25-window4k.json").write_text(json.dumps(
        {"loop": "closed", "window": 4096, "depth": 2, "warm_queries": 8192, "warm_passes": 1,
         "stream_queries": 65536}))
    (root / "portbench/metrics/windows_done.py").write_text(
        "def read(ctx):\n    return ctx['windows']\n")
    bench["configs"].append({"name": "msmarco-20k", "source": "https://example.org/passages",
                             "file": "portbench/configs/msmarco-20k.json", "reduced": ["docs"],
                             "why": "a test"})
    bench["workloads"].append({"name": "msmarco-20k.small", "config": "msmarco-20k",
                               "traffic": "bm25-window4k", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "plan_ms.test", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "plan", "moves": "qps",
                               "workloads": ["msmarco-1m.bm25"]})
    (root / "portbench/metrics/plan_ms.test.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    bench["per_layer"].append({"name": "windows_done", "unit": "windows", "better": "higher",
                               "source": "program_counter", "layer": "plan",
                               "moves": "peak_device_gib"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_resolve_without_editing_any(tree):
    from portbench import manifest

    before = _digests(tree)
    _add_cell(tree)
    after = _digests(tree)
    assert all(after[p] == d for p, d in before.items())  # nothing there changed
    cell = manifest.resolve(tree, "msmarco-20k.small")
    assert cell.config["corpus"]["docs"] == 20000
    assert cell.traffic["window"] == 4096
    names = [m.name for m in cell.per_layer]
    # No workloads list: read in every cell that reports peak_device_gib, the new one too.
    assert "windows_done" in names
    assert "windows_done" in [m.name for m in manifest.resolve(tree, "msmarco-1m.bm25").per_layer]
    assert "plan_ms.test" not in names  # listed for msmarco-1m.bm25 only
    assert "plan_ms.test" in [m.name for m in manifest.resolve(tree, "msmarco-1m.bm25").per_layer]
    reader = next(m for m in cell.per_layer if m.name == "windows_done").read
    assert reader({"windows": 7}) == 7
    # An end-to-end metric with a workloads list is reported in those cells only.
    assert [m.name for m in cell.end_to_end] == ["peak_device_gib", "setup_s"]
    assert [m.name for m in manifest.resolve(tree, "msmarco-1m.bm25").end_to_end] == [
        "window_p95_ms", "peak_device_gib", "setup_s"]
    assert [m.name for m in manifest.resolve(tree, "msmarco-1m.typeahead").end_to_end] == [
        "qps", "peak_device_gib", "setup_s"]


# A scorer that exists only as a new file: BM25 under another name, with the
# configuration's k1 and b, noting each query its reference scores.
PROBE_SCORER = """
from portbench.reference import scorers

SCORED = []


def program(spec):
    from probly_search_tpu_torch import bm25

    return bm25.new(bm25k1=float(spec["k1"]), bm25b=float(spec["b"]))


def reference(ix, words, spec, precision="float64"):
    SCORED.append(list(words))
    return scorers.bm25(ix, words, float(spec["k1"]), float(spec["b"]), precision=precision)


def ops_per_posting(F):
    return 9 * F + 3


def bytes_per_posting(F):
    return 4 * (1 + F)
"""


def _add_scorer_cell(root, scorer):
    """A configuration that names ``scorer`` and a cell of it, each a new
    file and a new entry (the cell's CPU cut as well)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/msmarco-1m.json").read_text())
    cfg["scorer"] = {"name": scorer, "k1": 1.6, "b": 0.75}
    (root / "portbench/configs/msmarco-probe.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "msmarco-probe", "source": "https://example.org/passages",
                             "file": "portbench/configs/msmarco-probe.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "msmarco-probe.bm25", "config": "msmarco-probe",
                               "traffic": "bm25-window16k", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench/tests/tiny/msmarco-probe.bm25.json").write_text(json.dumps({
        "config": {"corpus": {"docs": 3000, "vocab": {"terms": 3000, "min_len": 2}}},
        "traffic": {"window": 64, "warm_queries": 64, "warm_passes": 1, "prewarm": False,
                    "stream_queries": 4096, "rows_per_window": 16, "check_rows": 16,
                    "check_longest": 4}}))


def test_a_scorer_added_as_a_file_runs_a_cell(tree):
    """The new scorer's program serves the window on the CPU and its
    reference scores every row the check judges; no file that was there
    changes."""
    from portbench import run

    from conftest import tiny_cell

    before = _digests(tree)
    (tree / "portbench/scorers/bm25_probe.py").write_text(PROBE_SCORER)
    _add_scorer_cell(tree, "bm25_probe")
    after = _digests(tree)
    assert all(after[p] == d for p, d in before.items())
    cell = tiny_cell("msmarco-probe.bm25", root=tree)
    assert cell.scorer.name == "bm25_probe" and cell.scorer.spec["k1"] == 1.6
    scored = cell.scorer.reference.__globals__["SCORED"]
    res = run.run_cell(cell, 2**31 + 29, 0.5, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["checked_rows"] > 0 and len(scored) == res["checked_rows"]


def test_a_scorer_without_a_file_fails_at_resolve(tree):
    from portbench import manifest

    _add_scorer_cell(tree, "no_such_scorer")
    with pytest.raises(FileNotFoundError) as err:
        manifest.resolve(tree, "msmarco-probe.bm25")
    assert str(tree / "portbench" / "scorers" / "no_such_scorer.py") in str(err.value)


def test_every_cell_resolves_its_files():
    from portbench import manifest

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    moves = {m["name"]: m["moves"] for m in bench["per_layer"]}
    for w in bench["workloads"]:
        cell = manifest.resolve(ROOT, w["name"])
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        # Each per-layer metric of a cell moves an end-to-end metric it reports.
        assert {moves[m.name] for m in cell.per_layer} <= e2e, w["name"]


def test_a_run_without_a_card_fails_and_prints_no_result(tree):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _add_cell(tree)
    for cell in ("msmarco-20k.small", "msmarco-1m.bm25"):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
             "--seconds", "1", "--trace", "0"],
            cwd=tree, capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0
        assert out.stdout.strip() == ""
        assert "CUDA device" in out.stderr


def test_a_timer_reads_host_ms_a_window():
    """A window may time a phase more than once (its heavy queries are
    submitted again): the reader sums the timer over the drained windows."""
    from portbench.readers import timer_ms

    ctx = {"timers": {"query/plan": {"count": 6, "mean_us": 500.0}}, "windows": 2}
    assert timer_ms(ctx, "query/plan") == 1.5
    assert timer_ms(ctx, "query/pack") is None
    assert timer_ms(dict(ctx, windows=0), "query/plan") is None
