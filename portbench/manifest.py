"""Finds a cell's files by the names in ``BENCHMARK.json``: its
configuration (the file the ``configs`` entry names), the scorer that
configuration names (``portbench/scorers/<scorer name>.py``), its traffic mix
(``portbench/traffic/<traffic>.json``) and one reader a metric
(``portbench/metrics/<metric>.py``, a function ``read(ctx)``).  A new
configuration, scorer, mix or metric is a new file and a new entry; no file
that is there changes.

A scorer file gives four functions, of the configuration's ``scorer`` entry
(``spec``) and the number of fields ``F``:

  program(spec)           the port's scorer object for the timed call; it
                          imports the port inside the function, never at
                          module level
  reference(ix, words, spec, precision)
                          (docs, scores) of every document the query
                          matches, from the plain reference
                          (``portbench/reference/``) in ``precision``
  ops_per_posting(F)      the least float32 operations of one posting
  bytes_per_posting(F)    the least bytes read of one posting
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Scorer:
    name: str
    spec: dict
    program: Callable
    reference: Callable
    ops_per_posting: Callable
    bytes_per_posting: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    scorer: Scorer
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load(path: Path, kind: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(path: Path) -> Callable:
    return _load(path, "metric").read


def load_scorer(root: Path, spec: dict) -> Scorer:
    """The scorer file ``root/portbench/scorers/<name>.py`` of a
    configuration's ``scorer`` entry ``spec``."""
    mod = _load(root / "portbench" / "scorers" / f"{spec['name']}.py", "scorer")
    return Scorer(spec["name"], spec, mod.program, mod.reference, mod.ops_per_posting,
                  mod.bytes_per_posting)


def _metric(root: Path, entry: dict) -> Metric:
    path = root / "portbench" / "metrics" / f"{entry['name']}.py"
    return Metric(entry["name"], entry["unit"], load_reader(path))


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs: Dict[str, dict] = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())

    def applies(entry):
        return "workloads" not in entry or workload in entry["workloads"]

    e2e = [_metric(root, m) for m in bench["end_to_end"] if applies(m)]
    reported = {m.name for m in e2e}

    def layer_applies(entry):
        # Without a list, a per-layer metric is read in every cell that
        # reports the end-to-end metric it moves.
        if "workloads" in entry:
            return workload in entry["workloads"]
        return entry["moves"] in reported

    per_layer = [_metric(root, m) for m in bench["per_layer"] if layer_applies(m)]
    scorer = load_scorer(root, config["scorer"])
    return Cell(workload, int(w["chips"]), config, scorer, traffic, e2e, per_layer)
