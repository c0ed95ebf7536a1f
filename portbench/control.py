"""The control of ``correct``: the reference put in the program's place,
computed in a lower precision (or with a guarantee broken), judged by the
same comparison against the float64 reference.  It needs no card and no
program; the benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--controls bfloat16:low,float64:high]

For each seed it draws the cell's corpus and traffic as a run does, takes
the traffic's number of checked rows from the stream (seeded, plus
the longest requests), ranks them with each control and prints a JSON line
of the comparison's numbers beside the configuration's limits for each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench import check, corpus, manifest  # noqa: E402
from portbench.reference import ReferenceIndex, rank  # noqa: E402


def controls(cell: manifest.Cell, seed: int, modes) -> list:
    """The comparison's numbers of each control ``(precision, ties)`` in
    ``modes``, on one draw of the cell's data for ``seed``."""
    cfg, traffic = cell.config, cell.traffic
    k = int(cfg["top_k"])
    data = corpus.make_corpus(cfg, seed)
    pool = corpus.make_traffic(cfg, traffic, data, seed)
    ck = cfg["check"]
    rng = np.random.default_rng([seed, 5])
    stream = np.arange(pool.warm, len(pool))
    picked = rng.choice(stream, int(traffic["check_rows"]), replace=False).tolist()
    longest = stream[np.argsort(-np.diff(pool.offsets)[pool.warm:], kind="stable")[: int(traffic["check_longest"])]].tolist()
    ref = ReferenceIndex(data.fields, data.n_docs, data.spell, data.spell_len)
    queries = [pool.words(data, qi) for qi in picked + longest]
    ref.load_queries(queries)
    out = []
    for precision, ties in modes:
        rows = []
        for words in queries:
            docs, scores = cell.scorer.reference(ref, words, cell.scorer.spec, precision)
            top, _ = rank(docs, scores, k, ties=ties)
            rows.append(np.concatenate([top, np.full(k - len(top), -1)]))
        numbers = check.judge(ref, cell.scorer, queries, rows, k)
        out.append({"seed": seed, "precision": precision, "ties": ties, **numbers,
                    "checks": check.verdict(numbers, ck["limits"])})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="bfloat16:low,float64:high",
                    help="precision:ties pairs, each judged on the same rows")
    args = ap.parse_args(argv)
    cell = manifest.resolve(ROOT, args.workload)
    modes = [tuple(m.split(":")) for m in args.controls.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for out in controls(cell, seed, modes):
            out["seconds"] = time.perf_counter() - t
            out["correct"] = check.passed(out.pop("checks"))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
