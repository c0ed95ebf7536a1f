"""The comparison that decides ``correct``: rows the measured window drained
against the float64 reference of the cell's scorer (``reference`` of its
file under ``portbench/scorers/``), by the numbers a configuration's
``check`` names, each held to its limit.

  bad_rows       rows that return another number of documents than the
                 reference matches (up to k), a document twice, a document
                 the query does not match, or a gap before the last valid
                 entry (exact: limit 0)
  rank_gap       the widest gap, relative to the reference's i-th best
                 score, between that score and the reference's score of the
                 document the row returns at position i (f32 scoring meets
                 the float64 order up to near-ties; a lower precision swaps
                 documents that differ by its rounding)
  tie_rows       rows that put a document before one of a lower id whose
                 float64 score is exactly equal, or leave out such a one
                 (the tie guarantee)
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .manifest import Scorer
from .reference import ReferenceIndex, rank


def judge(ix: ReferenceIndex, scorer: Scorer, queries: Sequence[List[str]],
          rows: Sequence[np.ndarray], k: int) -> Dict[str, float]:
    """The numbers of ``rows`` (document ids, -1 past the last) against the
    float64 reference of ``queries``."""
    ix.load_queries(list(queries))
    bad = ties = 0
    gap = 0.0
    for words, row in zip(queries, rows):
        docs, scores = scorer.reference(ix, words, scorer.spec, "float64")
        top_d, top_s = rank(docs, scores, k)
        row = np.asarray(row, np.int64)[:k]
        valid = row[row >= 0]
        pos = np.searchsorted(docs, valid)
        known = (pos < len(docs)) & (docs[np.minimum(pos, len(docs) - 1)] == valid) if len(docs) else np.zeros(len(valid), bool)
        if (
            len(valid) != len(top_d)
            or (len(valid) and not (row[: len(valid)] >= 0).all())
            or len(set(valid.tolist())) != len(valid)
            or not known.all()
        ):
            bad += 1
            continue
        if len(valid):
            got = scores[pos]
            gap = max(gap, float(np.max(np.abs(top_s - got) / top_s)))
        for i, (d, s) in enumerate(zip(valid.tolist(), scores[pos].tolist())):
            lower = docs[(scores == s) & (docs < d)]
            if not np.isin(lower, valid[:i]).all():
                ties += 1
                break
    return {"bad_rows": bad, "rank_gap": gap, "tie_rows": ties, "rows": len(rows)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit."""
    return {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
