"""Scorer plugin protocol (the torch port's copy of
``probly_search_tpu/models/base.py``).

Reproduces the reference's ``ScoreCalculator<T, M>`` trait
(`reference src/score/calculator.rs:33-70`) with its three phases:

* ``before_each`` — called once per (query term x expansion) *before* the
  posting walk; receives the expansion's document frequency and a view of all
  live documents; may return an arbitrary precomputation object ``M``
  (calculator.rs:43-50; default returns ``None``).
* ``score`` — called once per live posting; returns ``float`` or ``None``
  (``None`` means "do not enter the result map", calculator.rs:58-66).
* ``finalize`` — called once per query with the mutable result list
  (calculator.rs:69; default no-op).

Context structs mirror ``TermData`` (calculator.rs:9-19) and ``FieldData``
(calculator.rs:21-26).

A scorer may additionally implement the **device protocol**
(:class:`DeviceScorer`) to run vectorized on a device; the built-in BM25
does.
Scorers that only implement the host protocol still work through the exact
host path — user-pluggable scoring is a headline reference feature
(`README.md:19`) and remains first-class here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@dataclass(frozen=True)
class TermData:
    """Per-(query term, expansion) context (calculator.rs:9-19)."""

    query_term_index: int  # position of the query term in the query
    query_term: str  # the raw query term
    query_term_expanded: str  # the expansion currently being scored
    query_terms_len: int  # total tokens in the query (INCLUDING empties,
    # matching query.rs:32 which measures before filtering)


@dataclass(frozen=True)
class FieldData:
    """Per-query field context (calculator.rs:21-26)."""

    fields_boost: Sequence[float]  # per-field boost from the query arguments
    fields: Sequence["FieldDetails"]  # per-field stats (sum / avg)


# Re-declared here to avoid a circular import; the canonical definitions are
# re-exported from probly_search_tpu_torch.index.core.
@dataclass
class FieldDetails:
    """Per-field statistics (`index.rs:389-396`)."""

    sum: int = 0
    avg: float = 0.0


@dataclass(frozen=True, slots=True)
class DocumentDetails:
    """Per-document info (`index.rs:341-349`).

    ``slots=True``: the bulk build creates one of these per document — slot
    instances construct ~2x faster and halve the per-doc memory."""

    key: Any
    field_length: np.ndarray  # int64[num_fields] — number of terms per field


@dataclass(frozen=True)
class DocumentPointer:
    """One posting: (document, per-field term frequency) (`index.rs:352-361`)."""

    details_key: Any
    term_frequency: np.ndarray  # int64[num_fields]


@dataclass
class QueryResult:
    """Query result (`query.rs:10-15`)."""

    key: Any
    score: float

    def __iter__(self):  # allow tuple-unpacking: key, score = result
        yield self.key
        yield self.score

    def __eq__(self, other):
        if isinstance(other, QueryResult):
            return self.key == other.key and self.score == other.score
        if isinstance(other, tuple) and len(other) == 2:
            return (self.key, self.score) == other
        return NotImplemented


@runtime_checkable
class ScoreCalculator(Protocol):
    """Host scorer protocol — the `ScoreCalculator` trait (calculator.rs:33)."""

    def before_each(
        self,
        term_expansion: TermData,
        document_frequency: int,
        documents: Mapping[Any, DocumentDetails],
    ) -> Optional[Any]:
        return None

    def score(
        self,
        before_output: Optional[Any],
        document_pointer: DocumentPointer,
        document_details: DocumentDetails,
        index_node: int,
        field_data: FieldData,
        term_expansion: TermData,
    ) -> Optional[float]:
        ...

    def finalize(self, scores: List[QueryResult]) -> None:
        pass


class BaseScoreCalculator:
    """Convenience base class providing the trait's default methods."""

    def before_each(self, term_expansion, document_frequency, documents):
        return None

    def score(
        self, before_output, document_pointer, document_details,
        index_node, field_data, term_expansion,
    ):
        raise NotImplementedError

    def finalize(self, scores):
        pass


@runtime_checkable
class DeviceScorer(Protocol):
    """Optional vectorized device protocol for device execution.

    ``device_term_scale`` is the vectorized analogue of ``before_each``
    (calculator.rs:43-50): a host-side per-(query term x expansion)
    precompute, evaluated over the whole planned job table at once.  Its
    result is shipped to the device as one f32 scale per job.  This is
    possible because everything ``before_each`` sees — document frequency
    and the live-document count — is static per device snapshot (liveness
    is baked in at snapshot build; any mutation rebuilds the snapshot).

    ``device_score_lanes`` evaluates the per-posting score for a whole padded
    lane tile at once in torch; it is the vectorized analogue of
    ``score``.  Scorers with a non-trivial ``finalize`` additionally set
    ``device_needs_finalize`` and the engine falls back to gathering tuples.
    """

    device_needs_finalize: bool

    def device_term_scale(
        self, df: np.ndarray, n_docs: float, expansion_boost: np.ndarray
    ) -> np.ndarray:
        ...

    def device_score_lanes(self, lanes: "ScoreLanes") -> Any:
        ...
