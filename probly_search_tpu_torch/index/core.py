"""The Index — host orchestration over immutable segments.

The torch port's copy of ``probly_search_tpu/index/core.py``: the same host
state and f64 oracle, with the device routes of ``query_batch`` /
``query_batch_async`` going to the port's engines on a torch device
(``Index(..., device="cuda")``, the default, or ``device="cpu"``).

Reproduces the observable semantics of the reference `Index<T>`
(`reference src/index.rs:19-199`) and its query engine
(`reference src/query.rs:17-164`) on top of the segment SoA data model
(see segment.py).  The exact host path below is the **semantics oracle**: it
runs in pure Python/NumPy float64 and passes every reference golden test to
8 decimal places.  The device path (index/device.py + ops/) is validated against
it.

Faithfully reproduced quirks (they are observable through golden scores):

* Field stats bookkeeping: on add, ``sum`` / ``avg`` are updated once per
  field *value* with denominator ``len(docs_before_insert) + 1``
  (index.rs:112-114); multi-valued fields leave ``field_length`` equal to the
  LAST value's count (index.rs:114 overwrites, does not accumulate).
* On remove, only fields with ``field_length > 0`` get their stats updated,
  and ``avg`` becomes IEEE ``inf``/``nan`` when the last document is removed
  (index.rs:175-185; asserted by index.rs:643).
* ``document_frequency`` equals the number of live posting *pointers* in the
  reference — one per term occurrence across all fields (index.rs:119) — i.e.
  ``sum of occurrence counts over live docs``, not the deduplicated doc
  count.  BM25's df clamp (bm25.rs:41) depends on this.
* Query-term tokens are counted BEFORE empty-token filtering
  (query.rs:32-35); ``query_terms_len`` includes empties (observable through
  zero-to-one's normalization, zero_to_one.rs:119).
* Latent deletion: removed docs' postings stay in segments until ``vacuum``;
  queries filter them via the liveness mask (query.rs:65), and term expansion
  still sees their terms (query.rs:136 checks ``first_doc`` regardless of
  removal) but a term whose live df is 0 is never scored (query.rs:48).

Documented divergences (no golden test covers either; both are reference
bugs this engine chooses not to reproduce):

* Re-adding an existing key in the reference leaves stale postings pointing
  at the key while overwriting ``docs[key]`` (index.rs:118; exploited only by
  structural tests index.rs:744-775).  Here, re-adding a key first removes
  the old document (latently), then adds the new one.
* In the reference, removing a key and then re-adding it leaves the key in
  the ``removed`` set, hiding the re-added doc from queries until ``vacuum``.
  Here liveness is tracked per doc slot, so the re-added doc is visible.
* Score merging implements the canonical "max within a query term, sum
  across query terms" rule directly (per-term max accumulator, then sum).
  The reference's literal ``max_score_merger`` (query.rs:150-164) folds the
  running *total* into the per-term max — ``max(total + s_first, s_later)``
  — which makes multi-term results depend on its internal trie-insertion
  visit order.  The two rules agree on every reference golden test and on
  all single-term queries; they can differ only when a doc matches two
  expansions of one term in a multi-term query AND a later-visited expansion
  outscores the accumulated total, where the reference's own answer is
  order-dependent.  The canonical rule is order-independent, which is what
  makes the massively-parallel device merge well-defined.  WITNESS TEST:
  ``tests/test_merge_rule.py`` constructs exactly that divergent corpus,
  pins this engine's canonical answer on both the host and device paths,
  and computes the literal fold for both visit orders to demonstrate that
  the reference's own answer is order-dependent there.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..config import IndexConfig
from ..models.base import (
    DocumentDetails,
    DocumentPointer,
    FieldData,
    FieldDetails,
    QueryResult,
    ScoreCalculator,
    TermData,
)
from ..utils.tokenizers import whitespace_tokenizer
from .segment import Segment, merge_segments

import threading

FieldAccessor = Callable[[Any], Sequence[str]]
Tokenizer = Callable[[str], Sequence[str]]

# Sentinel default for query_batch's ``top_k``: distinguishes "not given"
# (-> config.default_top_k) from an explicit ``top_k=None`` (-> ALL matching
# documents, the reference's uncapped contract, query.rs:97-105).
_DEFAULT_TOP_K = object()


class Index:
    """Full-text index over generic document keys.

    Mirrors ``Index::new`` / ``new_with_capacity`` (index.rs:37-60),
    ``add_document`` (index.rs:77), ``remove_document`` (index.rs:161),
    ``vacuum`` (index.rs:194) and ``query`` (query.rs:21).

    Capacity hints: ``expected_documents_count`` pre-sizes the doc-store
    arrays (``_doc_len`` / ``_alive``).  ``expected_index_size`` — the
    reference's trie-node arena capacity (index.rs:42-60) — is accepted for
    constructor parity but is a documented no-op: segments size their CSR
    arrays exactly at build time (see config.py).
    """

    def __init__(
        self,
        fields_num: int,
        expected_index_size: int = 1000,
        expected_documents_count: int = 10000,
        config: Optional[IndexConfig] = None,
        device: Any = "cuda",
    ):
        if fields_num < 0:
            raise ValueError("fields_num must be >= 0")
        self.config = config or IndexConfig(
            expected_index_size=expected_index_size,
            expected_documents_count=expected_documents_count,
        )
        self._num_fields = fields_num
        # Torch device of the device engine (``device_index``).  Host state
        # and the oracle never touch it; a CUDA device is checked when the
        # first device snapshot is built.
        self.device = device
        self._fields: List[FieldDetails] = [FieldDetails(sum=0, avg=0.0) for _ in range(fields_num)]

        # Document store: user key <-> dense int32 slot.
        self._key_to_slot: Dict[Any, int] = {}
        self._slot_to_key: List[Any] = []
        self._docs: Dict[Any, DocumentDetails] = {}  # live docs only
        cap = max(16, self.config.expected_documents_count)
        self._doc_len = np.zeros((cap, fields_num), dtype=np.int64)
        self._alive = np.zeros(cap, dtype=bool)
        self._next_slot = 0

        # Latent-removal bookkeeping (the `removed` set, index.rs:32).
        self._removed_keys: Set[Any] = set()

        # Postings: immutable segments + a sequential WRITE BUFFER.  An add
        # only extracts field values and appends (key, values, tokenizer) —
        # tokenize/intern/count/pack and even stats + slot registration are
        # deferred to `_flush_pending`, which feeds the same native bulk
        # pipeline as `add_documents_columnar` (index/bulk._bulk_ingest).
        # Every reader flushes first, so the deferral is unobservable; the
        # reference's per-add trie insertion (index.rs:77-158) has no
        # analogue to preserve.  Append order == slot order (slots are
        # monotonic), keeping the CSR doc-ascending invariant.
        self._segments: List[Segment] = []
        self._pending: List[Tuple[Any, List[Any], Any]] = []
        self._pending_keys: Set[Any] = set()

        # Monotonic version for device-side cache invalidation.
        self._version = 0
        self._device_cache = None
        # Doc-sharded serving: the attached mesh (attach_mesh) and the
        # sharded snapshot over it (sharded_index).
        self._mesh = None
        self._sharded_cache = None

        # Host-side concurrency: a re-entrant lock guards every public
        # entry point.  The reference is single-threaded and only proves
        # Send-ness via an external Mutex (integrations_tests.rs:151-168);
        # here interleaved add/remove/query from multiple threads is safe
        # by construction (SURVEY §5 race-detection plan).  On the card,
        # threads that serve one snapshot at once (DeviceIndex,
        # ShardedDeviceIndex, on any streams) are kept apart by the
        # snapshot's locks and events (index/device.py): the plan lock
        # around its pools and caches; one lock and one CUDA event per
        # graph cache, so each window's copies into a graph's static input,
        # replay and copies out run behind the previous window's on any
        # stream, and a dropped snapshot frees nothing before its last
        # window has run; and launch counts that a capture diverts from its
        # own thread only (ops/counts.py).
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ #
    # constructors mirroring the reference                                #
    # ------------------------------------------------------------------ #

    @classmethod
    def new(cls, fields_num: int, device: Any = "cuda") -> "Index":
        return cls(fields_num, device=device)

    @classmethod
    def new_with_capacity(
        cls, fields_num: int, expected_index_size: int, expected_documents_count: int,
        device: Any = "cuda",
    ) -> "Index":
        return cls(fields_num, expected_index_size, expected_documents_count, device=device)

    # ------------------------------------------------------------------ #
    # properties / introspection                                          #
    # ------------------------------------------------------------------ #

    @property
    def num_fields(self) -> int:
        return self._num_fields

    @property
    def fields(self) -> List[FieldDetails]:
        """Per-field stats (`FieldDetails`, index.rs:389-396)."""
        self._flush_pending()
        return self._fields

    @property
    def docs(self) -> Dict[Any, DocumentDetails]:
        """Live documents by key (the `docs` map, index.rs:21)."""
        self._flush_pending()
        return self._docs

    @property
    def removed_keys(self) -> Set[Any]:
        """Keys removed but not yet vacuumed (the `removed` set, index.rs:32)."""
        return set(self._removed_keys)

    @property
    def num_segments(self) -> int:
        self._flush_pending()
        return len(self._segments)

    @property
    def version(self) -> int:
        return self._version

    def terms(self) -> List[str]:
        """All indexed terms (union across segments), sorted."""
        self._flush_pending()
        out: Set[str] = set()
        for seg in self._segments:
            out.update(seg.terms)
        return sorted(out)

    def document_frequency(self, term: str) -> int:
        """Live posting-pointer count for an exact term — the analogue of
        ``count_documents`` (index.rs:282-297): one pointer per occurrence,
        removed docs skipped."""
        self._flush_pending()
        slots, _tfs, occs = self._gather_postings(term)
        if len(slots) == 0:
            return 0
        return int(occs[self._alive[slots]].sum())

    # ------------------------------------------------------------------ #
    # mutation                                                            #
    # ------------------------------------------------------------------ #

    def add_document(
        self,
        field_accessors: Sequence[FieldAccessor],
        tokenizer: Tokenizer,
        key: Any,
        doc: Any,
    ) -> None:
        """Add a document (index.rs:77-158).

        Tokenizes each field value, filters empty tokens (index.rs:100-110),
        updates field stats with the reference's exact bookkeeping, and
        buffers the (term -> per-field tf) postings for the next segment
        flush.  Re-adding an existing key removes the old doc first
        (documented divergence, see module docstring).
        """
        if key in self._pending_keys:
            # Duplicate of a BUFFERED doc: materialize first so the remove
            # below sees it (a buffered key is not in _key_to_slot yet).
            self._flush_pending()
        if key in self._key_to_slot:
            # Re-add removes the old doc first (documented divergence: the
            # reference does NOT error — it overwrites docs[key] and leaves
            # the old postings stale, index.rs:77-158, exploited by its
            # structural test index.rs:744-755; see the module docstring and
            # tests/test_index_structure.py::test_readd_same_key_replaces_
            # document).  No flush:
            # removes are eager, and stats commute (sum is additive; avg is
            # recomputed from the final sum at the next flush, which every
            # reader triggers before observing it).
            self.remove_document(key)

        # Extract eagerly (the reference reads the doc at add time;
        # deferring the ACCESSOR call would observe later mutations), but
        # tokenize/count/pack lazily — the flush runs the native bulk
        # pipeline over the whole buffer.
        # A bare ``str`` return is ONE field value, not a char sequence
        # (lib.rs:11 is Vec<&str>; Python's str-is-Sequence[str] would
        # silently index single characters) — same rule as bulk.py cells.
        self._pending.append(
            (
                key,
                [
                    [v] if isinstance(v := a(doc), str) else list(v)
                    for a in field_accessors
                ],
                tokenizer,
            )
        )
        self._pending_keys.add(key)
        self._version += 1
        if len(self._pending) >= self.config.pending_flush_docs:
            self._flush_pending()

    def add_documents(
        self,
        field_accessors: Sequence[FieldAccessor],
        tokenizer: Tokenizer,
        items: Sequence[Tuple[Any, Any]],
    ) -> None:
        """Bulk add — batched indexing is the device engine's entry point."""
        for key, doc in items:
            self.add_document(field_accessors, tokenizer, key, doc)

    def add_documents_columnar(
        self,
        keys: Sequence[Any],
        field_texts: Sequence[Sequence[str]],
        tokenizer: Tokenizer = whitespace_tokenizer,
    ) -> None:
        """Bulk columnar ingestion — the batched build pipeline (see
        index/bulk.py).  End-state identical to sequential ``add_document``
        calls; orders of magnitude faster for large corpora."""
        from .bulk import bulk_add

        bulk_add(self, keys, field_texts, tokenizer)

    def remove_document(self, key: Any) -> None:
        """Latent removal (index.rs:161-191): flips the liveness bit and
        updates field stats; postings stay until ``vacuum``."""
        if key in self._pending_keys:
            # Only a BUFFERED key forces materialization; removing an
            # already-materialized doc is eager (stats commute — see
            # add_document) so re-add-heavy workloads never flush per doc.
            self._flush_pending()
        details = self._docs.get(key)
        if details is None:
            return
        self._removed_keys.add(key)
        new_len = len(self._docs) - 1
        for i in range(self._num_fields):
            fl = int(details.field_length[i])
            if fl > 0:
                fd = self._fields[i]
                fd.sum -= fl
                # IEEE semantics: 0/0 -> nan, x/0 -> +/-inf (matches Rust
                # f64; asserted by the reference at index.rs:643).  Plain
                # scalar math — np.errstate per remove measured ~2 us.
                if new_len:
                    fd.avg = fd.sum / new_len
                elif fd.sum:
                    fd.avg = math.copysign(math.inf, fd.sum)
                else:
                    fd.avg = math.nan
        slot = self._key_to_slot.pop(key)
        self._alive[slot] = False
        del self._docs[key]
        self._version += 1

    def vacuum(self) -> None:
        """Purge removed documents (index.rs:194-241): merge all segments
        dropping dead postings and empty terms, and compact doc slots."""
        self._flush_pending()
        F = self._num_fields
        live_slots = np.flatnonzero(self._alive[: self._next_slot])
        remap = np.full(self._next_slot, -1, dtype=np.int64)
        remap[live_slots] = np.arange(len(live_slots))

        merged = merge_segments(self._segments, F, alive=self._alive, slot_remap=remap)
        self._segments = [merged] if merged.num_postings else []

        # Compact the doc store.
        new_count = len(live_slots)
        cap = max(16, self.config.expected_documents_count, new_count)
        new_doc_len = np.zeros((cap, F), dtype=np.int64)
        if new_count:
            new_doc_len[:new_count] = self._doc_len[live_slots]
        new_alive = np.zeros(cap, dtype=bool)
        new_alive[:new_count] = True
        new_slot_to_key: List[Any] = [self._slot_to_key[s] for s in live_slots]
        self._doc_len = new_doc_len
        self._alive = new_alive
        self._slot_to_key = new_slot_to_key
        self._key_to_slot = {k: i for i, k in enumerate(new_slot_to_key)}
        self._next_slot = new_count
        self._removed_keys = set()
        self._version += 1

    # ------------------------------------------------------------------ #
    # query                                                               #
    # ------------------------------------------------------------------ #

    def query(
        self,
        query: str,
        score_calculator: ScoreCalculator,
        tokenizer: Tokenizer = whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
    ) -> List[QueryResult]:
        """Free-text disjunctive query (query.rs:21-106) — exact host path.

        Per query term: expand to all completions (query.rs:109-147); per
        expansion with live df > 0: ``before_each`` then the posting walk
        calling ``score`` per live posting; merge with the max-within-term /
        sum-across-terms rule (query.rs:150-164); ``finalize``; sort by score
        descending.  Returns ALL matching docs like the reference (tie order:
        deterministic by doc insertion order, where the reference's is
        unspecified HashMap order).
        """
        if fields_boost is None:
            fields_boost = [1.0] * self._num_fields
        self._flush_pending()

        query_terms = list(tokenizer(query))
        query_terms_len = len(query_terms)  # counted BEFORE filtering (query.rs:32)
        scores: Dict[int, float] = {}  # doc slot -> merged score
        node_ids: Dict[str, int] = {}  # expanded term -> per-query node id
        field_data = FieldData(fields_boost=fields_boost, fields=self._fields)

        for qti, qterm in enumerate(query_terms):
            if not qterm:
                continue
            # Per-term max accumulator — the "max within a query term" half of
            # the merge rule (query.rs:150-164; see module docstring).
            term_best: Dict[int, float] = {}
            for exp_term in self._expand_term_sorted(qterm):
                slots, tfs, occs = self._gather_postings(exp_term)
                if len(slots) == 0:
                    continue
                alive_mask = self._alive[slots]
                df = int(occs[alive_mask].sum())
                if df <= 0:
                    continue  # query.rs:48
                node_id = node_ids.setdefault(exp_term, len(node_ids))
                term_data = TermData(
                    query_term_index=qti,
                    query_term=qterm,
                    query_term_expanded=exp_term,
                    query_terms_len=query_terms_len,
                )
                pre = score_calculator.before_each(term_data, df, self._docs)
                for j in range(len(slots)):
                    slot = int(slots[j])
                    if alive_mask[j]:
                        key = self._slot_to_key[slot]
                        details = self._docs[key]
                        pointer = DocumentPointer(details_key=key, term_frequency=tfs[j])
                        s = score_calculator.score(
                            pre, pointer, details, node_id, field_data, term_data
                        )
                        if s is not None:
                            prev = term_best.get(slot)
                            term_best[slot] = s if prev is None else max(prev, s)
            # "Sum across query terms" — disjunction (query.rs:150-164).
            for slot, best in term_best.items():
                scores[slot] = scores.get(slot, 0.0) + best

        results = [
            QueryResult(key=self._slot_to_key[slot], score=sc) for slot, sc in scores.items()
        ]
        score_calculator.finalize(results)
        slot_order = {self._slot_to_key[slot]: slot for slot in scores}
        results.sort(key=lambda r: (-r.score, slot_order[r.key]))
        if top_k is not None:
            results = results[:top_k]
        return results

    def query_batch(
        self,
        queries: Sequence[str],
        score_calculator: Optional[ScoreCalculator] = None,
        tokenizer: Tokenizer = whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Any = _DEFAULT_TOP_K,
        backend: str = "auto",
    ) -> List[List[QueryResult]]:
        """Batched top-k query — the device engine's entry point.

        The reference answers one query at a time (`query.rs:21`); batching
        is what turns the device into a QPS machine (SURVEY §2.3).  Scorers
        implementing the device protocol (BM25) run as one window over the
        whole batch on ``self.device``; two-phase scorers (zero-to-one) run
        the z2o window engine; custom host scorers fall back to the exact
        host path per query.

        ``top_k`` contract: omitted -> ``config.default_top_k`` rows per
        query.  An explicit ``top_k=None`` returns EVERY matching document
        per query — the reference's uncapped contract (query.rs:97-105) —
        served through the host path (vectorized when the scorer provides
        it), since the device engine is top-k by construction; it is
        incompatible with ``backend="device"`` (raises ValueError).
        """
        self._flush_pending()
        if score_calculator is None:
            from ..models import bm25 as _bm25

            score_calculator = _bm25.new()
        if top_k is None:
            if backend == "device":
                raise ValueError(
                    "top_k=None (all matching documents, query.rs:97-105) is "
                    "served by the host path; the device engine is top-k by "
                    "construction — pass a finite top_k or backend='auto'"
                )
            vq = getattr(score_calculator, "vectorized_query", None)
            if vq is not None:
                return [
                    vq(self, q, tokenizer, top_k=None, fields_boost=fields_boost)
                    for q in queries
                ]
            return [
                self.query(q, score_calculator, tokenizer, fields_boost, top_k=None)
                for q in queries
            ]
        k = (top_k if top_k is not _DEFAULT_TOP_K else 0) or self.config.default_top_k
        device_capable = hasattr(score_calculator, "device_score_lanes") and not getattr(
            score_calculator, "device_needs_finalize", True
        )
        device_two_phase = getattr(score_calculator, "device_two_phase", False)
        if backend == "device" and not (device_capable or device_two_phase):
            raise ValueError(
                f"{type(score_calculator).__name__} does not implement the "
                "device scorer protocol; use backend='exact'"
            )
        if backend in ("auto", "device") and (device_capable or device_two_phase):
            # An attached mesh serves the batch through the doc-sharded
            # engine (parallel/dist_query.py): one-phase scorers through its
            # BM25 window, two-phase (zero-to-one) through its z2o window.
            if self._mesh is not None and device_capable:
                return self.sharded_index().query_batch(
                    queries, score_calculator, tokenizer, fields_boost, top_k=k
                )
            if self._mesh is not None and device_two_phase:
                return (
                    self.sharded_index()
                    .query_batch_z2o(queries, score_calculator, tokenizer, top_k=k)
                    .get()
                )
            try:
                dix = self.device_index()
            except ValueError:
                from ..utils.metrics import metrics

                # Doc slots exceed the single-device merge-key capacity.
                # With more than one CUDA device visible, shard over them
                # (the capacity scales with the shard count); otherwise
                # degrade to the exact host path.
                if device_capable and _device_count(self.device) > 1:
                    metrics.inc("auto_sharded_batches")
                    return self.sharded_index().query_batch(
                        queries, score_calculator, tokenizer, fields_boost, top_k=k
                    )
                if backend == "device":
                    raise
                metrics.inc("device_snapshot_fallbacks")
            else:
                if device_two_phase:
                    # zero-to-one: the port's z2o window engine
                    # (ops/z2o_device.py).
                    from ..ops.z2o_device import z2o_query_batch

                    return z2o_query_batch(
                        dix, queries, tokenizer, k, scorer=score_calculator
                    )
                return dix.query_batch(
                    queries, score_calculator, tokenizer, fields_boost, top_k=k
                )
        # Host fallback: vectorized execution when the scorer provides it
        # (BM25 and zero-to-one both do), else the exact per-posting path.
        vq = getattr(score_calculator, "vectorized_query", None)
        if backend == "auto" and vq is not None:
            return [
                vq(self, q, tokenizer, top_k=k, fields_boost=fields_boost)
                for q in queries
            ]
        return [
            self.query(q, score_calculator, tokenizer, fields_boost, top_k=k)
            for q in queries
        ]

    def query_batch_async(
        self,
        queries: Sequence[str],
        score_calculator: Optional[ScoreCalculator] = None,
        tokenizer: Tokenizer = whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Any = _DEFAULT_TOP_K,
    ):
        """Non-blocking :meth:`query_batch`: plan + dispatch, return a
        pending-batch handle (``.get()`` for QueryResult rows,
        ``.get_arrays()`` for the columnar serving surface).  Routes like
        ``query_batch``: two-phase scorers -> the z2o programs, one-phase
        -> the BM25-style window engine.
        Host-only scorers have no async path (raises ValueError); neither
        does ``top_k=None`` full-result retrieval (use :meth:`query_batch`,
        which serves it synchronously on host)."""
        self._flush_pending()
        if score_calculator is None:
            from ..models import bm25 as _bm25

            score_calculator = _bm25.new()
        if top_k is None:
            raise ValueError(
                "top_k=None (all matching documents) has no async device "
                "path; use query_batch, which serves it on the host"
            )
        k = (top_k if top_k is not _DEFAULT_TOP_K else 0) or self.config.default_top_k
        device_capable = hasattr(score_calculator, "device_score_lanes") and not getattr(
            score_calculator, "device_needs_finalize", True
        )
        device_two_phase = getattr(score_calculator, "device_two_phase", False)
        if self._mesh is not None and device_capable:
            return self.sharded_index().query_batch_async(
                queries, score_calculator, tokenizer, fields_boost, top_k=k
            )
        if self._mesh is not None and device_two_phase:
            return self.sharded_index().query_batch_z2o(
                queries, score_calculator, tokenizer, top_k=k
            )
        if device_two_phase:
            from ..ops.z2o_device import z2o_query_batch_async

            return z2o_query_batch_async(
                self.device_index(), queries, tokenizer, k, scorer=score_calculator
            )
        if device_capable:
            return self.device_index().query_batch_async(
                queries, score_calculator, tokenizer, fields_boost, top_k=k
            )
        raise ValueError(
            f"{type(score_calculator).__name__} does not implement a device "
            "scorer protocol; use query_batch (host execution is synchronous)"
        )

    def device_index(self):
        """Device-resident snapshot on ``self.device`` (cached until the
        index mutates or the snapshot-shaping config changes)."""
        from .device import DeviceIndex

        self._flush_pending()
        want_chunk = int(getattr(self.config, "chunk_size", 0) or DeviceIndex.CHUNK)
        if (
            self._device_cache is None
            or self._device_cache.version != self._version
            or self._device_cache.CHUNK != want_chunk
        ):
            self._device_cache = DeviceIndex(self, device=self.device)
        return self._device_cache

    def attach_mesh(self, mesh) -> None:
        """Serve ``query_batch`` / ``query_batch_async`` through the
        doc-sharded engine over ``mesh`` (``parallel.make_mesh``; several
        cells may name one device, e.g. ``devices=["cuda:0"] * 4``).  Pass
        ``None`` to detach and return to single-device serving."""
        with self._lock:
            self._mesh = mesh
            self._sharded_cache = None

    def sharded_index(self, mesh=None):
        """Doc-sharded device snapshot over the attached (or given) mesh,
        cached until the index mutates or the snapshot-shaping config
        changes: the sharded mirror of :meth:`device_index`.  With no mesh
        attached, builds ``make_mesh(data=1)`` over every visible CUDA
        device and remembers it."""
        from ..parallel.dist_query import ShardedDeviceIndex
        from ..parallel.mesh import make_mesh

        if mesh is None:
            mesh = self._mesh
        if mesh is None:
            mesh = self._mesh = make_mesh(data=1)
        self._flush_pending()
        want_chunk = int(getattr(self.config, "chunk_size", 0) or ShardedDeviceIndex.CHUNK)
        c = self._sharded_cache
        if c is None or c.version != self._version or c.CHUNK != want_chunk or c.mesh is not mesh:
            self._sharded_cache = ShardedDeviceIndex(self, mesh)
        return self._sharded_cache

    def expand_term(self, term: str) -> List[str]:
        """All completions of ``term`` that carry at least one posting
        (including postings of removed-but-unvacuumed docs), mirroring
        ``expand_term`` (query.rs:109-147).  Returned in lexicographic order
        (the reference returns reverse-insertion trie order; only membership
        is part of the contract)."""
        self._flush_pending()
        return self._expand_term_sorted(term)

    # ------------------------------------------------------------------ #
    # internals                                                           #
    # ------------------------------------------------------------------ #

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        from .bulk import _bulk_ingest

        pending = self._pending
        self._pending = []
        self._pending_keys = set()

        F = self._num_fields
        # Group consecutive rows by tokenizer identity (a per-call argument,
        # lib.rs:14); each group is one bulk ingest — slot order is preserved
        # because groups are consecutive and slots are monotonic.  Cells
        # with exactly one string value pass as plain str so the group hits
        # the native tokenize path; multi/empty-value cells pass as lists
        # (the bulk multi-value machinery reproduces the per-value
        # bookkeeping, index.rs:112-114).
        i, n = 0, len(pending)
        while i < n:
            tok = pending[i][2]
            j = i + 1
            while j < n and pending[j][2] is tok:
                j += 1
            group = pending[i:j]
            keys = [row[0] for row in group]
            cols = [
                [
                    vals[f][0]
                    if len(vals[f]) == 1 and type(vals[f][0]) is str
                    else vals[f]
                    for _, vals, _ in group
                ]
                for f in range(F)
            ]
            _bulk_ingest(self, keys, cols, tok, is_last=None)
            i = j
        if len(self._segments) > self.config.max_segments:
            # Routine merge: keep latently-deleted postings (only vacuum drops).
            merged = merge_segments(self._segments, self._num_fields)
            self._segments = [merged] if merged.num_postings else []

    def _expand_term_sorted(self, term: str) -> List[str]:
        out: Set[str] = set()
        for seg in self._segments:
            lo, hi = seg.prefix_range(term)
            if hi > lo:
                out.update(seg.terms[lo:hi])
        return sorted(out)

    def _gather_postings(self, term: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Concatenated postings for an exact term across segments, sorted by
        doc slot.  Each (term, slot) pair is unique across segments because a
        document's postings land in exactly one segment."""
        parts = []
        for seg in self._segments:
            tid = seg.find_term(term)
            if tid >= 0:
                parts.append(seg.postings(tid))
        if not parts:
            return (
                np.zeros(0, dtype=np.int32),
                np.zeros((0, self._num_fields), dtype=np.int32),
                np.zeros(0, dtype=np.int32),
            )
        if len(parts) == 1:
            slots, tfs, occs = parts[0]
        else:
            slots = np.concatenate([p[0] for p in parts])
            tfs = np.concatenate([p[1] for p in parts])
            occs = np.concatenate([p[2] for p in parts])
        order = np.argsort(slots, kind="stable")
        return slots[order], tfs[order], occs[order]


def _device_count(device) -> int:
    """CUDA devices visible when ``device`` is a CUDA device, else 1."""
    import torch

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


def _locked(method):
    """Serialize a public entry point on the per-index re-entrant lock."""
    import functools

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)

    return wrapper


for _name in (
    "add_document",
    "add_documents",
    "add_documents_columnar",
    "remove_document",
    "vacuum",
    "query",
    "query_batch",
    "query_batch_async",
    "device_index",
    "sharded_index",
    "expand_term",
    "terms",
    "document_frequency",
    "_flush_pending",
):
    setattr(Index, _name, _locked(getattr(Index, _name)))
del _name
