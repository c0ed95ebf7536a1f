"""Configuration knobs (the torch port's copy of ``probly_search_tpu/config.py``).

The reference has no config system — all configuration is constructor
arguments (`reference src/index.rs:37-60`) and scorer struct fields
(`bm25.rs:14-26`).  This dataclass mirrors exactly those knobs and adds the
device-engine ones (tile sizes, bucketing, dtype policy, mesh layout).  The
names, defaults and behaviour equal the JAX package's, so one configuration
means the same on both engines.  The comments state no measurement: the
port's times on an NVIDIA H100 are in PERF.md, each beside the script that
took it.
"""

from __future__ import annotations

from dataclasses import dataclass


class HostFallbackError(RuntimeError):
    """Raised when ``IndexConfig.host_fallback = "error"`` and a device-path
    query would degrade to host-speed serving (see ``host_fallback``)."""


@dataclass
class IndexConfig:
    # --- reference-mirrored knobs -----------------------------------------
    # `Index::new_with_capacity(fields_num, expected_index_size,
    #  expected_documents_count)` — index.rs:42-60 (defaults at index.rs:38).
    # ``expected_documents_count`` pre-sizes the doc-store arrays
    # (index/core.py).  ``expected_index_size`` (the reference's trie-node
    # arena capacity hint, index.rs:42-60) is accepted for constructor
    # parity but is a documented NO-OP here: the trie was replaced by
    # sorted-term CSR segments whose arrays are sized exactly at build time,
    # so there is no arena to pre-size.
    expected_index_size: int = 1000
    expected_documents_count: int = 10000

    # --- delta-segment / LSM policy ---------------------------------------
    # Pending host-side adds are flushed into an immutable delta segment when
    # a query arrives or when the pending buffer exceeds this many documents.
    # The buffer holds raw (key, field values) tuples — flush work is O(batch)
    # through the native CSR pass, so a large window costs only references;
    # small windows cost extra segments and routine merges.
    pending_flush_docs: int = 65536
    # When the number of delta segments exceeds this, they are merged into
    # the base segment (amortized compaction; `vacuum()` always fully merges).
    max_segments: int = 8

    # --- device knobs ------------------------------------------------------
    # Max expansions per query term admitted to the device job path.
    # 0 = uncapped (the default, matching the reference's uncapped trie
    # DFS): expansion-heavy queries (single-char prefixes) tile through the
    # device job machinery like any other query.  A positive value routes
    # over-cap queries to the scorer's vectorized host path instead.
    max_expansions: int = 0
    # Max query terms per query on the device path.
    max_query_terms: int = 16
    # Expansion count at which a query term switches from per-expansion
    # jobs to TERM-RANGE jobs: one job covering the term's whole contiguous
    # expansion range in the CSR, with idf/term-length read per posting
    # from the static aux record array (index/device.py).  Kills the
    # one-chunk-per-tiny-term padding that would otherwise make single-char
    # prefix queries explode.  0 disables range jobs.
    range_min_expansions: int = 64
    # NOTE on dtype policy (there is deliberately NO dtype knob): device
    # scoring/merging is fixed f32 and the host oracle path is fixed f64.
    # The parity contract (device within 2e-5 relative of the f64 oracle
    # with equal rankings) is part of the public surface and leaves no room
    # for a lower compute precision; bf16 lanes would also not cut memory
    # traffic (the gathered posting record is int32 regardless).
    # Default top-k for the device query path.
    default_top_k: int = 10
    # Posting-chunk width of the device gather (lanes per chunk; a job's
    # first chunk starts at its 128-aligned base).  0 = engine default.
    chunk_size: int = 0
    # Compact device->host result format: the packed window result becomes
    # int16[rows, 3, k] (f16 score bits, slot lo16, slot hi16) — 25% fewer
    # bytes in the window's device-to-host copy.
    # Rankings are computed on device in f32 and unchanged; only the
    # REPORTED scores are f16-quantized (~5e-4 relative), so this is
    # opt-in and off by default to keep the f32 parity surface.
    compact_results: bool = False
    # Device->host result format for the packed window result; overrides
    # compact_results when set:
    #   "f32"     int32[rows, 2, k] — f32 score bits + int32 slots (80 B per
    #             query at k=10; the default, full parity surface)
    #   "compact" int16[rows, 3, k] — f16 score bits + slot lo/hi (60 B)
    #   "slots"   int8[rows, 3, k]  — slot bytes only, NO scores (30 B).
    #             Rankings are still computed on device in f32; only the
    #             score REPORT is dropped, so `get_arrays` returns
    #             scores=None and `.get()` (which builds QueryResult
    #             objects) is unavailable.  Requires doc slots < 2^23.
    #   "slots20" int8[rows, 2k+ceil(k/2)] — 20-bit nibble-packed slots
    #             (25 B at k=10, the entropy floor for top-10 of 1M docs);
    #             same slots-only contract.  Requires doc slots < 2^20;
    #             windows that do not fit auto-downgrade to "slots" /
    #             "compact" (index/device.py resolve_result_format).
    # Fewer bytes per query make the window's device-to-host copy smaller.
    result_format: str = ""

    def effective_result_format(self) -> str:
        if self.result_format:
            return self.result_format
        return "compact" if self.compact_results else "f32"
    # Block-max safe top-k pruning (index/prune.py), honoured by the port's
    # DeviceIndex: plan-time removal of posting chunks that provably cannot
    # reach the requested top-k — per-chunk score upper bounds vs an
    # achievable k-th-best threshold, the production-engine WAND/block-max
    # machinery adapted to this engine's chunked execution model; the job
    # tables equal the JAX engine's bit for bit.  EXACT: surviving top-k
    # rows are bit-equal to the unpruned window (tests/test_torch_prune.py
    # asserts it); pruning auto-disables wherever safety cannot be proven
    # (k > prune_max_top_k, negative boosts, term-range queries, scorers
    # without device_impact, non-finite field averages).  Wins are on
    # single-term queries; uniform multi-term disjunctions (the bench mix)
    # prune ~nothing — the known weak spot of WAND-family bounds (see the
    # prune.py module docstring).  Read when a DeviceIndex is built (its
    # snapshot keeps the bounds' host copies only if set) and on every
    # window.
    prune_blocks: bool = True
    # Relative safety margin baked into the static bounds (inflates chunk
    # upper bounds, deflates thresholds).  Must dominate the device's f32
    # drift vs the f64 oracle (the parity bar, 2e-5 relative).
    prune_margin: float = 1e-4
    # Top-K ladder depth stored per job; requests with top_k above this
    # are never pruned.
    prune_max_top_k: int = 16
    # Heavy-query result cache: a query whose device plan spans at least
    # this many posting chunks (~0.9M postings at the default chunk width)
    # is served from a snapshot-static per-(scorer, job-table, boosts)
    # top-k cache — the first encounter computes it once through the normal
    # device path (a full-index prefix scan is one of the costliest windows
    # the device runs); every repeat is a host lookup.  Exact: the job table IS the query's
    # device program input, so equal tables give equal results.  0 disables.
    heavy_cache_min_chunks: int = 1024
    # Top-k depth stored per cached heavy query (requests with larger k
    # bypass the cache).
    heavy_cache_top_k: int = 128
    # LIGHT-CLASS chunk width (default off): queries whose bucketed lane
    # count would strictly shrink are classed at this smaller chunk width
    # instead of the global one (index/device.py _light_classes), cutting
    # the in-chunk tail padding of queries of rare terms at the price of
    # more shape classes a window.  Results are EXACT at any valid width
    # (a power of two, a multiple of 128, below the global width: chunks
    # stay ascending doc-sorted runs); tests/test_torch_dispatch_modes.py
    # pins bit-equality on the composed, template and per-class paths.
    # Off by default, as in the JAX engine; the port's light-on against
    # light-off times on an H100 are in PERF.md (chip_smoke.py phase 3l).
    # An invalid width turns light classes off.  0 disables.
    light_chunk_size: int = 0
    # Fine (non-pow2) chunk-count buckets for the fused shape classes:
    # adds NC in {2, 3, 6, 12, 24} to the pow2 ladder, so e.g. the dominant
    # 3-single-chunk-term query class stops padding 33% of its gather,
    # merge network, and top-k work up to NC=4.  The odd-even merge runs on
    # a virtual pow2 lane space with a phantom +inf tail — exact, same
    # comparator network restricted to the real lanes (ops/pallas_merge).
    fine_nc_buckets: bool = True
    # Split each shape class's query rows into greedy power-of-two
    # sub-dispatches (2048+512+pad(78) instead of one pow2 pad to 4096)
    # inside the same window step, so that a partly filled class does not
    # pad its rows up to the next power of two.  Sub-dispatch shapes stay
    # inside the same pow2 ladder, so no new kernel shapes — only new window
    # compositions.
    pow2_row_split: bool = True
    # Run all shape classes of a query window as one step with one packed
    # input buffer and one packed result copy (one H2D and one D2H copy a
    # window).  False: per-dispatch windows — one step per dispatch of
    # pack_dispatches, each part's f32 scores and slots drained apart (the
    # JAX engine's one program per dispatch).  See index/device.py
    # ``_window_step`` and ``_dispatch_parts``.
    single_dispatch_windows: bool = True
    # Dispatch each shape class as its own step plus one pack step (the JAX
    # engine compiles a program per class shape, shared across window
    # compositions), instead of composing the whole window.  The port
    # compiles nothing per window, so this mode runs the composed window's
    # step (same kernels, rows, single packed H2D buffer and single packed
    # D2H drain) and differs from it only in taking no template, so no CUDA
    # graph.  Takes precedence over single_dispatch_windows when set.
    per_class_dispatch: bool = False
    # Freeze the window's shape-class composition into a reusable TEMPLATE
    # the first time a (scorer, k, fmt, window size) stream is seen: each
    # non-range class gets a fixed row capacity (first window's count x
    # template_headroom, ceil-8) and later windows reuse the same layout —
    # queries that overflow a class's capacity spill into the next larger
    # class of their chunk width (their extra chunk slots are dead padding:
    # zero jobs), and only a window that overflows the whole template
    # re-freezes it.  A fixed layout is what lets prewarm capture the
    # window step as one CUDA graph (index/device.py WindowGraph), and it
    # merges each class's pow2 row-split spans into one exact-height
    # dispatch.  Windows containing term-range jobs, and the per-class and
    # per-dispatch modes, keep the per-composition path.  Slots are
    # bit-equal to the composed window.
    template_compositions: bool = True
    # Row-capacity headroom factor when freezing a composition template.
    template_headroom: float = 1.15
    # --- serving-loop shape ------------------------------------------------
    # Sub-window size for the BLOCKING convenience path
    # (DeviceIndex.query_batch): batches larger than this are split into
    # serving_window-sized windows submitted as a pipeline of depth
    # serving_depth (plan/pack of window i+1 overlaps device compute of
    # window i; results are identical — queries are independent).  0 =
    # never split.  The async path (query_batch_async) is untouched:
    # latency-sensitive servers own their window size and drain cadence;
    # the `low_latency()` preset picks smaller windows.
    serving_window: int = 0
    serving_depth: int = 4

    @classmethod
    def low_latency(cls, **kw) -> "IndexConfig":
        """Preset for latency-sensitive serving: 2,048-query windows at
        pipeline depth 4 (the JAX engine's preset), trading throughput for
        a shorter wait per window.  Deeper pipelines raise throughput and
        latency; depth 1 is the fully synchronous floor.  Its windows from
        several threads on an H100 are measured in ``chip_smoke.py`` phase
        3t (``PERF.md``).
        """
        kw.setdefault("serving_window", 2048)
        kw.setdefault("serving_depth", 4)
        return cls(**kw)

    # Policy when a device-path query degrades to HOST-speed serving
    # (cap-exceeding plans; z2o queries past the class lane budget, and
    # shared-node ones of more than 8 fields or, on the CPU, past
    # CPU_LOCKSTEP_LANES).  Host fallbacks are exact but slow: an
    # adversarial mix of them (duplicate-term hot-prefix queries,
    # benchmarks/z2o_adversarial.py) serves orders of magnitude below a
    # normal window.
    #   "allow"  serve them silently (the default; matches the reference,
    #            which has no device path and no caps)
    #   "warn"   serve them and emit a RuntimeWarning with the count
    #   "error"  raise probly_search_tpu_torch.HostFallbackError instead —
    #            for servers that would rather shed an adversarial query
    #            than absorb a host walk on the serving path
    host_fallback: str = "allow"

    # Start the device-to-host copy of the packed window result at submit
    # time, into pinned memory behind the window's kernels and one CUDA
    # event (index/device.py _start_fetch), so it streams while the device
    # computes later windows and the drain waits on that event only.  No
    # effect on results.  Drain one window LATE (read window i after
    # submitting i+2) so that the copy has finished before the read.
    prefetch_results: bool = True
