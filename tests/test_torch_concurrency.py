"""Several threads serving from one engine of the port, on the CPU.

The port keeps state across windows that the JAX engine lacks: graph
caches with static inputs and outputs (``ClassGraphs``, ``WindowGraph``),
launch counters that a capture diverts, and, on the card, ordering on each
caller's stream.  Here, with Python's switch interval shortened so that the
threads interleave finely:

- the port's counterparts of ``tests/test_thread_safety.py``: writers and
  readers on one ``Index``, and four threads growing one ``DeviceIndex``'s
  plan pools, their rows held to the JAX engine's ``DeviceIndex`` run
  serially on the same documents (``probly_search_tpu_torch.testing``'s
  rule);
- four threads submitting and draining windows on one ``DeviceIndex``
  through the class-graph path (``tests/torch_util.EagerClasses``: the
  cache's lock and ordering run on the CPU), and two threads on a CPU mesh
  (1, 2), rows bit-equal to the same windows served one after another;
- a capture's launch accounting (``index.device._uncounted``): a capture
  that waits while another thread counts launches takes only its own
  counts into its delta, and the other thread's counts stay.

The card's half (own streams, concurrent captures, a snapshot dropped with
a window in flight) is ``tests/test_torch_cuda.py -k concurrent``.
"""

import os
import random
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from probly_search_tpu import Index as JIndex
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu.index import snapshot as jsnap
from probly_search_tpu.index.device import DeviceIndex as JDeviceIndex
from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, ShardedDeviceIndex, bm25
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.index import snapshot as psnap
from probly_search_tpu_torch.ops import fused_merge as fm
from probly_search_tpu_torch.ops import fused_query as fq
from probly_search_tpu_torch.testing import assert_topk_agree

from .test_torch_sharding import cpu_mesh
from .torch_util import EagerClasses
from .util import Doc, title_extract, tokenizer

TOK = pdev.whitespace_tokenizer
JOIN_S = 60


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops on the CPU: where several test workers share the
    cores, OpenMP's spinning threads slow them by an order of magnitude, so
    this module runs torch on one thread (as test_torch_sharding.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fine_switching():
    """Switch threads every 10 µs, so that their steps interleave."""
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(was)


def _run(targets):
    """Run each callable on a thread of its own; re-raise the first error."""
    errors = []

    def guard(fn):
        try:
            fn()
        except BaseException as e:  # reported below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(fn,)) for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    if errors:
        raise errors[0]


def _jax_rows(jix, queries, k):
    """The JAX engine's rows of ``queries``, one window, serially."""
    s, d, _keys = JDeviceIndex(jix).query_batch_async(queries, jbm25.new(), TOK, top_k=k).get_arrays()
    return np.asarray(s), np.asarray(d)


def test_concurrent_mutation_and_query():
    """Four writers (adds, removes, vacuums) and two readers (host queries
    and device windows on the snapshots they take) on one port ``Index``;
    afterwards every live key answers, and the final index's device rows
    equal the JAX engine's on the same state (carried across by a
    snapshot)."""
    ix = Index(1, device="cpu")
    stop = threading.Event()
    queries = ["shared w1", "w2 w3", "shared", "t0 w4 w5"]

    def writer(tid):
        rng = random.Random(tid)
        for i in range(60):
            key = tid * 1000 + i
            ix.add_document([title_extract], tokenizer, key,
                            Doc(id=key, title=f"w{rng.randint(0, 30)} shared t{tid}"))
            if i % 7 == 0:
                ix.remove_document(key)
            if i % 25 == 24:
                ix.vacuum()

    def reader():
        while not stop.is_set():
            ix.query("shared w1", bm25.new(), tokenizer, [1.0])
            if len(ix.docs):
                ix.query_batch_async(queries, bm25.new(), tokenizer, top_k=5).get_arrays()

    writers = [lambda t=t: writer(t) for t in range(4)]

    def stop_after_writers():
        _run(writers)
        stop.set()

    _run([stop_after_writers, reader, reader])
    r = ix.query("shared", bm25.new(), tokenizer, [1.0])
    assert len(r) == len(ix.docs) == 4 * (60 - 9)
    got = ix.query_batch_async(queries, bm25.new(), tokenizer, top_k=5).get_arrays()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ix.npz")
        psnap.save(ix, path)
        jix = jsnap.load(path)
    assert_topk_agree(got[0], got[1], *_jax_rows(jix, queries, 5))


def _pool_corpus():
    rng = random.Random(3)
    vocab = ["t%04d" % i for i in range(400)]
    texts = [" ".join(rng.choice(vocab) for _ in range(8)) for _ in range(600)]
    batches = [["%s %s" % (vocab[i], vocab[i + 200]) for i in range(t * 40, t * 40 + 40)]
               for t in range(4)]
    return texts, batches


def test_device_index_concurrent_plan_pool_growth():
    """Four threads call ``query_batch_async`` on one port ``DeviceIndex``
    with disjoint novel terms, so every thread grows the plan pools under
    the plan lock; each thread's rows equal the JAX engine's serial rows of
    the same queries."""
    texts, batches = _pool_corpus()
    ix = Index(1, device="cpu")
    ix.add_documents_columnar(list(range(600)), [texts])
    dix = ix.device_index()
    out = {}

    def worker(t):
        out[t] = dix.query_batch_async(batches[t], bm25.new(), top_k=5).get_arrays()

    _run([lambda t=t: worker(t) for t in range(4)])
    jix = JIndex(1)
    jix.add_documents_columnar(list(range(600)), [texts])
    js, jd = _jax_rows(jix, [q for b in batches for q in b], 5)
    for t in range(4):
        rows = slice(40 * t, 40 * t + 40)
        assert_topk_agree(out[t][0], out[t][1], js[rows], jd[rows])


def _graph_corpus():
    """Two fields at chunk 128 with ranges from 4 expansions (K1-shaped,
    wide and range classes) and four windows of distinct compositions."""
    rng = random.Random(12)
    vocab = ["aa" + "".join(rng.choice("bcde") for _ in range(j % 3 + 1)) for j in range(20)]
    vocab += ["".join(rng.choice("fghij") for _ in range(rng.randint(2, 4))) for _ in range(40)]
    n = 3000
    ix = Index(2, device="cpu", config=IndexConfig(chunk_size=128, range_min_expansions=4,
                                                   result_format="f32"))
    ix.add_documents_columnar(list(range(n)), [
        [("common " if i % 10 else "") + " ".join(rng.sample(vocab, 3)) for i in range(n)],
        [" ".join(rng.sample(vocab, 2)) for _ in range(n)],
    ])
    ix.remove_document(17)
    windows = [[" ".join(rng.sample(vocab, rng.randint(1, 3))) for _ in range(40)] + extra
               for extra in (["common"], ["aa"], ["common aab"], [""])]
    return ix, windows


def test_threads_on_class_graphs_match_serial():
    """Four threads each submit and drain two windows on one CPU
    ``DeviceIndex`` through the class-graph path: the first sights of the
    keys race, and each window's rows are bit-equal to the same window
    served serially; every window ran its classes through the cache."""
    ix, windows = _graph_corpus()
    serial = DeviceIndex(ix, device="cpu")
    want = [serial.query_batch_async(w, bm25.new(), top_k=10).get_arrays()[:2] for w in windows]
    dix = DeviceIndex(ix, device="cpu")
    dix._class_graphs = EagerClasses("cpu")
    got = {}

    def worker(t):
        for j in range(2):
            wi = (t + j) % len(windows)
            got[t, j] = wi, dix.query_batch_async(windows[wi], bm25.new(), top_k=10).get_arrays()

    _run([lambda t=t: worker(t) for t in range(4)])
    for (wi, arrays) in got.values():
        for a, b in zip(arrays, want[wi]):
            np.testing.assert_array_equal(a, b)
    assert len(dix._class_graphs.windows) == 8
    assert any(key.use_ranges for key in dix._class_graphs.keys())


def test_threads_on_a_cpu_mesh_match_serial():
    """Two threads serve windows on one ``ShardedDeviceIndex`` over a CPU
    mesh (1, 2), through its class-graph path, rows equal to the same
    windows served serially."""
    ix, windows = _graph_corpus()
    mesh = cpu_mesh(1, 2)
    want = [ShardedDeviceIndex(ix, mesh).query_batch_async(w, bm25.new(), top_k=10)
            .get_arrays()[:2] for w in windows[:2]]
    sdix = ShardedDeviceIndex(ix, mesh)
    sdix._class_graphs = {torch.device("cpu"): EagerClasses("cpu")}
    got = {}

    def worker(t):
        for j in range(2):
            wi = (t + j) % 2
            got[t, j] = wi, sdix.query_batch_async(windows[wi], bm25.new(), top_k=10).get_arrays()

    _run([lambda t=t: worker(t) for t in range(2)])
    for (wi, arrays) in got.values():
        for a, b in zip(arrays, want[wi]):
            np.testing.assert_array_equal(a, b)
    assert len(sdix._class_graphs[torch.device("cpu")].windows) == 4


def test_capture_counts_only_its_own_thread():
    """``_uncounted`` runs a stand-in capture that records one K1 launch,
    then waits while another thread counts three K1 and three K5 launches
    (as replays do): the other thread's counts stay in the counters, and
    the capture's delta holds its own launch only.  The capture and the
    other thread count through ``_recount``, as the graphs' replays do."""
    saved = [dict(c) for c in pdev._launch_counters()]
    started, release = threading.Event(), threading.Event()
    other = [(fq.launches, "full", 1), (fm.launches, "merge_topk", 1)]

    def capture():
        pdev._recount([(fq.launches, "full", 1)])
        started.set()
        assert release.wait(JOIN_S)
        return "out"

    def count():
        assert started.wait(JOIN_S)
        for _ in range(3):
            pdev._recount(other)
        release.set()

    try:
        before = (fq.launches["full"], fm.launches["merge_topk"])
        result = {}
        _run([lambda: result.update(zip(("out", "delta"), pdev._uncounted(capture))), count])
        assert (fq.launches["full"], fm.launches["merge_topk"]) == (before[0] + 3, before[1] + 3)
        assert result["out"] == "out"
        assert [(c is fq.launches, key, n) for c, key, n in result["delta"]] == [(True, "full", 1)]
    finally:
        for c, was in zip(pdev._launch_counters(), saved):
            c.clear()
            c.update(was)
