"""The torch port's zero-to-one path against the JAX engine's, on the CPU.

Each corpus is built twice from the same documents, as a JAX Index and as
the port's.  Integer work must match bit for bit: the planner's tables
(words, qlen, nchunks, njobs, fallback, shared), the score ranks and class
packing of a window, and the chunk tables the fast program expands.  The
programs' results agree within ``rtol=2e-5, atol=1e-6``
(``probly_search_tpu_torch.testing``; sums are taken in another order), the
lockstep program's accepted lanes exactly.  End to end, the port's
``Index.query_batch`` on ``device="cpu"`` is held against the JAX
``Index.query_batch(backend="device")`` with the Pallas kernel in interpret
mode, and against the f64 oracle.  On the CPU no launch counter moves.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probly_search_tpu.index.device as jdev
import probly_search_tpu.ops.pallas_z2o as jpz
import probly_search_tpu.ops.z2o_device as jz
from probly_search_tpu import Index as JIndex
from probly_search_tpu import IndexConfig as JConfig
from probly_search_tpu import zero_to_one as jz2o
import probly_search_tpu_torch as pt
from probly_search_tpu_torch.ops import fused_z2o as fz
from probly_search_tpu_torch.ops import z2o_device as pz
from probly_search_tpu_torch.testing import assert_topk_agree

from .util import Doc, text_extract, title_extract, tokenizer

K = 10


def _pair(docs, F=1, **cfg):
    """(JAX Index, port Index) of the same documents; ``docs`` holds
    (key, title, text) rows, or (key, title) with one field."""
    j = JIndex(F, config=JConfig(**cfg))
    p = pt.Index(F, config=pt.IndexConfig(**cfg), device="cpu")
    accs = [title_extract, text_extract][:F]
    for key, *fields in docs:
        d = Doc(key, *fields)
        for ix in (j, p):
            ix.add_document(accs, tokenizer, key, d)
    return j, p


def _titles(titles):
    return [(i, t) for i, t in enumerate(titles)]


def _random(seed, n, F, letters, nvocab, maxlen=7):
    rng = random.Random(seed)
    vocab = ["".join(rng.choice(letters) for _ in range(rng.randint(1, 4))) for _ in range(nvocab)]
    text = lambda: " ".join(rng.choice(vocab) for _ in range(rng.randint(1, maxlen)))  # noqa: E731
    docs = [(i, text(), text()) if F == 2 else (i, text()) for i in range(n)]
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(12)]
    for _ in range(4):
        t = rng.choice(vocab)
        queries += [f"{t} {t}", f"{t[:1]} {t}"]  # shared nodes: duplicates, overlapping prefixes
    queries += [rng.choice(vocab)[:1], "", "zzzz", "abc  abd", " ".join(vocab[:17])]
    return docs, queries


# The corpora of tests/test_z2o_device.py, and two random ones.
CORPORA = {
    "golden": (_titles(["abc", "abcefg", "abcefghij"]), 1,
               ["abc", "abcefg", "abcefghij", "abc abcefg", "a ab abc"]),
    "repeated": (_titles(["abc abc", "abc"]), 1, ["abc abc", "abc abc abc", "abc"]),
    "df_pool": (_titles(["a a a", "a"]), 1, ["a a", "a a a a", "a"]),
    "shared_nodes": (_titles(["abc def", "abcx", "ab"]), 1, ["abc def", "abc abc", "ab abc", "def"]),
    "multi_field": ([(0, "abc def", "xyz"), (1, "xyz", "abc def ghi"), (2, "abc", "abc")], 2,
                    ["abc", "abc def", "xyz abc", "ghi"]),
    "random1": (*_random(11, 150, 1, "abcde", 60)[:1], 1, _random(11, 150, 1, "abcde", 60)[1]),
    "random2": (*_random(3, 120, 2, "abcd", 30)[:1], 2, _random(3, 120, 2, "abcd", 30)[1]),
}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpus(request):
    docs, F, queries = CORPORA[request.param]
    j, p = _pair(docs, F, chunk_size=128)
    for key in (1, 40, 41):
        if key in p._key_to_slot and len(docs) > 10:
            for ix in (j, p):
                ix.remove_document(key)  # latent deletes
    return j, p, queries


def _assert_plans_equal(jplan, pplan):
    names = ("jquery", "words", "qlen", "nchunks", "njobs", "fallback", "shared")
    for name, a, b in zip(names, jplan, pplan):
        if a is None or b is None:
            assert a is None and b is None, name
        elif name == "fallback":
            assert list(a) == list(b)
        else:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_plan_batch_z2o(corpus):
    j, p, queries = corpus
    jplan = jz.plan_batch_z2o(j.device_index(), queries, tokenizer)
    pplan = pz.plan_batch_z2o(p.device_index(), queries, tokenizer)
    _assert_plans_equal(jplan, pplan)
    # a second call is served from the pool, with the same tables
    _assert_plans_equal(jplan, pz.plan_batch_z2o(p.device_index(), queries[::-1][::-1], tokenizer))


@pytest.mark.parametrize("cfg", [{"max_expansions": 2}, {"max_query_terms": 2}])
def test_plan_over_caps(cfg):
    docs, queries = _random(5, 80, 1, "abc", 25)
    j, p = _pair(docs, 1, chunk_size=128, **cfg)
    jplan = jz.plan_batch_z2o(j.device_index(), queries, tokenizer)
    pplan = pz.plan_batch_z2o(p.device_index(), queries, tokenizer)
    assert len(pplan[5]) >= 2  # fallback queries
    _assert_plans_equal(jplan, pplan)


def test_shared_node_detection():
    """Duplicate query terms or overlapping prefix expansions mark a query
    shared-node (lockstep program); plain queries take the fast program."""
    j, p = _pair(_titles(["abc def", "abcx", "ab"]))
    *_, fallback, shared = pz.plan_batch_z2o(
        p.device_index(), ["abc def", "abc abc", "ab abc", "def"], tokenizer
    )
    assert fallback == [] and list(shared) == [False, True, True, False]


def _capture_windows(monkeypatch, j, p, queries, k=K):
    """The packed window (words, qlen, class specs) each engine hands its
    device program, captured instead of run."""
    seen = {}

    def jstep(rec, words, qlen, **kw):
        seen["jax"] = (np.asarray(words), np.asarray(qlen), kw)
        return jnp.zeros((1,), jnp.int32)

    def pstep(rec, words, qlen, **kw):
        seen["port"] = (words.numpy().copy(), qlen.numpy().copy(), kw)
        return torch.zeros((1,), dtype=torch.int32)

    monkeypatch.setattr(jz, "_get_z2o_window_step", lambda: jstep)
    monkeypatch.setattr(pz, "_z2o_window_step", pstep)
    jz.z2o_query_batch_async(j.device_index(), queries, tokenizer, k)
    pz.z2o_query_batch_async(p.device_index(), queries, tokenizer, k)
    return seen


def test_window_packing(corpus, monkeypatch):
    """Score ranks (word 2 of fast rows), class specs, qlen and the packed
    job tables equal the JAX engine's bit for bit."""
    j, p, queries = corpus
    seen = _capture_windows(monkeypatch, j, p, queries * 3)
    if "jax" not in seen:
        assert "port" not in seen
        return
    (jw, jq, jkw), (pw, pq, pkw) = seen["jax"], seen["port"]
    np.testing.assert_array_equal(jw, pw)
    np.testing.assert_array_equal(jq.view(np.int32), pq.view(np.int32))
    assert [tuple(int(x) for x in s) for s in jkw["class_specs"]] == [
        tuple(int(x) for x in s) for s in pkw["class_specs"]
    ]
    assert (jkw["chunk"], jkw["k"], jkw["fused_ok"], jkw["fmt"]) == (
        pkw["chunk"], pkw["k"], pkw["fused_ok"], pkw["fmt"]
    )


def _classes(seen):
    """(jobs int32[b_pad, nj, 4], qlen f32[b_pad], spec) per packed class."""
    words, qlen, kw = seen
    off = qoff = 0
    for spec in kw["class_specs"]:
        b_pad, _b_out, nj, _nc, _fast = (int(x) for x in spec)
        yield words[off : off + b_pad * nj * 4].reshape(b_pad, nj, 4), qlen[qoff : qoff + b_pad], spec
        off += b_pad * nj * 4
        qoff += b_pad


def _mixed_window():
    docs, queries = _random(7, 100, 1, "abcdefgh", 30, maxlen=5)
    j, p = _pair(docs, 1, chunk_size=128)
    for key in (5, 6, 7, 120):
        for ix in (j, p):
            ix.remove_document(key)
    return j, p, queries


@pytest.fixture(scope="module")
def mixed():
    return _mixed_window()


def test_fast_step_tables_and_staged_program(mixed, monkeypatch):
    """The fast program's chunk tables equal the JAX prologue's (captured
    where the JAX engine hands them to the kernel), and the staged program
    agrees with the JAX engine's XLA branch (``fused_mode="off"``)."""
    j, p, queries = mixed
    seen = _capture_windows(monkeypatch, j, p, queries)["port"]
    C, F = p.device_index().CHUNK, p.num_fields
    jrec, prec = j.device_index().rec, p.device_index().rec
    # The JAX prologue's tables, returned where it calls the kernel.
    monkeypatch.setattr(jpz, "fused_z2o_topk", lambda *a, **kw: a[1:7])
    n_fast = 0
    for jobs, ql, (b_pad, _b_out, nj, nc, fast) in _classes(seen):
        if not fast:
            continue
        n_fast += 1
        kw = dict(chunk=C, k=K, num_fields=F, num_chunks=int(nc), fused_ok=True)

        def jax_fast(mode):
            step = jax.jit(lambda jobs_flat, qlen: jz.z2o_fast_step(
                rec=jrec, jobs_flat=jobs_flat, qlen=qlen, fused_mode=mode, **kw))
            return step(jnp.asarray(jobs.reshape(b_pad, -1)), jnp.asarray(ql))

        tables = pz.expand_chunks_z2o(torch.from_numpy(jobs), C, int(nc))
        for name, a, b in zip(("start", "skip", "len", "qterm", "score", "rank"),
                              jax_fast("interpret"), (*tables[:4], tables[5], tables[4])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
        js, jd = jax_fast("off")
        ps, pd = pz.z2o_staged_fast_step(
            prec, *tables[:4], tables[5], torch.from_numpy(ql), chunk=C, k=K, num_fields=F
        )
        assert_topk_agree(ps.numpy(), pd.numpy(), np.asarray(js), np.asarray(jd))
    assert n_fast >= 2


def test_lockstep_program(mixed, monkeypatch):
    """The torch lockstep program against the JAX ``z2o_step``: the same
    accepted entry lanes (the JAX loop's final state, taken by wrapping
    ``jax.lax.fori_loop``), results within the tolerance."""
    j, p, queries = mixed
    seen = _capture_windows(monkeypatch, j, p, queries)["port"]
    C, F = p.device_index().CHUNK, p.num_fields
    loop = jax.lax.fori_loop
    state = {}

    def spy(lo, hi, body, init):
        state["out"] = loop(lo, hi, body, init)
        return state["out"]

    monkeypatch.setattr(jax.lax, "fori_loop", spy)
    jrec = j.device_index().rec
    n_shared = 0
    for jobs, ql, (b_pad, _b_out, nj, nc, fast) in _classes(seen):
        if fast:
            continue
        n_shared += 1
        kw = dict(chunk=C, k=K, num_fields=F, num_chunks=int(nc))

        @jax.jit
        def jax_step(jobs_flat, qlen):
            out = jz.z2o_step(rec=jrec, jobs_flat=jobs_flat, qlen=qlen, **kw)
            return (*out, state["out"][2])

        js, jd, jacc = jax_step(jnp.asarray(jobs.reshape(b_pad, -1)), jnp.asarray(ql))
        ps, pd, acc = pz.z2o_step(p.device_index().rec, torch.from_numpy(jobs),
                                  torch.from_numpy(ql), **kw, return_accepted=True)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc) > 0)
        assert acc.any()
        assert_topk_agree(ps.numpy(), pd.numpy(), np.asarray(js), np.asarray(jd))
    assert n_shared >= 1


@pytest.fixture
def fused_interpret(monkeypatch):
    monkeypatch.setattr(jdev, "_FUSED_MODE", "interpret")
    jz._Z2O_STEP_CACHE.clear()
    yield
    jz._Z2O_STEP_CACHE.clear()


def _oracle_rows(ix, queries, k=K):
    return [ix.query(q, jz2o.new(), tokenizer, [1.0] * ix.num_fields)[:k] for q in queries]


def _rows_arrays(ix, rows, k=K):
    s = np.full((len(rows), k), -np.inf, np.float32)
    d = np.full((len(rows), k), -1, np.int32)
    for i, row in enumerate(rows):
        for r, res in enumerate(row[:k]):
            s[i, r] = res.score
            d[i, r] = ix._key_to_slot[res.key]
    return s, d


def _reset_launches():
    for counters in (fz.launches, pz.launches):
        for name in counters:
            counters[name] = 0


def test_slice_end_to_end(mixed, fused_interpret):
    """Mixed fast and shared-node windows with latent deletes, through
    ``Index.query_batch``, against the JAX engine (Pallas in interpret mode)
    and the f64 oracle; no launch counter moves on the CPU."""
    j, p, queries = mixed
    # The JAX side compiles one Pallas kernel (interpret mode) per fast
    # class: hold it to the queries of the narrow classes (nc <= 4, fast
    # and shared), and the whole window to the oracle.
    nc = pz._bucket_vec(pz.plan_batch_z2o(p.device_index(), queries, tokenizer)[3], (2, 3, 4), 2)
    narrow = [q for q, n in zip(queries, nc) if n <= 4]
    _reset_launches()
    prows = p.query_batch(narrow, pt.zero_to_one.new(), top_k=K)
    jrows = j.query_batch(narrow, jz2o.new(), top_k=K, backend="device")
    assert_topk_agree(*_rows_arrays(p, prows), *_rows_arrays(j, jrows))
    prows = p.query_batch(queries, pt.zero_to_one.new(), top_k=K)
    assert_topk_agree(*_rows_arrays(p, prows), *_rows_arrays(j, _oracle_rows(j, queries)))
    assert sum(fz.launches.values()) == 0 and sum(pz.launches.values()) == 0
    shared = pz.plan_batch_z2o(p.device_index(), queries, tokenizer)[6]
    assert shared.any() and not shared.all()


@pytest.mark.parametrize("fmt", ["f32", "compact", "slots", "slots20"])
def test_result_formats(mixed, fmt):
    """Every result format reports the f32 window's ranking (compact: f16
    scores of it; slots formats: no scores)."""
    _j, p, queries = mixed
    dix = p.device_index()
    want_s, want, _ = pz.z2o_query_batch_async(dix, queries, tokenizer, K, fmt="f32").get_arrays()
    scores, slots, keys = pz.z2o_query_batch_async(dix, queries, tokenizer, K, fmt=fmt).get_arrays()
    np.testing.assert_array_equal(slots, want)
    np.testing.assert_array_equal(keys[slots >= 0], dix.key_arr[slots[slots >= 0]])
    if fmt.startswith("slots"):
        assert scores is None
    elif fmt == "compact":
        dev = np.isfinite(want_s) & ~np.isin(np.arange(len(queries)), [len(queries) - 1])[:, None]
        np.testing.assert_array_equal(scores[dev], want_s[dev].astype(np.float16).astype(np.float32))
    else:
        np.testing.assert_array_equal(scores, want_s)


def test_serving_window_loop(mixed):
    """The blocking path's pipelined sub-windows give the single window's rows."""
    _j, p, queries = mixed
    want = pz.z2o_query_batch(p.device_index(), queries, tokenizer, K)
    saved = p.config.serving_window, p.config.serving_depth
    p.config.serving_window, p.config.serving_depth = 8, 2
    try:
        got = pz.z2o_query_batch(p.device_index(), queries, tokenizer, K)
    finally:
        p.config.serving_window, p.config.serving_depth = saved
    assert [[(r.key, r.score) for r in row] for row in got] == [
        [(r.key, r.score) for r in row] for row in want
    ]


def test_wide_schema_routes_to_host_lockstep():
    """Shared-node queries of more than 8 fields run the vectorized host
    lockstep, bit-equal to the oracle."""
    F = 9
    p = pt.Index(F, device="cpu")
    accessors = [lambda d, j=j: [d[j]] for j in range(F)]
    for i in range(12):
        p.add_document(accessors, tokenizer, i, tuple(f"w{(i + j) % 5}" for j in range(F)))
    queries = ["w1 w1", "w2 w3"]
    rows = p.query_batch(queries, pt.zero_to_one.new(), tokenizer, top_k=5, backend="device")
    for q, row in zip(queries, rows):
        oracle = p.query(q, pt.zero_to_one.new(), tokenizer, [1.0] * F)[:5]
        assert [(r.key, r.score) for r in row] == [(r.key, r.score) for r in oracle]


def test_device_index_routes_two_phase_scorers(mixed):
    _j, p, queries = mixed
    dix = p.device_index()
    a = dix.query_batch_async(queries, pt.zero_to_one.new(), top_k=K).get_arrays()
    b = pz.z2o_query_batch_async(dix, queries, tokenizer, K).get_arrays()
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
