"""The fused query of the torch port against the JAX engine.

* ``fused_query_topk_reference`` (the plain torch version of the CUDA
  kernel) against the Pallas kernel ``fused_query_topk(interpret=True)``;
* ``expand_chunks`` against the JAX step's chunk-expansion prologue;
* the torch merges against ``probly_search_tpu/ops/merge.py``;
* the wrapper's routing: CPU tensors take the plain version, launch counters
  stay at 0 (the kernel itself against the plain version on a CUDA device is
  ``test_torch_cuda.py``).

Tolerance: integer tables and lane keys bit-exact; scores ``rtol=2e-5,
atol=1e-6``; top-k slots equal except that neighbours within that score
tolerance may swap (``probly_search_tpu_torch.testing``).  Summation order
differs between the engines (segmented scans against sequential sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probly_search_tpu.index.device as jdev
import probly_search_tpu.ops.pallas_query as jpq
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu.ops import merge as jmerge
from probly_search_tpu_torch import bm25
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.ops import fused_merge as fm
from probly_search_tpu_torch.ops import fused_query as fq
from probly_search_tpu_torch.ops import merge as pmerge
from probly_search_tpu_torch.testing import assert_topk_agree

from .torch_util import QB, make_rec, make_tables, to_torch


@pytest.mark.parametrize(
    "phase,NC,k", [("full", 2, 10), ("full", 3, 64), ("full", 6, 10), ("lanes", 3, 10)]
)
def test_reference_matches_pallas_interpret(phase, NC, k):
    C, B = 128, 8
    rng = np.random.default_rng(NC)
    rec, starts, lens = make_rec(rng)
    # k = 64 runs over 3 chunks of at most 16 live lanes: k > live docs.
    tables = make_tables(rng, starts, lens, B, NC, max_len=16 if k == 64 else None)
    scalars = np.array([[6.5, 1.5]], np.float32)
    kw = dict(chunk=C, k=k, qterm_bits=QB, num_fields=1, phase=phase)
    js, jd = jpq.fused_query_topk(
        jbm25.new(), jnp.asarray(rec), *map(jnp.asarray, tables), jnp.asarray(scalars),
        interpret=True, **kw,
    )
    ps, pd = fq.fused_query_topk_reference(bm25.new(), *to_torch([rec, *tables, scalars]), **kw)
    js, jd, ps, pd = np.asarray(js), np.asarray(jd), ps.numpy(), pd.numpy()
    if phase == "lanes":  # (score, key) lanes: keys exact, scores close
        np.testing.assert_array_equal(pd, jd)
        fin = np.isfinite(js)
        np.testing.assert_array_equal(np.isfinite(ps), fin)
        np.testing.assert_allclose(ps[fin], js[fin], rtol=2e-5, atol=1e-6)
        return
    assert_topk_agree(ps, pd, js, jd)
    assert (pd[5] == -1).all()  # the empty row
    if k == 64:
        assert (pd == -1).any(axis=1).all()  # k past the live docs of every row


def _capture_jax_tables(monkeypatch, rec, jobs, C, NC):
    """Chunk tables of the JAX step's prologue, captured at its call of the
    fused kernel."""
    seen = {}

    def capture(scorer, rec, c_start, c_skip, c_len, c_qterm, c_scale, scalars, **kw):
        seen["t"] = (c_start, c_skip, c_len, c_qterm, c_scale)
        B = c_start.shape[0]
        return jnp.zeros((B, kw["k"]), jnp.float32), jnp.zeros((B, kw["k"]), jnp.int32)

    monkeypatch.setattr(jdev, "_FUSED_MODE", "interpret")
    monkeypatch.setattr(jpq, "fused_query_topk", capture)
    jdev._query_step_impl(
        jbm25.new(), chunk=C, k=10, qterm_bits=QB, num_fields=1, num_chunks=NC,
        rec=jnp.asarray(rec), field_avg=jnp.ones(1, jnp.float32),
        fields_boost=jnp.ones(1, jnp.float32), jobs_flat=jnp.asarray(jobs),
    )
    return [np.asarray(a) for a in seen["t"]]


@pytest.mark.parametrize("NC,NJ", [(3, 4), (8, 4), (12, 8)])
def test_expand_chunks_matches_jax_prologue(monkeypatch, NC, NJ):
    C, B = 128, 16
    rng = np.random.default_rng(NC)
    rec = np.zeros((4, 200_000), np.int32)
    jobs = np.zeros((B, NJ, 3), np.int32)
    for b in range(B):
        used = 0
        for j in range(int(rng.integers(0, NJ + 1))):
            start = int(rng.integers(0, 190_000))
            length = int(rng.integers(0, 400)) if j % 3 != 2 else 0  # some empty jobs
            need = (start % 128 + length + C - 1) // C if length else 0
            if used + need > NC:
                break
            used += need
            scale = np.float32(rng.uniform(0.1, 9.0))
            jobs[b, j] = (start, length | (j % 16) << 26, scale.view(np.int32))
    want = _capture_jax_tables(monkeypatch, rec, jobs.reshape(B, NJ * 3), C, NC)
    got = pdev.expand_chunks(torch.from_numpy(jobs), C, NC)
    for name, g, w in zip(("start", "skip", "len", "qterm", "scale"), got, want):
        assert g.dtype == (torch.float32 if name == "scale" else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _runs(rng, B, NC, run):
    """[B, NC * run] keys as ascending runs (-1 leads, INVALID tails)."""
    keys = np.full((B, NC * run), jmerge.INVALID_KEY, np.int32)
    for b in range(B):
        for r in range(NC):
            n = int(rng.integers(0, run + 1))
            lead = int(rng.integers(0, run - n + 1))
            docs = np.sort(rng.choice(200, size=n, replace=False)).astype(np.int32)
            seg = keys[b, r * run : (r + 1) * run]
            seg[:lead] = -1
            seg[lead : lead + n] = (docs << QB) | int(rng.integers(0, 3))
    return keys


# Jitted: the merges are whole XLA programs in the JAX engine.
_jax_presorted = jax.jit(jmerge.merge_scores_topk_presorted, static_argnums=(2, 3, 4, 5))
_jax_general = jax.jit(jmerge.merge_scores_topk, static_argnums=(2, 3))


@pytest.mark.parametrize("NC,excl", [(1, True), (3, True), (4, False), (6, True)])
def test_merge_presorted_matches_jax(NC, excl):
    rng = np.random.default_rng(10 + NC)
    run, k = 64, 12
    keys = _runs(rng, 6, NC, run)
    scores = rng.standard_normal(keys.shape).astype(np.float32) * 3
    if excl:
        scores = np.maximum(scores, 0.0)
    scores[rng.random(keys.shape) < 0.03] = -np.inf
    js, jd = _jax_presorted(jnp.asarray(keys), jnp.asarray(scores), k, QB, run, excl)
    ps, pd = pmerge.merge_scores_topk_presorted(
        torch.from_numpy(keys), torch.from_numpy(scores), k, QB, run, excl
    )
    assert_topk_agree(ps.numpy(), pd.numpy(), np.asarray(js), np.asarray(jd))


@pytest.mark.parametrize("L", [100, 384])
def test_merge_general_matches_jax(L):
    rng = np.random.default_rng(L)
    docs = rng.integers(0, 60, (5, L)).astype(np.int32)
    live_keys = (docs << QB) | rng.integers(0, 3, (5, L))
    keys = np.where(rng.random((5, L)) < 0.2, jmerge.INVALID_KEY, live_keys)
    keys = keys.astype(np.int32)
    scores = rng.uniform(0, 5, (5, L)).astype(np.float32)
    js, jd = _jax_general(jnp.asarray(keys), jnp.asarray(scores), 10, QB)
    # the general merge is K5's plain version with a full sort (run = 0)
    ps, pd = fm.merge_scores_topk_fused_reference(torch.from_numpy(keys), torch.from_numpy(scores), 10, QB)
    assert_topk_agree(ps.numpy(), pd.numpy(), np.asarray(js), np.asarray(jd))


@pytest.mark.parametrize("phase", ["full", "lanes"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, phase):
    monkeypatch.setattr(fq, "launches", {"full": 0, "lanes": 0})
    rng = np.random.default_rng(3)
    rec, starts, lens = make_rec(rng)
    args = to_torch([rec, *make_tables(rng, starts, lens, 8, 3), np.array([6.5, 1.5], np.float32)])
    kw = dict(chunk=128, k=10, qterm_bits=QB, num_fields=1, phase=phase)
    got = fq.fused_query_topk(bm25.new(), *args, **kw)
    want = fq.fused_query_topk_reference(bm25.new(), *args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fq.launches == {"full": 0, "lanes": 0}


def _rec(shape, device="cpu"):
    return torch.arange(shape[0] * shape[1], dtype=torch.int32).reshape(shape).to(device)


def test_padded_rows_keep_shape_and_values():
    a = np.arange(4 * 1001, dtype=np.int32).reshape(4, 1001)
    r = fq.padded_rows(a, "cpu")
    assert tuple(r.shape) == (4, 1001) and r.stride() == (1024, 1)
    np.testing.assert_array_equal(r.numpy(), a)
    fq.check_rec(r, 1)


@pytest.mark.parametrize(
    "make,ok",
    [
        (lambda: fq.padded_rows(np.zeros((4, 1001), np.int32), "cpu"), True),
        (lambda: fq.padded_rows(np.zeros((8, 300), np.int32), "cpu"), True),
        (lambda: _rec((4, 1000)), True),  # contiguous, 16-B rows
        (lambda: _rec((4, 1001)), False),  # rows not 16-B aligned: K1, K3 and K4 refuse it
        (lambda: _rec((4, 1004))[:, 1:], False),  # 16-B stride, but the rows start 4 B in
        (lambda: _rec((1001, 4)).t(), False),  # column stride != 1
        (lambda: _rec((4, 2048))[:, ::2], False),
        (lambda: _rec((4, 64)).to(torch.int64), False),
        (lambda: _rec((3, 64)), False),  # too few record rows
    ],
)
def test_check_rec(make, ok):
    rec = make()
    if ok:
        fq.check_rec(rec, 1)
    else:
        with pytest.raises(ValueError):
            fq.check_rec(rec, 1)


@pytest.mark.parametrize("phase", ["full", "lanes"])
@pytest.mark.parametrize("aligned", [True, False])
def test_check_query_args_needs_aligned_rec(phase, aligned):
    """Both phases load 16 B of a record row at a time (K3 since its
    redesign), so both refuse a ``rec`` whose rows are not 16-B aligned."""
    rng = np.random.default_rng(9)
    rec, starts, lens = make_rec(rng)
    tables = to_torch(make_tables(rng, starts, lens, 8, 3))
    rec_t = fq.padded_rows(rec, "cpu")
    if not aligned:
        buf = torch.zeros((rec.shape[0], rec.shape[1] + 1), dtype=torch.int32)
        buf[:, 1:] = torch.from_numpy(rec)
        rec_t = buf[:, 1:]
    scalars = torch.tensor([6.5, 1.5], dtype=torch.float32)
    kw = dict(chunk=128, k=10, num_fields=1, phase=phase, key_bits=31)
    if aligned:
        fq.check_query_args(rec_t, *tables, scalars, **kw)
    else:
        with pytest.raises(ValueError, match="16-B aligned"):
            fq.check_query_args(rec_t, *tables, scalars, **kw)


def test_check_query_args_checks_rec_on_every_call():
    """A ``rec`` that passed once and whose storage then moves to an
    unaligned view is refused on the next call: nothing about it is kept
    from one call to the next."""
    rng = np.random.default_rng(10)
    rec, starts, lens = make_rec(rng)
    tables = to_torch(make_tables(rng, starts, lens, 8, 3))
    rec_t = fq.padded_rows(rec, "cpu")
    scalars = torch.tensor([6.5, 1.5], dtype=torch.float32)
    kw = dict(chunk=128, k=10, num_fields=1, phase="lanes", key_bits=31)
    fq.check_query_args(rec_t, *tables, scalars, **kw)
    R, W = rec.shape
    buf = torch.zeros(R * (W + 1) + 1, dtype=torch.int32)
    rec_t.set_(buf.untyped_storage(), 1, (R, W), (W + 1, 1))
    with pytest.raises(ValueError, match="16-B aligned"):
        fq.check_query_args(rec_t, *tables, scalars, **kw)


@pytest.mark.parametrize(
    "L,C,F,k,avail,ring",
    [
        (16384, 1024, 1, 10, 231328, 4),  # the widest one-field class: the full ring
        (16384, 1024, 4, 10, 231328, 2),  # four fields: a shallower ring fits
        (16384, 1024, 8, 10, 231328, 1),
        (16384, 1024, 16, 10, 231328, 0),  # nothing fits: the wrapper raises
        (2048, 1024, 1, 4096, 231328, 2),  # no deeper than the class's 2 chunks
        (4096, 1024, 1, 10, 231328, 4),  # two such blocks still fit an SM
        (8192, 1024, 1, 10, 231328, 2),  # a deeper ring would keep one block an SM
        (384, 128, 2, 64, 48 * 1024, 3),
        (16384, 1024, 1, 16384, 231328, 4),  # k = L: the words in device scratch
        (8192, 1024, 1, 4097, 231328, 2),
    ],
)
def test_full_launch_sizes_shared_memory(L, C, F, k, avail, ring):
    got_ring, smem = fq.full_launch(L, C, F, k, avail)
    assert got_ring == ring
    words = fq.cand_words(k) if k <= fq.MAX_K else 0
    assert smem == 8 * L + 4 * max(ring, 1) * (2 + 2 * F) * C + 8 * words + 20 * (L // C) + 8 * F
    assert (smem <= avail) == (ring > 0)


@pytest.mark.parametrize("k,words", [(1, 32), (10, 32), (32, 32), (33, 64), (128, 128), (5000, 8192)])
def test_cand_words(k, words):
    assert fq.cand_words(k) == words
