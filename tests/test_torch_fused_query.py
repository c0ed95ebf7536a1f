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
