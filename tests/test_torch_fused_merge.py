"""The standalone merge (K5) of the torch port against the JAX engine.

``merge_scores_topk_fused_reference`` (the plain torch version of the CUDA
kernel in ``csrc/fused_merge.cu``) against the Pallas kernel
``merge_scores_topk_pallas(interpret=True)``, as ``tests/test_oddeven_merge.py``
runs it: ``run=0`` (a full sort) and ``run=128`` over 2 to 12 runs (run
counts that are not powers of two included), rows 4, ``excl`` on and off,
``max_seg`` 0 and NC; rows hold duplicate keys, leading and trailing pads,
dead docs and equal totals.  And the wrapper's routing: CPU tensors take the
plain version, the launch count stays at 0 (the kernel against the plain
version on a card is ``test_torch_cuda.py``).

Tolerance (``probly_search_tpu_torch.testing``): scores ``rtol=2e-5,
atol=1e-6``, slots equal except neighbours within that score tolerance (the
two sum a doc's query terms in different orders).
"""

import numpy as np
import pytest
import torch

from probly_search_tpu.ops.pallas_merge import merge_scores_topk_pallas
from probly_search_tpu_torch.ops import fused_merge as fm
from probly_search_tpu_torch.ops.merge import INVALID_KEY, merge_scores_topk_presorted
from probly_search_tpu_torch.testing import assert_topk_agree

from .torch_util import QB, merge_edge_rows, merge_rows


def _pallas(key, val, k, run, excl, max_seg):
    s, d = merge_scores_topk_pallas(
        key, val, k, QB, rows_per_block=2, interpret=True, run=run, excl=excl, max_seg=max_seg
    )
    return np.asarray(s), np.asarray(d)


@pytest.mark.parametrize("excl", [False, True])
@pytest.mark.parametrize("max_seg", [0, "NC"])
@pytest.mark.parametrize("n_runs", [2, 3, 4, 6, 8, 12])
def test_presorted_runs_match_pallas(n_runs, max_seg, excl):
    rng = np.random.default_rng(100 + n_runs)
    run, k = 128, 8
    key, val = merge_rows(rng, 4, n_runs, run, excl, presorted=True)
    ms = n_runs if max_seg == "NC" else 0
    js, jd = _pallas(key, val, k, run, excl, ms)
    ps, pd = fm.merge_scores_topk_fused_reference(
        torch.from_numpy(key), torch.from_numpy(val), k, QB, run=run, excl=excl, max_seg=ms
    )
    assert_topk_agree(ps.numpy(), pd.numpy(), js, jd)
    assert (pd >= 0).any()


@pytest.mark.parametrize("excl", [False, True])
@pytest.mark.parametrize("n_runs", [2, 4, 8])
def test_full_sort_matches_pallas(n_runs, excl):
    """run = 0: unsorted rows with duplicate (doc, qterm) keys and
    INVALID_KEY pads only (the range classes' lanes)."""
    rng = np.random.default_rng(200 + n_runs)
    key, val = merge_rows(rng, 4, n_runs, 128, excl, presorted=False)
    js, jd = _pallas(key, val, 10, 0, excl, 0)
    ps, pd = fm.merge_scores_topk_fused_reference(
        torch.from_numpy(key), torch.from_numpy(val), 10, QB, excl=excl
    )
    assert_topk_agree(ps.numpy(), pd.numpy(), js, jd)


def test_equal_totals_go_to_the_lowest_doc():
    """Docs 9, 4 and 7 total 2.0 (4 and 9 as two query terms of 1.0); doc 5
    totals 3.0.  Unsorted lanes, run = 0."""
    key = np.array([[9 << QB, 5 << QB, (4 << QB) | 1, 7 << QB, 4 << QB, (9 << QB) | 2,
                     INVALID_KEY, 5 << QB]], np.int32)
    val = np.array([[1.0, 3.0, 1.0, 2.0, 1.0, 1.0, 9.0, 0.5]], np.float32)
    want_s = np.array([[3.0, 2.0, 2.0, 2.0, -np.inf]], np.float32)
    want_d = np.array([[5, 4, 7, 9, -1]], np.int32)
    js, jd = _pallas(key, val, 5, 0, False, 0)
    ps, pd = fm.merge_scores_topk_fused_reference(torch.from_numpy(key), torch.from_numpy(val), 5, QB)
    for s, d in ((js, jd), (ps.numpy(), pd.numpy())):
        np.testing.assert_array_equal(s, want_s)
        np.testing.assert_array_equal(d, want_d)


@pytest.mark.parametrize("run", [0, 128])
def test_cpu_tensors_take_the_plain_version(monkeypatch, run):
    monkeypatch.setattr(fm, "launches", {"merge_topk": 0})
    rng = np.random.default_rng(7 + run)
    key, val = merge_rows(rng, 3, 3, 128, True, presorted=run > 0)
    kt, vt = torch.from_numpy(key), torch.from_numpy(val)
    s, d = fm.merge_scores_topk_fused(kt, vt, 10, QB, run=run, excl=True, max_seg=3)
    ws, wd = merge_scores_topk_presorted(kt, vt, 10, QB, run, True)
    assert torch.equal(s, ws) and torch.equal(d, wd)
    assert fm.launches == {"merge_topk": 0}


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fm.merge_scores_topk_fused(x, x.float(), 4, QB)


# The H100's opt-in shared memory per block less the block kernel's static part.
_SMEM = 232448 - 12 * 1024


@pytest.mark.parametrize(
    "B,L,k,run,key_bits,smem,path",
    [
        (1, 1, 1, 0, 31, _SMEM, "block"),
        (24, 16384, 10, 1024, 24, _SMEM, "block"),
        (2, 16384, 4096, 0, 31, _SMEM, "block"),
        (2, 16385, 10, 0, 31, _SMEM, "radix"),  # one past the block cap
        (24, 24576, 10, 1024, 24, _SMEM, "radix"),  # phase 3's lanes class
        (1, 2 * 16384, 256, 0, 24, _SMEM, "radix"),
        (1, 2 * 16384 + 1, 10, 0, 24, _SMEM, "radix"),
        (1, 49152, 128, 0, 24, _SMEM, "radix"),
        (1, 12000, 10, 0, 31, 100_000, "block"),  # a card with less shared memory
        (1, 16384, 10, 0, 31, 100_000, "radix"),
        (1, 20000, 257, 0, 31, _SMEM, "radix"),
        (1, 1 << 23, 128, 0, 24, _SMEM, "radix"),
    ],
)
def test_merge_plan(B, L, k, run, key_bits, smem, path):
    fm.check_merge_args(B, L, k, run, key_bits)  # run and key_bits do not enter the plan
    p = fm.merge_plan(B, L, k, smem)
    assert p.path == path
    kpad = 1 << (k - 1).bit_length()
    if path == "block":
        assert p.smem == 8 * L + 8 * max(32, kpad) <= smem and p.ws_bytes == 0
    else:
        assert p.smem == 8 * kpad
        assert p.ws_bytes >= 2 * 8 * B * L + 8 * B * L + 8 * B * kpad


@pytest.mark.parametrize(
    "B,L,k,run,key_bits,ok",
    [
        (1, 10, 10, 0, 31, True),
        (1, 10, 11, 0, 31, False),
        (1, 8192, 4097, 0, 31, False),
        (1, 10, 0, 0, 31, False),
        (1, 10, 5, 3, 31, False),
        (1, 10, 5, 0, 0, False),
        (1, 10, 5, 0, 32, False),
        (1, 10, 5, 1024, 24, True),
        (65536, 10, 5, 0, 31, False),
    ],
)
def test_check_merge_args(B, L, k, run, key_bits, ok):
    if ok:
        fm.check_merge_args(B, L, k, run, key_bits)
    else:
        with pytest.raises(ValueError):
            fm.check_merge_args(B, L, k, run, key_bits)


@pytest.mark.parametrize("num_slots,bits", [(1, 4), (16, 8), (17, 9), (1_000_000, 24), (1 << 27, 31)])
def test_key_bits_for(num_slots, bits):
    assert fm.key_bits_for(num_slots, QB) == bits


@pytest.mark.parametrize("kind", ["high", "ties", "one", "few", "pads"])
def test_edge_rows_match_pallas(kind):
    """Keys that use all 31 bits, all totals equal, one or five live lanes,
    all pads: the plain merge against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(len(kind))
    key, val = merge_edge_rows(rng, kind, 4, 256)
    if kind == "high":
        assert key[key != INVALID_KEY].max() >= 2**30
    js, jd = _pallas(key, val, 10, 0, False, 0)
    ps, pd = fm.merge_scores_topk_fused_reference(torch.from_numpy(key), torch.from_numpy(val), 10, QB)
    assert_topk_agree(ps.numpy(), pd.numpy(), js, jd)
    assert bool((pd >= 0).any()) == (kind != "pads")
