"""Result-row packing of the torch port against the JAX engine.

Integer work, so the bar is bit-exact: every format's packed bytes, their
decode, and the format resolution equal the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probly_search_tpu.index.device as jdev
from probly_search_tpu_torch.index import device as pdev

FORMATS = ("f32", "compact", "slots", "slots20")
# Largest slot each format can address (slots20 reserves 0xFFFFF for -1).
SLOT_CAP = {"f32": 2**31 - 1, "compact": 2**31 - 1, "slots": 2**23 - 1, "slots20": 2**20 - 2}


def _rows(fmt, k, seed=0):
    rng = np.random.default_rng(seed)
    rows = 9
    cap = SLOT_CAP[fmt]
    d = rng.integers(0, cap + 1, (rows, k), dtype=np.int64).astype(np.int32)
    d[0] = cap  # the largest addressable slot
    d[1, :] = cap - np.arange(k)
    d[2, k // 2 :] = -1  # sentinels after the valid entries
    d[3] = -1  # an empty row
    d[4, 0] = 0
    s = rng.standard_normal((rows, k)).astype(np.float32) * 30
    s[d < 0] = -np.inf
    return s, d


@pytest.mark.parametrize("k", [10, 7])
@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_result_rows_bit_exact(fmt, k):
    s, d = _rows(fmt, k)
    want = np.asarray(jdev.pack_result_rows(jnp.asarray(s), jnp.asarray(d), fmt))
    got = pdev.pack_result_rows(torch.from_numpy(s), torch.from_numpy(d), fmt).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)

    p_scores, p_slots = pdev.unpack_result_rows(got, fmt, k)
    j_scores, j_slots = jdev.unpack_result_rows(want, fmt, k)
    np.testing.assert_array_equal(p_slots, j_slots)
    np.testing.assert_array_equal(p_slots, d)  # round trip within the cap
    if j_scores is None:
        assert p_scores is None
    else:
        np.testing.assert_array_equal(p_scores, j_scores)


@pytest.mark.parametrize("num_slots", [0, 2**20 - 1, 2**20, 2**23 - 1, 2**23, 2**27])
def test_resolve_result_format(num_slots):
    for fmt in FORMATS:
        assert pdev.resolve_result_format(fmt, num_slots) == jdev.resolve_result_format(
            fmt, num_slots
        )
