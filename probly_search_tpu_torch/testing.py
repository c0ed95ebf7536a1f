"""Agreement rule for top-k results of two engines (tests and chip smoke).

Scores agree within ``rtol=2e-5, atol=1e-6``, the repo's device-vs-oracle
bar: summation order differs between engines (a segmented scan against a
sequential sum) and nvcc contracts multiply-adds.  Slots agree exactly,
except that neighbours whose scores lie within that tolerance may swap; a
group of such near-ties cut by the top-k boundary may hold different docs.
"""

from __future__ import annotations

import numpy as np

RTOL = 2e-5
ATOL = 1e-6


def assert_topk_agree(s_a, d_a, s_b, d_b, rtol: float = RTOL, atol: float = ATOL) -> float:
    """Check two [rows, k] results (scores f32, slots int32) against the
    rule above; returns the largest absolute score difference."""
    s_a, d_a, s_b, d_b = (np.asarray(x) for x in (s_a, d_a, s_b, d_b))
    assert s_a.shape == s_b.shape == d_a.shape == d_b.shape, (s_a.shape, s_b.shape)
    fin = np.isfinite(s_a)
    np.testing.assert_array_equal(fin, np.isfinite(s_b))
    np.testing.assert_array_equal(d_a < 0, d_b < 0)
    np.testing.assert_allclose(s_a[fin], s_b[fin], rtol=rtol, atol=atol)
    for r in np.flatnonzero((d_a != d_b).any(axis=1)):
        k = s_a.shape[1]
        i = 0
        while i < k:
            j = i + 1
            while j < k and abs(s_a[r, j] - s_a[r, j - 1]) <= atol + rtol * abs(s_a[r, j]):
                j += 1
            if j < k:  # a tie group wholly inside the top-k: same docs
                assert sorted(d_a[r, i:j]) == sorted(d_b[r, i:j]), (r, i, j, d_a[r], d_b[r])
            i = j
    return float(np.abs(s_a[fin] - s_b[fin]).max()) if fin.any() else 0.0
