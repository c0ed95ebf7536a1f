"""K4's plain torch version (``fused_z2o_topk_reference``, what the wrapper
runs for CPU tensors) against the Pallas kernel ``fused_z2o_topk`` in
interpret mode, on seeded tables.

Tables hold dead chunks, latently dead docs, an empty row, fields where a
posting has tf 0, and chunk entry scores drawn from four values, so equal
scores share a rank and the order among them comes from the lane.  Scores
agree within ``rtol=2e-5, atol=1e-6`` and slots through
``assert_topk_agree`` (``probly_search_tpu_torch.testing``).  The Pallas
kernel runs once per (NC, F) at k = 64: its top-k loop picks one entry per
round whatever k is, so its first 8 columns are its k = 8 answer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probly_search_tpu.ops.pallas_z2o as jpz
from probly_search_tpu_torch.ops import fused_z2o as fz
from probly_search_tpu_torch.testing import assert_topk_agree

from .torch_util import make_rec, make_z2o_tables, to_torch

C = 128
B = 16
K_PALLAS = 64


def _inputs(NC, F):
    rng = np.random.default_rng(100 * NC + F)
    rec, starts, lens = make_rec(rng, F=F, n_docs=400, n_terms=80, C=C)
    return rec, make_z2o_tables(rng, starts, lens, B, NC, C=C)


_PALLAS = {}


def _pallas(NC, F):
    if (NC, F) not in _PALLAS:
        rec, tables = _inputs(NC, F)
        s, d = jpz.fused_z2o_topk(
            jnp.asarray(rec), *(jnp.asarray(t) for t in tables),
            chunk=C, k=K_PALLAS, num_fields=F, interpret=True,
        )
        _PALLAS[NC, F] = (np.asarray(s), np.asarray(d))
    return _PALLAS[NC, F]


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("NC", [2, 3, 6])
def test_reference_matches_pallas_interpret(NC, F, k):
    rec, tables = _inputs(NC, F)
    before = dict(fz.launches)
    ps, pd = fz.fused_z2o_topk(torch.from_numpy(rec), *to_torch(tables), chunk=C, k=k, num_fields=F)
    assert fz.launches == before  # the CPU path launches nothing
    js, jd = _pallas(NC, F)
    assert_topk_agree(ps.numpy(), pd.numpy(), js[:, :k], jd[:, :k])
    assert (pd[5] == -1).all()  # the empty row
    assert (pd >= 0).sum(1).max() == k  # some row fills its k
    alive = rec[1 + 2 * F]
    docs = pd.numpy()[pd.numpy() >= 0]
    dead = np.unique(rec[0][(alive == 0) & (rec[0] >= 0)])
    assert not np.isin(docs, dead).any()  # latently dead docs never score
