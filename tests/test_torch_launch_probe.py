"""The launch probe (P1) of the torch port against the JAX package's.

``probe_add_reference`` (the plain torch version of ``csrc/launch_probe.cu``)
against the Pallas kernel of ``benchmarks/profile_launch.py`` (``pallas_add``:
``o_ref[...] = x_ref[...] + 1.0`` over f32[8, 512]), rebuilt here the same
way and run in interpret mode, and chains of 1, 4 and 16 probes.  Tolerance:
none, bit-equal (one f32 addition).  The wrapper's routing: CPU tensors take
the plain version and the launch count stays at 0 (the kernel on a card is
``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from probly_search_tpu_torch.ops import launch_probe as lp


def _pallas_add(x):
    def tiny_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    return pl.pallas_call(
        tiny_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True
    )(x)


def _probe_input(seed):
    x = np.random.default_rng(seed).standard_normal(lp.SHAPE).astype(np.float32) * 1e3
    x.flat[:4] = [-1.0, np.inf, -np.inf, 2.0**24]
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_pallas(seed):
    x = _probe_input(seed)
    want = np.asarray(_pallas_add(jnp.asarray(x)))
    got = lp.probe_add_reference(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == lp.SHAPE
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 4, 16])
def test_chain_of_probes(monkeypatch, n):
    monkeypatch.setattr(lp, "launches", {"probe_add": 0})
    x = _probe_input(n)
    want = jnp.asarray(x)
    got = torch.from_numpy(x)
    for _ in range(n):
        want = _pallas_add(want)
        got = lp.probe_add(got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lp.launches == {"probe_add": 0}  # the CPU path launches nothing


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        lp.probe_add(torch.zeros(lp.SHAPE, device="meta"))
