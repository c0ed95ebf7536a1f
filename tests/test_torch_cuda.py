"""The CUDA kernel against its plain torch version, on a CUDA device.

Every test here needs a card and skips without one.  The file imports no JAX,
so it runs where only torch is installed:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: lane keys bit-exact; scores ``rtol=2e-5, atol=1e-6``; top-k slots
equal except that neighbours within that score tolerance may swap (the
kernel sums a doc's terms sequentially, the plain version by a segmented
scan, and nvcc contracts multiply-adds).
"""

import numpy as np
import pytest
import torch

from probly_search_tpu_torch import bm25
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.ops import fused_query as fq
from probly_search_tpu_torch.testing import assert_topk_agree

from .torch_util import QB, make_rec, make_tables, to_torch


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("C,NC", [(128, 6), (1024, 3), (1024, 16), (1024, 24)])
def test_kernel_matches_plain_on_cuda(F, C, NC):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(C + NC + F)
    rec, starts, lens = make_rec(rng, F=F, n_docs=3000, n_terms=400, C=C)
    tables = to_torch(make_tables(rng, starts, lens, 64, NC, C=C), "cuda")
    rec_t = torch.from_numpy(rec).cuda()
    scalars = torch.tensor([6.5, 3.0][:F] + [1.5, 0.5][:F], dtype=torch.float32, device="cuda")
    phase = "full" if NC * C <= pdev._FUSED_MAX_LANES else "lanes"
    kw = dict(chunk=C, k=10, qterm_bits=QB, num_fields=F, phase=phase)
    before = fq.launches[phase]
    ks, kd = fq.fused_query_topk(bm25.new(), rec_t, *tables, scalars, **kw)
    torch.cuda.synchronize()
    assert fq.launches[phase] == before + 1
    ps, pd = fq.fused_query_topk_reference(bm25.new(), rec_t, *tables, scalars, **kw)
    if phase == "lanes":
        assert torch.equal(kd, pd)
        torch.testing.assert_close(ks, ps, rtol=2e-5, atol=1e-6)
    else:
        assert_topk_agree(ks.cpu().numpy(), kd.cpu().numpy(), ps.cpu().numpy(), pd.cpu().numpy())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_serving_on_cuda_matches_cpu():
    """The whole slice on the card against the same slice on the CPU (the
    plain versions): two fields with boosts, a latent delete, chunk 128; then
    slots20, and f32 without prefetch, on the card against f32 on the card,
    bit for bit."""
    _cuda()
    import dataclasses
    import random

    from probly_search_tpu_torch import Index, IndexConfig

    rng = random.Random(4)
    vocab = ["".join(rng.choice("abcdefg") for _ in range(rng.randint(2, 4))) for _ in range(90)]
    hot = ["hot%d" % i for i in range(4)]
    ix = Index(2, config=IndexConfig(chunk_size=128))
    texts = [
        [" ".join([rng.choice(hot)] + rng.sample(vocab, 3)) for _ in range(600)] for _ in range(2)
    ]
    ix.add_documents_columnar(list(range(600)), texts)
    ix.remove_document(9)
    window = [" ".join(rng.sample(vocab + hot, rng.randint(1, 3))) for _ in range(200)]
    window += ["hot0 hot1 hot2 hot3", "", "zzzz"]
    kw = dict(fields_boost=[1.5, 0.5], top_k=10)
    before = dict(fq.launches)
    dix = pdev.DeviceIndex(ix, device="cuda")
    got = dix.query_batch_async(window, bm25.new(), **kw).get_arrays()
    assert fq.launches["full"] > before["full"]
    cpu = pdev.DeviceIndex(ix, device="cpu")
    want = cpu.query_batch_async(window, bm25.new(), **kw).get_arrays()
    assert_topk_agree(got[0], got[1], want[0], want[1])
    dix.config = dataclasses.replace(ix.config, result_format="slots20")
    scores, slots, _keys = dix.query_batch_async(window, bm25.new(), **kw).get_arrays()
    assert scores is None
    np.testing.assert_array_equal(slots, got[1])
    # without the D2H copy started at submit, the drain copies synchronously
    dix.config = dataclasses.replace(ix.config, prefetch_results=False)
    scores, slots, _keys = dix.query_batch_async(window, bm25.new(), **kw).get_arrays()
    np.testing.assert_array_equal(slots, got[1])
    np.testing.assert_array_equal(scores, got[0])


@pytest.mark.cuda
def test_cuda_rejects_other_scorers():
    _cuda()
    rng = np.random.default_rng(0)
    rec, starts, lens = make_rec(rng)
    tables = make_tables(rng, starts, lens, 8, 3)
    args = to_torch([rec, *tables, np.array([6.5, 1.5], np.float32)], "cuda")

    class Custom:
        device_excludes_nonpositive = True

    with pytest.raises(NotImplementedError):
        fq.fused_query_topk(Custom(), *args, chunk=128, k=10, qterm_bits=QB, num_fields=1)
