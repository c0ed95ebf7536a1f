"""The CUDA kernels against their plain torch versions, on a CUDA device.

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

from probly_search_tpu_torch import bm25, zero_to_one
from probly_search_tpu_torch.index import device as pdev
from probly_search_tpu_torch.ops import fused_merge as fm
from probly_search_tpu_torch.ops import fused_query as fq
from probly_search_tpu_torch.ops import fused_z2o as fz
from probly_search_tpu_torch.ops import launch_probe as lp
from probly_search_tpu_torch.testing import assert_topk_agree

from .torch_util import QB, make_rec, make_tables, make_z2o_tables, merge_rows, to_torch


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


@pytest.mark.cuda
@pytest.mark.parametrize("C,NC,F", [(128, 6, 2), (1024, 8, 1)])
def test_z2o_kernel_matches_plain_on_cuda(C, NC, F):
    """K4 against its plain version; repeat runs bit-equal."""
    _cuda()
    rng = np.random.default_rng(C + NC + F)
    rec, starts, lens = make_rec(rng, F=F, n_docs=3000, n_terms=400, C=C)
    tables = to_torch(make_z2o_tables(rng, starts, lens, 64, NC, C=C), "cuda")
    rec_t = torch.from_numpy(rec).cuda()
    kw = dict(chunk=C, k=10, num_fields=F)
    before = fz.launches["fused_z2o"]
    ks, kd = fz.fused_z2o_topk(rec_t, *tables, **kw)
    ks2, kd2 = fz.fused_z2o_topk(rec_t, *tables, **kw)
    torch.cuda.synchronize()
    assert fz.launches["fused_z2o"] == before + 2
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2)
    ps, pd = fz.fused_z2o_topk_reference(rec_t, *tables, **kw)
    assert_topk_agree(ks.cpu().numpy(), kd.cpu().numpy(), ps.cpu().numpy(), pd.cpu().numpy())
    assert (kd >= 0).any()


@pytest.mark.cuda
def test_z2o_serving_on_cuda_matches_cpu():
    """Zero-to-one over a small two-field corpus with a latent delete: the
    window on the card (K4 on its fast classes, the lockstep program on
    shared-node queries) against the same window on the CPU."""
    _cuda()
    import random

    from probly_search_tpu_torch import Index, IndexConfig

    rng = random.Random(8)
    vocab = ["".join(rng.choice("abcdefg") for _ in range(rng.randint(1, 4))) for _ in range(80)]
    ix = Index(2, config=IndexConfig(chunk_size=128))
    texts = [[" ".join(rng.sample(vocab, n)) for _ in range(500)] for n in (3, 8)]
    ix.add_documents_columnar(list(range(500)), texts)
    ix.remove_document(11)
    window = [" ".join(rng.sample(vocab, rng.randint(1, 2))) for _ in range(120)]
    window += [f"{t} {t}" for t in vocab[:5]] + [vocab[5][:1], "", "zzzz"]
    before = dict(fz.launches)
    dix = pdev.DeviceIndex(ix, device="cuda")
    got = dix.query_batch_async(window, zero_to_one.new(), top_k=10).get_arrays()
    assert fz.launches["fused_z2o"] > before["fused_z2o"]
    cpu = pdev.DeviceIndex(ix, device="cpu")
    want = cpu.query_batch_async(window, zero_to_one.new(), top_k=10).get_arrays()
    assert_topk_agree(got[0], got[1], want[0], want[1])
    rows = ix.query_batch(window[:20], zero_to_one.new(), top_k=10)  # Index on "cuda"
    assert [[r.key for r in row] for row in rows] == [
        [int(k) for k, sl in zip(keys, slots) if sl >= 0] for keys, slots in zip(got[2][:20], got[1][:20])
    ]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,n_runs,run,excl,k",
    [
        (2, 3, 0, False, 10),  # a range class: L = 3072, one tile
        (1, 20, 0, False, 128),  # L = 20,480 > one tile: global stages
        (1, 256, 0, False, 128),  # L = 2^18: several top-k passes
        (24, 24, 1024, True, 10),  # the lanes merge after K3
        (4, 32, 1024, False, 128),
    ],
)
def test_merge_kernel_matches_plain_on_cuda(B, n_runs, run, excl, k):
    """K5 against its plain version; repeat runs bit-equal."""
    _cuda()
    rng = np.random.default_rng(B * 1000 + n_runs)
    key, val = merge_rows(rng, B, n_runs, 1024, excl, presorted=run > 0, n_docs=4096)
    kt, vt = to_torch([key, val], "cuda")
    before = fm.launches["merge_topk"]
    ks, kd = fm.merge_scores_topk_fused(kt, vt, k, QB, run=run, excl=excl, max_seg=n_runs)
    ks2, kd2 = fm.merge_scores_topk_fused(kt, vt, k, QB, run=run, excl=excl, max_seg=n_runs)
    torch.cuda.synchronize()
    assert fm.launches["merge_topk"] == before + 2
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2)
    ps, pd = fm.merge_scores_topk_fused_reference(kt, vt, k, QB, run=run, excl=excl)
    assert_topk_agree(ks.cpu().numpy(), kd.cpu().numpy(), ps.cpu().numpy(), pd.cpu().numpy())
    assert (kd >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 16])
def test_probe_matches_plain_on_cuda(n):
    """P1 against ``x + 1``, bit-equal, one launch per call."""
    _cuda()
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(lp.SHAPE).astype(np.float32)).cuda()
    before = lp.launches["probe_add"]
    got, want = x, x
    for _ in range(n):
        got = lp.probe_add(got)
        want = lp.probe_add_reference(want)
    torch.cuda.synchronize()
    assert lp.launches["probe_add"] == before + n
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_range_window_on_cuda_matches_cpu():
    """A window with term-range queries (range_min_expansions 4, chunk 128,
    two segments, a latent delete) on the card against the CPU: the range
    classes run the staged torch step and K5."""
    _cuda()
    import random

    from probly_search_tpu_torch import Index, IndexConfig

    rng = random.Random(6)
    vocab = ["aa" + "".join(rng.choice("bcde") for _ in range(j % 3 + 1)) for j in range(30)]
    vocab += ["zz%d" % j for j in range(10)]
    ix = Index(1, config=IndexConfig(chunk_size=128, range_min_expansions=4))
    for s in range(2):
        texts = [" ".join(rng.choice(vocab) for _ in range(rng.randint(2, 6))) for _ in range(300)]
        ix.add_documents_columnar(list(range(300 * s, 300 * (s + 1))), [texts])
        ix._flush_pending()
    ix.remove_document(17)
    window = ["aa", "a", "aab zz1", "zz2", "aa aab zz3", "zz4 zz5", "", "qq"] * 3
    before = fm.launches["merge_topk"]
    dix = pdev.DeviceIndex(ix, device="cuda")
    got = dix.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    assert fm.launches["merge_topk"] > before
    cpu = pdev.DeviceIndex(ix, device="cpu")
    want = cpu.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    assert_topk_agree(got[0], got[1], want[0], want[1])
