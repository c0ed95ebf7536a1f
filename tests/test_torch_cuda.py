"""The CUDA kernels against their plain torch versions, on a CUDA device.

Every test here needs a card and skips without one.  The file imports no JAX,
so it runs where only torch is installed:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

The cases of the section on several cards need two or four cards (``-k
"second_card or four_cards"``) and skip, naming the cards visible, on
fewer.  The last section's cases (``-k concurrent``) serve one engine from
several threads and streams at once.

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
from probly_search_tpu_torch.ops.fused_query import padded_rows
from probly_search_tpu_torch.ops import fused_z2o as fz
from probly_search_tpu_torch.ops import launch_probe as lp
from probly_search_tpu_torch.ops.fused_merge import key_bits_for
from probly_search_tpu_torch.testing import assert_topk_agree

from .torch_util import (
    QB, Z2O_EDGES, Z2O_ROW0_EDGES, kernel_case, make_rec, make_tables, make_z2o_tables,
    merge_edge_rows, merge_rows, to_torch, z2o_edge,
)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize(
    "C,NC", [(128, 6), (1024, 3), (1024, 16), (1024, 24), (256, 4), (256, 8), (256, 12)]
)
def test_kernel_matches_plain_on_cuda(F, C, NC):
    """C = 256 at NC 4, 8 and 12: the light classes' chunk width and chunk
    counts (IndexConfig.light_chunk_size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(C + NC + F)
    rec, starts, lens = make_rec(rng, F=F, n_docs=3000, n_terms=400, C=C)
    tables = to_torch(make_tables(rng, starts, lens, 64, NC, C=C), "cuda")
    rec_t = padded_rows(rec, "cuda")
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
@pytest.mark.parametrize("NC,k", [(6, 4097), (8, 5000), (16, 16384)])
def test_kernel_large_k_on_cuda(NC, k):
    """K1's full phase with k past what its shared memory holds (the top-k
    words in device scratch), up to k = L, against the plain version."""
    _cuda()
    rng = np.random.default_rng(NC + k)
    rec, starts, lens = make_rec(rng, n_docs=30_000, n_terms=400, C=1024)
    tables = to_torch(make_tables(rng, starts, lens, 16, NC, C=1024), "cuda")
    scalars = torch.tensor([6.5, 1.5], dtype=torch.float32, device="cuda")
    kw = dict(chunk=1024, k=k, qterm_bits=QB, num_fields=1)
    rec_t = padded_rows(rec, "cuda")
    ks, kd = fq.fused_query_topk(bm25.new(), rec_t, *tables, scalars, **kw)
    ks2, kd2 = fq.fused_query_topk(bm25.new(), rec_t, *tables, scalars, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2)
    ps, pd = fq.fused_query_topk_reference(bm25.new(), rec_t, *tables, scalars, **kw)
    assert_topk_agree(ks.cpu().numpy(), kd.cpu().numpy(), ps.cpu().numpy(), pd.cpu().numpy())


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
def test_serving_large_top_k_on_cuda_matches_cpu():
    """top_k past the fused kernel's shared-memory top-k buffer (5,000 over
    classes of 6-9 chunks of 1,024 lanes) on the card against the CPU."""
    _cuda()
    import random

    from probly_search_tpu_torch import Index

    rng = random.Random(5)
    vocab = ["w%03d" % i for i in range(300)]
    ix = Index(1)
    texts = [" ".join(["hot0", "hot1", "hot2"] + rng.sample(vocab, rng.randint(1, 6)))
             for _ in range(2500)]
    ix.add_documents_columnar(list(range(2500)), [texts])
    window = ["hot0 hot1 hot2", "hot0 w001", "hot1"]
    got = pdev.DeviceIndex(ix, device="cuda").query_batch_async(window, bm25.new(), top_k=5000)
    want = pdev.DeviceIndex(ix, device="cpu").query_batch_async(window, bm25.new(), top_k=5000)
    got, want = got.get_arrays(), want.get_arrays()
    assert_topk_agree(got[0], got[1], want[0], want[1])
    assert (got[1][0] >= 0).sum() == 2500


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["light", "per_class", "per_dispatch"])
def test_dispatch_modes_on_cuda_match_composed(mode):
    """A window served with light classes (chunk 256 beside 1,024), per-class
    dispatch or per-dispatch windows on the card: bit-equal to the composed
    window on the card (the same kernels on the same class tables; light
    classes sum the same postings in the same order), and to the CPU by the
    testing rule."""
    _cuda()
    import dataclasses
    import random

    from probly_search_tpu_torch import Index, IndexConfig

    rng = random.Random(7)
    vocab = [f"t{i:03d}" for i in range(60)]
    texts = [" ".join(rng.choice(vocab) for _ in range(5)) + " common" for _ in range(3000)]
    ix = Index(1, config=IndexConfig(result_format="f32"))
    ix.add_documents_columnar(list(range(3000)), [texts])
    window = [f"{vocab[i % 30]} {vocab[(i * 7) % 30]}" for i in range(200)]
    window += ["common", f"common {vocab[4]}", " ".join(vocab[:8]), "zzz", ""]
    cfg = {"light": dict(light_chunk_size=256), "per_class": dict(per_class_dispatch=True),
           "per_dispatch": dict(single_dispatch_windows=False)}[mode]
    dix = pdev.DeviceIndex(ix, device="cuda")
    want = dix.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    dix.config = dataclasses.replace(ix.config, **cfg)
    before = fq.launches["full"]
    got = dix.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    assert fq.launches["full"] > before
    if mode == "light":
        plan, _fb = dix.plan_batch(window, pdev.whitespace_tokenizer, bm25.new())
        assert 256 in {d[5] for d in dix.pack_dispatches(len(window), plan)}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    cpu = pdev.DeviceIndex(ix, device="cpu")
    cpu.config = dix.config
    c = cpu.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    assert_topk_agree(got[0], got[1], c[0], c[1])


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
    rec_t = padded_rows(rec, "cuda")  # the DeviceIndex layout
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
@pytest.mark.parametrize("kind", list(Z2O_EDGES))
def test_z2o_kernel_edges_on_cuda(kind):
    """K4 at its edges (tests/torch_util.z2o_edge): k = L = 8,192 with four
    fields (the top-k words in scratch), one live lane, a row of dead docs,
    alive docs whose postings all have tf 0 (score 0, returned), equal
    contributions (ties to the lowest doc, exactly as the plain version),
    doc slots near 2^26 (31 key bits), C = 128 over 64 chunks, C = 32 over
    256 (chunk tables read from device memory), C = 2 (scalar loads);
    against the plain version, repeat runs bit-equal."""
    _cuda()
    rec, tables, C, F, k, slots = z2o_edge(kind)
    rec_t = padded_rows(rec, "cuda")
    tables = to_torch(tables, "cuda")
    kw = dict(chunk=C, k=k, num_fields=F)
    key_bits = key_bits_for(slots, fz.DOC_SHIFT)
    ks, kd = fz.fused_z2o_topk(rec_t, *tables, **kw, key_bits=key_bits)
    ks2, kd2 = fz.fused_z2o_topk(rec_t, *tables, **kw, key_bits=key_bits)
    torch.cuda.synchronize()
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2)
    ps, pd = fz.fused_z2o_topk_reference(rec_t, *tables, **kw)
    assert_topk_agree(ks.cpu().numpy(), kd.cpu().numpy(), ps.cpu().numpy(), pd.cpu().numpy())
    # bit-equal where the sums are exact: every row of "ties", the edge row 0
    rows = slice(None) if kind == "ties" else 0 if kind in Z2O_ROW0_EDGES else None
    if rows is not None:
        assert torch.equal(kd[rows], pd[rows]) and torch.equal(ks[rows], ps[rows])
    assert (kd >= 0).any()


@pytest.mark.cuda
def test_z2o_kernel_refuses_unaligned_rec_on_cuda():
    _cuda()
    rng = np.random.default_rng(1)
    rec, starts, lens = make_rec(rng, F=1, C=128)
    tables = to_torch(make_z2o_tables(rng, starts, lens, 8, 2, C=128), "cuda")
    buf = torch.zeros((rec.shape[0], rec.shape[1] + 1), dtype=torch.int32, device="cuda")
    buf[:, 1:] = torch.from_numpy(rec).cuda()
    with pytest.raises(ValueError, match="16-B aligned"):
        fz.fused_z2o_topk(buf[:, 1:], *tables, chunk=128, k=10, num_fields=1)


@pytest.mark.cuda
def test_wide_lockstep_queries_run_on_cuda(monkeypatch):
    """Shared-node queries past 16,384 lockstep lanes replay a lockstep
    class graph on the card (no host row) and give the rows of the same
    program on the CPU (admitted there past ``CPU_LOCKSTEP_LANES``)."""
    _cuda()
    from probly_search_tpu_torch import Index
    from probly_search_tpu_torch.ops import z2o_device as pz
    from probly_search_tpu_torch.utils.tokenizers import whitespace_tokenizer

    monkeypatch.setattr(pz, "CPU_LOCKSTEP_LANES", 1 << 30)
    n = 20000
    titles = [f"abc{' abc' * (i % 3)} t{i % 7}" for i in range(n)]
    texts = [f"abcd u{i % 5}{' abc' * (i % 2)}" for i in range(n)]
    queries = ["abc abc", "abc t3 abc", "t1 u2", "abcd abc u1"]
    rows = []
    for device in ("cpu", "cuda"):
        ix = Index(2, device=device)
        ix.add_documents_columnar(list(range(n)), [titles, texts])
        dix = ix.device_index()
        nchunks = pz.plan_batch_z2o(dix, queries, whitespace_tokenizer)[3]
        assert (pz._bucket_vec(nchunks[:2], dix.nc_buckets, dix.nc_min) * dix.CHUNK * 2 > 16384).all()
        pending = pz.z2o_query_batch_async(dix, queries, whitespace_tokenizer, 10, fmt="f32")
        s, d, _ = pending.get_arrays(want_keys=False)
        assert not pending._host_rows
        rows.append((s, d))
    assert dix._class_graphs.captures > 0
    assert_topk_agree(*rows[0], *rows[1])


@pytest.mark.cuda
@pytest.mark.parametrize("NC", [17, 24, 32])
def test_lanes_kernel_matches_plain_on_cuda(NC):
    """K3 (phase "lanes") at NC 17, 24 and 32 over 1,024-lane chunks, with
    dead chunks, an empty row, alignment skips and trailing pads: keys
    bit-equal, scores within the tolerance."""
    _cuda()
    rng = np.random.default_rng(NC)
    rec, starts, lens = make_rec(rng, n_docs=3000, n_terms=400, C=1024)
    tables = to_torch(make_tables(rng, starts, lens, 40, NC, C=1024), "cuda")
    rec_t = padded_rows(rec, "cuda")
    scalars = torch.tensor([6.5, 1.5], dtype=torch.float32, device="cuda")
    kw = dict(chunk=1024, k=10, qterm_bits=QB, num_fields=1, phase="lanes")
    ks, kk = fq.fused_query_topk(bm25.new(), rec_t, *tables, scalars, **kw)
    torch.cuda.synchronize()
    ps, pk = fq.fused_query_topk_reference(bm25.new(), rec_t, *tables, scalars, **kw)
    assert torch.equal(kk, pk)
    torch.testing.assert_close(ks, ps, rtol=2e-5, atol=1e-6)
    assert (kk == -1).any() and (kk == 2**31 - 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("C,NC,align", [(2, 40, 1), (32, 70, 4)])
def test_lanes_kernel_narrow_chunks_on_cuda(C, NC, align):
    """K3 with chunks narrower than 4 lanes (scalar loads and stores) and of
    32 lanes, against the plain version: keys bit-equal."""
    _cuda()
    rng = np.random.default_rng(C)
    rec, starts, lens = make_rec(rng, F=2, n_docs=3000, n_terms=400, C=C)
    tables = to_torch(make_tables(rng, starts, lens, 24, NC, C=C, align=align), "cuda")
    rec_t = padded_rows(rec, "cuda")
    scalars = torch.tensor([6.5, 3.0, 1.5, 0.5], dtype=torch.float32, device="cuda")
    kw = dict(chunk=C, k=10, qterm_bits=QB, num_fields=2, phase="lanes")
    ks, kk = fq.fused_query_topk(bm25.new(), rec_t, *tables, scalars, **kw)
    torch.cuda.synchronize()
    ps, pk = fq.fused_query_topk_reference(bm25.new(), rec_t, *tables, scalars, **kw)
    assert torch.equal(kk, pk)
    torch.testing.assert_close(ks, ps, rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
def test_lanes_kernel_refuses_unaligned_rec_on_cuda():
    _cuda()
    rng = np.random.default_rng(2)
    rec, starts, lens = make_rec(rng, C=1024)
    tables = to_torch(make_tables(rng, starts, lens, 4, 17, C=1024), "cuda")
    buf = torch.zeros((rec.shape[0], rec.shape[1] + 1), dtype=torch.int32, device="cuda")
    buf[:, 1:] = torch.from_numpy(rec).cuda()
    scalars = torch.tensor([6.5, 1.5], dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="16-B aligned"):
        fq.fused_query_topk(bm25.new(), buf[:, 1:], *tables, scalars, chunk=1024, k=10,
                            qterm_bits=QB, num_fields=1, phase="lanes")


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


def _edge_len(L):
    """Lane counts at the K5 paths' edge: the block cap and one past it."""
    if isinstance(L, int):
        return L
    return fm.TILE_LANES + 1 if L.endswith("+1") else fm.TILE_LANES


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,B,L,k,key_bits",
    [
        ("random", 1, 1, 1, 31),
        ("random", 2, "block", 10, 31),
        ("random", 2, "block+1", 128, 31),
        ("random", 1, 32768, 10, 31),
        ("random", 1, 32769, 128, 24),
        ("random", 1, 300_000, 300, 31),
        ("ties", 2, 4096, 10, 31),
        ("ties", 1, 40_000, 128, 31),
        ("ties", 1, 600_000, 128, 31),
        ("pads", 2, 3000, 10, 31),
        ("pads", 1, 600_000, 10, 31),
        ("one", 2, 5000, 10, 31),
        ("one", 1, 50_000, 10, 31),
        ("few", 2, 600_000, 10, 24),
        ("high", 2, 20_000, 128, 31),
        ("high", 1, 600_000, 10, 31),
    ],
)
def test_merge_kernel_edges_on_cuda(kind, B, L, k, key_bits):
    """K5 at its paths' edges against the plain version, repeat runs
    bit-equal, one launch counted per call."""
    _cuda()
    L = _edge_len(L)
    rng = np.random.default_rng(L + k)
    key, val = merge_edge_rows(rng, kind, B, L)
    if key_bits < 31:
        assert int(key.max(where=key != 2**31 - 1, initial=0)) < 1 << key_bits
    kt, vt = to_torch([key, val], "cuda")
    before = fm.launches["merge_topk"]
    ks, kd = fm.merge_scores_topk_fused(kt, vt, k, QB, key_bits=key_bits)
    ks2, kd2 = fm.merge_scores_topk_fused(kt, vt, k, QB, key_bits=key_bits)
    torch.cuda.synchronize()
    assert fm.launches["merge_topk"] == before + 2
    assert torch.equal(ks, ks2) and torch.equal(kd, kd2)
    ps, pd = fm.merge_scores_topk_fused_reference(kt, vt, k, QB)
    assert_topk_agree(ks.cpu().numpy(), kd.cpu().numpy(), ps.cpu().numpy(), pd.cpu().numpy())
    assert bool((kd >= 0).any()) == (kind != "pads")


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
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset_4B"])
@pytest.mark.parametrize("n", [1, 3, 4096, 4099, 1 << 20])
def test_probe_sizes_on_cuda(n, offset):
    """P1 at sizes with and without a tail of n % 4 floats, and on a view
    whose pointer is 4 B past a 16-B boundary (the scalar kernel):
    bit-equal to ``x + 1``, one launch a call."""
    _cuda()
    buf = np.random.default_rng(n).standard_normal(n + 1).astype(np.float32)
    buf = torch.from_numpy(buf).cuda()
    x = buf[offset : offset + n]
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    before = lp.launches["probe_add"]
    got = lp.probe_add(x)
    torch.cuda.synchronize()
    assert lp.launches["probe_add"] == before + 1
    assert torch.equal(got, lp.probe_add_reference(x))


@pytest.mark.cuda
def test_pruned_window_on_cuda_matches_unpruned():
    """Block-max pruning on the card: a window whose pruned plan splits a
    job in the middle (two kept-chunk runs: the second starts at its
    128-aligned chunk base) and drops whole jobs (zero-length rows in the
    packed job tables), served with pruning on and off: bit-equal rows, and
    equal to the CPU's pruned rows."""
    _cuda()
    from probly_search_tpu_torch import Index, IndexConfig
    from probly_search_tpu_torch.utils.metrics import metrics

    ix = Index(1, config=IndexConfig(chunk_size=128, result_format="f32"))
    ix.add_documents_columnar(list(range(600)), [[
        "common common common common" if (i < 5 or i >= 595)
        else f"common f{i % 97} g{i % 89} h{i % 83} j{i % 79}"
        for i in range(600)
    ]])
    window = ["common", "f1 common", "g2 h3", "zzz", "common f1"] * 4
    dix = pdev.DeviceIndex(ix, device="cuda")
    plan, _ = dix.plan_batch(window, pdev.whitespace_tokenizer, bm25.new())
    pruned = dix.prune(plan, bm25.new(), 3, [1.0])
    assert pruned.njobs[0] == plan.njobs[0] + 1, "the job of 'common' splits"
    assert (pruned.njobs[1:] < plan.njobs[1:]).any(), "whole jobs drop"
    split = pruned.words[pruned.jquery == 0]
    assert split[1, 0] % 128 == 0 and split[1, 0] > split[0, 0]
    before = metrics.counters.get("prune/pruned_chunks", 0)
    launches = fq.launches["full"]
    on = dix.query_batch_async(window, bm25.new(), top_k=3).get_arrays()
    assert metrics.counters.get("prune/pruned_chunks", 0) > before
    assert fq.launches["full"] > launches
    ix.config.prune_blocks = False
    try:
        off = dix.query_batch_async(window, bm25.new(), top_k=3).get_arrays()
    finally:
        ix.config.prune_blocks = True
    np.testing.assert_array_equal(on[1], off[1])
    np.testing.assert_array_equal(on[0], off[0])
    cpu = pdev.DeviceIndex(ix, device="cpu")
    cpu = cpu.query_batch_async(window, bm25.new(), top_k=3).get_arrays()
    assert_topk_agree(on[0], on[1], cpu[0], cpu[1])


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


def _sharded_corpus():
    """One field, chunk 128, 4,097 docs (shard 0's largest local slot a
    power of two on 4 shards), latent deletes, 16 tie docs over every shard;
    a window with every class kind on 4 shards: K1 classes, a class past
    16,384 lanes a shard (``p``: K3 + K5), term-range classes (200
    expansions: ``q``, ``q01 a``), a host-fallback query (nine terms)."""
    import random

    from probly_search_tpu_torch import Index, IndexConfig

    rng = random.Random(8)
    vocab = ["".join(rng.choice("abcdef") for _ in range(rng.randint(1, 4))) for _ in range(120)]
    n = 4 * 1024 + 1
    texts = [
        "tie" if i < 8 or i >= n - 8 else
        f"p{(i // 4) % 150:03d} q{i % 400:04d} "
        + " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 6)))
        for i in range(n)
    ]
    ix = Index(1, config=IndexConfig(chunk_size=128, range_min_expansions=200, max_query_terms=8))
    ix.add_documents_columnar(list(range(n)), [texts])
    for key in range(30, n, 101):
        ix.remove_document(key)
    window = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(200)]
    window += ["p", "p01", "q", "q01 a", "tie", "a", "b", "", "zzz", " ".join(vocab[:9])]
    return ix, window


@pytest.mark.cuda
@pytest.mark.parametrize("data,docs", [(1, 4), (2, 2)])
def test_sharded_window_on_cuda_matches_single_device(data, docs):
    """A doc-sharded window on ``cuda:0`` x 4 (every class kind: K1 classes,
    a K3 + K5 class past 16,384 lanes, term-range classes, a fallback query,
    ties across shards) against the single-device engine on the card, with
    each shard's merge keys at its own width (shard 0's largest local slot
    is a power of two); and a zero-to-one window (K4 and the lockstep
    program) the same way."""
    _cuda()
    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.ops import z2o_device as pz
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex

    ix, window = _sharded_corpus()
    sdix = ShardedDeviceIndex(ix, make_mesh(data, docs, devices=["cuda:0"] * 4))
    assert sdix.key_bits[0] == sdix.key_bits[1] + 1
    planned, fallback = sdix.plan_batch(window, pdev.whitespace_tokenizer, bm25.new())
    specs = sdix._pack_window(planned, len(window))[0]
    assert fallback and any(rng for *_s, rng in specs) and max(s[3] for s in specs) * 128 > 16384
    before = dict(fq.launches), dict(fm.launches)
    got = sdix.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    assert fq.launches["full"] > before[0]["full"] and fq.launches["lanes"] > before[0]["lanes"]
    assert fm.launches["merge_topk"] > before[1]["merge_topk"]
    want = pdev.DeviceIndex(ix, device="cuda").query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    assert_topk_agree(got[0], got[1], want[0], want[1])
    z2o_window = window[:100] + ["a a", "ab a b"]
    before = fz.launches["fused_z2o"]
    got = sdix.query_batch_z2o(z2o_window, top_k=10).get_arrays()
    assert fz.launches["fused_z2o"] > before
    dix = pdev.DeviceIndex(ix, device="cuda")
    want = pz.z2o_query_batch_async(dix, z2o_window, pdev.whitespace_tokenizer, 10, fmt="f32").get_arrays()
    assert_topk_agree(got[0], got[1], want[0], want[1])


def _launch_counts():
    return [dict(c) for c in pdev._launch_counters()]


def _serve_counted(dix, window, scorer, **kw):
    """One window's arrays and the launch counts it moved, per counter."""
    before = _launch_counts()
    out = dix.query_batch_async(window, scorer, **kw).get_arrays()
    torch.cuda.synchronize()
    moved = [{key: n - was.get(key, 0) for key, n in c.items() if n != was.get(key, 0)}
             for c, was in zip(pdev._launch_counters(), before)]
    return out, moved


def _class_graph_corpus():
    """Two fields, chunk 128, a latent delete: K1 classes, a class past
    16,384 lanes (K3 + K5), term-range classes (range_min_expansions 4),
    shared-node zero-to-one queries (the lockstep program) and fast classes
    past K4's 8,192 lanes (the staged program)."""
    import random

    from probly_search_tpu_torch import Index, IndexConfig

    rng = random.Random(12)
    vocab = ["aa" + "".join(rng.choice("bcde") for _ in range(j % 3 + 1)) for j in range(30)]
    vocab += ["".join(rng.choice("fghij") for _ in range(rng.randint(2, 4))) for _ in range(60)]
    n = 20_000
    ix = Index(2, config=IndexConfig(chunk_size=128, range_min_expansions=4, result_format="f32"))
    texts = [[("common " if i % 10 else "") + " ".join(rng.sample(vocab, 3)) for i in range(n)],
             [" ".join(rng.sample(vocab, 2)) + (" common" if i % 7 == 0 else "") for i in range(n)]]
    ix.add_documents_columnar(list(range(n)), texts)
    ix.remove_document(17)
    window = [" ".join(rng.sample(vocab, rng.randint(1, 3))) for _ in range(300)]
    window += ["common", "common " + vocab[40], "aa", "aab " + vocab[41], "", "zzz"]
    return ix, window, vocab


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["composed", "per_class", "per_dispatch", "range", "tfboost"])
def test_class_graphs_match_eager_on_cuda(mode):
    """Windows without a frozen template replay cached class graphs: rows
    bit-equal (f32 scores and slots) to the same class steps run eagerly
    (``EagerClasses``), and every launch counter moved as the eager window
    moves it, on the capturing window and on a replayed one; the second
    window captures nothing."""
    _cuda()
    import dataclasses

    from probly_search_tpu_torch.utils.metrics import metrics

    from .torch_util import EagerClasses, TfBoost

    ix, window, _vocab = _class_graph_corpus()
    cfg = {"composed": dict(template_compositions=False),
           "per_class": dict(per_class_dispatch=True),
           "per_dispatch": dict(single_dispatch_windows=False),
           "range": dict(), "tfboost": dict()}[mode]
    scorer = TfBoost() if mode == "tfboost" else bm25.new()
    if mode != "range":
        window = [q for q in window if not q.startswith("aa")]
    graphs, eager = pdev.DeviceIndex(ix, device="cuda"), pdev.DeviceIndex(ix, device="cuda")
    eager._class_graphs = EagerClasses(eager.device)
    for d in (graphs, eager):
        d.config = dataclasses.replace(ix.config, **cfg)
    want, want_moved = _serve_counted(eager, window, scorer, top_k=10)
    metrics.reset()
    for turn in range(2):
        got, moved = _serve_counted(graphs, window, scorer, top_k=10)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert moved == want_moved, (turn, moved, want_moved)
        ctr = metrics.counters
        assert ctr["class_graph_captures"] == len(graphs._class_graphs) > 0
        assert ctr["class_graph_replays"] == (turn + 1) * len(eager._class_graphs.windows[0])
    assert set(graphs._class_graphs.keys()) == set(eager._class_graphs.keys())
    assert any(want_moved), want_moved
    if mode == "range":
        assert any(k.use_ranges for k in graphs._class_graphs.keys())
        assert want_moved[2].get("merge_topk")
    if mode == "tfboost":
        assert not want_moved[0] and want_moved[2].get("merge_topk")
    cpu = pdev.DeviceIndex(ix, device="cpu")
    cpu.config = graphs.config
    c = cpu.query_batch_async(window, scorer, top_k=10).get_arrays()
    assert_topk_agree(got[0], got[1], c[0], c[1])


@pytest.mark.cuda
def test_z2o_class_graphs_match_eager_on_cuda():
    """A zero-to-one window with K4 classes, staged classes (fast classes
    past 8,192 lanes) and lockstep classes, replayed from class graphs:
    packed rows bit-equal to the eager class steps, K4's and both torch
    programs' launch counts equal to the eager window's."""
    _cuda()
    from probly_search_tpu_torch.ops import z2o_device as pz

    from .torch_util import EagerClasses

    ix, window, vocab = _class_graph_corpus()
    window = [q for q in window if not q.startswith("aa")] + [f"{t} {t}" for t in vocab[30:36]]
    graphs, eager = pdev.DeviceIndex(ix, device="cuda"), pdev.DeviceIndex(ix, device="cuda")
    eager._class_graphs = EagerClasses(eager.device)
    want, want_moved = _serve_counted(eager, window, zero_to_one.new(), top_k=10)
    assert want_moved[4].get("fused_z2o") and want_moved[5].get("z2o_staged") \
        and want_moved[5].get("z2o_lockstep"), want_moved
    for _turn in range(2):
        got, moved = _serve_counted(graphs, window, zero_to_one.new(), top_k=10)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert moved == want_moved
    assert {type(k) for k in graphs._class_graphs.keys()} == {pz.Z2OClassKey}
    cpu = pdev.DeviceIndex(ix, device="cpu")
    c = cpu.query_batch_async(window, zero_to_one.new(), top_k=10).get_arrays()
    assert_topk_agree(got[0], got[1], c[0], c[1])


@pytest.mark.cuda
def test_class_graphs_capture_only_new_keys_on_cuda():
    """A second window of another composition (half the first window's
    queries, plus queries of a new class shape) captures only the keys the
    first window did not, and replays the rest."""
    _cuda()
    from probly_search_tpu_torch.utils.metrics import metrics

    ix, window, vocab = _class_graph_corpus()
    dix = pdev.DeviceIndex(ix, device="cuda")
    dix.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    first = set(dix._class_graphs.keys())
    second = window[::2] + [" ".join(vocab[30:45])]
    metrics.reset()
    got = dix.query_batch_async(second, bm25.new(), top_k=10).get_arrays()
    new = set(dix._class_graphs.keys()) - first
    assert new and metrics.counters["class_graph_captures"] == len(new)
    cpu = pdev.DeviceIndex(ix, device="cpu").query_batch_async(second, bm25.new(), top_k=10)
    c = cpu.get_arrays()
    assert_topk_agree(got[0], got[1], c[0], c[1])


@pytest.mark.cuda
def test_class_graphs_replay_out_of_capture_order_on_cuda():
    """The shared pool: a window's classes (range classes with K5's
    scratch, a K3 + K5 class, K1 classes; several classes share a key, so
    one graph replays more than once a window) captured in one order and
    replayed in the reverse order, twice, each class's rows equal to its
    eager step's: no replay clobbers an output copied out before it."""
    _cuda()
    from probly_search_tpu_torch.index.device import composed_class_specs

    ix, window, _vocab = _class_graph_corpus()
    dix = pdev.DeviceIndex(ix, device="cuda")
    plan, _fb = dix.plan_batch(window, pdev.whitespace_tokenizer, bm25.new())
    dispatches = dix.pack_dispatches(len(window), plan)
    specs = composed_class_specs(dispatches)
    assert any(s[4] for s in specs) and any(s[3] * s[5] > pdev._FUSED_MAX_LANES for s in specs)
    words = np.concatenate([d[1].reshape(-1) for d in dispatches] + [np.ones(2, np.float32).view(np.int32)])
    classes = dix._graph_classes(bm25.new(), 10, "parts", specs, dix._pinned(words),
                                 dix._aux_rec(bm25.new()))
    want = [tuple(t.clone() for t in make()(torch.cat([p.cuda() for p in pieces])))
            for _key, make, pieces in classes]
    first = dix._class_graphs.run(classes)
    for turn in range(2):
        got = dix._class_graphs.run(classes[::-1])[::-1]
        torch.cuda.synchronize()
        for (s, d), (ws, wd), (fs, fd) in zip(got, want, first):
            assert torch.equal(s, ws) and torch.equal(d, wd), turn
            assert torch.equal(s, fs) and torch.equal(d, fd), turn
    assert len(dix._class_graphs) == len({key for key, _m, _p in classes}) < len(classes)
    assert dix._class_graphs.pool_bytes > 0


def _sharded_served(sdix, window, scorer):
    """One sharded window of ``scorer`` (None: zero-to-one): its handle,
    arrays and the launch counts it moved, per counter."""
    before = _launch_counts()
    if scorer is None:
        h = sdix.query_batch_z2o(window, top_k=10)
    else:
        h = sdix.query_batch_async(window, scorer, top_k=10)
    out = h.get_arrays()
    torch.cuda.synchronize()
    moved = [{key: n - was.get(key, 0) for key, n in c.items() if n != was.get(key, 0)}
             for c, was in zip(pdev._launch_counters(), before)]
    return h, out, moved


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bm25", "tfboost", "z2o"])
@pytest.mark.parametrize("data,docs", [(1, 4), (2, 2)])
def test_sharded_class_graphs_match_eager_on_cuda(data, docs, kind):
    """Sharded windows on ``cuda:0`` x 4 replay one cached graph per (group,
    class): packed rows bit-equal to the same group steps run eagerly
    (``EagerClasses``) and to the eager cells (no caches), every launch
    counter moved as the eager window moves it, on the capturing window and
    on a replayed one; BM25 with K1, K3 + K5 and range classes, TfBoost
    (staged lanes + K5), zero-to-one with K4, staged and lockstep
    classes."""
    _cuda()
    import dataclasses

    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex
    from probly_search_tpu_torch.utils.metrics import metrics

    from .torch_util import EagerClasses, TfBoost

    ix, window = _sharded_corpus()
    ix.config = dataclasses.replace(ix.config, result_format="f32")
    mesh = make_mesh(data, docs, devices=["cuda:0"] * 4)
    scorer = {"bm25": bm25.new(), "tfboost": TfBoost(), "z2o": None}[kind]
    if kind == "z2o":
        window = window[:100] + ["p", "a a", "ab a b"]
    graphs, eager, cells = (ShardedDeviceIndex(ix, mesh) for _ in range(3))
    eager._class_graphs = {dev: EagerClasses(dev) for dev in eager._class_graphs}
    cells._class_graphs = None
    want_h, want, want_moved = _sharded_served(eager, window, scorer)
    plain_h, plain, plain_moved = _sharded_served(cells, window, scorer)
    (runs,) = [g.windows for g in eager._class_graphs.values()]
    metrics.reset()
    for turn in range(2):
        got_h, got, moved = _sharded_served(graphs, window, scorer)
        for a, b, c in zip(got, want, plain):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        for rows_g, rows_w, rows_p in zip(got_h._packed, want_h._packed, plain_h._packed):
            for a, b, c in zip(rows_g, rows_w, rows_p):
                assert torch.equal(a, b) and torch.equal(a, c), turn
        assert moved == want_moved == plain_moved, (turn, moved, want_moved, plain_moved)
        (cache,) = graphs._class_graphs.values()
        ctr = metrics.counters
        assert ctr["class_graph_captures"] == len(cache) > 0
        assert ctr["class_graph_replays"] == (turn + 1) * sum(len(run) for run in runs)
    keys = set(cache.keys())
    assert keys == {key for run in runs for key in run}
    assert all(key.shards == tuple(range(docs)) for key in keys)
    if kind == "bm25":
        assert any(key.use_ranges for key in keys)
        assert want_moved[0].get("full") and want_moved[0].get("lanes")
        assert want_moved[2].get("merge_topk")
    elif kind == "tfboost":
        assert not want_moved[0] and want_moved[2].get("merge_topk")
    else:
        assert want_moved[4].get("fused_z2o") and want_moved[5].get("z2o_staged") \
            and want_moved[5].get("z2o_lockstep"), want_moved
        assert {key.fast for key in keys} == {True, False}


@pytest.mark.cuda
def test_sharded_class_graphs_capture_only_new_keys_on_cuda():
    """Mesh (2, 2) on one card: the two data rows share the card's graphs
    (the second row captures nothing); a second window of another
    composition captures only the keys the first did not."""
    _cuda()
    import dataclasses

    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex
    from probly_search_tpu_torch.utils.metrics import metrics

    ix, window = _sharded_corpus()
    sdix = ShardedDeviceIndex(ix, make_mesh(2, 2, devices=["cuda:0"] * 4))
    sdix.config = dataclasses.replace(ix.config, prune_blocks=False)  # the window packs `specs`
    planned, _fb = sdix.plan_batch(window, pdev.whitespace_tokenizer, bm25.new())
    specs = sdix._pack_window(planned, len(window))[0]
    metrics.reset()
    sdix.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    (cache,) = sdix._class_graphs.values()
    first = set(cache.keys())
    assert metrics.counters["class_graph_captures"] == len(first)
    assert metrics.counters["class_graph_replays"] == 2 * len(specs)  # a class a data row
    second = window[::2] + ["p"]
    metrics.reset()
    got = sdix.query_batch_async(second, bm25.new(), top_k=10).get_arrays()
    new = set(cache.keys()) - first
    assert new and metrics.counters["class_graph_captures"] == len(new)
    want = pdev.DeviceIndex(ix, device="cuda").query_batch_async(second, bm25.new(), top_k=10)
    c = want.get_arrays()
    assert_topk_agree(got[0], got[1], c[0], c[1])


@pytest.mark.cuda
def test_sharded_class_graphs_replay_out_of_capture_order_on_cuda():
    """The card's shared pool: a group's classes (K1 classes, a K3 + K5
    class, range classes) captured in one order and replayed in the reverse
    order, twice, each class's outputs equal to its eager step's."""
    _cuda()
    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex

    ix, window = _sharded_corpus()
    sdix = ShardedDeviceIndex(ix, make_mesh(1, 4, devices=["cuda:0"] * 4))
    planned, _fb = sdix.plan_batch(window, pdev.whitespace_tokenizer, bm25.new())
    specs, _layout, buf = sdix._pack_window(planned, len(window))
    assert any(s[4] for s in specs) and any(s[3] * 128 > pdev._FUSED_MAX_LANES for s in specs)
    ((dev, shards),) = sdix._groups[0]
    classes = sdix._bm25_classes(
        bm25.new(), specs, buf, np.ones(1, np.float32).view(np.int32), sdix._aux_rec(bm25.new()),
        10, 0, dev, shards,
    )
    want = [tuple(t.clone() for t in make()(torch.cat([p.cuda() for p in pieces])))
            for _key, make, pieces in classes]
    cache = sdix._class_graphs[dev]
    first = cache.run(classes)
    for turn in range(2):
        got = cache.run(classes[::-1])[::-1]
        torch.cuda.synchronize()
        for (s, d), (ws, wd), (fs, fd) in zip(got, want, first):
            assert torch.equal(s, ws) and torch.equal(d, wd), turn
            assert torch.equal(s, fs) and torch.equal(d, fd), turn
    assert len(cache) == len({key for key, _m, _p in classes}) and cache.pool_bytes > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_class_graphs_free_with_their_snapshot_on_cuda(sharded):
    """A snapshot's class graphs keep their steps, which hold the
    snapshot's tensors and not the snapshot: with the collector off,
    dropping a DeviceIndex or ShardedDeviceIndex whose windows captured
    graphs (a range class among them) frees it and returns the card's
    allocated memory to what it was before (a first round warms the
    kernels' build and the allocator)."""
    _cuda()
    import gc
    import weakref

    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex

    ix, window = _sharded_corpus()

    def snapshot():
        if sharded:
            return ShardedDeviceIndex(ix, make_mesh(1, 4, devices=["cuda:0"] * 4))
        return pdev.DeviceIndex(ix, device="cuda")

    d = snapshot()
    d.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    del d
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gc.disable()
    try:
        d = snapshot()
        d.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
        caches = list(d._class_graphs.values()) if sharded else [d._class_graphs]
        assert all(len(c) for c in caches) and any(
            key.use_ranges for c in caches for key in c.keys())
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() > base
        ref = weakref.ref(d)
        del d, caches
        torch.cuda.synchronize()
        assert ref() is None
        assert torch.cuda.memory_allocated() == base
    finally:
        gc.enable()


# --------------------------------------------------------------------- #
# several cards: each engine and kernel wrapper keeps to its own card     #
# --------------------------------------------------------------------- #


def _cards(n):
    """Skip unless at least ``n`` CUDA devices are visible."""
    _cuda()
    have = torch.cuda.device_count()
    if have < n:
        pytest.skip(f"needs {n} CUDA devices, {have} visible")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["K1", "K3", "K4", "K5", "P1"])
def test_kernel_on_second_card_keeps_current_device_on_cuda(name):
    """A launch on ``cuda:1`` from a thread whose current device is
    ``cuda:0`` leaves ``torch.cuda.current_device()`` at 0 (the C entries
    select their device for the call only), and agrees with the plain
    version; the same launch inside a capture on a side stream of
    ``cuda:1`` is recorded in that card's graph: a replay rewrites the
    outputs (filled with a sentinel after the capture) with the eager
    launch's values, bit for bit, and the current device is 1 inside the
    capture and 0 after it."""
    _cards(2)
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    inputs, kernel, plain, (counter, key) = kernel_case(name, dev)
    before = counter[key]
    got = kernel(*inputs)
    assert torch.cuda.current_device() == 0
    assert counter[key] == before + 1
    torch.cuda.synchronize(dev)
    want = plain(*inputs)
    if name == "P1":
        assert torch.equal(got[0], want[0])
    elif name == "K3":
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=1e-6)
    else:
        assert_topk_agree(*(t.cpu().numpy() for t in (*got, *want)))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        g.capture_begin(capture_error_mode="relaxed")
        try:
            out = kernel(*inputs)
            inside = torch.cuda.current_device()
        finally:
            g.capture_end()
    assert inside == 1 and torch.cuda.current_device() == 0
    for t in out:
        t.fill_(-7)
    g.replay()
    torch.cuda.synchronize(dev)
    for a, b in zip(out, got):
        assert torch.equal(a, b)
    assert torch.cuda.current_device() == 0


def _template_corpus():
    """One field, chunk 128, 20,000 docs, every one holding ``all`` (a
    class past 16,384 lanes: K3 + K5) and a window of one template (no
    term-range query): ``tests/test_torch_templates.py``'s corpus."""
    import random

    from probly_search_tpu_torch import Index, IndexConfig

    rng = random.Random(5)
    vocab = ["w%03d" % i for i in range(400)]
    texts = [" ".join(["all"] + [rng.choice(vocab) for _ in range(rng.randint(1, 6))])
             for _ in range(20000)]
    window = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(60)]
    window += ["all", "all w001", "all w002 w003", "zzz", ""]
    ix = Index(1, config=IndexConfig(chunk_size=128, result_format="f32"))
    ix.add_documents_columnar(list(range(len(texts))), [texts])
    return ix, window


@pytest.mark.cuda
def test_capture_span_counts_every_graph_capture_on_cuda(tmp_path):
    """``query/capture`` opens once a capture: a template's in ``prewarm``
    and each class graph of a window of new class shapes (no template: a
    window of another length), inside ``query/dispatch``."""
    _cuda()
    from probly_search_tpu_torch.utils.metrics import metrics

    ix, window = _template_corpus()
    dix, _p = _prewarmed(ix, window, tmp_path)
    metrics.reset()
    assert dix.prewarm(bm25.new()) == 1
    dix.query_batch_async(window[:30] + ["all w004 w005"], bm25.new(), top_k=10).get_arrays()
    c, h = metrics.counters, metrics.snapshot()["histograms"]
    assert c["template_graph_captures"] == 1 and c["class_graph_captures"] >= 1
    assert h["query/capture"]["count"] == c["class_graph_captures"] + c["template_graph_captures"]
    assert h["query/capture"]["items"] == h["query/capture"]["count"]
    dispatch = h["query/dispatch"]
    assert dispatch["self_us"] < dispatch["count"] * dispatch["mean_us"]  # the captures nest in it


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["class_graphs", "template"])
def test_device_index_on_second_card_matches_first_on_cuda(path, tmp_path):
    """A ``DeviceIndex`` on ``cuda:1`` serves bit-equal to one on ``cuda:0``
    (f32 scores and slots), two windows of one composition in turns, and
    every window launches K1 (a replay counts its graph's launches): on the
    class graphs (with a zero-to-one window: K4 and both torch programs),
    and on a template's graph after ``prewarm`` (``cuda:0`` prewarmed
    first, so torch's shared capture stream, were it used, would live
    there).  The current device stays 0."""
    _cards(2)
    torch.cuda.set_device(0)
    from probly_search_tpu_torch.utils.metrics import metrics

    if path == "template":
        ix, window = _template_corpus()
    else:
        ix, window, vocab = _class_graph_corpus()
    windows = [window, window[::-1]]
    devs = ("cuda:0", "cuda:1")
    dixs = [pdev.DeviceIndex(ix, device=d) for d in devs]
    if path == "template":
        src = pdev.DeviceIndex(ix, device="cuda:0")
        src.query_batch_async(windows[0], bm25.new(), top_k=10).get_arrays()
        p = str(tmp_path / "t.json")
        assert src.save_templates(p) == 1
        for d in dixs:
            assert d.load_templates(p) == 1 and d.prewarm(bm25.new()) == 1
            assert torch.cuda.current_device() == 0
    for turn in range(4):
        outs = []
        for d in dixs:
            replays = metrics.counters.get("template_graph_replays", 0)
            out, moved = _serve_counted(d, windows[turn % 2], bm25.new(), top_k=10)
            assert moved[0].get("full"), moved
            if path == "template":
                assert metrics.counters.get("template_graph_replays", 0) == replays + 1
            outs.append((out, moved))
            assert torch.cuda.current_device() == 0
        (a, ma), (b, mb) = outs
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert ma[:6] == mb[:6] and _by_card(ma) == {0: _by_card(mb)[1]}, (ma, mb)
    if path == "class_graphs":
        z2o = window + [f"{t} {t}" for t in vocab[30:36]]
        (a, ma), (b, mb) = (_serve_counted(d, z2o, zero_to_one.new(), top_k=10) for d in dixs)
        assert mb[4].get("fused_z2o") and mb[5].get("z2o_lockstep") and ma[:6] == mb[:6], mb
        assert _by_card(ma) == {0: _by_card(mb)[1]}, (ma, mb)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert all(len(d._class_graphs) for d in dixs)
    cpu = pdev.DeviceIndex(ix, device="cpu")
    c = cpu.query_batch_async(windows[1], bm25.new(), top_k=10).get_arrays()
    got = dixs[1].query_batch_async(windows[1], bm25.new(), top_k=10).get_arrays()
    assert_topk_agree(got[0], got[1], c[0], c[1])


def _four_cards():
    return [torch.device("cuda", i) for i in range(4)]


def _by_card(moved):
    """The per-card launch counts of ``moved`` (``_serve_counted``,
    ``_sharded_served``) as {card index: {kernel: n}}."""
    out = {}
    for counts in moved[6:]:
        for key, n in counts.items():
            name, card = key.split("@cuda:")
            out.setdefault(int(card), {})[name] = n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bm25", "tfboost", "z2o"])
@pytest.mark.parametrize("data,docs", [(1, 4), (2, 2)])
def test_sharded_windows_over_four_cards_match_one_card_on_cuda(data, docs, kind):
    """The sharded engine on a mesh over four distinct cards against the
    same mesh on ``cuda:0`` x 4: packed rows bit-equal and every launch
    counter moved alike, on the capturing window and a replayed one (BM25
    with K1, K3 + K5 and range classes; TfBoost; zero-to-one with K4,
    staged and lockstep classes).  Each card keeps its own class graphs:
    one group a card (one shard), its keys naming that shard, the second
    window capturing nothing; the current device stays 0."""
    _cards(4)
    torch.cuda.set_device(0)
    import dataclasses

    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex
    from probly_search_tpu_torch.utils.metrics import metrics

    from .torch_util import TfBoost

    ix, window = _sharded_corpus()
    ix.config = dataclasses.replace(ix.config, result_format="f32")
    scorer = {"bm25": bm25.new(), "tfboost": TfBoost(), "z2o": None}[kind]
    if kind == "z2o":
        window = window[:100] + ["p", "a a", "ab a b"]
    one = ShardedDeviceIndex(ix, make_mesh(data, docs, devices=["cuda:0"] * 4))
    four = ShardedDeviceIndex(ix, make_mesh(data, docs))
    assert list(four._class_graphs) == _four_cards()
    assert all(len(groups) == docs for groups in four._groups)
    want_h, want, want_moved = _sharded_served(one, window, scorer)
    metrics.reset()
    for turn in range(2):
        got_h, got, moved = _sharded_served(four, window, scorer)
        assert torch.cuda.current_device() == 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for rows_g, rows_w in zip(got_h._packed, want_h._packed):
            for d, (a, b) in enumerate(zip(rows_g, rows_w)):
                assert a.device == four.mesh.devices[d, 0]
                assert torch.equal(a.cpu(), b.cpu()), turn
        assert moved[:6] == want_moved[:6], (turn, moved, want_moved)
        # Each card launches what the one-card engine launches a shard.
        (per_cell,) = ({key: n // 4 for key, n in c.items()} for c in _by_card(want_moved).values())
        assert _by_card(moved) == dict.fromkeys(range(4), per_cell), (moved, want_moved)
        caches = four._class_graphs
        assert metrics.counters["class_graph_captures"] == sum(len(c) for c in caches.values())
    (cache_one,) = one._class_graphs.values()
    for d in range(data):
        for s in range(docs):
            cache = caches[four.mesh.devices[d, s]]
            assert len(cache) and all(key.shards == (s,) for key in cache.keys())
    # One card's keys for all its shards against one key a shard a card.
    assert sum(len(c) for c in caches.values()) == data * docs * len(cache_one)
    if kind == "bm25":
        assert any(key.use_ranges for c in caches.values() for key in c.keys())
        assert want_moved[0].get("full") and want_moved[0].get("lanes")
        assert want_moved[2].get("merge_topk")
    elif kind == "tfboost":
        assert not want_moved[0] and want_moved[2].get("merge_topk")
    else:
        assert want_moved[4].get("fused_z2o") and want_moved[5].get("z2o_staged") \
            and want_moved[5].get("z2o_lockstep"), want_moved


@pytest.mark.cuda
def test_sharded_four_cards_capture_only_new_keys_on_cuda():
    """Mesh (2, 2) over four cards: a second window of another composition
    captures on each card only the keys that card had not seen."""
    _cards(4)
    torch.cuda.set_device(0)
    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex
    from probly_search_tpu_torch.utils.metrics import metrics

    ix, window = _sharded_corpus()
    sdix = ShardedDeviceIndex(ix, make_mesh(2, 2))
    sdix.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    first = {dev: set(c.keys()) for dev, c in sdix._class_graphs.items()}
    assert all(first.values())
    second = window[::2] + ["p"]
    metrics.reset()
    got = sdix.query_batch_async(second, bm25.new(), top_k=10).get_arrays()
    new = {dev: set(c.keys()) - first[dev] for dev, c in sdix._class_graphs.items()}
    assert all(new.values())
    assert metrics.counters["class_graph_captures"] == sum(map(len, new.values()))
    want = pdev.DeviceIndex(ix, device="cuda:0").query_batch_async(second, bm25.new(), top_k=10)
    c = want.get_arrays()
    assert_topk_agree(got[0], got[1], c[0], c[1])
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_sharded_snapshot_over_four_cards_frees_every_card_on_cuda():
    """With the collector off, dropping a ShardedDeviceIndex over four
    cards whose windows captured graphs on every card (range classes among
    them) returns each card's allocated memory to what it was before."""
    _cards(4)
    torch.cuda.set_device(0)
    import gc
    import weakref

    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex

    ix, window = _sharded_corpus()
    cards = _four_cards()

    def served():
        d = ShardedDeviceIndex(ix, make_mesh(1, 4))
        d.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
        return d

    served()  # a first round warms the kernels' build and the allocator
    gc.collect()
    for dev in cards:
        torch.cuda.synchronize(dev)
    base = [torch.cuda.memory_allocated(dev) for dev in cards]
    gc.disable()
    try:
        d = served()
        assert all(len(c) for c in d._class_graphs.values())
        assert any(key.use_ranges for c in d._class_graphs.values() for key in c.keys())
        for dev in cards:
            torch.cuda.synchronize(dev)
        assert all(torch.cuda.memory_allocated(dev) > b for dev, b in zip(cards, base))
        ref = weakref.ref(d)
        del d
        assert ref() is None
        for dev in cards:
            torch.cuda.synchronize(dev)
        assert [torch.cuda.memory_allocated(dev) for dev in cards] == base
    finally:
        gc.enable()


@pytest.mark.cuda
def test_index_serves_on_four_cards_through_mutation_on_cuda():
    """``Index`` routing over four cards: ``attach_mesh(make_mesh(2, 2))``
    and ``sharded_index()`` with no mesh (every visible card), BM25 and
    zero-to-one through ``query_batch`` / ``query_batch_async`` against the
    single-device engine on ``cuda:0``; then documents added and removed, a
    new snapshot, the same queries again against the single-device engine
    and the f64 oracle, and the old snapshot freed on every card."""
    _cards(4)
    torch.cuda.set_device(0)
    import gc
    import weakref

    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.ops import z2o_device as pz

    ix, window = _sharded_corpus()
    window = window[:-1]  # no host-fallback query
    tok = pdev.whitespace_tokenizer

    def single(queries):
        dix = pdev.DeviceIndex(ix, device="cuda:0")
        return (dix.query_batch_async(queries, bm25.new(), top_k=10).get_arrays(),
                pz.z2o_query_batch_async(dix, queries, tok, 10, fmt="f32").get_arrays())

    def check(queries):
        for (scorer, want), blocking in zip(zip((bm25.new(), zero_to_one.new()), single(queries)),
                                            (False, True)):
            got = ix.query_batch_async(queries, scorer, top_k=10).get_arrays()
            assert_topk_agree(got[0], got[1], want[0], want[1])
            if blocking:
                rows = ix.query_batch(queries, scorer, top_k=10)
                assert [[r.key for r in row] for row in rows] == [
                    [key for key, slot in zip(keys, slots) if slot >= 0]
                    for keys, slots in zip(got[2].tolist(), got[1])]
        assert torch.cuda.current_device() == 0

    ix.attach_mesh(make_mesh(2, 2))
    check(window)
    assert [str(d) for d in ix.sharded_index().mesh.devices.reshape(-1)] == [
        f"cuda:{i}" for i in range(4)]
    ix.attach_mesh(None)
    sdix = ix.sharded_index()
    assert sdix.mesh.shape == {"data": 1, "docs": 4}
    assert list(sdix._class_graphs) == _four_cards()
    check(window)
    n = ix._next_slot
    ix.add_documents_columnar(
        list(range(n, n + 300)), [[f"p001 q0007 new{i % 7}" for i in range(300)]])
    for key in range(5, n, 97):
        ix.remove_document(key)
    ref = weakref.ref(sdix)
    del sdix
    gc.disable()
    try:
        fresh = ix.sharded_index()
        assert ref() is None and fresh.version == ix.version
    finally:
        gc.enable()
    queries = window[:50] + ["p001", "q0007 new3", "new1", "p001 new2"]
    check(queries)
    s, sl, _keys = ix.query_batch_async(queries, bm25.new(), top_k=10).get_arrays()
    for qi, q in enumerate(queries):
        want = ix.query(q, bm25.new(), tok, [1.0], top_k=10)
        np.testing.assert_allclose(
            s[qi][: len(want)], [r.score for r in want], rtol=2e-5, atol=1e-6)
        assert (sl[qi][len(want):] == -1).all()


# --------------------------------------------------------------------- #
# several threads serving one engine (``-k concurrent``)                  #
# --------------------------------------------------------------------- #

# About 10 ms of the card's clock: a sleep queued first on a stream holds
# the stream's later work until every thread has enqueued its own.
SLEEP_CYCLES = 20_000_000


def _threads(targets, timeout=120):
    """Run each callable on a thread of its own; re-raise the first error."""
    import threading

    errors = []

    def guard(fn):
        try:
            fn()
        except BaseException as e:  # re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(fn,)) for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    if errors:
        raise errors[0]


def _moved_since(before):
    """The launch counts moved since ``before`` (``_launch_counts``)."""
    return [{key: n - was.get(key, 0) for key, n in c.items() if n != was.get(key, 0)}
            for c, was in zip(pdev._launch_counters(), before)]


def _summed(moves):
    """Per counter, the sum of several windows' moved counts."""
    total = [{} for _ in pdev._launch_counters()]
    for moved in moves:
        for t, m in zip(total, moved):
            for key, n in m.items():
                t[key] = t.get(key, 0) + n
    return total


def _prewarmed(ix, window, tmp_path):
    """A fresh DeviceIndex with ``window``'s template loaded (frozen by
    another one), not prewarmed, and the manifest's path."""
    src = pdev.DeviceIndex(ix, device="cuda")
    src.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    p = str(tmp_path / "t.json")
    assert src.save_templates(p) == 1
    dix = pdev.DeviceIndex(ix, device="cuda")
    assert dix.load_templates(p) == 1
    return dix, p


@pytest.mark.cuda
def test_concurrent_window_graph_on_own_streams_on_cuda(tmp_path):
    """Two threads, each under a CUDA stream of its own, replay one
    template's ``WindowGraph`` at once, four rounds: a sleep queued first on
    each stream holds both threads' copies, replays and copies out until
    both are enqueued, so windows not ordered across streams would
    overwrite each other's static input and output.  Each window's packed
    rows equal the same window served alone, and the launches counted
    equal the serial windows'."""
    _cuda()
    import threading

    from probly_search_tpu_torch.utils.metrics import metrics

    ix, window = _template_corpus()
    dix, _p = _prewarmed(ix, window, tmp_path)
    assert dix.prewarm(bm25.new()) == 1
    windows = [window, window[::-1]]
    want, serial = [], []
    for w in windows:
        before = _launch_counts()
        h = dix.query_batch_async(w, bm25.new(), top_k=10)
        h.get_arrays()
        want.append(h._packed.cpu())
        serial.append(_moved_since(before))
    streams = [torch.cuda.Stream() for _ in windows]
    barrier = threading.Barrier(2)
    got, rounds = {}, 4

    def worker(t):
        with torch.cuda.stream(streams[t]):
            for r in range(rounds):
                barrier.wait(60)
                torch.cuda._sleep(SLEEP_CYCLES)
                h = dix.query_batch_async(windows[t], bm25.new(), top_k=10)
                barrier.wait(60)  # both windows enqueued behind their sleeps
                h.get_arrays()
                got[t, r] = h._packed.cpu()

    metrics.reset()
    before = _launch_counts()
    _threads([lambda t=t: worker(t) for t in range(2)])
    torch.cuda.synchronize()
    assert metrics.counters["template_graph_replays"] == 2 * rounds
    assert _moved_since(before) == _summed(serial * rounds)
    for (t, r), packed in got.items():
        assert torch.equal(packed, want[t]), f"thread {t} round {r}: rows of another window"


@pytest.mark.cuda
def test_concurrent_capture_beside_replays_on_cuda():
    """A thread's first window on a fresh ``DeviceIndex`` captures its
    class graphs while another thread replays windows on a second
    ``DeviceIndex`` of the same card: rows equal each engine's serial rows,
    the launches counted across both threads equal the serial windows'
    sum, and the fresh engine's graphs then replay with a serial window's
    counts (no launch of the other thread in their deltas)."""
    _cuda()
    import threading

    ix, window, _vocab = _class_graph_corpus()
    other = window[::-1]
    warm = pdev.DeviceIndex(ix, device="cuda")
    want_w, moved_w = _serve_counted(warm, other, bm25.new(), top_k=10)
    want_f, moved_f = _serve_counted(pdev.DeviceIndex(ix, device="cuda"), window, bm25.new(), top_k=10)
    fresh = pdev.DeviceIndex(ix, device="cuda")
    done = threading.Event()
    replayed, captured = [], {}

    def capturer():
        try:
            captured["rows"] = fresh.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
        finally:
            done.set()

    def replayer():
        while not done.is_set() or len(replayed) < 2:
            replayed.append(warm.query_batch_async(other, bm25.new(), top_k=10).get_arrays())

    before = _launch_counts()
    _threads([capturer, replayer])
    torch.cuda.synchronize()
    assert _moved_since(before) == _summed([moved_f] + [moved_w] * len(replayed))
    for a, b in zip(captured["rows"], want_f):
        np.testing.assert_array_equal(a, b)
    for rows in replayed:
        for a, b in zip(rows, want_w):
            np.testing.assert_array_equal(a, b)
    again, moved = _serve_counted(fresh, window, bm25.new(), top_k=10)
    assert moved == moved_f, (moved, moved_f)
    for a, b in zip(again, want_f):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_concurrent_snapshot_dropped_with_window_in_flight_on_cuda():
    """Windows queued on a side stream behind a sleep, on a snapshot whose
    class graphs were captured on the default stream: a handle that is
    kept keeps its snapshot and drains rows equal to the serial window; a
    snapshot dropped with its handles (the collector off) is freed only
    once its last window has run on the side stream, so nothing it frees
    is still read or written there."""
    _cuda()
    import gc
    import weakref

    ix, window, _vocab = _class_graph_corpus()
    d = pdev.DeviceIndex(ix, device="cuda")
    want = d.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
        kept = d.query_batch_async(window, bm25.new(), top_k=10)
        d.query_batch_async(window[::-1], bm25.new(), top_k=10)  # its handle dropped at once
    ref = weakref.ref(d)
    del d
    assert ref() is not None
    for a, b in zip(kept.get_arrays(), want):
        np.testing.assert_array_equal(a, b)
    del kept
    gc.collect()
    d = pdev.DeviceIndex(ix, device="cuda")
    d.query_batch_async(window, bm25.new(), top_k=10).get_arrays()
    torch.cuda.synchronize()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            torch.cuda._sleep(10 * SLEEP_CYCLES)
            d.query_batch_async(window, bm25.new(), top_k=10)
        assert not side.query(), "the window ran before the snapshot was dropped"
        ref = weakref.ref(d)
        del d
        assert ref() is None
        assert side.query(), "the snapshot was freed while its window still ran"
    finally:
        gc.enable()


@pytest.mark.cuda
def test_concurrent_prewarm_while_serving_on_cuda(tmp_path):
    """``prewarm`` on a thread while two threads serve windows of its
    template on the same fresh ``DeviceIndex``: windows submitted before
    the template's graph exists run on class graphs (capturing them while
    the graph is captured), later ones replay the graph, and every window's
    packed rows equal the serial ones."""
    _cuda()
    import threading

    from probly_search_tpu_torch.utils.metrics import metrics

    ix, window = _template_corpus()
    ref, p = _prewarmed(ix, window, tmp_path)
    assert ref.prewarm(bm25.new()) == 1
    windows = [window, window[::-1]]
    want = []
    for w in windows:
        h = ref.query_batch_async(w, bm25.new(), top_k=10)
        h.get_arrays()
        want.append(h._packed.cpu())
    dix = pdev.DeviceIndex(ix, device="cuda")
    assert dix.load_templates(p) == 1
    started, warmed = threading.Barrier(3), threading.Event()
    got = []

    def server(t):
        after = 0
        for r in range(200):
            h = dix.query_batch_async(windows[t], bm25.new(), top_k=10)
            h.get_arrays()
            got.append((t, h._packed.cpu()))
            if r == 0:
                started.wait(60)
            after += warmed.is_set()
            if after == 2:
                return

    def warmer():
        started.wait(60)
        assert dix.prewarm(bm25.new()) == 1
        warmed.set()

    metrics.reset()
    _threads([lambda: server(0), lambda: server(1), warmer])
    ctr = metrics.counters
    assert ctr["template_graph_replays"] >= 2 and ctr["class_graph_replays"] > 0, dict(ctr)
    assert not ctr.get("template_refreezes")
    for t, packed in got:
        assert torch.equal(packed, want[t]), f"thread {t}: rows differ from the serial window"


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["one_card", "four_cards"])
def test_concurrent_sharded_windows_on_cuda(cards):
    """Two threads, each under a stream of its own, serve windows on one
    ``ShardedDeviceIndex`` over ``cuda:0`` x 4, or over four cards (BM25
    with K1, K3 + K5 and range classes, then zero-to-one): rows equal the
    serial windows', and the launches counted equal the serial windows'
    sum, per kernel and per card."""
    _cards(1 if cards == "one_card" else 4)
    torch.cuda.set_device(0)
    from probly_search_tpu_torch import make_mesh
    from probly_search_tpu_torch.parallel import ShardedDeviceIndex

    ix, window = _sharded_corpus()
    devices = ["cuda:0"] * 4 if cards == "one_card" else _four_cards()
    sdix = ShardedDeviceIndex(ix, make_mesh(1, 4, devices=devices))
    jobs = [(bm25.new(), window), (bm25.new(), window[::-1]), (None, window[:100] + ["a a"])]
    want, serial = [], []
    for scorer, w in jobs:
        _h, out, moved = _sharded_served(sdix, w, scorer)
        want.append(out)
        serial.append(moved)
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = []

    def worker(t):
        with torch.cuda.stream(streams[t]):
            for j in range(len(jobs)):
                scorer, w = jobs[(t + j) % len(jobs)]
                torch.cuda._sleep(SLEEP_CYCLES)
                if scorer is None:
                    h = sdix.query_batch_z2o(w, top_k=10)
                else:
                    h = sdix.query_batch_async(w, scorer, top_k=10)
                got.append(((t + j) % len(jobs), h.get_arrays()))

    before = _launch_counts()
    _threads([lambda t=t: worker(t) for t in range(2)])
    torch.cuda.synchronize()
    assert _moved_since(before) == _summed(serial * 2)
    for i, rows in got:
        for a, b in zip(rows, want[i]):
            np.testing.assert_array_equal(a, b)
