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

The CUDA kernel's design is held here too: a plain model of its lane order
against the reference's (k1, k2) sort, its launch plan over every class the
route admits, its key bits and its argument checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probly_search_tpu.ops.pallas_z2o as jpz
from probly_search_tpu_torch.ops import fused_query as fq
from probly_search_tpu_torch.ops import fused_z2o as fz
from probly_search_tpu_torch.ops import z2o_device as pz
from probly_search_tpu_torch.ops.fused_merge import key_bits_for
from probly_search_tpu_torch.testing import assert_topk_agree

from .torch_util import make_rec, make_z2o_tables, score_ranks, to_torch, z2o_edge

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


# --------------------------------------------------------------------- #
# The CUDA kernel's design, held on the CPU                              #
# --------------------------------------------------------------------- #

INT32_MAX = 2**31 - 1


def _kernel_order(rec, c_start, c_skip, c_len, c_qterm, c_rank, C, F):
    """Plain model of K4's lane order (csrc/fused_z2o.cu): the chunks laid
    out in ascending (rank, chunk) order, lane p of a chunk at position *
    C + p, then a stable sort by k1 alone that drops pads and the lanes of
    dead docs.  Per row, the source lanes (chunk * C + p) in that order."""
    B, NC = c_start.shape
    doc, _tf, _fl, alive, pos = fz.gather_lanes(rec, c_start, C, F)
    live = (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None]) & (alive > 0)
    k1 = torch.where(live, (doc << 5) | (1 << 4) | c_qterm[..., None], INT32_MAX)
    chunk_at = torch.sort(c_rank, dim=1, stable=True)[1]  # the chunk at each position
    laid = torch.gather(k1, 1, chunk_at[..., None].expand(B, NC, C)).reshape(B, NC * C)
    src = (chunk_at[..., None] * C + torch.arange(C)).reshape(B, NC * C)
    order = torch.sort(laid, dim=1, stable=True)[1]
    n = (laid != INT32_MAX).sum(1)
    return [src[r, order[r, : n[r]]].tolist() for r in range(B)]


def _reference_order(rec, c_start, c_skip, c_len, c_qterm, c_rank, C, F):
    """The reference's lane order: ascending (k1 << 32) | k2 over every lane,
    k2 = rank << 14 | lane, restricted to the live lanes of alive docs."""
    B, NC = c_start.shape
    doc, _tf, _fl, alive, pos = fz.gather_lanes(rec, c_start, C, F)
    in_pay = (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None])
    k1 = torch.where(
        in_pay, (doc << 5) | (alive << 4) | c_qterm[..., None],
        torch.where(pos < c_skip[..., None], -1, INT32_MAX).to(torch.int32),
    ).reshape(B, -1)
    lane = torch.arange(NC * C, dtype=torch.int32).reshape(NC, C)
    k2 = ((c_rank[..., None] << 14) | lane).reshape(B, -1)
    order = torch.sort((k1.long() << 32) | k2.long(), dim=-1)[1]
    keep = (in_pay & (alive > 0)).reshape(B, -1)
    return [[int(i) for i in order[r] if keep[r, i]] for r in range(B)]


@pytest.mark.parametrize(
    "ranks,C,NC",
    [("equal", 128, 6), ("distinct", 128, 6), ("four", 128, 8), ("equal", 1024, 3),
     ("distinct", 1024, 4), ("four", 1024, 2)],
)
def test_kernel_order_matches_reference_sort(ranks, C, NC):
    """K4 orders lanes by a stable sort of k1 over chunks laid out by (rank,
    chunk): the same lane order as the reference's sort by (k1, k2), on
    tables with equal ranks, all-distinct ranks, dead chunks, dead docs and
    leading and trailing pads, and rows whose chunks all share one query
    term (so k1 repeats across chunks)."""
    F = 2
    rng = np.random.default_rng(NC * C)
    rec, starts, lens = make_rec(rng, F=F, n_docs=300, n_terms=40, C=C)
    tables = make_z2o_tables(rng, starts, lens, 24, NC, C=C)
    c_start, c_skip, c_len, c_qterm, c_score, _rank, _qlen = tables
    if ranks == "equal":
        c_score[:] = 0.5
    elif ranks == "distinct":
        c_score = np.stack([rng.permutation(NC) for _ in range(24)]).astype(np.float32) / NC
    c_qterm[::2] = 0
    c_rank = score_ranks(c_score)
    args = to_torch([rec, c_start, c_skip, c_len, c_qterm, c_rank])
    got = _kernel_order(*args, C, F)
    want = _reference_order(*args, C, F)
    assert got == want
    # the cases the order decides occur: equal k1 from different chunks
    doc, _tf, _fl, alive, pos = fz.gather_lanes(args[0], args[1], C, F)
    live = (pos >= args[2][..., None]) & (pos < (args[2] + args[3])[..., None]) & (alive > 0)
    k1 = torch.where(live, (doc << 5) | args[4][..., None], -1).reshape(24, -1)
    assert any(len(set(row[row >= 0].tolist())) < int((row >= 0).sum()) for row in k1)
    assert (alive[..., :] == 0).logical_and(live.logical_not()).any()  # dead docs dropped


# Conservative dynamic shared memory of a K4 block on an H100: the opt-in
# 232,448 B less 14 KB, above the kernel's static shared memory (the radix
# sort's and the select's scratch and the chunk tables, about 13.1 KB).
H100_AVAIL = 232448 - 14 * 1024


def _routed_shapes():
    for cbits in range(14):
        C = 1 << cbits
        for NC in range(1, 8192 // C + 1):
            for F in range(1, 5):
                if pz.fused_route(NC, C, F, True):
                    yield NC, C, F


def test_launch_plan_fits_every_routed_class():
    """Every class that ``fused_route`` admits fits one block's shared
    memory, at every k in [1, L]: past ``LIST_K`` the top-k words beside the
    lanes where they fit, else in device scratch."""
    n = 0
    for NC, C, F in _routed_shapes():
        L = NC * C
        for k in sorted({1, 10, 32, 33, 128, 4096, L} & set(range(1, L + 1))):
            smem, words = fz.z2o_launch(L, C, F, k, H100_AVAIL)
            assert smem <= H100_AVAIL
            pos = (2 * NC + 15) // 16 * 16
            held = 8 * fq.cand_words(k) if k > fz.LIST_K and not words else 0
            assert smem == (8 + 4 * F) * L + pos + held
            assert words in (0, fq.cand_words(k)) and (k > fz.LIST_K or not words)
            if words:  # only when the words do not fit beside the lanes
                assert smem + 8 * fq.cand_words(k) > H100_AVAIL
            n += 1
    assert n > 1000
    assert not pz.fused_route(8, 2048, 1, True) and not pz.fused_route(2, 1024, 5, True)


@pytest.mark.parametrize(
    "L,C,F,k,avail,smem,words",
    [
        (8192, 1024, 4, 10, H100_AVAIL, 196608 + 16, 0),  # the largest layout; k from the lists
        (8192, 1024, 4, 8192, H100_AVAIL, 196608 + 16, 8192),  # k = L: words in scratch
        (8192, 1, 4, 32, H100_AVAIL, 196608 + 16384, 0),  # 8,192 chunks of one lane
        (2048, 1024, 1, 33, H100_AVAIL, 24576 + 16 + 512, 0),  # past LIST_K: words in smem
        (2048, 1024, 1, 2048, H100_AVAIL, 24576 + 16 + 16384, 0),
        (1024, 128, 2, 128, 18 * 1024, 16384 + 16 + 1024, 0),
        (1024, 128, 2, 1024, 17 * 1024, 16384 + 16, 1024),
    ],
)
def test_launch_plan_sizes_shared_memory(L, C, F, k, avail, smem, words):
    assert fz.z2o_launch(L, C, F, k, avail) == (smem, words)


@pytest.mark.parametrize(
    "L,C,F,avail", [(8192, 1024, 4, 150_000), (2048, 1024, 1, 24_000), (128, 128, 1, 1024)]
)
def test_launch_plan_raises_where_the_lanes_do_not_fit(L, C, F, avail):
    with pytest.raises(ValueError):
        fz.z2o_launch(L, C, F, 10, avail)


@pytest.mark.parametrize(
    "slots,bits", [(1 << 16, 21), (1 << 20, 25), (50_000, 21), ((1 << 26) - 1, 31)]
)
def test_key_bits_for_z2o_keys(slots, bits):
    """K4 sorts k1 = doc << 5 | alive << 4 | qterm over key_bits_for(slots,
    5) bits: every key of the index lies below 2^bits."""
    assert key_bits_for(slots, fz.DOC_SHIFT) == bits
    top = (slots - 1) << 5 | 31
    assert top < 2**bits <= 2 * top


def _z2o_args(C=128, NC=3, F=2):
    rng = np.random.default_rng(4)
    rec, starts, lens = make_rec(rng, F=F, C=C)
    return [fq.padded_rows(rec, "cpu"), *to_torch(make_z2o_tables(rng, starts, lens, 8, NC, C=C))]


@pytest.mark.parametrize(
    "change,ok",
    [
        ({}, True),
        ({"k": 384}, True),  # k = L
        ({"k": 0}, False),
        ({"k": 385}, False),
        ({"key_bits": 0}, False),
        ({"key_bits": 32}, False),
        ({"rec": "unaligned"}, False),  # K4 loads 16 B at a time
        ({"num_fields": 5}, False),
        ({"chunk": 96}, False),
    ],
)
def test_check_z2o_args(change, ok):
    args = _z2o_args()
    if change.get("rec") == "unaligned":
        args[0] = torch.zeros((args[0].shape[0], 1001), dtype=torch.int32)[:, :1000][:, 1:]
    kw = dict(chunk=128, k=10, num_fields=2, key_bits=21)
    kw.update({key: v for key, v in change.items() if key != "rec"})
    if ok:
        fz.check_z2o_args(*args, **kw)
    else:
        with pytest.raises(ValueError):
            fz.check_z2o_args(*args, **kw)


def test_cpu_path_takes_key_bits():
    args = _z2o_args()
    got = fz.fused_z2o_topk(*args, chunk=128, k=10, num_fields=2, key_bits=17)
    want = fz.fused_z2o_topk_reference(*args, chunk=128, k=10, num_fields=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kind", ["one_lane", "dead_docs", "tf_zero", "ties", "high_slots"])
def test_reference_matches_pallas_on_edges(kind):
    """K4's edge inputs (tests/torch_util.z2o_edge, also driven on the card):
    the plain version against the Pallas kernel in interpret mode, and what
    each edge is built to show."""
    rec, tables, C, F, k, _slots = z2o_edge(kind)
    kw = dict(chunk=C, k=k, num_fields=F)
    ps, pd = fz.fused_z2o_topk_reference(torch.from_numpy(rec), *to_torch(tables), **kw)
    js, jd = jpz.fused_z2o_topk(
        jnp.asarray(rec), *(jnp.asarray(t) for t in tables), **kw, interpret=True,
    )
    assert_topk_agree(ps.numpy(), pd.numpy(), np.asarray(js), np.asarray(jd))
    row0 = pd[0][pd[0] >= 0]
    if kind == "one_lane":
        assert len(row0) == 1
    if kind == "dead_docs":
        assert len(row0) == 0 and (pd[1:] >= 0).any()
    if kind == "tf_zero":
        assert len(row0) == k and (ps[0] == 0.0).all()
    if kind == "ties":
        s = ps[torch.isfinite(ps)]
        assert torch.equal(s, s.round()) and (pd[ps == ps[:, :1]].numel() > pd.shape[0])
    if kind == "high_slots":
        assert int(pd.max()) >= (1 << 26) - 4000
