"""The torch port's host planner against the JAX engine's, on one index.

The JAX Index is carried into the port through a snapshot
(``probly_search_tpu_torch.index.snapshot``), so both planners see the same
state.  Integer work, so the bar is bit-exact: the posting record array, the
job tables, the shape classes and the template packing (with a refreeze).
Only host code of the JAX DeviceIndex runs here, no device program.
"""

import dataclasses
import os
import random
import tempfile

import numpy as np
import pytest

import probly_search_tpu.index.device as jdev
from probly_search_tpu import Index, IndexConfig
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu.index import snapshot as jsnap
import probly_search_tpu_torch as pt
from probly_search_tpu_torch import DeviceIndex, bm25
from probly_search_tpu_torch.index import snapshot as psnap

from .util import Doc, text_extract, title_extract, tokenizer


def _index(seed=0, **cfg):
    """Two fields, a bulk add, two delta segments and a latent delete."""
    rng = random.Random(seed)
    vocab = ["".join(rng.choice("abcdef") for _ in range(rng.randint(1, 4))) for _ in range(70)]
    vocab += ["hot%d" % i for i in range(3)]

    def text(n):
        return " ".join([rng.choice(vocab[-3:])] + [rng.choice(vocab) for _ in range(n)])

    ix = Index(2, config=IndexConfig(chunk_size=128, **cfg))
    n = 300
    titles = [text(rng.randint(0, 4)) for _ in range(n)]
    bodies = [text(rng.randint(0, 9)) for _ in range(n)]
    ix.add_documents_columnar(list(range(n)), [titles, bodies])
    for seg in range(2):
        for i in range(n + 40 * seg, n + 40 * (seg + 1)):
            ix.add_document(
                [title_extract, text_extract], tokenizer, i,
                Doc(id=i, title=text(rng.randint(0, 3)), text=text(rng.randint(0, 6))),
            )
        assert ix.num_segments >= 2 + seg  # flushes the delta segment
    ix.remove_document(7)
    ix.remove_document(333)
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(48)]
    queries += ["hot0 hot1 hot2", "a", "b c", "zzzz", "", " ".join(vocab[:17])]
    return ix, queries


def port_index(ix):
    """The port's Index carried across from the JAX Index ``ix``."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ix.npz")
        jsnap.save(ix, path)
        cfg = pt.IndexConfig(**dataclasses.asdict(ix.config))
        return psnap.load(path, config=cfg, device="cpu")


@pytest.fixture(scope="module")
def engines():
    ix, queries = _index()
    return ix, queries, DeviceIndex(port_index(ix), device="cpu"), jdev.DeviceIndex(ix)


def test_snapshot_arrays(engines):
    ix, _q, p, j = engines
    np.testing.assert_array_equal(p.rec.numpy(), np.asarray(j.rec))
    np.testing.assert_array_equal(p.field_avg.numpy(), np.asarray(j.field_avg))
    assert (p.num_postings, p.num_slots, p.CHUNK) == (j.num_postings, j.num_slots, j.CHUNK)


def _plans(engines, queries):
    _ix, _q, p, j = engines
    pp, pfb = p.plan_batch(queries, tokenizer, bm25.new())
    jp, jfb = j.plan_batch(queries, tokenizer, jbm25.new())
    return pp, pfb, jp, jfb


@pytest.mark.parametrize("part", [slice(0, 20), slice(None)])
def test_plan_batch(engines, part):
    queries = engines[1][part]
    pp, pfb, jp, jfb = _plans(engines, queries)
    assert pfb == jfb
    for name in ("jquery", "words", "nchunks", "njobs", "has_range"):
        np.testing.assert_array_equal(getattr(pp, name), getattr(jp, name), err_msg=name)


def test_fallback_caps():
    ix, queries = _index(seed=1, max_expansions=3)
    p, j = DeviceIndex(port_index(ix), device="cpu"), jdev.DeviceIndex(ix)
    pp, pfb = p.plan_batch(queries, tokenizer, bm25.new())
    jp, jfb = j.plan_batch(queries, tokenizer, jbm25.new())
    assert pfb == jfb and len(pfb) >= 2  # the 17-term query and prefix queries
    np.testing.assert_array_equal(pp.words, jp.words)
    np.testing.assert_array_equal(pp.nchunks, jp.nchunks)


@pytest.mark.parametrize("pow2_row_split", [True, False])
def test_pack_dispatches(engines, monkeypatch, pow2_row_split):
    ix, queries, p, j = engines
    for cfg in (ix.config, p.config):
        monkeypatch.setattr(cfg, "pow2_row_split", pow2_row_split)
    queries = queries * 40  # classes of more than 512 rows split differently
    pp, _pfb, jp, _jfb = _plans(engines, queries)
    pd = p.pack_dispatches(len(queries), pp)
    jd = j.pack_dispatches(len(queries), jp)
    assert len(pd) == len(jd) > 1
    split = len({d[2] for d in pd}) < len(pd)  # some class spans two dispatches
    assert split == pow2_row_split
    for (pi, pj, pnc, pnj, prng), (ji, jj, jnc, jnj, jrng, jcw) in zip(pd, jd):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pj, jj)
        assert (pnc, pnj, prng, p.CHUNK) == (jnc, jnj, jrng, jcw)


def test_pack_dispatches_template_refreeze(engines):
    _ix, queries, p, j = engines
    # A small window freezes the template; the full window overflows it and
    # refreezes; the small one then fits the grown template.
    frozen = []
    for window in (queries[:12], queries, queries[:12]):
        pp, _pfb, jp, _jfb = _plans(engines, window)
        pd, pspecs = p._pack_dispatches_template(len(window), pp, ("t", 10))
        jd, jspecs = j._pack_dispatches_template(len(window), jp, ("t", 10))
        assert [s[:5] for s in jspecs] == list(pspecs)
        assert all(s[4:] == (False, p.CHUNK) for s in jspecs)
        assert [e[:3] for e in j._comp_templates[("t", 10)]] == p._comp_templates[("t", 10)]
        for (pi, pj, pnc, pnj, prng), (ji, jj, jnc, jnj, jrng, *_r) in zip(pd, jd):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pj, jj)
            assert (pnc, pnj, prng) == (jnc, jnj, jrng)
        frozen.append(list(p._comp_templates[("t", 10)]))
    assert frozen[0] != frozen[1] == frozen[2]
