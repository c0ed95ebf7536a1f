"""The torch port's own host layers against the JAX package's.

The port keeps copies of ``Index``, its segments and native build, the
scorers' host halves, ``snapshot`` and ``IndexConfig``.  Built from the same
documents (one and two fields; columnar through the native build and per
document; deletes and vacuum), the two packages must hold bit-equal segments,
doc tables and field stats and give equal f64 oracle results.  A snapshot
saved by either package loads in the other with the same state.
"""

import dataclasses
import os
import random
import tempfile

import numpy as np
import pytest
import torch

from probly_search_tpu import Index as JIndex
from probly_search_tpu import bm25 as jbm25
from probly_search_tpu import zero_to_one as jz2o
from probly_search_tpu.index import snapshot as jsnap
import probly_search_tpu_torch as pt
from probly_search_tpu_torch.index import snapshot as psnap

from .util import Doc, text_extract, title_extract, tokenizer

# (fields, how documents arrive, deletes, vacuum)
SCENARIOS = [
    (1, "columnar", False, False),
    (2, "columnar", True, False),
    (2, "per_doc", True, False),
    (2, "mixed", True, True),
    (1, "per_doc", True, True),
]


def _build(Index, F, mode, deletes, vacuum, seed=3, **kw):
    rng = random.Random(seed)
    vocab = ["".join(rng.choice("abcdeé") for _ in range(rng.randint(1, 4))) for _ in range(50)]
    n = 160

    def text(m):
        return " ".join(rng.choice(vocab) for _ in range(m))

    docs = [Doc(id=i, title=text(rng.randint(1, 4)), text=text(rng.randint(0, 7))) for i in range(n)]
    ix = Index(F, **kw)
    accs = [title_extract, text_extract][:F]
    cols = lambda ds: [[d.title for d in ds], [d.text for d in ds]][:F]  # noqa: E731
    if mode == "columnar":
        ix.add_documents_columnar([d.id for d in docs], cols(docs))
    elif mode == "per_doc":
        for d in docs:
            ix.add_document(accs, tokenizer, d.id, d)
    else:
        ix.add_documents_columnar([d.id for d in docs[:100]], cols(docs[:100]))
        for d in docs[100:]:
            ix.add_document(accs, tokenizer, d.id, d)
    if deletes:
        for key in (4, 17, 101, 150):
            ix.remove_document(key)
    if vacuum:
        ix.vacuum()
    queries = [text(rng.randint(1, 3)) for _ in range(12)] + ["a", "é", "", "zzz"]
    return ix, queries


def _assert_same_state(a, b):
    a._flush_pending()
    b._flush_pending()
    assert len(a._segments) == len(b._segments)
    for sa, sb in zip(a._segments, b._segments):
        assert list(sa.terms) == list(sb.terms)
        for name in ("term_lens", "offsets", "post_doc", "post_tf", "post_occ"):
            x, y = getattr(sa, name), getattr(sb, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    n = a._next_slot
    assert n == b._next_slot
    np.testing.assert_array_equal(a._doc_len[:n], b._doc_len[:n])
    np.testing.assert_array_equal(a._alive[:n], b._alive[:n])
    assert a._slot_to_key == b._slot_to_key
    assert a._key_to_slot == b._key_to_slot
    assert sorted(a._docs) == sorted(b._docs)
    for key, d in a._docs.items():
        np.testing.assert_array_equal(d.field_length, b._docs[key].field_length)
    assert a._removed_keys == b._removed_keys
    assert [(f.sum, f.avg) for f in a._fields] == [(f.sum, f.avg) for f in b._fields]


@pytest.fixture(scope="module", params=SCENARIOS, ids=lambda s: "F%d-%s-del%d-vac%d" % s)
def pair(request):
    j, queries = _build(JIndex, *request.param)
    p, _ = _build(pt.Index, *request.param, device="cpu")
    return j, p, queries


def test_same_state(pair):
    j, p, _ = pair
    _assert_same_state(j, p)


@pytest.mark.parametrize("scorer", ["bm25", "zero_to_one"])
def test_same_oracle(pair, scorer):
    j, p, queries = pair
    F = p.num_fields
    boosts = [1.5, 0.5][:F]
    jnew, pnew = {"bm25": (jbm25.new, pt.bm25.new), "zero_to_one": (jz2o.new, pt.zero_to_one.new)}[scorer]
    for q in queries:
        want = [(r.key, r.score) for r in j.query(q, jnew(), tokenizer, boosts)]
        assert [(r.key, r.score) for r in p.query(q, pnew(), tokenizer, boosts)] == want, q
        jv = type(jnew()).vectorized_query
        pv = type(pnew()).vectorized_query
        args = dict(tokenizer=tokenizer, top_k=10, fields_boost=boosts)
        wantv = [(r.key, r.score) for r in (jv(jnew(), j, q, **args) if scorer == "bm25" else jv(j, q, **args))]
        gotv = pv(pnew(), p, q, **args) if scorer == "bm25" else pv(p, q, **args)
        assert [(r.key, r.score) for r in gotv] == wantv, q


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses(pair, direction):
    j, p, _ = pair
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ix.npz")
        if direction == "jax_to_port":
            jsnap.save(j, path)
            other = psnap.load(path, device="cpu")
            assert isinstance(other, pt.Index) and other.device == "cpu"
        else:
            psnap.save(p, path)
            other = jsnap.load(path)
    _assert_same_state(j, other)


def test_index_from_arrays_matches_load():
    j, _ = _build(JIndex, 2, "mixed", True, False)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ix.npz")
        jsnap.save(j, path)
        z = np.load(path, allow_pickle=True)
        arrays = {name: z[name] for name in z.files}
    import json

    meta = json.loads(arrays["meta"].tobytes().decode("utf-8"))
    cfg = pt.IndexConfig(chunk_size=128)
    p = psnap.index_from_arrays(arrays, meta, config=cfg, device="cpu")
    assert p.config is cfg
    _assert_same_state(j, p)


def test_config_copy_matches():
    from probly_search_tpu import IndexConfig as JConfig

    assert [f.name for f in dataclasses.fields(JConfig)] == [
        f.name for f in dataclasses.fields(pt.IndexConfig)
    ]
    assert dataclasses.asdict(JConfig()) == dataclasses.asdict(pt.IndexConfig())


def test_device_index_takes_only_the_ports_index():
    j, _ = _build(JIndex, 1, "columnar", False, False)
    with pytest.raises(TypeError, match="snapshot"):
        pt.DeviceIndex(j, device="cpu")


def test_entry_points_default_to_the_card():
    p, queries = _build(pt.Index, 1, "columnar", False, False, device="cpu")
    assert pt.Index(1).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Index(1).device_index()
    cuda_ix, _ = _build(pt.Index, 1, "columnar", False, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_ix.query_batch(queries[:2], pt.bm25.new())
    assert p.query_batch(queries[:2], pt.bm25.new())  # device="cpu" serves


def test_sharding_raises_not_ported():
    p = pt.Index(1, device="cpu")
    for call in (lambda: p.attach_mesh(object()), p.sharded_index):
        with pytest.raises(NotImplementedError, match="M9"):
            call()
