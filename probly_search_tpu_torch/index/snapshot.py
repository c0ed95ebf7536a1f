"""Index snapshots — persistence / checkpoint-resume.

The torch port's copy of ``probly_search_tpu/index/snapshot.py``, reading
and writing the same format (2): a snapshot that either package saved loads
in the other, bit for bit.  ``index_from_arrays`` builds the port's
``Index`` from the snapshot's arrays without a file, which is how the JAX
package's index state (term dictionary, CSR postings, doc store, field
stats, liveness, slot -> key) crosses into the port.

The reference has NO persistence of any kind (SURVEY §5: no serde, no I/O —
if the process dies the index is gone).  This is a new subsystem: the SoA
data model serializes naturally — term dictionary (utf-8 blob + offsets),
CSR postings, doc store, field stats, liveness — into a single ``.npz``
file.  Latent-deletion state is preserved exactly: loading a snapshot taken
between ``remove_document`` and ``vacuum`` reproduces the same query
results, including expansion behavior over dead postings.

Document keys are stored with pickle when they are not a homogeneous
int/str column (keys are generic in the reference, `index.rs:35`).
"""

from __future__ import annotations

import json
from typing import Any, List, Mapping

import numpy as np

from ..config import IndexConfig
from ..models.base import DocumentDetails, FieldDetails
from .segment import Segment

_FORMAT_VERSION = 2


def _pack_terms(terms: List[str]):
    """Terms as a utf-8 blob + cumulative byte offsets.

    A delimiter-joined blob would corrupt on terms containing the delimiter
    (any byte is legal in a term — the default tokenizer only splits on
    spaces), so boundaries are explicit.
    """
    encoded = [t.encode("utf-8") for t in terms]
    blob = b"".join(encoded)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return np.frombuffer(blob, dtype=np.uint8), offsets


def _unpack_terms(blob: np.ndarray, offsets: np.ndarray) -> List[str]:
    raw = blob.tobytes()
    return [
        raw[offsets[i] : offsets[i + 1]].decode("utf-8")
        for i in range(len(offsets) - 1)
    ]


def save(index, path: str) -> None:
    """Serialize an Index (including pending adds and latent deletions)."""
    index._flush_pending()
    data = {}
    data["meta"] = np.frombuffer(
        json.dumps(
            {
                "format": _FORMAT_VERSION,
                "num_fields": index._num_fields,
                "num_segments": len(index._segments),
                "next_slot": index._next_slot,
                "fields_sum": [fd.sum for fd in index._fields],
                "fields_avg": [fd.avg for fd in index._fields],
            }
        ).encode("utf-8"),
        dtype=np.uint8,
    )
    for i, seg in enumerate(index._segments):
        data[f"seg{i}_terms"], data[f"seg{i}_terms_offsets"] = _pack_terms(seg.terms)
        data[f"seg{i}_term_lens"] = seg.term_lens
        data[f"seg{i}_offsets"] = seg.offsets
        data[f"seg{i}_post_doc"] = seg.post_doc
        data[f"seg{i}_post_tf"] = seg.post_tf
    data["doc_len"] = index._doc_len[: index._next_slot]
    data["alive"] = index._alive[: index._next_slot]
    keys = index._slot_to_key
    # np.asarray(list-of-tuples) would make a 2-D array; force a 1-D object
    # vector so tuple keys survive the round trip.
    # Fast path ONLY for keys of one homogeneous scalar type: np.asarray on
    # mixed [1, 'docA'] silently coerces to unicode and corrupts the round
    # trip.  bool is excluded (it is an int subclass but round-trips wrong).
    key_types = {type(k) for k in keys}
    if keys and (key_types == {int} or key_types == {str}):
        data["keys"] = np.asarray(keys)
    else:
        key_arr = np.empty(len(keys), dtype=object)
        key_arr[:] = keys
        data["keys_pickled"] = key_arr
    removed = list(index._removed_keys)
    removed_arr = np.empty(len(removed), dtype=object)
    removed_arr[:] = removed
    data["removed_pickled"] = removed_arr
    np.savez_compressed(path, **data)


def load(path: str, config: IndexConfig | None = None, device: Any = "cuda"):
    """Reconstruct an Index from a snapshot (either package's format 2)."""
    z = np.load(path, allow_pickle=True)
    return index_from_arrays(
        z, json.loads(z["meta"].tobytes().decode("utf-8")), config, device
    )


def index_from_arrays(
    arrays: Mapping[str, np.ndarray], meta: dict, config: IndexConfig | None = None,
    device: Any = "cuda",
):
    """Build the port's ``Index`` from a snapshot's arrays (the keys ``save``
    writes, ``meta`` decoded).  The arrays are taken as they are, so the
    segments, doc store and liveness equal the saved index's bit for bit."""
    from .core import Index

    z = arrays
    if meta["format"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported snapshot format {meta['format']}")
    F = meta["num_fields"]
    index = Index(F, config=config, device=device)

    for i in range(meta["num_segments"]):
        terms = _unpack_terms(z[f"seg{i}_terms"], z[f"seg{i}_terms_offsets"])
        index._segments.append(
            Segment(
                terms=terms,
                term_lens=z[f"seg{i}_term_lens"],
                offsets=z[f"seg{i}_offsets"],
                post_doc=z[f"seg{i}_post_doc"],
                post_tf=z[f"seg{i}_post_tf"],
                post_occ=z[f"seg{i}_post_tf"].sum(axis=1).astype(np.int32),
            )
        )

    n = meta["next_slot"]
    doc_len = z["doc_len"]
    alive = z["alive"]
    cap = max(16, index.config.expected_documents_count, n)
    index._doc_len = np.zeros((cap, F), dtype=np.int64)
    index._doc_len[:n] = doc_len
    index._alive = np.zeros(cap, dtype=bool)
    index._alive[:n] = alive
    index._next_slot = n

    if "keys" in z:
        keys = list(z["keys"])
        # np round-trips python ints to np ints; normalize scalars.
        keys = [k.item() if isinstance(k, np.generic) else k for k in keys]
    else:
        keys = list(z["keys_pickled"])
    index._slot_to_key = keys
    for slot, key in enumerate(keys):
        if alive[slot]:
            index._key_to_slot[key] = slot
            index._docs[key] = DocumentDetails(key=key, field_length=index._doc_len[slot])
    index._removed_keys = set(
        k.item() if isinstance(k, np.generic) else k for k in z["removed_pickled"]
    )
    index._fields = [
        FieldDetails(sum=int(s), avg=float(a))
        for s, a in zip(meta["fields_sum"], meta["fields_avg"])
    ]
    index._version += 1
    return index
