"""BM25 with the configuration's ``k1`` and ``b``: the port's scorer, the
float64 reference (``portbench/reference/scorers.py``) and the least work of
one posting (``portbench/counts.py``)."""

from portbench.reference import scorers


def program(spec):
    from probly_search_tpu_torch import bm25

    return bm25.new(bm25k1=float(spec["k1"]), bm25b=float(spec["b"]))


def reference(ix, words, spec, precision="float64"):
    return scorers.bm25(ix, words, float(spec["k1"]), float(spec["b"]), precision=precision)


def ops_per_posting(F):
    """Per field: divide the length by the average, scale by b, add 1 - b,
    scale by k1, add tf, scale tf by k1 + 1, divide, scale by the field boost
    and add into the field sum (9); per posting: scale by the term's idf
    times expansion boost, keep the best expansion and add into the query
    sum (3)."""
    return 9 * F + 3


def bytes_per_posting(F):
    """The document id and one term frequency per field, 4 bytes each."""
    return 4 * (1 + F)
