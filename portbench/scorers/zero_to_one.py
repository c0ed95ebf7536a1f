"""Zero-to-one: the port's scorer, the float64 reference
(``portbench/reference/zero_to_one.py``) and the least work of one posting
(``portbench/counts.py``)."""

from portbench.reference import zero_to_one as z2o


def program(spec):
    from probly_search_tpu_torch import zero_to_one

    return zero_to_one.new()


def reference(ix, words, spec, precision="float64"):
    return z2o.zero_to_one(ix, words, precision=precision)


def ops_per_posting(F):
    """Per field: the entry's contribution, which is ``score / max(length,
    query words)`` since ``score <= 1 <= tf`` makes ``min(score / tf, 1) *
    tf`` the score itself (the larger length and the division, 2), keeping
    the best entry of its query word (1), adding it into the field's sum (1)
    and taking the larger of the field sums (1)."""
    return 5 * F


def bytes_per_posting(F):
    """The document id and one term frequency per field, 4 bytes each (the
    df pool and the field test read the counts; the field lengths are the
    document's, not the posting's)."""
    return 4 * (1 + F)
