"""Host ms a window of the program's ``plan/pool``: growing the term pool
(its concatenations, pruning bounds included, and its probe re-sort) and
the query-plan pool.  Beside it: the job rows appended a window
(``rows``)."""

from portbench.spans import span_count, span_ms


def read(ctx):
    v = span_ms(ctx, "plan/pool")
    if v is None:
        return None
    return {"value": v, "rows": span_count(ctx, "plan/pool", "items")}
