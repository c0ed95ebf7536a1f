"""Host ms a window of the program's ``plan/pool``: appending the window's
rows to the term pool (its pruning bounds' rows included) and to the
query-plan pool, with the reallocations of a full column nested in it
(``plan/pool_grow``).  Beside it: the job rows appended a window
(``rows``)."""

from portbench.spans import span_count, span_ms


def read(ctx):
    v = span_ms(ctx, "plan/pool")
    if v is None:
        return None
    return {"value": v, "rows": span_count(ctx, "plan/pool", "items")}
