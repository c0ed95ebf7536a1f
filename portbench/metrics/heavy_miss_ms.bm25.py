"""Host ms a window of the program's ``query/heavy_miss``: each heavy-query
cache miss served as a blocking one-query window inside the submit call,
from its submit to its drained rows.  Beside it: the misses a window
(``misses``)."""

from portbench.spans import span_count, span_ms


def read(ctx):
    v = span_ms(ctx, "query/heavy_miss")
    if v is None:
        return None
    return {"value": v, "misses": span_count(ctx, "query/heavy_miss")}
