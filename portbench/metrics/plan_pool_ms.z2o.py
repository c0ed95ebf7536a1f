"""Host ms a window of the program's ``z2o/plan_pool`` self time: appending
the first-sight queries' job rows and per-query columns to the zero-to-one
query-plan pool.  Beside it: the job rows appended a window (``rows``).
None from a program without the span."""

from portbench.spans import span_count, span_ms


def read(ctx):
    if "z2o/plan_pool" not in ctx["timers"]:
        return None
    v = span_ms(ctx, "z2o/plan_pool", "self_us")
    if v is None:
        return None
    return {"value": v, "rows": span_count(ctx, "z2o/plan_pool", "items")}
