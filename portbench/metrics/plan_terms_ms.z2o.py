"""Host ms a window of the program's ``z2o/plan_terms`` self time: the
zero-to-one planner's first-sight pass over the queries not yet pooled
(tokenising, expansion by binary search, df, node ids, entry scores, the
shared-node test, chunk counts).  Beside it: those queries a window
(``queries``) and the ``z2o/plan`` self ms a window (``plan_self_ms``: the
pool lookups and the window's gather), so that ``plan_self_ms`` + the value
+ ``plan_pool_ms.z2o`` make ``plan_ms.z2o``.  None from a program without
the span."""

from portbench.spans import span_count, span_ms


def read(ctx):
    if "z2o/plan_terms" not in ctx["timers"]:
        return None
    v = span_ms(ctx, "z2o/plan_terms", "self_us")
    if v is None:
        return None
    return {
        "value": v,
        "queries": span_count(ctx, "z2o/plan_terms", "items"),
        "plan_self_ms": span_ms(ctx, "z2o/plan", "self_us"),
    }
