"""Host ms a window of the program's ``plan/terms`` self time: planning the
terms seen for the first time, without the pruning bounds and the term
pool's growth nested in it.  Beside it: the first-sight terms a window
(``terms``), the ``query/prune_bounds`` ms a window (``bounds_ms``) and the
``query/plan`` self ms a window (``plan_self_ms``: tokenising, lookups and
the window's gather), so that ``plan_self_ms`` + the value + ``bounds_ms``
+ ``plan_pool_ms.bm25`` make ``plan_ms.bm25``."""

from portbench.spans import span_count, span_ms


def read(ctx):
    v = span_ms(ctx, "plan/terms", "self_us")
    if v is None:
        return None
    return {
        "value": v,
        "terms": span_count(ctx, "plan/terms", "items"),
        "bounds_ms": span_ms(ctx, "query/prune_bounds"),
        "plan_self_ms": span_ms(ctx, "query/plan", "self_us"),
    }
