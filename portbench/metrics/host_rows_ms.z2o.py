"""Host ms a window of the program's ``z2o/host_rows``: the rows of the
queries past the device caps, computed by the vectorized float64 host path
inside the submit call.  Beside it: those queries a window (``queries``).
A window with none reads 0.0; None from a program without the planner's
zero-to-one spans (no ``z2o/plan_terms``)."""

from portbench.spans import span_count, span_ms


def read(ctx):
    if "z2o/plan_terms" not in ctx["timers"]:
        return None
    v = span_ms(ctx, "z2o/host_rows")
    if v is None:
        return None
    return {"value": v, "queries": span_count(ctx, "z2o/host_rows", "items")}
