"""Host ms a window of the program's ``query/capture``: CUDA graph captures
(class graphs and template graphs) inside the measured window.  Beside
it: the captures in the whole window (``captures``)."""

from portbench.spans import span_ms


def read(ctx):
    v = span_ms(ctx, "query/capture")
    if v is None:
        return None
    return {"value": v, "captures": ctx["timers"].get("query/capture", {}).get("count", 0)}
