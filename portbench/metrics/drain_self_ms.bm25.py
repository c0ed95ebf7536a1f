"""Host ms a window of the program's ``query/drain`` self time: decoding
the drained rows, without the ``query/fetch`` wait nested in it."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "query/drain", "self_us")
