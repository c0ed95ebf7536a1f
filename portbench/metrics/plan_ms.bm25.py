"""Mean host ms a window of the program's ``query/plan``, over the measured
window."""

from portbench.readers import timer_ms


def read(ctx):
    return timer_ms(ctx, "query/plan")
