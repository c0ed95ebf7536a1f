"""Mean host ms a window of the program's ``z2o/pack``: the zero-to-one
classes' job tables and qlen vectors, over the measured window."""

from portbench.readers import timer_ms


def read(ctx):
    return timer_ms(ctx, "z2o/pack")
