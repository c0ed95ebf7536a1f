"""Mean host ms a window of the program's ``z2o/dispatch``: the zero-to-one
classes' graph replays (and captures of new class shapes), over the
measured window."""

from portbench.readers import timer_ms


def read(ctx):
    return timer_ms(ctx, "z2o/dispatch")
