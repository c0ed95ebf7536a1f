"""Host ms a window in which the program's ``z2o/plan`` held no CPU
(``offcpu_us``: its wall time less the planning thread's CPU time over it):
the zero-to-one planner's wait for the interpreter lock or for a core."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "z2o/plan", "offcpu_us")
