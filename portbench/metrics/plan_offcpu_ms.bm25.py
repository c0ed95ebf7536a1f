"""Host ms a window in which the program's ``query/plan`` held no CPU
(``offcpu_us``: its wall time less the planning thread's CPU time over it,
in the windows the caller submits).  The planner is pure host work, so this
is the wait for the interpreter lock (held by the drain thread meanwhile)
or for a core."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "query/plan", "offcpu_us")
