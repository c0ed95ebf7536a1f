"""Mean host ms a window of the program's ``z2o/plan``: the zero-to-one
planner's lookups of the window's queries in the query-plan pool, the
first-sight planning (``z2o/plan_terms``), the pool's appends
(``z2o/plan_pool``) and the window's gather of job rows."""

from portbench.readers import timer_ms


def read(ctx):
    return timer_ms(ctx, "z2o/plan")
