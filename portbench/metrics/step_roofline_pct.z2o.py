"""The least time of the window's zero-to-one scoring work
(``portbench/counts.py`` with ``portbench/scorers/zero_to_one.py``'s bytes
and operations a posting, counted from the workload) over the card's
kernel-busy time, in %, with the bound that applies and the card's power
limit beside it."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "zero_to_one")
