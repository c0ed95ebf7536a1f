"""The least time of the window's scoring work (``portbench/counts.py``,
counted from the workload) over the card's kernel-busy time (union of
kernel intervals), in %, with the bound that applies and the card's power
limit beside it."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "bm25")
