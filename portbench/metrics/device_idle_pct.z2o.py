"""Share of the traced window's wall time in which the card runs no
operation, in %, in the zero-to-one cell."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "zero_to_one")
