"""Queries drained in the measured window over its wall seconds (first
submit to last drain), on the host's clock."""


def read(ctx):
    t = ctx["timed"]
    if t["wall_s"] <= 0:
        return None
    return t["queries"] / t["wall_s"]
