"""``torch.cuda.max_memory_reserved()`` over the whole run, set-up
included, in GiB: what a deployment provisions on the card."""


def read(ctx):
    peak = ctx["timed"]["peak_bytes"]
    return peak / 2**30 if peak else None
