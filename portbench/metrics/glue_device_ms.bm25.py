"""Device ms a window of the torch ops the port runs on the card (its glue:
chunk expansion, gathers, packing, copies of results), that is of every
kernel of the traced window that is none of the port's hand-written CUDA
kernels (``readers.PORT_KERNELS``)."""

from portbench.readers import glue_ms


def read(ctx):
    return glue_ms(ctx, "bm25")
