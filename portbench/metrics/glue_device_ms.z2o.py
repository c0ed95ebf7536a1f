"""Device ms a window of the torch ops the port runs on the card in the
zero-to-one cell (chunk expansion, the staged fast program, the lockstep
program's sorts and scans, packing, copies of results): every kernel of the
traced window that is none of the port's hand-written CUDA kernels
(``readers.PORT_KERNELS``)."""

from portbench.readers import glue_ms


def read(ctx):
    return glue_ms(ctx, "zero_to_one")
