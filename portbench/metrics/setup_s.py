"""Wall seconds from the start of the benchmark's process to the start of
the measured window: corpus, index build, device snapshot, query pool and
warm-up passes."""


def read(ctx):
    return ctx["timed"]["setup_s"]
