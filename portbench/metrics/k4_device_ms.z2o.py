"""Device ms a window of K4, ``fused_z2o_kernel`` (the fused zero-to-one
fast kernel, ``csrc/fused_z2o.cu``), over the traced window's windows."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["scorer"] != "zero_to_one" or not ctx["windows"]:
        return None
    k4 = [t for name, t in tr["kernel_s"].items() if "fused_z2o_kernel" in name]
    if not k4:
        return None
    return sum(k4) * 1e3 / ctx["windows"]
