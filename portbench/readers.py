"""What the metric readers (``portbench/metrics/<name>.py``) share.  A
reader gets the run's context and returns its number, a dict with
``value`` and further keys shown beside it, or None when the run holds
nothing for it to read (the metric is then left out of the line).

The context (``run.py``):
  timed     {"latencies_s", "queries", "wall_s", "setup_s", "peak_bytes"}
  timers    the program's timers over the measured window, by name:
            {"count", "mean_us"} (``utils.metrics`` histograms)
  trace     ``trace.reduce`` of the traced window (--trace 1), else None
  windows   windows drained in the measured window
  work      {"least_s", "bound"} of those windows (``counts``), or None
  scorer    the configuration's scorer name
  power_w   the card's power limit in W, or None
"""

from __future__ import annotations

from typing import Optional

# The port's hand-written CUDA kernels (``probly_search_tpu_torch/csrc/``),
# by name; every other kernel of a trace is the port's torch glue.
PORT_KERNELS = (
    "fused_query_full_kernel",
    "fused_query_lanes_kernel",
    "fused_z2o_kernel",
    "merge_block_kernel",
    "radix_hist_kernel",
    "radix_scan_kernel",
    "radix_scatter_kernel",
    "radix_count_kernel",
    "radix_collect_kernel",
    "radix_totals_kernel",
    "radix_finish_kernel",
    "probe_add_scalar",
    "probe_add_vec4",
)


def timer_ms(ctx, name: str) -> Optional[float]:
    """Host ms a window in the program's timer ``name``: its total over the
    measured window over the windows drained (a window may time it more
    than once, as the heavy queries of a window are submitted again)."""
    h = ctx["timers"].get(name)
    if not h or not h["count"] or not ctx["windows"]:
        return None
    return h["count"] * h["mean_us"] / 1e3 / ctx["windows"]


def glue_ms(ctx, scorer: str) -> Optional[float]:
    """Device ms a window of every kernel whose name holds none of
    ``PORT_KERNELS``."""
    tr = ctx["trace"]
    if tr is None or ctx["scorer"] != scorer or not ctx["windows"] or not tr["kernel_s"]:
        return None
    glue = sum(t for name, t in tr["kernel_s"].items() if not any(k in name for k in PORT_KERNELS))
    return glue * 1e3 / ctx["windows"]


def roofline_pct(ctx, scorer: str):
    """The windows' least time over the card's kernel-busy time, in %."""
    tr, work = ctx["trace"], ctx["work"]
    if tr is None or work is None or ctx["scorer"] != scorer or tr["kernel_busy_s"] <= 0:
        return None
    return {
        "value": 100.0 * work["least_s"] / tr["kernel_busy_s"],
        "bound": work["bound"],
        "power_limit_w": ctx["power_w"],
    }


def idle_pct(ctx, scorer: str) -> Optional[float]:
    tr = ctx["trace"]
    if tr is None or ctx["scorer"] != scorer or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
