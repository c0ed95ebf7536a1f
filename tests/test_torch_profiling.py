"""The port's tracing utilities (``probly_search_tpu_torch.utils.profiling``),
the counterpart of the JAX package's: phase timers feed the metrics
registry, and ``device_trace`` writes a Chrome / Perfetto trace through
``torch.profiler`` (CPU activity here; CUDA too where a card is present)."""

import json
import os

import torch

from probly_search_tpu_torch.utils import profiling
from probly_search_tpu_torch.utils.metrics import metrics


def test_phase_and_annotate_feed_the_registry():
    metrics.reset()
    with profiling.phase("plan"):
        pass

    @profiling.annotate("drain")
    def drain(x):
        return x + 1

    assert drain(1) == 2 and drain.__name__ == "drain"
    hist = metrics.snapshot()["histograms"]
    assert hist["phase/plan"]["count"] == 1 and hist["phase/drain"]["count"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    with profiling.device_trace(str(out)):
        torch.ones(64).cumsum(0)
    with open(os.path.join(out, "trace.json")) as f:
        trace = json.load(f)
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])
