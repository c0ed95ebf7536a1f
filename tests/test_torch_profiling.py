"""The port's tracing utility (``probly_search_tpu_torch.utils.profiling``),
the counterpart of the JAX package's: ``device_trace`` writes a Chrome /
Perfetto trace through ``torch.profiler`` (CPU activity here; CUDA too where
a card is present).  The spans it shows are tested in ``test_torch_spans.py``."""

import json
import os

import torch

from probly_search_tpu_torch.utils import profiling


def test_device_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    with profiling.device_trace(str(out)):
        torch.ones(64).cumsum(0)
    with open(os.path.join(out, "trace.json")) as f:
        trace = json.load(f)
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])
