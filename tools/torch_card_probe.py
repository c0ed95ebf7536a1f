#!/usr/bin/env python3
"""Does the port keep to its own card?  A probe on a host with two or more
CUDA cards.

    python3 tools/torch_card_probe.py [--root DIR]

Imports ``probly_search_tpu_torch`` from DIR (default: this checkout), and
the seeded kernel inputs (``tests/torch_util.kernel_case``) from this
checkout, so a parent checkout and a change run the same probe.  With
``cuda:0`` current:

- each kernel wrapper (K1 phase full, K3 phase lanes, K4, K5, P1) launches
  once on seeded tensors on ``cuda:1``; the probe reads
  ``torch.cuda.current_device()`` after the launch (then sets 0 again), and
  whether the result agrees with the plain version;
- a template is frozen from a window on ``cuda:0`` and saved; a
  ``DeviceIndex`` on ``cuda:0`` and then one on ``cuda:1`` load it and
  ``prewarm`` (each captures the template's window step as a CUDA graph);
  both serve two windows of that template, and the probe reports for
  each whether its rows equal the eager engine's on ``cuda:0``, its live
  rows, its template replays, and the current device after.

Prints the card's name and power limit, then one JSON line.  Exits 1
without a second card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile


def agree(got, want, testing) -> bool:
    import torch

    if len(got) == 1:
        return bool(torch.equal(got[0], want[0]))
    a = [t.cpu().numpy() for t in (*got, *want)]
    if got[0].shape[1] > 128:  # K3's lanes
        return bool(torch.equal(got[1], want[1]) and torch.allclose(
            got[0], want[0], rtol=testing.RTOL, atol=testing.ATOL, equal_nan=True))
    try:
        testing.assert_topk_agree(*a)
    except AssertionError:
        return False
    return True


def template_probe(pt, pdev, bm25):
    """Rows of a prewarmed template on cuda:0 and on cuda:1."""
    import numpy as np
    import torch

    rng = random.Random(5)
    vocab = ["w%03d" % i for i in range(400)]
    texts = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 6))) for _ in range(20000)]
    w1 = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(60)]
    windows = [w1, w1[::-1]]
    ix = pt.Index(1, config=pt.IndexConfig(chunk_size=128, result_format="f32"))
    ix.add_documents_columnar(list(range(len(texts))), [texts])
    eager = pdev.DeviceIndex(ix, device="cuda:0")
    want = [eager.query_batch_async(w, bm25.new(), top_k=10).get_arrays() for w in windows]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        eager.save_templates(path)
        graphs = []
        for dev in ("cuda:0", "cuda:1"):
            d = pdev.DeviceIndex(ix, device=dev)
            d.load_templates(path)
            out[f"prewarmed_{dev}"] = d.prewarm(bm25.new())
            out[f"current_device_after_prewarm_{dev}"] = torch.cuda.current_device()
            torch.cuda.set_device(0)
            graphs.append(d)
    for dev, d in zip(("cuda:0", "cuda:1"), graphs):
        before = pdev.metrics.counters.get("template_graph_replays", 0)
        got = [d.query_batch_async(w, bm25.new(), top_k=10).get_arrays() for w in windows]
        out[f"replays_{dev}"] = pdev.metrics.counters.get("template_graph_replays", 0) - before
        out[f"rows_equal_eager_{dev}"] = all(
            np.array_equal(a, b) for g, e in zip(got, want) for a, b in zip(g, e))
        out[f"live_rows_{dev}"] = int(sum((g[1] >= 0).sum() for g in got))
    out["live_rows_eager"] = int(sum((e[1] >= 0).sum() for e in want))
    out["current_device_after"] = torch.cuda.current_device()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print(f"torch_card_probe: needs two CUDA cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 1
    import probly_search_tpu_torch as pt
    from probly_search_tpu_torch import bm25, testing
    from probly_search_tpu_torch.index import device as pdev

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "card_probe_util", os.path.join(here, "tests", "torch_util.py"))
    util = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(util)
    assert os.path.dirname(os.path.dirname(pt.__file__)) == root, pt.__file__
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    result = {"root": os.path.relpath(root), "cards": torch.cuda.device_count(), "kernels": {}}
    for name in ("K1", "K3", "K4", "K5", "P1"):
        inputs, kernel, plain, _counter = util.kernel_case(name, dev)
        got = kernel(*inputs)
        after = torch.cuda.current_device()
        torch.cuda.set_device(0)
        torch.cuda.synchronize(dev)
        result["kernels"][name] = {
            "current_device_after": after, "agrees": agree(got, plain(*inputs), testing)}
    try:
        result["template"] = template_probe(pt, pdev, bm25)
    except Exception as e:  # a fault to report, not to stop at
        result["template"] = {"error": repr(e)}
    torch.cuda.set_device(0)
    print(smi[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
