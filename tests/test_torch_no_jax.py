"""The torch port imports torch and never JAX.

The test process itself imports JAX (conftest.py), so the proof runs in a
fresh interpreter where ``import jax`` fails: it imports the port, serves a
50-document slice on the CPU, and checks that DeviceIndex refuses a CUDA
device that is not there.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import probly_search_tpu_torch

PKG = Path(probly_search_tpu_torch.__file__).resolve().parent

_CHILD = r"""
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import torch
import probly_search_tpu_torch as pt

ix = pt.Index(1)
texts = ["w%d w%d common" % (i % 7, i % 11) for i in range(50)]
ix.add_documents_columnar(list(range(50)), [texts])
dix = pt.DeviceIndex(ix, device="cpu")
h = dix.query_batch_async(["w3 common", "w5", "nothing"], pt.bm25.new(), top_k=5)
scores, slots, keys = h.get_arrays()
assert slots.shape == (3, 5) and (slots[0] >= 0).all() and (slots[2] == -1).all(), slots
oracle = [r.key for r in ix.query("w3 common", pt.bm25.new(), pt.whitespace_tokenizer, [1.0])[:5]]
assert [int(k) for k in keys[0]] == oracle, (keys[0], oracle)

torch.cuda.is_available = lambda: False
try:
    pt.DeviceIndex(ix, device="cuda")
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("DeviceIndex(device='cuda') must raise without a CUDA device")
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=PKG.parent, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stderr[-3000:]


def test_no_jax_import_in_the_package():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [
        str(p.relative_to(PKG.parent))
        for p in PKG.rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert not offenders, offenders
