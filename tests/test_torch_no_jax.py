"""The torch port imports torch and never JAX, nor anything of the JAX
package ``probly_search_tpu``.

The test process itself imports JAX (conftest.py), so the proof runs in a
fresh interpreter where ``import jax`` fails: it imports the port (the
launch probe and the profiling utilities too), serves a 50-document slice
on the CPU with BM25 and with zero-to-one, checks that
DeviceIndex refuses a CUDA device that is not there, and ends with no module
of the JAX package loaded.  A static check finds no import of the JAX
package in the port or in ``chip_smoke.py``.
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

ix = pt.Index(1, device="cpu")
texts = ["w%d w%d common" % (i % 7, i % 11) for i in range(50)]
ix.add_documents_columnar(list(range(50)), [texts])
dix = pt.DeviceIndex(ix, device="cpu")
h = dix.query_batch_async(["w3 common", "w5", "nothing"], pt.bm25.new(), top_k=5)
scores, slots, keys = h.get_arrays()
assert slots.shape == (3, 5) and (slots[0] >= 0).all() and (slots[2] == -1).all(), slots
oracle = [r.key for r in ix.query("w3 common", pt.bm25.new(), pt.whitespace_tokenizer, [1.0])[:5]]
assert [int(k) for k in keys[0]] == oracle, (keys[0], oracle)
z2o = ix.query_batch(["w3 common", "w5 w5"], pt.zero_to_one.new(), top_k=5)
z2o_oracle = ix.query("w3 common", pt.zero_to_one.new(), pt.whitespace_tokenizer, [1.0])[:5]
assert [r.key for r in z2o[0]] == [r.key for r in z2o_oracle] and z2o[1], z2o

import probly_search_tpu_torch.ops.launch_probe as lp
import probly_search_tpu_torch.utils.profiling  # noqa: F401
assert torch.equal(lp.probe_add(torch.zeros(3)), torch.ones(3))

torch.cuda.is_available = lambda: False
try:
    pt.DeviceIndex(ix, device="cuda")
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("DeviceIndex(device='cuda') must raise without a CUDA device")
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
jax_pkg = [m for m in sys.modules if m == "probly_search_tpu" or m.startswith("probly_search_tpu.")]
assert not jax_pkg, jax_pkg
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=PKG.parent, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stderr[-3000:]


def _sources():
    return [*PKG.rglob("*.py"), PKG.parent / "chip_smoke.py"]


def test_no_jax_import_in_the_package():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [str(p.relative_to(PKG.parent)) for p in _sources() if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_no_import_of_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+probly_search_tpu(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(PKG.parent)) for p in _sources() if pattern.search(p.read_text())]
    assert not offenders, offenders
