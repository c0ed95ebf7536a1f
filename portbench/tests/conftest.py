"""Shared set-up of the benchmark's tests: the repository root on the path,
the ``cuda`` marker, and the cells of ``BENCHMARK.json`` cut to a size a
CPU test holds (one file a cell under ``tiny/``)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips (inside the test) where none is present"
    )


def _merge(base: dict, cut: dict) -> dict:
    """``base`` with the values of ``cut`` in place of its own, nested
    dicts key by key."""
    out = dict(base)
    for key, value in cut.items():
        out[key] = _merge(base.get(key, {}), value) if isinstance(value, dict) else value
    return out


def tiny_cell(name: str, root: Path = ROOT):
    """The cell ``name`` of ``root/BENCHMARK.json`` cut to the size in
    ``portbench/tests/tiny/<name>.json``: its ``config`` and ``traffic``
    values (sizes; the shapes and the scorer stay the cell's) replace the
    cell's own."""
    from portbench import manifest

    cell = manifest.resolve(root, name)
    cut = json.loads((root / "portbench" / "tests" / "tiny" / f"{name}.json").read_text())
    cell.config = _merge(cell.config, cut.get("config", {}))
    cell.traffic = _merge(cell.traffic, cut.get("traffic", {}))
    return cell


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card with python3 -m pytest -m cuda portbench/tests")
    return "cuda"
