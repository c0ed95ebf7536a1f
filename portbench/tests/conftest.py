"""Shared set-up of the benchmark's tests: the repository root on the path,
the ``cuda`` marker, and the cells of ``BENCHMARK.json`` cut to a size a
CPU test holds."""

import copy
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


# Per cell: docs, vocabulary terms, window, warm queries, stream queries
# (the shapes are the cell's).
TINY = {
    "msmarco-1m.bm25": (3000, 3000, 256, 1024, 65536),
    "msmarco-1m.typeahead": (3000, 3000, 128, 128, 2048),
}


def tiny_cell(name: str):
    """The cell ``name`` with its corpus, vocabulary, window and traffic cut
    down (a 2-letter shortest spelling, so prefixes still expand)."""
    from portbench import manifest

    cell = manifest.resolve(ROOT, name)
    docs, vocab, window, warm, stream = TINY[name]
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["corpus"]["docs"] = docs
    cfg["corpus"]["vocab"]["terms"] = vocab
    cfg["corpus"]["vocab"]["min_len"] = 2
    tr["check_rows"], tr["check_longest"] = 200, 8
    tr["window"], tr["warm_queries"], tr["stream_queries"] = window, warm, stream
    cell.config, cell.traffic = cfg, tr
    return cell


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card with python3 -m pytest -m cuda portbench/tests")
    return "cuda"
