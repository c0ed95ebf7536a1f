"""The small cells on the card, traced: correct, the card busy, every
roofline share under 100%.  Run on the card:
``python3 -m pytest -m cuda portbench/tests``."""

import pytest

from portbench import run

from conftest import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["msmarco-1m.bm25", "msmarco-1m.typeahead"])
def test_small_cell_on_the_card(cuda_device, name):
    res = run.run_cell(tiny_cell(name), 2**31 + 55, 1.0, True, cuda_device)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert res["breakdown"]["device_ops"]
    for m, v in res["metrics"].items():
        if m.startswith("step_roofline_pct"):
            assert 0 < v["value"] < 100, (m, v)
