"""The control of ``correct`` at a size a test holds: the reference put in
the program's place in bfloat16 (the precision below the cells' float32)
fails the cells' check on every seed, and so does the float64 reference
with ties to the highest document.  The same controls at the cells' own sizes run on the card's host with
``python3 portbench/control.py`` (PERF.md)."""

import pytest

from portbench.control import controls

from conftest import tiny_cell

SEEDS = [2**31 + 1, 2**31 + 2, 2**31 + 3]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["msmarco-1m.bm25", "msmarco-1m.typeahead"])
def test_bfloat16_control_fails_bm25(name, seed):
    out = controls(tiny_cell(name), seed, [("bfloat16", "low")])[0]
    limit = out["checks"]["rank_gap"]["limit"]
    assert out["rank_gap"] > 3 * limit, out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["msmarco-1m.bm25", "msmarco-1m.typeahead"])
def test_tie_control_fails_bm25(name, seed):
    """The float64 reference with ties to the highest document."""
    out = controls(tiny_cell(name), seed, [("float64", "high")])[0]
    assert out["tie_rows"] > out["checks"]["tie_rows"]["limit"], out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["msmarco-1m.bm25", "msmarco-1m.typeahead"])
def test_float64_in_the_programs_place_passes(name, seed):
    out = controls(tiny_cell(name), seed, [("float64", "low")])[0]
    assert out["rank_gap"] == 0.0 and out["bad_rows"] == 0 and out["tie_rows"] == 0
