"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, a small cell driven on the CPU through
the same set-up, window and check, with the program's answers altered where
they are drained, or half of each window's rows left out."""

import numpy as np
import pytest

from portbench import run

from conftest import tiny_cell

CELLS = ["msmarco-1m.bm25", "msmarco-1m.typeahead"]


def _broken(monkeypatch, fault):
    from probly_search_tpu_torch.index import device

    inner = device.PendingBatch.get_arrays

    def get_arrays(self, want_keys=True):
        scores, slots, keys = inner(self, want_keys)
        slots, keys = slots.copy(), keys.copy()
        if fault == "answer":
            # Every row's best answer replaced by another document.
            other = (slots[:, 0] + 1) % self._dix.num_slots
            live = slots[:, 0] >= 0
            slots[live, 0] = other[live]
            keys[live, 0] = other[live]
        else:  # "half": the second half of the window never computed
            slots[len(slots) // 2 :] = -1
        return scores, slots, keys

    monkeypatch.setattr(device.PendingBatch, "get_arrays", get_arrays)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run.run_cell(tiny_cell(name), 2**31 + 101, 0.5, False, "cpu")
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["answer", "half"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    res = run.run_cell(tiny_cell(name), 2**31 + 101, 0.5, False, "cpu")
    assert not res["correct"], res["checks"]
    assert res["checks"]["bad_rows"]["value"] > 0
