"""What decides ``correct`` has to fail what is wrong: the control (the
reference in bfloat16 in the program's place), and a run with the timed
path broken underneath, once for each fault a cell of one card can have.
(The exchange between cards is a fault of four-card cells only.)"""
from __future__ import annotations

import json

import pytest

from portbench import control, run
from portbench.tests.conftest import TINY_CELLS
from tahoe_tpu_torch.engine.forest import Forest

CELLS = sorted(TINY_CELLS)


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell, seed):
    r = control.control_gap(tiny_root, cell, seed, device="cpu")
    assert not r["correct"] and r["control_gap"] > 100 * r["limit"]


def stale(pred, state):
    """A step that returns its state unchanged: the last call's answer."""
    last = state.get("last")
    state["last"] = pred
    return pred if last is None else last


def half_left_out(pred, state):
    """Half of the batch left out, the mean of the rest in its place."""
    kept = (len(pred) + 1) // 2
    out = pred.clone()
    out[kept:] = pred[:kept].mean()
    return out


def altered(pred, state):
    """One answer altered where it is produced: the middle row's."""
    out = pred.clone()
    out[len(pred) // 2] += 1.0
    return out


def nan_answer(pred, state):
    """One answer produced as NaN: wrong, and the result line stays JSON."""
    out = pred.clone()
    out[0] = float("nan")
    return out


FAULTS = {"stale": stale, "half_left_out": half_left_out, "altered": altered,
          "nan_answer": nan_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    """Every call goes through the fault, the warm-up's too: so a window
    of one call still gets a stale answer."""
    state = {}
    sound = Forest.predict
    monkeypatch.setattr(Forest, "predict", lambda self, rows, strategy: FAULTS[fault](
        sound(self, rows, strategy), state))
    result = run.run_cell(tiny_root, cell, 9, 0.3, False, device="cpu")
    assert result["correct"] is False
    json.dumps(result, allow_nan=False)
    assert result["checks"]["max_abs_gap"]["value"] > result["checks"][
        "max_abs_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_a_sound_traced_run_is_correct(tiny_root, cuda_device, cell):
    result = run.run_cell(tiny_root, cell, 21, 0.5, True, device="cuda")
    assert result["correct"] and result["device"]["busy_s"] > 0
    for name, m in result["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, name


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_control_is_not_correct(tiny_root, cuda_device, cell):
    assert not control.control_gap(tiny_root, cell, 5, device="cuda")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [31, 2**31 + 33, 35])
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["susy.batch", "cup98.batch"])
def test_on_the_card_a_broken_path_is_not_correct_at_the_cells_size(
        cuda_device, monkeypatch, cell, fault, seed):
    """The cell as committed, its table and batch, a short window."""
    state = {}
    sound = Forest.predict
    monkeypatch.setattr(Forest, "predict", lambda self, rows, strategy: FAULTS[fault](
        sound(self, rows, strategy), state))
    result = run.run_cell(run.ROOT, cell, seed, 1.0, False, device="cuda")
    gap = result["checks"]["max_abs_gap"]
    print(f"fault {fault} in {cell}, seed {seed}: max_abs_gap {gap['value']!r}")
    assert result["correct"] is False and gap["value"] > 10 * gap["limit"]
