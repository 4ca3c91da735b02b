"""The plain reference against the port's numpy oracle, its visit count
against a walk row by row, and its independence of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generators, reference
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops import oracle

PORTBENCH = Path(__file__).resolve().parents[1]
CASES = {
    # trees, depth, columns, keyword arguments of generate_forest
    "nan_missing": (30, 6, 12, {}),
    "early_leaves": (25, 7, 9, {"leaf_prob": 0.2}),
    "finite_sentinel": (20, 5, 8, {"missing": -999.0, "leaf_prob": 0.05}),
    "avg_bias_sigmoid": (16, 5, 10, {"output": 0x11, "global_bias": 0.5}),
    "wide_compacted": (12, 6, 479, {"active_cols": 300}),
}


def case(name: str, seed: int = 3):
    trees, depth, cols, kw = CASES[name]
    forest = generators.generate_forest(trees, depth, cols, seed=seed, **kw)
    if name == "early_leaves":  # the hot-child swap's flag, on a third of the nodes
        forest["exchange"] = np.random.default_rng(seed).random(
            forest["values"].shape) < 0.3
    rows = generators.generate_data(700, cols, missing=forest["missing"],
                                    missing_prob=0.1, seed=seed + 1)
    return forest, rows


def visits_row_by_row(forest: dict, rows: np.ndarray) -> np.ndarray:
    nan = np.isnan(forest["missing"])
    out = np.zeros(len(rows), np.int64)
    for r, x in enumerate(rows):
        for t in range(forest["values"].shape[0]):
            node = 0
            while not forest["is_leaf"][t, node]:
                out[r] += 1
                v = x[forest["fids"][t, node]]
                miss = np.isnan(v) if nan else abs(float(v) - forest["missing"]) <= 1e-6
                right = (not forest["def_left"][t, node]) if miss else bool(
                    v >= forest["values"][t, node])
                right ^= bool(forest["exchange"][t, node])
                node = 2 * node + 1 + int(right)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_is_the_oracle(name):
    forest, rows = case(name)
    want = oracle.predict(from_arrays(forest), rows)
    got, _ = reference.predict(forest, torch.from_numpy(rows), block_pairs=1000)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_visits_are_counted_node_by_node(name):
    forest, rows = case(name)
    _, visits = reference.predict(forest, torch.from_numpy(rows[:60]))
    assert np.array_equal(visits.numpy(), visits_row_by_row(forest, rows[:60]))


def test_blocks_do_not_change_the_answer():
    forest, rows = case("nan_missing")
    whole, v1 = reference.predict(forest, torch.from_numpy(rows))
    blocks, v2 = reference.predict(forest, torch.from_numpy(rows), block_pairs=37)
    assert torch.equal(whole, blocks) and torch.equal(v1, v2)


def test_bfloat16_control_is_far_from_the_reference():
    forest, rows = case("nan_missing")
    want, _ = reference.predict(forest, torch.from_numpy(rows))
    low, _ = reference.predict(forest, torch.from_numpy(rows), dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16
    assert (low.double() - want).abs().max() > 0.1


def imported_modules(path: Path) -> set:
    """Every module an ``import`` or ``from`` of ``path`` names, wherever it
    stands (top level or inside a function)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("module", ["reference.py", "generators.py", "work.py"])
def test_the_yardstick_imports_nothing_of_the_program(module):
    tops = {n.split(".")[0] for n in imported_modules(PORTBENCH / module)}
    assert not tops & {"tahoe_tpu_torch", "tahoe_tpu", "jax", "jaxlib", "flax"}, tops
