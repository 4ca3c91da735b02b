"""The counting of work, from the forest's arrays alone, and the least
time."""
from __future__ import annotations

import numpy as np

from portbench import generators, work


def test_least_time_is_the_larger_bound():
    ops, moved = np.array([67e12, 1.0, 134e12]), np.array([1.0, 3.35e12, 3.35e12])
    assert np.allclose(work.least_time(ops, moved), [1.0, 1.0, 2.0])


def test_complete_forest_shape():
    f = generators.generate_forest(500, 8, 18, seed=1)
    assert work.forest_shape(f) == work.ForestShape(500, 500 * 511, 18)


def test_compacted_forest_reads_its_live_columns():
    f = generators.generate_forest(150, 8, 479, active_cols=300, seed=1)
    assert work.forest_shape(f).live_cols == len(np.unique(f["fids"][:, :255]))
    assert work.forest_shape(f).live_cols <= 300


def test_nodes_under_an_early_leaf_are_not_counted():
    f = generators.generate_forest(3, 3, 4, seed=2)
    f["is_leaf"][:] = False
    f["is_leaf"][:, 7:] = True
    f["is_leaf"][0, 1] = True  # tree 0: the root's left child is a leaf
    f["fids"][:] = 0
    f["fids"][1, 0] = 3
    shape = work.forest_shape(f)
    assert shape.nodes == 3 * 15 - 6
    assert shape.live_cols == 2


def test_call_work_counts_rows_visits_nodes_and_outputs():
    shape = work.ForestShape(trees=10, nodes=100, live_cols=5)
    ops, moved = work.call_work(shape, np.array([4, 8]), np.array([30, 70]))
    assert list(ops) == [30 + 40, 70 + 80]
    assert list(moved) == [4 * 5 * 4 + 1200 + 16, 8 * 5 * 4 + 1200 + 32]
