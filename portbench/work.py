"""The work a predict has to do, counted from the forest's arrays and the
rows alone, never from the program's tables, and the least time an H100
could do it in.

- Operations: one compare for each internal node a row visits (the plain
  reference's walk counts them) and one add for each leaf, one per tree.
- Bytes: each input value of a column the forest reads, read once; the
  forest's reachable nodes once a call, at the reference binary's node
  width (its 12-byte ``dense_node_t``); each prediction written once.
- Least time: the larger of the operations at the card's scalar f32 rate
  and the bytes at its memory rate: the published peaks of an H100 SXM
  (NVIDIA's data sheet, dense, at 700 W).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
NODE_BYTES = 12
VALUE_BYTES = 4


class ForestShape(NamedTuple):
    """What the count needs of a forest: its trees, its reachable nodes,
    and the columns its reachable internal nodes read."""

    trees: int
    nodes: int
    live_cols: int


def forest_shape(forest: dict) -> ForestShape:
    is_leaf = np.asarray(forest["is_leaf"], bool)
    trees, nodes = is_leaf.shape
    reach = np.zeros_like(is_leaf)
    reach[:, 0] = True
    # heap order: a node's children come after it, so one pass in order
    # reaches every node under an internal one
    for i in range((nodes - 1) // 2):
        down = reach[:, i] & ~is_leaf[:, i]
        reach[:, 2 * i + 1] = down
        reach[:, 2 * i + 2] = down
    inner = reach & ~is_leaf
    live = np.unique(np.asarray(forest["fids"])[inner]).size
    return ForestShape(trees, int(reach.sum()), int(live))


def call_work(shape: ForestShape, rows, visits) -> tuple:
    """(operations, bytes) of predicts of ``rows`` rows each, whose rows
    visit ``visits`` internal nodes in all (scalars or arrays, one entry a
    call)."""
    rows = np.asarray(rows, np.float64)
    ops = np.asarray(visits, np.float64) + rows * shape.trees
    moved = (rows * shape.live_cols * VALUE_BYTES + shape.nodes * NODE_BYTES
             + rows * VALUE_BYTES)
    return ops, moved


def least_time(ops, moved):
    """Seconds: the larger of the operations at the scalar rate and the
    bytes at the memory rate, elementwise."""
    return np.maximum(np.asarray(ops, np.float64) / SCALAR_OPS_PER_S,
                      np.asarray(moved, np.float64) / HBM_BYTES_PER_S)

