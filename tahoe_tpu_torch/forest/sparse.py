"""Sparse (CSR) forests: SparseForest, from_dense, predict_margins_np and
predict_np, the port's own copy of the numpy half of
tahoe_tpu/forest/sparse.py (held to the original bit for bit by
tests/test_torch_host_layer.py), and the SPARSE strategy's gather tier in
plain PyTorch.

The CSR layout is the reference's ``sparse_forest`` (Struct.h:2327-2353):
one flat SoA pool over all trees, each internal node's children at
``left_idx`` and ``left_idx + 1`` (``curr = left_idx + cond``,
Struct.h:2244); ``from_dense`` prunes the subtrees below early leaves, so
depth-20 forests are stored at their true node count.

``SparseGatherEngine`` is the port of tahoe_tpu/forest/sparse.py:147-224:
the pruned node pool stays in device memory and every (row, tree) lane
advances one level per step, ``curr = left_idx + cond``, masked at leaves.
SPARSE takes it for forests whose banded live features do not fit the rank
planes (more than 480); the JAX package runs it as plain XLA, so it has no
kernel here either.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tahoe_tpu_torch.config import MISSING_EPS, Output, resolve_device
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops.gather_engine import IS_LEAF, node_cond, node_flags
from tahoe_tpu_torch.ops.graphed import GraphedEngine
from tahoe_tpu_torch.ops.oracle import apply_output_transform_np
from tahoe_tpu_torch.ops.rows import map_row_chunks, stage_rows

__all__ = ["SparseForest", "SparseGatherEngine", "from_dense",
           "predict_margins_np", "predict_np"]


@dataclasses.dataclass
class SparseForest:
    num_cols: int
    values: np.ndarray
    fids: np.ndarray
    def_left: np.ndarray
    is_leaf: np.ndarray
    exchange: np.ndarray
    left_idx: np.ndarray
    tree_roots: np.ndarray
    max_depth: int
    output: int = int(Output.RAW)
    global_bias: float = 0.0
    threshold: float = 0.5
    missing: float = float("nan")

    @property
    def num_trees(self) -> int:
        return int(self.tree_roots.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.values.shape[0])


def from_dense(forest: ForestSpec) -> SparseForest:
    """Dense complete-tree forest → pruned CSR forest (BFS order per tree).

    Only reachable nodes are emitted: children of early leaves are dropped
    (the reference's dense layout stores them anyway, Struct.h:19-21)."""
    values, fids = [], []
    def_left, is_leaf, exchange, left_idx = [], [], [], []
    roots = []
    max_depth = 0

    for t in range(forest.num_trees):
        base = len(values)
        roots.append(base)
        # BFS over heap indices; emit in visit order, so each internal node's
        # children land as a contiguous pair whose position is the running
        # child cursor
        queue = [(0, 0)]  # (heap index, depth)
        head = 0
        while head < len(queue):
            h, d = queue[head]
            head += 1
            max_depth = max(max_depth, d)
            leaf = bool(forest.is_leaf[t, h]) or d == forest.depth
            values.append(forest.values[t, h])
            fids.append(forest.fids[t, h])
            def_left.append(forest.def_left[t, h])
            is_leaf.append(leaf)
            exchange.append(forest.exchange[t, h])
            left_idx.append(-1)  # patched below for internal nodes
            if not leaf:
                queue.append((2 * h + 1, d + 1))
                queue.append((2 * h + 2, d + 1))
        child_cursor = base + 1
        for i in range(len(queue)):
            node = base + i
            if not is_leaf[node]:
                left_idx[node] = child_cursor
                child_cursor += 2
        assert child_cursor == base + len(queue)

    return SparseForest(
        num_cols=forest.num_cols,
        values=np.asarray(values, np.float32),
        fids=np.asarray(fids, np.int32),
        def_left=np.asarray(def_left, bool),
        is_leaf=np.asarray(is_leaf, bool),
        exchange=np.asarray(exchange, bool),
        left_idx=np.asarray(left_idx, np.int32),
        tree_roots=np.asarray(roots, np.int32),
        max_depth=max_depth,
        output=forest.output,
        global_bias=forest.global_bias,
        threshold=forest.threshold,
        missing=forest.missing,
    )


def predict_margins_np(sf: SparseForest, data: np.ndarray) -> np.ndarray:
    """Vectorized numpy CSR descent (oracle for the sparse engine)."""
    data = np.asarray(data, np.float32)
    rows = data.shape[0]
    curr = np.broadcast_to(sf.tree_roots[None, :], (rows, sf.num_trees)).copy()
    if np.isnan(np.float32(sf.missing)):
        miss_of = lambda xv: np.isnan(xv)
    else:
        miss_of = lambda xv: np.abs(xv - np.float32(sf.missing)) <= np.float32(MISSING_EPS)

    for _ in range(sf.max_depth):
        leaf = sf.is_leaf[curr]
        thr = sf.values[curr]
        fid = sf.fids[curr]
        dl = sf.def_left[curr]
        ex = sf.exchange[curr]
        xv = np.take_along_axis(data, fid, axis=1)
        cond = np.where(miss_of(xv), ~dl, xv >= thr)
        cond = np.where(ex, ~cond, cond)
        nxt = sf.left_idx[curr] + cond
        curr = np.where(leaf, curr, nxt)
    return sf.values[curr].sum(axis=1, dtype=np.float32)


def predict_np(sf: SparseForest, data: np.ndarray) -> np.ndarray:
    return apply_output_transform_np(
        predict_margins_np(sf, data), sf.num_trees, sf.output,
        sf.global_bias, sf.threshold,
    )


class SparseGatherEngine(GraphedEngine):
    """A CSR pool on ``device`` and its level-synchronous gather descent."""

    def __init__(self, sf: SparseForest, *, device):
        self.device = resolve_device(device)
        self.sf = sf
        self.num_trees = sf.num_trees
        self.output = sf.output
        self.global_bias = sf.global_bias
        self.threshold = sf.threshold
        dev = self.device
        self.values = torch.as_tensor(sf.values, device=dev)
        self.fids = torch.as_tensor(sf.fids, device=dev)
        self.flags = torch.as_tensor(
            node_flags(sf.def_left, sf.is_leaf, sf.exchange), device=dev)
        self.left_idx = torch.as_tensor(sf.left_idx, dtype=torch.int64, device=dev)
        self.roots = torch.as_tensor(sf.tree_roots, dtype=torch.int64, device=dev)
        # one CUDA graph a shape on the card (ops/graphed.py), as the JAX
        # engine jits _predict_impl
        self._graph()

    def _margins_chunk(self, x: torch.Tensor) -> torch.Tensor:
        curr = self.roots.expand(x.shape[0], self.num_trees)
        for _ in range(self.sf.max_depth):
            flags = self.flags[curr]
            cond = node_cond(x, self.sf.missing, self.fids[curr],
                             self.values[curr], flags)
            curr = torch.where((flags & IS_LEAF) != 0, curr,
                               self.left_idx[curr] + cond)
        return self.values[curr].sum(dim=1)

    def _stage(self, rows, out: torch.Tensor | None = None) -> torch.Tensor:
        return stage_rows(rows, device=self.device, out=out)

    def _margins_staged(self, x: torch.Tensor) -> torch.Tensor:
        return map_row_chunks(self._margins_chunk, x, 48 * self.num_trees)
