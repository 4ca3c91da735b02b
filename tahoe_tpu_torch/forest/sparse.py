"""Sparse (CSR) forests: the numpy host layer's SparseForest, from_dense and
predict_margins_np (tahoe_tpu/forest/sparse.py, jax-free, re-exported), and
the SPARSE strategy's gather tier in plain PyTorch.

``SparseGatherEngine`` is the port of tahoe_tpu/forest/sparse.py:147-224:
the pruned node pool stays in device memory and every (row, tree) lane
advances one level per step, ``curr = left_idx + cond``, masked at leaves.
SPARSE takes it for forests whose banded live features do not fit the rank
planes (more than 480); the JAX package runs it as plain XLA, so it has no
kernel here either.
"""
from __future__ import annotations

import torch

from tahoe_tpu.forest.sparse import SparseForest, from_dense, predict_margins_np
from tahoe_tpu_torch.config import resolve_device
from tahoe_tpu_torch.ops.gather_engine import IS_LEAF, node_cond, node_flags
from tahoe_tpu_torch.ops.rows import map_row_chunks
from tahoe_tpu_torch.ops.transform import apply_output_transform

__all__ = ["SparseForest", "SparseGatherEngine", "from_dense",
           "predict_margins_np"]


class SparseGatherEngine:
    """A CSR pool on ``device`` and its level-synchronous gather descent."""

    def __init__(self, sf: SparseForest, *, device):
        self.device = resolve_device(device)
        self.sf = sf
        self.num_trees = sf.num_trees
        dev = self.device
        self.values = torch.as_tensor(sf.values, device=dev)
        self.fids = torch.as_tensor(sf.fids, device=dev)
        self.flags = torch.as_tensor(
            node_flags(sf.def_left, sf.is_leaf, sf.exchange), device=dev)
        self.left_idx = torch.as_tensor(sf.left_idx, dtype=torch.int64, device=dev)
        self.roots = torch.as_tensor(sf.tree_roots, dtype=torch.int64, device=dev)

    def _margins_chunk(self, x: torch.Tensor) -> torch.Tensor:
        curr = self.roots.expand(x.shape[0], self.num_trees)
        for _ in range(self.sf.max_depth):
            flags = self.flags[curr]
            cond = node_cond(x, self.sf.missing, self.fids[curr],
                             self.values[curr], flags)
            curr = torch.where((flags & IS_LEAF) != 0, curr,
                               self.left_idx[curr] + cond)
        return self.values[curr].sum(dim=1)

    def margins(self, rows) -> torch.Tensor:
        x = torch.as_tensor(rows, dtype=torch.float32, device=self.device)
        return map_row_chunks(self._margins_chunk, x, 48 * self.num_trees)

    def predict(self, rows) -> torch.Tensor:
        sf = self.sf
        return apply_output_transform(self.margins(rows), sf.num_trees,
                                      sf.output, sf.global_bias, sf.threshold)
