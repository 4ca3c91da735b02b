"""Gather-descent engine (HBM_DIRECT) in plain PyTorch.

The port of tahoe_tpu/ops/gather_engine.py ``GatherEngine``, which is plain
XLA in the JAX package (no Pallas), so plain torch here: node tables stay in
device memory, node-major ``[N, T]``, and all (row, tree) lanes advance one
level per step by gathers, masked at leaves, with the reference's per-node
rule (Struct.h:365-403):

    cond = missing(x) ? !def_left : x >= thresh;  cond ^= exchange
    curr = is_leaf ? curr : 2 * curr + 1 + cond

The facade runs it on the hot-swapped, clustered forest, as the JAX facade
does (engine/forest.py:50-52, 96-99). It is the naive baseline the kernels
are measured against. ``node_cond`` is shared with the CSR gather tier
(forest/sparse.py).
"""
from __future__ import annotations

import numpy as np
import torch

from tahoe_tpu_torch.config import resolve_device
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops.rows import map_row_chunks, missing_mask
from tahoe_tpu_torch.ops.transform import apply_output_transform

# node flag bits, as in the JAX engines
DEF_LEFT, IS_LEAF, EXCHANGE = 1, 2, 4
# device bytes of one node: f32 threshold or leaf value, int32 fid, u8 flags
NODE_BYTES = 9


def node_flags(def_left: np.ndarray, is_leaf: np.ndarray,
               exchange: np.ndarray) -> np.ndarray:
    return (def_left * DEF_LEFT | is_leaf * IS_LEAF
            | exchange * EXCHANGE).astype(np.uint8)


def node_cond(x: torch.Tensor, missing: float, fid: torch.Tensor,
              thresh: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """The branch condition of the nodes ``(fid, thresh, flags)`` [R, T] for
    rows ``x`` [R, C]: True routes right."""
    xv = torch.gather(x, 1, fid.to(torch.int64))
    cond = torch.where(missing_mask(xv, missing), (flags & DEF_LEFT) == 0,
                       xv >= thresh)
    return cond ^ ((flags & EXCHANGE) != 0)


class GatherEngine:
    """Node-major tables of one forest on ``device`` and a level-synchronous
    gather descent."""

    def __init__(self, forest: ForestSpec, *, device):
        self.device = resolve_device(device)
        self.depth = forest.depth
        self.num_trees = forest.num_trees
        self.num_cols = forest.num_cols
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold
        self.missing = forest.missing
        # node-major [N, T]: each level's gather reads a stripe over trees
        # (the reference's coalesced "reorg" layout, Struct.h:1911-1923)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a.T), device=self.device)
        self.values = as_dev(forest.values)
        self.fids = as_dev(forest.fids.astype(np.int32))
        self.flags = as_dev(node_flags(forest.def_left, forest.is_leaf,
                                       forest.exchange))

    def _margins_chunk(self, x: torch.Tensor) -> torch.Tensor:
        curr = torch.zeros(x.shape[0], self.num_trees, dtype=torch.int64,
                           device=self.device)
        for _ in range(self.depth):
            flags = self.flags.gather(0, curr)
            cond = node_cond(x, self.missing, self.fids.gather(0, curr),
                             self.values.gather(0, curr), flags)
            curr = torch.where((flags & IS_LEAF) != 0, curr, 2 * curr + 1 + cond)
        return self.values.gather(0, curr).sum(dim=1)

    def margins(self, rows) -> torch.Tensor:
        x = torch.as_tensor(rows, dtype=torch.float32, device=self.device)
        # per row and tree: the int64 index, the gathered node and its row value
        return map_row_chunks(self._margins_chunk, x, 48 * self.num_trees)

    def predict(self, rows) -> torch.Tensor:
        return apply_output_transform(self.margins(rows), self.num_trees,
                                      self.output, self.global_bias,
                                      self.threshold)
