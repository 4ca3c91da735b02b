"""Tensorized select-fold engine (ROW_TILED, TENSOR) in plain PyTorch.

The port of tahoe_tpu/ops/tensor_engine.py ``TensorEngine``, plain XLA in
the JAX package (no Pallas), so plain torch here. It runs on
compiler.levelize's form: early leaves pushed down, exchange folded into
``invert`` and ``def_right``, nodes in bit-reversed order, so every level
is one unconditional select over contiguous halves,

    cond = missing ? def_right : (x >= thresh) ^ invert
    w_d  = where(cond, w_{d+1}[..., 2^d:], w_{d+1}[..., :2^d])

from the leaves up. Each level's feature values are selected in one of two
ways:

- ``take`` (ROW_TILED): an index select of the level's fids;
- ``onehot`` (TENSOR): a matmul of the rows, missing values zeroed first,
  and the missing flags against a one-hot matrix S_d [F, T * 2^d]. The JAX
  engine takes it at Precision.HIGHEST, which selects f32 values bit-exactly;
  here it is an f64 matmul, which selects them exactly whatever the global
  TF32 setting of f32 matmuls. An infinite value would turn every product
  of its row into NaN (inf * 0), as it does in the JAX engine, so it enters
  the matmul as +-1e300, a finite f64 that rounds back to +-inf in f32.

The JAX engine's lax.map over 256-row tiles becomes row chunks sized by
bytes (ops/rows.py).
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from tahoe_tpu_torch.config import resolve_device
from tahoe_tpu_torch.forest.spec import LeveledForest
from tahoe_tpu_torch.ops.rows import map_row_chunks, missing_mask
from tahoe_tpu_torch.ops.transform import apply_output_transform

SelectMode = Literal["take", "onehot"]

# an infinite row value's stand-in in the one-hot matmul: finite in f64, past
# the f32 range, so the selected value rounds back to the same infinity
F64_INF_STANDIN = 1e300


def onehot_matrix(fid_level: np.ndarray, num_cols: int) -> np.ndarray:
    """S_d [F, T * 2^d] f64 with S[fid[t, i], t * 2^d + i] = 1."""
    flat = fid_level.reshape(-1)
    s = np.zeros((num_cols, flat.size), np.float64)
    s[flat, np.arange(flat.size)] = 1.0
    return s


class TensorEngine:
    """Leveled tables of one forest on ``device`` and the select-fold."""

    def __init__(self, leveled: LeveledForest, *,
                 select_mode: SelectMode = "onehot", device):
        if select_mode not in ("take", "onehot"):
            raise ValueError(f"unknown select mode {select_mode!r}")
        self.device = resolve_device(device)
        self.depth = leveled.depth
        self.num_trees = leveled.num_trees
        self.num_cols = leveled.num_cols
        self.output = leveled.output
        self.global_bias = leveled.global_bias
        self.threshold = leveled.threshold
        self.missing = leveled.missing
        self.select_mode = select_mode
        dev = self.device
        as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
        self.thresh = [as_dev(t) for t in leveled.thresh]
        self.invert = [as_dev(v) if v.any() else None for v in leveled.invert]
        self.def_right = [as_dev(v) for v in leveled.def_right]
        self.leaf = as_dev(leveled.leaf_values)
        if select_mode == "take":
            self.sel = [as_dev(f.reshape(-1).astype(np.int64)) for f in leveled.fid]
        else:
            self.sel = [as_dev(onehot_matrix(f, self.num_cols)) for f in leveled.fid]

    def _margins_chunk(self, x: torch.Tensor) -> torch.Tensor:
        rt = x.shape[0]
        if self.depth == 0:  # a forest of stumps
            return self.leaf[:, 0].sum().expand(rt)
        miss = missing_mask(x, self.missing)
        if self.select_mode == "onehot":
            xs = torch.where(miss, 0.0, x).to(torch.float64)
            xs = torch.where(torch.isinf(xs), xs.sign() * F64_INF_STANDIN, xs)
            stacked = torch.cat([xs, miss.to(torch.float64)])
        w = self.leaf[None]
        for d in range(self.depth - 1, -1, -1):
            shape = (rt, self.num_trees, 1 << d)
            if self.select_mode == "take":
                xv = x.index_select(1, self.sel[d]).view(shape)
                mv = miss.index_select(1, self.sel[d]).view(shape)
            else:
                out = stacked @ self.sel[d]
                xv = out[:rt].to(torch.float32).view(shape)
                mv = (out[rt:] > 0.5).view(shape)
            cmp = xv >= self.thresh[d]
            if self.invert[d] is not None:
                cmp = cmp ^ self.invert[d]
            cond = torch.where(mv, self.def_right[d], cmp)
            half = 1 << d
            w = torch.where(cond, w[..., half:], w[..., :half])
        return w[..., 0].sum(dim=1)

    def margins(self, rows) -> torch.Tensor:
        x = torch.as_tensor(rows, dtype=torch.float32, device=self.device)
        # per row: the leaf frontier and a level's values, flags and conds
        # (f32, bool), and the one-hot product's two f64 rows
        return map_row_chunks(self._margins_chunk, x,
                              32 * self.num_trees << self.depth)

    def predict(self, rows) -> torch.Tensor:
        return apply_output_transform(self.margins(rows), self.num_trees,
                                      self.output, self.global_bias,
                                      self.threshold)
