"""CPU reference oracle — the correctness gate for every engine.

The port's own copy of tahoe_tpu/ops/oracle.py (the numpy host
layer), held to the original bit for bit by
tests/test_torch_host_layer.py.

Re-implements the reference's golden model (BaseTahoeTest.h:440-487
``infer_one_tree`` / ``predict_on_cpu``) as vectorized numpy: level-synchronous
masked descent over all (row, tree) pairs at once instead of nested per-row
per-tree loops, but with *identical* per-node math:

    cond = missing(x) ? !def_left : (x >= thresh)      (BaseTahoeTest.h:450-452)
    cond = exchange ? !cond : cond                     (Struct.h:896-898)
    curr = 2*curr + 1 + cond                           (BaseTahoeTest.h:453)
    stop at leaves; margin = sum of leaf values; then output transform.

missing(x) is |x - sentinel| <= 1e-6 for finite sentinels, isnan(x) for NaN
sentinels (Struct.h:380-383 vs 518).
"""
from __future__ import annotations

import numpy as np

from tahoe_tpu_torch.config import MISSING_EPS, Output
from tahoe_tpu_torch.forest.spec import ForestSpec


def apply_output_transform_np(margins, num_trees: int, output: int,
                              global_bias: float, threshold: float):
    """The output transform on numpy arrays (tahoe_tpu/ops/transform.py
    with numpy as its ``xp``; ops/transform.py is its torch twin): AVG ->
    + global_bias -> SIGMOID -> THRESHOLD, every constant rounded to f32
    first."""
    preds = margins
    dtype = preds.dtype
    if output & Output.AVG:
        preds = preds / np.float32(num_trees)
    if global_bias != 0.0:
        preds = preds + np.float32(global_bias)
    if output & Output.SIGMOID:
        preds = 1.0 / (1.0 + np.exp(-preds))
    if output & Output.THRESHOLD:
        preds = np.where(preds > np.float32(threshold), np.float32(1.0), np.float32(0.0))
    return preds.astype(dtype)


def missing_mask_np(x: np.ndarray, missing: float) -> np.ndarray:
    if np.isnan(np.float32(missing)):
        return np.isnan(x)
    return np.abs(x - np.float32(missing)) <= np.float32(MISSING_EPS)


def predict_margins(forest: ForestSpec, data: np.ndarray) -> np.ndarray:
    """Raw per-row margin (sum of leaf values over trees), f32 [R]."""
    data = np.asarray(data, dtype=np.float32)
    rows, _ = data.shape
    trees = forest.num_trees

    # curr: heap node index per (row, tree)
    curr = np.zeros((rows, trees), dtype=np.int64)
    tree_ix = np.arange(trees)[None, :]

    for _ in range(forest.depth):
        node_leaf = forest.is_leaf[tree_ix, curr]
        active = ~node_leaf
        thresh = forest.values[tree_ix, curr]
        fid = forest.fids[tree_ix, curr]
        def_left = forest.def_left[tree_ix, curr]
        exch = forest.exchange[tree_ix, curr]

        xv = np.take_along_axis(data, fid, axis=1)
        miss = missing_mask_np(xv, forest.missing)
        cond = np.where(miss, ~def_left, xv >= thresh)
        cond = np.where(exch, ~cond, cond)
        curr = np.where(active, 2 * curr + 1 + cond, curr)

    leaf_vals = forest.values[tree_ix, curr]
    return leaf_vals.sum(axis=1, dtype=np.float32)


def predict(forest: ForestSpec, data: np.ndarray) -> np.ndarray:
    """Full prediction with output transform, f32 [R]."""
    margins = predict_margins(forest, data)
    return apply_output_transform_np(
        margins, forest.num_trees, forest.output, forest.global_bias,
        forest.threshold,
    )


def predict_scalar(forest: ForestSpec, data: np.ndarray) -> np.ndarray:
    """Unvectorized per-row/per-tree oracle — a literal transcription of the
    reference's control flow, used to validate the vectorized oracle itself."""
    data = np.asarray(data, dtype=np.float32)
    out = np.zeros(data.shape[0], dtype=np.float32)
    nan_missing = np.isnan(np.float32(forest.missing))
    for r in range(data.shape[0]):
        acc = np.float32(0.0)
        for t in range(forest.num_trees):
            curr = 0
            while not forest.is_leaf[t, curr]:
                x = data[r, forest.fids[t, curr]]
                if nan_missing:
                    miss = np.isnan(x)
                else:
                    miss = abs(float(x) - forest.missing) <= MISSING_EPS
                if miss:
                    cond = not forest.def_left[t, curr]
                else:
                    cond = bool(x >= forest.values[t, curr])
                if forest.exchange[t, curr]:
                    cond = not cond
                curr = 2 * curr + 1 + int(cond)
            acc += forest.values[t, curr]
        out[r] = acc
    return apply_output_transform_np(
        out, forest.num_trees, forest.output, forest.global_bias,
        forest.threshold,
    )
