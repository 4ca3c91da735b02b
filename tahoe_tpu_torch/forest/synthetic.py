"""Seeded synthetic forest / data generators.

The port's own copy of tahoe_tpu/forest/synthetic.py (the numpy host
layer), held to the original bit for bit by
tests/test_torch_host_layer.py.

The reference's in-code generators (BaseTahoeTest.h:123-262 generate_forest,
404-438 generate_data) build random complete forests and random data with a
NaN-injection probability; they are the harness's file-free test path. Same
capability here, vectorized over numpy instead of per-node loops.
"""
from __future__ import annotations

import numpy as np

from tahoe_tpu_torch.config import Output, tree_num_nodes
from tahoe_tpu_torch.forest.spec import ForestSpec


def generate_forest(
    num_trees: int,
    depth: int,
    num_cols: int,
    *,
    leaf_prob: float = 0.0,
    output: int = int(Output.RAW),
    global_bias: float = 0.0,
    threshold: float = 0.5,
    missing: float = float("nan"),
    active_cols: int | None = None,
    seed: int = 42,
) -> ForestSpec:
    """Random complete forest.

    ``leaf_prob`` is the probability that an *internal-level* node is an early
    leaf (the reference draws per-node leaf bits the same way,
    BaseTahoeTest.h:169-183). Nodes below an early leaf are unreachable; they
    are still populated (the storage is a complete tree) exactly like the
    reference's.

    ``active_cols``: draw fids from a random subset of this many columns —
    the realistic shape of forests trained on wide datasets (gisette has
    2,500 noise "probe" features by construction; trained trees concentrate
    on the informative subset). Exercises used-feature compaction.
    """
    rng = np.random.default_rng(seed)
    n = tree_num_nodes(depth)
    shape = (num_trees, n)

    values = rng.uniform(-1.0, 1.0, size=shape).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    if active_cols is not None and active_cols < num_cols:
        pool = np.sort(rng.choice(num_cols, size=active_cols, replace=False))
        fids = pool[rng.integers(0, active_cols, size=shape)].astype(np.int32)
    else:
        fids = rng.integers(0, num_cols, size=shape, dtype=np.int32)
    def_left = rng.random(shape) < 0.5
    is_leaf = rng.random(shape) < leaf_prob
    # Complete-tree invariant: deepest level is all leaves.
    is_leaf[:, (1 << depth) - 1 :] = True
    # Root is never a leaf for depth > 0 (keeps tests exercising traversal).
    if depth > 0:
        is_leaf[:, 0] = False

    return ForestSpec(
        depth=depth,
        num_cols=num_cols,
        values=values,
        weights=weights,
        fids=fids,
        def_left=def_left,
        is_leaf=is_leaf,
        exchange=np.zeros(shape, dtype=bool),
        output=output,
        global_bias=global_bias,
        threshold=threshold,
        missing=missing,
    )


def generate_data(
    num_rows: int,
    num_cols: int,
    *,
    missing: float = float("nan"),
    missing_prob: float = 0.0,
    seed: int = 42,
) -> np.ndarray:
    """Random rows in [-1, 1) with missing values injected at missing_prob.

    When the sentinel is NaN this matches the reference's nan_kernel path
    (cuda_base.h:57-61, BaseTahoeTest.h:420); for a finite sentinel the value
    itself is written (the file-driven datasets use finite sentinels).
    """
    rng = np.random.default_rng(seed)
    data = rng.uniform(-1.0, 1.0, size=(num_rows, num_cols)).astype(np.float32)
    if missing_prob > 0.0:
        mask = rng.random((num_rows, num_cols)) < missing_prob
        data[mask] = np.float32(missing)
    return data


def susy_class_forest(seed: int = 0) -> ForestSpec:
    """A SUSY-class benchmark forest: 500 trees, depth 8, 18 features.

    Mirrors the shape of the reference's SUSY benchmark (main.cu:24-27 uses
    S_sample=18 features; constructor defaults depth 8 / 500 trees,
    BaseTahoeTest.h:49)."""
    return generate_forest(500, 8, 18, seed=seed)


def generate_mixed_depth_forest(
    num_trees: int,
    depth: int,
    num_cols: int,
    *,
    min_depth: int | None = None,
    leaf_prob: float = 0.05,
    missing: float = float("nan"),
    seed: int = 42,
) -> ForestSpec:
    """Trained-ensemble shape: per-tree effective depth sampled uniformly in
    [min_depth, depth], all trees STORED complete at ``depth`` (the reference
    loader materializes complete trees regardless of real leaf placement,
    BaseTahoeTest.h:282-331). The showcase for depth truncation and the
    depth-bucketed strategy."""
    rng = np.random.default_rng(seed)
    f = generate_forest(num_trees, depth, num_cols, leaf_prob=leaf_prob,
                        missing=missing, seed=seed)
    lo = max(1, min_depth if min_depth is not None else depth // 2)
    per_tree = rng.integers(lo, depth + 1, size=num_trees)
    for t in range(num_trees):
        d = int(per_tree[t])
        if d < depth:
            f.is_leaf[t, f.level_slice(d).start :] = True
    return f
