"""Per-strategy feasibility predicates.

The counterpart of tahoe_tpu/engine/feasibility.py for all eight
strategies: where the TPU engines check VMEM budgets and compile walls, the
CUDA kernels check feature caps and shared memory per block (GpuLimits).
Every strategy's device tables keep the JAX package's 2 GiB cap
(feasibility.py:128-146), priced at the port's own bytes at the forest's
stored depth: the fold strategies' at the deep kernel's route
(fold_kernel.fold_table_bytes), which takes every depth past 14, so that
SPLIT_FOREST and DEPTH_BUCKETED reach as deep as the JAX package runs them.
The leveled form stops at depth 14, as there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tahoe_tpu_torch.config import GpuLimits, Strategy, forest_num_nodes
from tahoe_tpu_torch.forest.compiler import (
    RANK_MAX_COLS,
    rank_groups,
    reachable_depths,
    reachable_mask,
)
from tahoe_tpu_torch.forest.spec import ForestSpec
# rank_buckets_fit is DEPTH_BUCKETED's choice of variant, read here too
from tahoe_tpu_torch.ops.bucketed import plan_buckets, rank_buckets_fit
from tahoe_tpu_torch.ops.fold_kernel import (
    MAX_NONGE_COLS,
    MAX_SIGN_COLS,
    TABLE_CAP_BYTES,
    fold_leveled,
    fold_plan,
    fold_table_bytes,
    row_width,
)
from tahoe_tpu_torch.ops.gather_engine import NODE_BYTES
from tahoe_tpu_torch.ops.rank_kernel import rank_virtual_cols
from tahoe_tpu_torch.ops.sparse_kernel import RECORD_BYTES

# the leveled form stores 2^depth leaves per tree (feasibility.py:130)
MAX_LEVELED_DEPTH = 14


def fold_cols(forest: ForestSpec) -> Tuple[int, str]:
    """(live features, form) of the ge fold, compacted and chosen exactly
    as fold_kernel.fold_tables does (feasibility.py:20-31 of the JAX
    package): "dual" up to 64 live features, "sign" above."""
    lev, _, form = fold_leveled(forest)
    return lev.num_cols, form


def _table_reason(what: str, nbytes: int) -> Optional[str]:
    if nbytes > TABLE_CAP_BYTES:
        return (f"{what} ~{nbytes / 2**30:.1f} GiB > "
                f"{TABLE_CAP_BYTES / 2**30:.0f} GiB")
    return None


def _rank_reason(forest: ForestSpec) -> Optional[str]:
    vcols = rank_virtual_cols(forest)
    if vcols > RANK_MAX_COLS:
        return (f"forest needs {vcols} banded virtual live features "
                f"> {RANK_MAX_COLS}")
    return _table_reason(
        f"dense rank tables (depth {forest.depth})",
        _rank_table_bytes(forest.num_trees, forest.depth, rank_groups(vcols)))


def _rank_table_bytes(trees: int, depth: int, groups: int) -> int:
    nodes = (1 << depth) - 1
    return trees * (nodes * 128 * groups + 4 * (nodes + 1))


def _fold_reason(strategy: Strategy, forest: ForestSpec,
                 limits: GpuLimits) -> Optional[str]:
    T, D = forest.num_trees, forest.depth
    reason = _table_reason(f"dense fold tables ({T} trees of depth {D})",
                           fold_table_bytes(T, D))
    if reason:
        return reason
    cols, form = fold_cols(forest)
    if cols > MAX_SIGN_COLS:
        return (f"fold kernels take <= {MAX_SIGN_COLS} live features, forest "
                f"has {cols}")
    width = row_width(form, cols)
    whole = strategy == Strategy.VMEM_FOREST
    if fold_plan(form, width, forest.depth, forest.num_trees, limits,
                 whole_forest=whole) is None:
        what = ("the whole forest's node tables and a 32-row block" if whole
                else f"a 32-row block of {width}-wide rows")
        return (f"{what} do not fit {limits.smem_per_block} bytes of shared "
                f"memory per block")
    return None


def _bucketed_reason(forest: ForestSpec) -> Optional[str]:
    depths = reachable_depths(forest)
    if np.unique(depths).size < 2:
        return "uniform tree depth — identical work to SPLIT_FOREST"
    # each bucket's tables at its own depth (ops/bucketed.py), the variant
    # chosen as the JAX package chooses it
    buckets = [(idx.size, int(depths[idx].max())) for idx in plan_buckets(depths)]
    buckets = [(n, d) for n, d in buckets if d > 0]
    if rank_buckets_fit(forest):
        groups = rank_groups(rank_virtual_cols(forest))
        return _table_reason(
            f"the buckets' dense rank tables (depths {[d for _, d in buckets]})",
            sum(_rank_table_bytes(n, d, groups) for n, d in buckets))
    if forest.num_cols > MAX_NONGE_COLS:
        return (f"rank variant needs <= 2 plane groups and the fold variant "
                f"<= {MAX_NONGE_COLS} columns; forest has {forest.num_cols}")
    # the fold variant: the deep kernel takes every bucket too deep for a
    # tile of kernel C, in the non-ge form too, so fold_plan always has a
    # kernel
    return _table_reason(
        f"the buckets' dense fold tables (depths {[d for _, d in buckets]})",
        sum(fold_table_bytes(n, d) for n, d in buckets))


def check(strategy: Strategy, forest: ForestSpec,
          limits: GpuLimits = GpuLimits()) -> Optional[str]:
    """None if the strategy's kernels take ``forest``, else the reason."""
    if strategy in (Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST):
        return _fold_reason(strategy, forest, limits)
    if strategy == Strategy.DEPTH_BUCKETED:
        return _bucketed_reason(forest)
    if strategy == Strategy.RANK_MXU:
        return _rank_reason(forest)
    if strategy == Strategy.SPARSE:
        pool = int(reachable_mask(forest).sum())
        return _table_reason(f"sparse node pool of {pool} nodes",
                             pool * RECORD_BYTES)
    if strategy == Strategy.HBM_DIRECT:
        return _table_reason(
            f"dense node tables (complete trees of depth {forest.depth})",
            forest_num_nodes(forest.num_trees, forest.depth) * NODE_BYTES)
    if strategy in (Strategy.ROW_TILED, Strategy.TENSOR):
        if forest.depth > MAX_LEVELED_DEPTH:
            return (f"leveled form of depth {forest.depth} is too large "
                    f"(> {MAX_LEVELED_DEPTH})")
    return None
