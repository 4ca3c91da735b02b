"""Per-strategy feasibility predicates.

The counterpart of tahoe_tpu/engine/feasibility.py for all eight
strategies: where the TPU engines check VMEM budgets and compile walls, the
CUDA kernels check feature caps, the dense depth cap and shared memory per
block (GpuLimits). The plain torch engines and SPARSE keep the JAX limits
(feasibility.py:128-146): 2 GiB of device tables, priced at the port's bytes
per node, and depth <= 14 for the leveled form.
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
from tahoe_tpu_torch.ops.fold_kernel import (
    MAX_DENSE_DEPTH,
    MAX_NONGE_COLS,
    MAX_SIGN_COLS,
    fold_leveled,
    fold_plan,
    row_width,
)
from tahoe_tpu_torch.ops.gather_engine import NODE_BYTES
from tahoe_tpu_torch.ops.rank_kernel import rank_virtual_cols
from tahoe_tpu_torch.ops.sparse_kernel import RECORD_BYTES

# the JAX package's caps on device tables (feasibility.py:138, :145)
TABLE_CAP_BYTES = 2 << 30
# the leveled form stores 2^depth leaves per tree (feasibility.py:130)
MAX_LEVELED_DEPTH = 14


def fold_cols(forest: ForestSpec) -> Tuple[int, str]:
    """(live features, form) of the ge fold, compacted and chosen exactly
    as fold_kernel.fold_tables does (feasibility.py:20-31 of the JAX
    package): "dual" up to 64 live features, "sign" above."""
    lev, _, form = fold_leveled(forest)
    return lev.num_cols, form


def rank_buckets_fit(forest: ForestSpec) -> bool:
    """Whether DEPTH_BUCKETED takes its rank variant: one or two plane
    groups (bucketed.py:292-295 of the JAX package)."""
    if forest.num_cols > RANK_MAX_COLS:
        return False
    vcols = rank_virtual_cols(forest)
    return vcols <= RANK_MAX_COLS and rank_groups(vcols) <= 2


def _depth_reason(depth: int) -> Optional[str]:
    if depth > MAX_DENSE_DEPTH:
        return (f"dense fold tables stop at depth {MAX_DENSE_DEPTH}, forest "
                f"has depth {depth} (SPARSE serves it)")
    return None


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
    nodes = (1 << forest.depth) - 1
    return _table_reason(
        f"dense rank tables (depth {forest.depth})",
        forest.num_trees * (nodes * 128 * rank_groups(vcols) + 4 * (nodes + 1)))


def _fold_reason(strategy: Strategy, forest: ForestSpec,
                 limits: GpuLimits) -> Optional[str]:
    reason = _depth_reason(forest.depth)
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
    reason = _depth_reason(forest.depth)
    if reason:
        return reason
    depths = reachable_depths(forest)
    if np.unique(depths).size < 2:
        return "uniform tree depth — identical work to SPLIT_FOREST"
    if rank_buckets_fit(forest):
        return None
    if forest.num_cols > MAX_NONGE_COLS:
        return (f"rank variant needs <= 2 plane groups and the fold variant "
                f"<= {MAX_NONGE_COLS} columns; forest has {forest.num_cols}")
    # the fold variant: the deep kernel takes every bucket's depth (<= 15) in
    # the non-ge form too, so fold_plan always has a kernel
    return None


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
