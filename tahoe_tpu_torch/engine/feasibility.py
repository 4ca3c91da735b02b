"""Per-strategy feasibility predicates, and the facts of a forest they read.

The counterpart of tahoe_tpu/engine/feasibility.py for all eight
strategies: where the TPU engines check VMEM budgets and compile walls, the
CUDA kernels check feature caps and shared memory per block (GpuLimits).
Every strategy's device tables keep the JAX package's 2 GiB cap
(feasibility.py:128-146), priced at the port's own bytes at the forest's
stored depth: the fold strategies' at the deep kernel's route
(fold_kernel.fold_table_bytes), which takes every depth past 14, so that
SPLIT_FOREST and DEPTH_BUCKETED reach as deep as the JAX package runs them.
The leveled form stops at depth 14, as there.

The checks read a forest's ``ForestFacts``, which the cost model and Forest
share; the rules of each engine's choice stay in its module.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from tahoe_tpu_torch.config import GpuLimits, Strategy, forest_num_nodes
from tahoe_tpu_torch.forest.compiler import (
    RANK_MAX_COLS,
    rank_groups,
    reachable_depths,
    reachable_mask,
    truncate_depth,
)
from tahoe_tpu_torch.forest.spec import ForestSpec
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


class ForestFacts:
    """What the selection layer reads of one forest, each item derived on
    first read and at most once, by the call the engine's module makes: a
    check that reads only ``num_trees`` and ``depth`` derives nothing."""

    def __init__(self, spec: ForestSpec):
        self.spec = spec
        self.num_trees = spec.num_trees
        self.depth = spec.depth

    @classmethod
    def cut(cls, spec: ForestSpec) -> ForestFacts:
        """The facts of ``spec`` cut to its reachable depth, as Forest takes
        it (forest.py:40-43 of the JAX package); the cut keeps each tree's
        reachable depth."""
        depths = reachable_depths(spec)
        facts = cls(truncate_depth(spec, int(depths.max(initial=0))))
        facts.depths = depths
        return facts

    @functools.cached_property
    def depths(self) -> np.ndarray:
        return reachable_depths(self.spec)

    @functools.cached_property
    def buckets(self) -> list[tuple[int, int]]:
        """DEPTH_BUCKETED's (trees, depth) a bucket, stumps left out."""
        buckets = [(idx.size, int(self.depths[idx].max()))
                   for idx in plan_buckets(self.depths)]
        return [(n, d) for n, d in buckets if d > 0]

    @functools.cached_property
    def vcols(self) -> int:
        return rank_virtual_cols(self.spec)

    @functools.cached_property
    def groups(self) -> int:
        return rank_groups(self.vcols)

    @functools.cached_property
    def fold(self) -> tuple[int, str, bool]:
        """The ge fold's live features, form and whether it compacts the
        columns, as fold_kernel.fold_tables chooses them
        (feasibility.py:20-31 of the JAX package)."""
        lev, col_index, form = fold_leveled(self.spec)
        return lev.num_cols, form, col_index is not None

    @functools.cached_property
    def pool(self) -> int:
        return int(reachable_mask(self.spec).sum())


def _table_reason(what: str, nbytes: int) -> Optional[str]:
    if nbytes > TABLE_CAP_BYTES:
        return (f"{what} ~{nbytes / 2**30:.1f} GiB > "
                f"{TABLE_CAP_BYTES / 2**30:.0f} GiB")
    return None


def _rank_reason(facts: ForestFacts) -> Optional[str]:
    if facts.vcols > RANK_MAX_COLS:
        return (f"forest needs {facts.vcols} banded virtual live features "
                f"> {RANK_MAX_COLS}")
    return _table_reason(
        f"dense rank tables (depth {facts.depth})",
        _rank_table_bytes(facts.num_trees, facts.depth, facts.groups))


def _rank_table_bytes(trees: int, depth: int, groups: int) -> int:
    nodes = (1 << depth) - 1
    return trees * (nodes * 128 * groups + 4 * (nodes + 1))


def _fold_reason(strategy: Strategy, facts: ForestFacts,
                 limits: GpuLimits) -> Optional[str]:
    T, D = facts.num_trees, facts.depth
    reason = _table_reason(f"dense fold tables ({T} trees of depth {D})",
                           fold_table_bytes(T, D))
    if reason:
        return reason
    cols, form, _ = facts.fold
    if cols > MAX_SIGN_COLS:
        return (f"fold kernels take <= {MAX_SIGN_COLS} live features, forest "
                f"has {cols}")
    width = row_width(form, cols)
    whole = strategy == Strategy.VMEM_FOREST
    if fold_plan(form, width, D, T, limits, whole_forest=whole) is None:
        what = ("the whole forest's node tables and a 32-row block" if whole
                else f"a 32-row block of {width}-wide rows")
        return (f"{what} do not fit {limits.smem_per_block} bytes of shared "
                f"memory per block")
    return None


def _bucketed_reason(facts: ForestFacts) -> Optional[str]:
    if np.unique(facts.depths).size < 2:
        return "uniform tree depth — identical work to SPLIT_FOREST"
    # each bucket's tables at its own depth (ops/bucketed.py), the variant
    # chosen as the JAX package chooses it
    buckets = facts.buckets
    num_cols = facts.spec.num_cols
    if rank_buckets_fit(num_cols, facts.vcols):
        return _table_reason(
            f"the buckets' dense rank tables (depths {[d for _, d in buckets]})",
            sum(_rank_table_bytes(n, d, facts.groups) for n, d in buckets))
    if num_cols > MAX_NONGE_COLS:
        return (f"rank variant needs <= 2 plane groups and the fold variant "
                f"<= {MAX_NONGE_COLS} columns; forest has {num_cols}")
    # the fold variant: the deep kernel takes every bucket too deep for a
    # tile of kernel C, in the non-ge form too, so fold_plan always has a
    # kernel
    return _table_reason(
        f"the buckets' dense fold tables (depths {[d for _, d in buckets]})",
        sum(fold_table_bytes(n, d) for n, d in buckets))


def check(strategy: Strategy, facts: ForestFacts,
          limits: GpuLimits = GpuLimits()) -> Optional[str]:
    """None if the strategy's kernels take the forest of ``facts``, else
    the reason."""
    if strategy in (Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST):
        return _fold_reason(strategy, facts, limits)
    if strategy == Strategy.DEPTH_BUCKETED:
        return _bucketed_reason(facts)
    if strategy == Strategy.RANK_MXU:
        return _rank_reason(facts)
    if strategy == Strategy.SPARSE:
        return _table_reason(f"sparse node pool of {facts.pool} nodes",
                             facts.pool * RECORD_BYTES)
    if strategy == Strategy.HBM_DIRECT:
        return _table_reason(
            f"dense node tables (complete trees of depth {facts.depth})",
            forest_num_nodes(facts.num_trees, facts.depth) * NODE_BYTES)
    if strategy in (Strategy.ROW_TILED, Strategy.TENSOR):
        if facts.depth > MAX_LEVELED_DEPTH:
            return (f"leveled form of depth {facts.depth} is too large "
                    f"(> {MAX_LEVELED_DEPTH})")
    return None
