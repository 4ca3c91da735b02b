"""Analytical performance model: predict the best strategy before running.

The port of tahoe_tpu/perf_model/model.py, the re-derivation of the
reference's closed-form model (main.cu:22-82): per-strategy cost = the work
of the engine that serves it, scaled by calibrated machine constants
(calibrate.py); the argmin is the pick. Every term follows the port's own
engines, not the TPU's:

- **descents**: kernel C, the deep kernel and kernel B descend D levels a
  (row, tree): T x D steps a row at the kernel's ns per (row, tree, level)
  slot, plus its ns per row (staging, paid once a launch). A launch runs in
  waves of blocks (``occupancy``), each the larger of one block's least
  time (a thread's chain of steps: where rows are too few to fill the card,
  it binds; kernel C also waits on each tile of trees) and the throughput of
  the blocks an SM holds at once (``blocks_per_sm``). ``fold_plan`` says
  which fold kernel serves a forest, its block and VMEM_FOREST's one tile;
- **sparse**: the sparse kernel walks each tree of the pruned pool, a warp
  as deep as its deepest row: the trees' reachable depths, not 2^D;
- **kernel A**: rows x virtual features, once for RANK_MXU, DEPTH_BUCKETED's
  rank variant and SPARSE;
- **bytes**: kernel C restages its tables once a row block;
- **plain torch**: gather steps (HBM_DIRECT, the CSR gather tier) and the
  select-fold's nodes (ROW_TILED, TENSOR);
- **host**: every kernel launch and plain torch op the path issues, at the
  calibrated µs each. TensorEngine sizes its row chunks by ROW_CHUNK_BYTES
  (ops/rows.py), so it issues a depth-long chain a chunk.

A call's predicted time is the larger of the device's and the host's, plus
one call's latency. The JAX model's TPU terms (TpuLimits, split budgets,
RANK_STREAM_GBPS, MXU rates, the VMEM residency penalty) have no
counterpart. Costs are seconds per predict of ``rows`` rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from tahoe_tpu_torch.config import GpuLimits, Output, Strategy
from tahoe_tpu_torch.engine import feasibility
from tahoe_tpu_torch.forest.compiler import (
    rank_groups,
    reachable_depths,
    truncate_depth,
)
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops.bucketed import plan_buckets
from tahoe_tpu_torch.ops.fold_kernel import (
    MAX_DUAL_COLS,
    FoldLaunch,
    fold_leveled,
    fold_plan,
    row_width,
    tree_bytes,
)
from tahoe_tpu_torch.ops.rank_kernel import (
    rank_block_rows,
    rank_row_words,
    rank_virtual_cols,
)
from tahoe_tpu_torch.ops.rows import ROW_CHUNK_BYTES
from tahoe_tpu_torch.ops.sparse_kernel import SparseRankEngine
from tahoe_tpu_torch.perf_model.calibrate import SPARSE_BLOCK_ROWS, Calibration

# plain torch ops a row chunk issues per level (and once a chunk), read off
# the engines: GatherEngine._margins_chunk, SparseGatherEngine's and
# TensorEngine's; a finite missing sentinel costs two more a missing test
GATHER_LEVEL_OPS, GATHER_CHUNK_OPS = 19, 3
SPARSE_GATHER_LEVEL_OPS, SPARSE_GATHER_CHUNK_OPS = 18, 2
SELECT_LEVEL_OPS = {"take": 5, "onehot": 6}
SELECT_CHUNK_OPS = {"take": 2, "onehot": 10}
# the ops of the call calibrate.py times whole (call_us): dual rows
CALL_OPS = 2
# an SM's threads and resident blocks at most (sm_90)
SM_THREADS, SM_BLOCKS = 2048, 32
# bytes a row a chunk: the gather tiers' and TensorEngine's own sizing
GATHER_ROW_BYTES, SELECT_ROW_BYTES = 48, 32


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    device_s: float
    host_s: float
    latency_s: float
    launches: int  # kernel launches and plain torch ops a call issues

    @property
    def total(self) -> float:
        return max(self.device_s, self.host_s) + self.latency_s


def _transform_ops(forest: ForestSpec) -> int:
    """Ops of ops/transform.py apply_output_transform."""
    out = forest.output
    return (bool(out & Output.AVG) + (forest.global_bias != 0.0)
            + 4 * bool(out & Output.SIGMOID) + 2 * bool(out & Output.THRESHOLD))


def _canon_ops(forest: ForestSpec, gather: bool, dual: bool = False) -> int:
    """Ops of ops/rows.py canonicalize_rows on rows already on the card."""
    return 4 * _finite_missing(forest) + int(gather) + 2 * int(dual)


def _finite_missing(forest: ForestSpec) -> bool:
    return not np.isnan(np.float32(forest.missing))


def occupancy(rows: int, rows_per_block: int, blocks_per_sm: int,
              sms: int) -> list[int]:
    """The waves of a launch of one block per ``rows_per_block`` rows
    spread evenly over ``sms`` SMs, as the blocks an SM runs at once in
    each: full waves of ``blocks_per_sm``, then the rest."""
    blocks = -(-max(rows, 1) // rows_per_block)
    per_sm = -(-blocks // sms)
    full, rest = divmod(per_sm, blocks_per_sm)
    return [blocks_per_sm] * full + ([rest] if rest else [])


def blocks_per_sm(smem_bytes: int, threads: int, limits: GpuLimits) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` of shared memory one
    SM holds at once (registers are not counted)."""
    by_smem = limits.smem_per_sm // (smem_bytes + limits.SMEM_RESERVED_PER_BLOCK)
    return max(1, min(by_smem, SM_THREADS // threads, SM_BLOCKS))


def _descent_s(unit: float, row: float, floor: float, floor_us: float,
               rows: int, chain: float, rows_per_block: int, per_sm: int,
               limits: GpuLimits, floor_chain: Optional[float] = None,
               waits_us: float = 0.0) -> float:
    """A descent kernel of ``chain`` (tree, level) steps a row, in waves of
    blocks: a wave takes the larger of one block's least time (its thread's
    ``floor_chain`` and ``waits_us``; what binds where an SM holds one block)
    and the throughput of the blocks an SM runs at once."""
    floor_chain = chain if floor_chain is None else floor_chain
    least = floor * floor_chain + (floor_us + waits_us) * 1e3
    per_row = row + unit * chain
    return sum(max(least, at_once * rows_per_block * limits.sm_count * per_row)
               for at_once in occupancy(rows, rows_per_block, per_sm,
                                        limits.sm_count)) * 1e-9


def _fold_kernel_s(form: str, width: int, depth: int, trees: int, rows: int,
                   cal: Calibration, limits: GpuLimits,
                   whole_forest: bool = False) -> float:
    """Kernel C or the deep kernel, as fold_plan routes the forest. Kernel C
    waits on each tile of trees but the first; it restages its tables once
    a row block."""
    plan = fold_plan(form, width, depth, trees, limits, whole_forest=whole_forest)
    chain = trees * depth
    if isinstance(plan, FoldLaunch):
        tiles = -(-trees // plan.tile_trees)
        rpb = plan.rows_per_block
        compute = _descent_s(
            cal.fold_c_ns, cal.fold_c_row_ns, cal.fold_c_floor_ns,
            cal.fold_c_floor_us, rows, chain, rpb,
            blocks_per_sm(plan.smem_bytes, rpb, limits), limits,
            waits_us=cal.fold_c_tile_us * (tiles - 1))
        moved = rows * (width + 1) * 4 + -(-rows // rpb) * trees * tree_bytes(depth)
        return max(compute, moved / (cal.hbm_gbps * 1e9))
    threads = plan.rows_per_block * plan.lanes
    return _descent_s(cal.fold_deep_ns, cal.fold_deep_row_ns,
                      cal.fold_deep_floor_ns, cal.fold_deep_floor_us, rows,
                      chain, plan.rows_per_block,
                      blocks_per_sm(plan.smem_bytes, threads, limits), limits,
                      chain / plan.lanes)


def _rank_a_s(vcols: int, rows: int, cal: Calibration) -> float:
    """Kernel A: one block an SM walks 256-row tiles; its least time is a
    launch's."""
    return max(cal.rank_transform_floor_us * 1e3,
               rows * vcols * cal.rank_transform_ns) * 1e-9


def rank_b_geometry(groups: int, limits: GpuLimits) -> tuple[int, int]:
    """(rows a block, blocks an SM) of kernel B (csrc/common.cuh)."""
    rpb = rank_block_rows(groups)
    return rpb, blocks_per_sm(rpb * 4 * rank_row_words(groups), rpb, limits)


def sparse_geometry(groups: int, limits: GpuLimits) -> tuple[int, int]:
    """(rows a block, blocks an SM) of the sparse kernel, which stages its
    rows as kernel B does (csrc/sparse_rank.cu)."""
    rpb = SPARSE_BLOCK_ROWS
    return rpb, blocks_per_sm(rpb * 4 * rank_row_words(groups), rpb, limits)


def _rank_b_s(groups: int, depth: int, trees: int, rows: int,
              cal: Calibration, limits: GpuLimits) -> float:
    """Kernel B: int16 pair staging at one plane group, bytes past it."""
    unit = cal.rank_fold_ns if groups == 1 else cal.rank_fold_bytes_ns
    floor = cal.rank_fold_floor_ns * unit / cal.rank_fold_ns
    return _descent_s(unit, cal.rank_fold_row_ns * groups, floor,
                      cal.rank_fold_floor_us, rows, trees * depth,
                      *rank_b_geometry(groups, limits), limits)


def _cost(device_s: float, launches: int, ops: int,
          cal: Calibration) -> CostBreakdown:
    """A path's cost: a kernel path's host time is the calibrated call of
    the shortest one (CALL_OPS ops and a launch) and its other launches and
    ops; a plain torch path's is its ops."""
    if launches:
        host_us = (cal.call_us + (launches - 1) * cal.launch_us
                   + (ops - CALL_OPS) * cal.op_us)
    else:
        host_us = ops * cal.op_us
    return CostBreakdown(
        device_s=device_s,
        host_s=host_us * 1e-6,
        latency_s=cal.latency_us * 1e-6,
        launches=launches + ops,
    )


def _chunks(rows: int, bytes_per_row: int) -> int:
    """Row chunks of ops/rows.py map_row_chunks."""
    return -(-max(rows, 1) // max(1, ROW_CHUNK_BYTES // max(1, bytes_per_row)))


def predict_cost(strategy: Strategy, forest: ForestSpec, rows: int,
                 cal: Calibration, limits: GpuLimits = GpuLimits()
                 ) -> Optional[CostBreakdown]:
    """Predicted cost of one predict of ``rows`` rows, or None where
    feasibility.check refuses the strategy (reference: acc=FLT_MAX skip,
    BaseTahoeTest.h:657-679). The forest is cut to its reachable depth
    first, as Forest does."""
    d_eff = int(reachable_depths(forest).max(initial=0))
    if d_eff < forest.depth:
        forest = truncate_depth(forest, d_eff)
    if feasibility.check(strategy, forest, limits) is not None:
        return None
    T, D = forest.num_trees, forest.depth
    out_ops = _transform_ops(forest)
    miss_ops = 2 * _finite_missing(forest)

    if strategy in (Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST):
        lev, col_index, form = fold_leveled(forest)
        width = row_width(form, lev.num_cols)
        device = _fold_kernel_s(form, width, D, T, rows, cal, limits,
                                strategy == Strategy.VMEM_FOREST)
        ops = _canon_ops(forest, col_index is not None, form == "dual") + out_ops
        return _cost(device, 1, ops, cal)

    if strategy == Strategy.RANK_MXU:
        vcols = rank_virtual_cols(forest)
        device = (_rank_a_s(vcols, rows, cal)
                  + _rank_b_s(rank_groups(vcols), D, T, rows, cal, limits))
        ops = _canon_ops(forest, vcols != forest.num_cols) + out_ops
        return _cost(device, 2, ops, cal)

    if strategy == Strategy.DEPTH_BUCKETED:
        depths = reachable_depths(forest)
        buckets = [(len(idx), int(depths[idx].max(initial=0)))
                   for idx in plan_buckets(depths)]
        buckets = [(n, d) for n, d in buckets if d > 0]
        adds = len(buckets)  # the buckets' sum and the stumps' margin
        if feasibility.rank_buckets_fit(forest):
            vcols = rank_virtual_cols(forest)
            G = rank_groups(vcols)
            device = _rank_a_s(vcols, rows, cal) + sum(
                _rank_b_s(G, d, n, rows, cal, limits) for n, d in buckets)
            ops = _canon_ops(forest, vcols != forest.num_cols) + adds + out_ops
            return _cost(device, 1 + len(buckets), ops, cal)
        dual = forest.num_cols <= MAX_DUAL_COLS
        form = "dual" if dual else "nonge"
        width = row_width(form, forest.num_cols)
        device = sum(_fold_kernel_s(form, width, d, n, rows, cal, limits)
                     for n, d in buckets)
        ops = _canon_ops(forest, False, dual) + adds + out_ops
        return _cost(device, len(buckets), ops, cal)

    if strategy == Strategy.SPARSE:
        if SparseRankEngine.feasible(forest) is None:
            vcols = rank_virtual_cols(forest)
            G = rank_groups(vcols)
            unit = cal.sparse_ns * (1 if G == 1
                                    else cal.rank_fold_bytes_ns / cal.rank_fold_ns)
            # a warp descends each tree as deep as its deepest row: the
            # trees' reachable depths in the pruned pool
            path = int(reachable_depths(forest).sum())
            device = _rank_a_s(vcols, rows, cal) + _descent_s(
                unit, cal.sparse_row_ns, cal.sparse_floor_ns,
                cal.sparse_floor_us, rows, path, *sparse_geometry(G, limits),
                limits)
            ops = _canon_ops(forest, vcols != forest.num_cols) + out_ops
            return _cost(device, 2, ops, cal)
        depth = int(reachable_depths(forest).max(initial=0))
        chunks = _chunks(rows, GATHER_ROW_BYTES * T)
        device = rows * T * depth * cal.gather_step_ns * 1e-9
        ops = chunks * ((SPARSE_GATHER_LEVEL_OPS + miss_ops) * depth
                        + SPARSE_GATHER_CHUNK_OPS) + 1 + out_ops
        return _cost(device, 0, ops, cal)

    if strategy == Strategy.HBM_DIRECT:
        chunks = _chunks(rows, GATHER_ROW_BYTES * T)
        device = rows * T * D * cal.gather_step_ns * 1e-9
        ops = chunks * ((GATHER_LEVEL_OPS + miss_ops) * D
                        + GATHER_CHUNK_OPS) + 1 + out_ops
        return _cost(device, 0, ops, cal)

    # ROW_TILED, TENSOR: TensorEngine, take or one-hot
    mode = "take" if strategy == Strategy.ROW_TILED else "onehot"
    node_ns = cal.select_node_ns if mode == "take" else cal.onehot_node_ns
    chunks = _chunks(rows, SELECT_ROW_BYTES * T << D)
    device = rows * (T << D) * node_ns * 1e-9
    ops = chunks * (SELECT_LEVEL_OPS[mode] * D + SELECT_CHUNK_OPS[mode]
                    + miss_ops) + 1 + out_ops
    return _cost(device, 0, ops, cal)


def choose_strategy(forest: ForestSpec, rows: int,
                    cal: Optional[Calibration] = None,
                    limits: GpuLimits = GpuLimits()
                    ) -> Tuple[Strategy, Dict[Strategy, Optional[CostBreakdown]]]:
    """argmin over predicted costs (main.cu:66-82 analog). Returns the pick
    and the full cost table for reporting."""
    cal = cal or Calibration.default()
    costs = {s: predict_cost(s, forest, rows, cal, limits) for s in Strategy}
    best = min(
        (s for s in Strategy if costs[s] is not None),
        key=lambda s: costs[s].total,
    )
    return best, costs
