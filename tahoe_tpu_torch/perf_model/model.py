"""Analytical performance model: predict the best strategy before running.

The port of tahoe_tpu/perf_model/model.py, the re-derivation of the
reference's closed-form model (main.cu:22-82): per-strategy cost = the work
of the engine that serves it, scaled by calibrated machine constants
(calibrate.py); the argmin is the pick. Every term follows the port's own
engines, not the TPU's:

- **descents**: kernel C, the deep kernel and kernel B descend D levels a
  (row, tree): T x D steps a row at the kernel's ns per (row, tree, level)
  slot, plus its ns per row (staging, paid once a launch). The deep
  kernel's terms are fit on tables that sit in the L2; where the sectors a
  call reads of a forest's lower levels do not (``deep_misses``:
  rf_deep18-class), each of those loads a (row, tree) adds its own
  calibrated ns to the row and to a thread's chain. A launch runs in
  waves of blocks (``occupancy``), each the larger of one block's least
  time (a thread's chain of steps: where rows are too few to fill the card,
  it binds; kernel C also waits on each tile of trees, and where one block
  fills an SM it batches its loads, at a floor of its own) and the
  throughput of the blocks an SM holds at once (``blocks_per_sm``: shared
  memory, threads and registers), each still waiting on its tiles.
  ``fold_plan`` says which fold kernel serves a forest, its block and
  VMEM_FOREST's one tile;
- **sparse**: the sparse kernel walks each tree of the pruned pool, a warp
  as deep as its deepest row: the trees' reachable depths, not 2^D;
- **kernel A**: rows x virtual features, once for RANK_MXU, DEPTH_BUCKETED's
  rank variant and SPARSE;
- **bytes**: kernel C restages its tables once a row block;
- **plain torch**: gather steps (HBM_DIRECT, the CSR gather tier) and the
  select-fold's nodes (ROW_TILED, TENSOR);
- **graph nodes**: a predict is one CUDA graph replay (ops/graphed.py).
  Every kernel launch and plain torch op of the path is a node of it; each
  plain torch op costs the card its calibrated µs (a launch's own is in its
  kernel's floor), and each node adds its calibrated µs to the host's issue
  of the replay. TensorEngine sizes its row chunks by ROW_CHUNK_BYTES
  (ops/rows.py), so it holds a depth-long chain a chunk;
- **the graph's copies**: around the replay the card copies the rows into
  the graph's static input where the engine gathers no columns, and clones
  the result out: their bytes at the card's copy rate, an op each;
- **host**: one graphed call of the shortest kernel path (the rows staged
  in, the replay, the result cloned out), plus the nodes past its own.

Where the rows are too few to fill the card, kernel C's least time also
follows its block: a thread stages its own row, a word at a time
(``fold_c_stage_ns`` a word; wide rows, mnist-class), and a (tree, level)
step of its chain takes longer the more warps the SM runs
(``fold_c_warp_ns`` a warp, from the calibration's 256-row block;
64-row blocks, VMEM_FOREST on mnist- and cifar-class).

A predict of a chain, which the enumeration's slope times, costs the
card's time alone (``CostBreakdown.chained``): its kernels, its ops and
the copy of ungathered rows, not the host's issue nor the clone out. One
call on its own (``total``) is the larger of the device's time, the clone
included, and the host's, plus what an event pair around a call reads past
the host's issue where calls run back to back. The JAX model's TPU terms
(TpuLimits, split budgets, RANK_STREAM_GBPS, MXU rates, the VMEM residency
penalty) have no counterpart. Costs are seconds per predict of ``rows``
rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from tahoe_tpu_torch.config import GpuLimits, Output, Strategy
from tahoe_tpu_torch.engine import feasibility
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops.bucketed import rank_buckets_fit
from tahoe_tpu_torch.ops.fold_kernel import (
    MAX_DUAL_COLS,
    DeepLaunch,
    FoldLaunch,
    deep_groups,
    fold_plan,
    row_width,
    tree_bytes,
)
from tahoe_tpu_torch.ops.rank_kernel import (
    RANK_PAIR_GROUPS,
    rank_block_rows,
    rank_row_words,
)
from tahoe_tpu_torch.ops.rows import ROW_CHUNK_BYTES
from tahoe_tpu_torch.ops.sparse_kernel import sparse_rank_reason
from tahoe_tpu_torch.perf_model.calibrate import (
    CAL_BLOCK_ROWS,
    SPARSE_BLOCK_ROWS,
    Calibration,
)

# plain torch ops a row chunk issues per level (and once a chunk), read off
# the engines: GatherEngine._margins_chunk, SparseGatherEngine's and
# TensorEngine's; a finite missing sentinel costs two more a missing test
GATHER_LEVEL_OPS, GATHER_CHUNK_OPS = 19, 3
SPARSE_GATHER_LEVEL_OPS, SPARSE_GATHER_CHUNK_OPS = 18, 2
SELECT_LEVEL_OPS = {"take": 5, "onehot": 6}
SELECT_CHUNK_OPS = {"take": 2, "onehot": 10}
# the graph nodes of the call calibrate.py times whole (call_us): dual rows
# (two ops) and kernel C
CALL_NODES = 3
# an SM's threads and resident blocks at most (sm_90)
SM_THREADS, SM_BLOCKS = 2048, 32
# bytes a row a chunk: the gather tiers' and TensorEngine's own sizing
GATHER_ROW_BYTES, SELECT_ROW_BYTES = 48, 32
# the L2's partitions (H100 SXM: two of 25 MB), each caching the reads of
# the SMs wired to it; the deep kernel's loads past the near one's share
# are priced on their own (``deep_misses``), fit to rf_deep16- and
# rf_deep18-class at the sweep's rows (PERF.md section 6)
L2_PARTITIONS = 2
# an SM's registers, granted a warp at a time in units of REGISTER_UNIT
SM_REGISTERS, REGISTER_UNIT = 65536, 256
# the fold forms' index in the library's register queries (csrc/common.cuh
# NodeForm)
FORM_INDEX = {"dual": 0, "sign": 1, "nonge": 2}
# the sparse kernel stages int16 pairs up to this many plane groups
# (csrc/sparse_rank.cu TAHOE_SPARSE_PAIR_GROUPS)
SPARSE_PAIR_GROUPS = 1
# registers a thread of each kernel instance the model prices, keyed by the
# library's register query (``register_query`` and its siblings): ptxas -v
# and cudaFuncGetAttributes on an NVIDIA H100 80GB HBM3 (700.00 W), the
# kernels of commit 9148f4a (the deep kernel's two-lane dual instance: of
# its staging of raw rows, 64 where the staged rows' copy loop took 72);
# chip_smoke.py phase 2 fails when the library reads otherwise. None binds
# a launch of today's: kernel C's batched instances take more than half an
# SM's shared memory anyway, and ``deep_launch`` gives the dual form's
# rows, at most 128 lanes, 256 a block and one thread each
KERNEL_REGISTERS = {
    ("tahoe_fold_registers", 0, 0): 34, ("tahoe_fold_registers", 0, 1): 79,
    ("tahoe_fold_registers", 1, 0): 32, ("tahoe_fold_registers", 1, 1): 99,
    ("tahoe_fold_registers", 2, 0): 39, ("tahoe_fold_registers", 2, 1): 80,
    ("tahoe_fold_deep_registers", 0, 1): 48, ("tahoe_fold_deep_registers", 0, 2): 64,
    ("tahoe_fold_deep_registers", 1, 1): 48, ("tahoe_fold_deep_registers", 1, 2): 70,
    ("tahoe_fold_deep_registers", 2, 1): 48, ("tahoe_fold_deep_registers", 2, 2): 72,
    ("tahoe_rank_fold_registers", 0): 40, ("tahoe_rank_fold_registers", 1): 40,
    ("tahoe_sparse_rank_registers", 0): 56, ("tahoe_sparse_rank_registers", 1): 56,
}


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    device_s: float
    host_s: float
    latency_s: float
    launches: int  # kernel launches and plain torch ops: a call's graph nodes
    # the card's clone of one call's result out of its graph (in device_s)
    clone_s: float = 0.0

    @property
    def total(self) -> float:
        """One call on its own: the larger of the card's and the host's
        time, and the event pair's tail past the issue
        (scripts/path_time.py)."""
        return max(self.device_s, self.host_s) + self.latency_s

    @property
    def chained(self) -> float:
        """One predict of a chain (ops/graphed.py ``chain``), what the
        enumeration's slope measures: the path's work on the card (its
        kernels, its plain ops as graph nodes, the copy into the static
        input where the engine gathers no columns); no host issue, no
        event tail and no per-call clone."""
        return self.device_s - self.clone_s


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


def blocks_per_sm(smem_bytes: int, threads: int, limits: GpuLimits,
                  registers: int) -> int:
    """Blocks of ``threads`` threads, ``registers`` a thread and
    ``smem_bytes`` of shared memory one SM holds at once."""
    by_smem = limits.smem_per_sm // (smem_bytes + limits.SMEM_RESERVED_PER_BLOCK)
    warp_regs = -(-registers * 32 // REGISTER_UNIT) * REGISTER_UNIT
    by_regs = SM_REGISTERS // warp_regs // -(-threads // 32)
    return max(1, min(by_smem, by_regs, SM_THREADS // threads, SM_BLOCKS))


def fold_batches(smem_bytes: int, limits: GpuLimits = GpuLimits()) -> bool:
    """Whether kernel C batches its block loads: where one block takes more
    than half an SM's shared memory (csrc/fold.cu TAHOE_FOLD_BATCH 1)."""
    return 2 * (smem_bytes + limits.SMEM_RESERVED_PER_BLOCK) > limits.smem_per_sm


def register_query(form: str, launch: FoldLaunch | DeepLaunch,
                   limits: GpuLimits = GpuLimits()) -> tuple:
    """The library's register query (export, arguments) of the fold
    kernel instance that runs ``launch`` in ``form``: KERNEL_REGISTERS'
    key."""
    if isinstance(launch, FoldLaunch):
        return ("tahoe_fold_registers", FORM_INDEX[form],
                int(fold_batches(launch.smem_bytes, limits)))
    return ("tahoe_fold_deep_registers", FORM_INDEX[form], launch.lanes)


def rank_register_query(groups: int) -> tuple:
    """Kernel B's register query at ``groups`` plane groups."""
    return ("tahoe_rank_fold_registers", int(groups <= RANK_PAIR_GROUPS))


def sparse_register_query(groups: int) -> tuple:
    """The sparse kernel's register query at ``groups`` plane groups."""
    return ("tahoe_sparse_rank_registers", int(groups <= SPARSE_PAIR_GROUPS))


def _descent_s(unit: float, row: float, floor: float, floor_us: float,
               rows: int, chain: float, rows_per_block: int, per_sm: int,
               limits: GpuLimits, floor_chain: Optional[float] = None,
               waits_us: float = 0.0, stage_us: float = 0.0) -> float:
    """A descent kernel of ``chain`` (tree, level) steps a row, in waves of
    blocks: a wave takes the larger of one block's least time (its thread's
    ``floor_chain``, ``waits_us`` and staging its rows, ``stage_us``; what
    binds where an SM holds one block) and the throughput of the blocks an
    SM runs at once, each of which still waits ``waits_us`` on its tiles
    (svhn-class, PERF.md section 6: two blocks an SM took their tile waits
    beside their descents)."""
    floor_chain = chain if floor_chain is None else floor_chain
    least = floor * floor_chain + (floor_us + waits_us + stage_us) * 1e3
    per_block = rows_per_block * limits.sm_count * (row + unit * chain) + waits_us * 1e3
    return sum(max(least, at_once * per_block)
               for at_once in occupancy(rows, rows_per_block, per_sm,
                                        limits.sm_count)) * 1e-9


def deep_misses(trees: int, depth: int, rows: int, l2_bytes: int) -> float:
    """Loads of one (row, tree) descent of the deep kernel that the L2 does
    not hold, where calls repeat on the same ``rows`` (as the enumeration
    and the calibration time them): its groups of blocks, then its leaves,
    top first. A call reads of a group at most a 32-byte sector a (row,
    tree), and no more than the group's blocks over every tree; each
    group's sectors are held in the share of the L2 the groups above leave
    them, the rest read from device memory. The L2 holding a read is taken
    as the partition near the SM that issues it, one of L2_PARTITIONS
    (NVIDIA's A100 architecture paper: each partition caches the accesses
    of the SMs wired to it)."""
    l2_bytes //= L2_PARTITIONS
    spans, d = [], 0
    for size in deep_groups(depth):
        spans.append(trees * min(16 << d, 32 * rows))
        d += size
    spans.append(trees * min(4 << depth, 32 * rows))
    free, misses = l2_bytes, 0.0
    for span in spans:
        misses += 1.0 - min(span, max(free, 0)) / span
        free -= span
    return misses


def _fold_kernel_s(form: str, width: int, depth: int, trees: int, rows: int,
                   cal: Calibration, limits: GpuLimits,
                   whole_forest: bool = False) -> float:
    """Kernel C or the deep kernel, as fold_plan routes the forest. Kernel C
    waits on each tile of trees but the first; it restages its tables once
    a row block."""
    plan = fold_plan(form, width, depth, trees, limits, whole_forest=whole_forest)
    chain = trees * depth
    regs = KERNEL_REGISTERS[register_query(form, plan, limits)]
    if isinstance(plan, FoldLaunch):
        tiles = -(-trees // plan.tile_trees)
        rpb = plan.rows_per_block
        floor_ns, floor_us = ((cal.fold_c_batch_floor_ns, cal.fold_c_batch_floor_us)
                              if fold_batches(plan.smem_bytes, limits)
                              else (cal.fold_c_floor_ns, cal.fold_c_floor_us))
        floor_ns += cal.fold_c_warp_ns * (rpb - CAL_BLOCK_ROWS) / 32
        compute = _descent_s(
            cal.fold_c_ns, cal.fold_c_row_ns, floor_ns, floor_us, rows, chain,
            rpb, blocks_per_sm(plan.smem_bytes, rpb, limits, regs), limits,
            waits_us=cal.fold_c_tile_us * (tiles - 1),
            stage_us=(width | 1) * cal.fold_c_stage_ns * 1e-3)
        moved = rows * (width + 1) * 4 + -(-rows // rpb) * trees * tree_bytes(depth)
        return max(compute, moved / (cal.hbm_gbps * 1e9))
    threads = plan.rows_per_block * plan.lanes
    # the loads past the L2: each adds to a row's time and to its thread's
    # chain (its trees' share of them)
    misses = trees * deep_misses(trees, depth, rows, limits.l2_bytes)
    return _descent_s(cal.fold_deep_ns,
                      cal.fold_deep_row_ns + cal.fold_deep_miss_ns * misses,
                      cal.fold_deep_floor_ns,
                      cal.fold_deep_floor_us
                      + cal.fold_deep_miss_floor_ns * misses / plan.lanes * 1e-3,
                      rows, chain, plan.rows_per_block,
                      blocks_per_sm(plan.smem_bytes, threads, limits, regs), limits,
                      chain / plan.lanes)


def _rank_a_s(vcols: int, rows: int, cal: Calibration) -> float:
    """Kernel A: one block an SM walks 256-row tiles; its least time is a
    launch's."""
    return max(cal.rank_transform_floor_us * 1e3,
               rows * vcols * cal.rank_transform_ns) * 1e-9


def rank_b_geometry(groups: int, limits: GpuLimits) -> tuple[int, int]:
    """(rows a block, blocks an SM) of kernel B (csrc/common.cuh)."""
    rpb = rank_block_rows(groups)
    return rpb, blocks_per_sm(rpb * 4 * rank_row_words(groups), rpb, limits,
                              KERNEL_REGISTERS[rank_register_query(groups)])


def sparse_geometry(groups: int, limits: GpuLimits) -> tuple[int, int]:
    """(rows a block, blocks an SM) of the sparse kernel, which stages its
    rows as kernel B does (csrc/sparse_rank.cu)."""
    rpb = SPARSE_BLOCK_ROWS
    return rpb, blocks_per_sm(rpb * 4 * rank_row_words(groups), rpb, limits,
                              KERNEL_REGISTERS[sparse_register_query(groups)])


def _rank_b_s(groups: int, depth: int, trees: int, rows: int,
              cal: Calibration, limits: GpuLimits) -> float:
    """Kernel B: int16 pair staging at one plane group, bytes past it."""
    unit = cal.rank_fold_ns if groups == 1 else cal.rank_fold_bytes_ns
    floor = cal.rank_fold_floor_ns * unit / cal.rank_fold_ns
    return _descent_s(unit, cal.rank_fold_row_ns * groups, floor,
                      cal.rank_fold_floor_us, rows, trees * depth,
                      *rank_b_geometry(groups, limits), limits)


def _cost(device_s: float, launches: int, ops: int, cal: Calibration,
          rows: int, copied_cols: int) -> CostBreakdown:
    """A path's cost as one graph replay: the card runs the kernels
    (``device_s``) and the ops; the host issues one graphed call, the
    calibrated call of the shortest path (CALL_NODES nodes) and its nodes
    past those. Around the replay the card also copies the rows into the
    graph's static input where the engine gathers no columns
    (``copied_cols`` f32 a row; where it gathers, the gather writes them
    there, as an eager call's writes them) and clones the result out: a
    read and a write of each, an op each. A predict of a chain makes the
    copy (its stage step) but not the clone (``clone_s``)."""
    nodes = launches + ops
    host_us = cal.call_us + max(0, nodes - CALL_NODES) * cal.node_us
    copied = 8 * rows * copied_cols
    ops += bool(copied_cols)
    clone_s = cal.op_device_us * 1e-6 + 8 * rows / (cal.hbm_gbps * 1e9)
    return CostBreakdown(
        device_s=(device_s + ops * cal.op_device_us * 1e-6
                  + copied / (cal.hbm_gbps * 1e9) + clone_s),
        host_s=host_us * 1e-6,
        latency_s=cal.latency_us * 1e-6,
        launches=nodes,
        clone_s=clone_s,
    )


def _chunks(rows: int, bytes_per_row: int) -> int:
    """Row chunks of ops/rows.py map_row_chunks."""
    return -(-max(rows, 1) // max(1, ROW_CHUNK_BYTES // max(1, bytes_per_row)))


def predict_cost(strategy: Strategy, facts: feasibility.ForestFacts,
                 rows: int, cal: Calibration, limits: GpuLimits = GpuLimits()
                 ) -> Optional[CostBreakdown]:
    """Predicted cost of one predict of ``rows`` rows of the forest of
    ``facts``, or None where feasibility.check refuses the strategy
    (reference: acc=FLT_MAX skip, BaseTahoeTest.h:657-679). ``facts`` are
    those of the forest cut to its reachable depth (ForestFacts.cut), as
    Forest takes it."""
    if feasibility.check(strategy, facts, limits) is not None:
        return None
    forest = facts.spec
    T, D, C = facts.num_trees, facts.depth, forest.num_cols
    out_ops = _transform_ops(forest)
    miss_ops = 2 * _finite_missing(forest)

    if strategy in (Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST):
        cols, form, compacted = facts.fold
        width = row_width(form, cols)
        device = _fold_kernel_s(form, width, D, T, rows, cal, limits,
                                strategy == Strategy.VMEM_FOREST)
        ops = _canon_ops(forest, compacted, form == "dual") + out_ops
        return _cost(device, 1, ops, cal, rows, 0 if compacted else C)

    # a graphed call copies the rows into its static input where its engine
    # gathers no columns: the rank engines gather where banding or
    # compaction changes the columns
    if strategy == Strategy.RANK_MXU:
        vcols = facts.vcols
        device = (_rank_a_s(vcols, rows, cal)
                  + _rank_b_s(facts.groups, D, T, rows, cal, limits))
        ops = _canon_ops(forest, vcols != C) + out_ops
        return _cost(device, 2, ops, cal, rows, 0 if vcols != C else C)

    if strategy == Strategy.DEPTH_BUCKETED:
        buckets = facts.buckets
        adds = len(buckets)  # the buckets' sum and the stumps' margin
        if rank_buckets_fit(C, facts.vcols):
            vcols, G = facts.vcols, facts.groups
            device = _rank_a_s(vcols, rows, cal) + sum(
                _rank_b_s(G, d, n, rows, cal, limits) for n, d in buckets)
            ops = _canon_ops(forest, vcols != C) + adds + out_ops
            return _cost(device, 1 + len(buckets), ops, cal, rows,
                         0 if vcols != C else C)
        dual = C <= MAX_DUAL_COLS
        form = "dual" if dual else "nonge"
        width = row_width(form, C)
        device = sum(_fold_kernel_s(form, width, d, n, rows, cal, limits)
                     for n, d in buckets)
        ops = _canon_ops(forest, False, dual) + adds + out_ops
        return _cost(device, len(buckets), ops, cal, rows, C)

    if strategy == Strategy.SPARSE:
        if sparse_rank_reason(facts.vcols) is None:
            vcols, G = facts.vcols, facts.groups
            unit = cal.sparse_ns * (1 if G == 1
                                    else cal.rank_fold_bytes_ns / cal.rank_fold_ns)
            # a warp descends each tree as deep as its deepest row: the
            # trees' reachable depths in the pruned pool
            path = int(facts.depths.sum())
            device = _rank_a_s(vcols, rows, cal) + _descent_s(
                unit, cal.sparse_row_ns, cal.sparse_floor_ns,
                cal.sparse_floor_us, rows, path, *sparse_geometry(G, limits),
                limits)
            ops = _canon_ops(forest, vcols != C) + out_ops
            return _cost(device, 2, ops, cal, rows, 0 if vcols != C else C)
        depth = int(facts.depths.max(initial=0))
        chunks = _chunks(rows, GATHER_ROW_BYTES * T)
        device = rows * T * depth * cal.gather_step_ns * 1e-9
        ops = chunks * ((SPARSE_GATHER_LEVEL_OPS + miss_ops) * depth
                        + SPARSE_GATHER_CHUNK_OPS) + 1 + out_ops
        return _cost(device, 0, ops, cal, rows, C)

    if strategy == Strategy.HBM_DIRECT:
        chunks = _chunks(rows, GATHER_ROW_BYTES * T)
        device = rows * T * D * cal.gather_step_ns * 1e-9
        ops = chunks * ((GATHER_LEVEL_OPS + miss_ops) * D
                        + GATHER_CHUNK_OPS) + 1 + out_ops
        return _cost(device, 0, ops, cal, rows, C)

    # ROW_TILED, TENSOR: TensorEngine, take or one-hot
    mode = "take" if strategy == Strategy.ROW_TILED else "onehot"
    node_ns = cal.select_node_ns if mode == "take" else cal.onehot_node_ns
    chunks = _chunks(rows, SELECT_ROW_BYTES * T << D)
    device = rows * (T << D) * node_ns * 1e-9
    ops = chunks * (SELECT_LEVEL_OPS[mode] * D + SELECT_CHUNK_OPS[mode]
                    + miss_ops) + 1 + out_ops
    return _cost(device, 0, ops, cal, rows, C)


def choose_strategy(forest: ForestSpec, rows: int,
                    cal: Optional[Calibration] = None,
                    limits: GpuLimits = GpuLimits()
                    ) -> Tuple[Strategy, Dict[Strategy, Optional[CostBreakdown]]]:
    """argmin over predicted costs (main.cu:66-82 analog), each a predict
    of a chain (``CostBreakdown.chained``), as the enumeration times them.
    Returns the pick and the full cost table for reporting."""
    cal = cal or Calibration.default()
    facts = feasibility.ForestFacts.cut(forest)
    costs = {s: predict_cost(s, facts, rows, cal, limits) for s in Strategy}
    best = min(
        (s for s in Strategy if costs[s] is not None),
        key=lambda s: costs[s].chained,
    )
    return best, costs
