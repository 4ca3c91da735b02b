"""Machine calibration: the port's kernels and plain torch engines, timed.

The port of tahoe_tpu/perf_model/calibrate.py, the analog of the
reference's adapted NVIDIA ``bandwidthTest`` probe (bandwidthTest.h:110-381):
measure the machine once and feed the analytical model (model.py). Each
engine family is micro-run in this process on small forests, and its time
is reduced to per-element costs that the model scales to a forest's shape:

- each descent kernel (kernel C, the deep kernel, kernel B, the sparse
  kernel), by device time (``cuda_device_ms``) on forests of two sizes, at
  many rows: ns per (row, tree, level) descended, the slope, and ns per row,
  the intercept (staging the row, writing its margin: paid once a launch);
  and at one block an SM, where rows are too few to fill the card and a
  thread's chain of descents binds: the least time of a launch, ns per
  (tree, level) plus µs a launch. Kernel C also pays for each tile of trees
  it waits on, µs a tile (the same forest in tiles of two sizes), for
  each word of its row a thread stages (the same tables on rows of two
  widths), and how a step's floor changes with the warps of a block
  (blocks of 256 and of 64 rows). The deep kernel also on a forest whose
  lower levels pass the L2 (random tables of depth 18): ns per load past
  the L2 (model.deep_misses) a row, and in a thread's chain, over what
  its depth-12 terms price;
- kernel A, per (row, virtual feature), and its least time a launch;
- the plain torch engines by device time: ns per gather step (HBM_DIRECT)
  and per (row, node) of the select-fold (ROW_TILED's take, TENSOR's
  one-hot product), less their ops' own;
- device memory, by a device-to-device copy of 256 MiB between two events
  (2 x bytes / time), the role of bandwidthTest.h:829-908;
- a predict is one CUDA graph replay (ops/graphed.py): the device µs one
  small torch op adds to a replay, and the host's: µs to issue one graphed
  call of the shortest kernel path (200 issued back to back, by the host's
  clock) and the µs each graph node adds to a replay's issue (graphs of 1
  and of 400 small ops); the µs an event pair around such a call reads past
  its issue, in calls back to back (as the enumeration times a strategy).

``Calibration.default()`` holds the values measured on an H100; ``measure``
re-measures them on the card and raises on the CPU. The JAX module's
subprocess, its disk cache and its clamps are not ported: this process owns
its card, and a reading is used as it comes.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys

# rows of one block of kernel A (csrc/rank_transform.cu kTileRows) and of
# the sparse kernel (csrc/sparse_rank.cu TAHOE_SPARSE_ROWS)
RANK_TRANSFORM_TILE_ROWS = 256
SPARSE_BLOCK_ROWS = 64
# the calibration forests: depth, features, and the two tree counts whose
# times give each descent kernel's slope and intercept
CAL_DEPTH = 8
CAL_COLS = 18
CAL_WIDE_COLS = 36  # two plane groups: kernel B's byte staging
CAL_TREES = (32, 256)
# rows of the calibration data: enough for CAL_WAVES full waves of every
# kernel (the deep kernel's: 2 x 132 SMs x 6 blocks x 256 rows)
CAL_ROWS = 416 << 10
CAL_WAVES = 2
# kernel C's tile of trees in the calibration (and half of it), and its
# block's rows
C_TILE = 16
CAL_BLOCK_ROWS = 256
# the deep kernel's calibration forests, whose tables sit in the L2
DEEP_DEPTH = 12
DEEP_TREES = (8, 64)
# ... and random tables of depth 18 whose lower levels do not (96 trees,
# 537 MB with the deep kernel's heap tables; rf_deep18-class holds 1.1 GB)
DEEP_FAR_DEPTH = 18
DEEP_FAR_TREES = 96
COPY_BYTES = 256 << 20
HOST_CALLS = 200
# graph nodes of the long graph that times a node's host issue
GRAPH_NODES = 400
# kernel C's row staging: a sign-form forest's tables on rows of its own
# width and of STAGE_WIDTH, STAGE_ROWS rows a block (also the small block
# of its floor a warp), STAGE_TILE trees a tile
STAGE_COLS = 100
STAGE_WIDTH = 400
STAGE_ROWS = 64
STAGE_TILE = 8


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-element latencies in nanoseconds, plus machine constants."""

    # kernel C (csrc/fold.cu): per (row, tree, level); per row; least time
    # of a launch per (tree, level) and a launch; per tile of trees waited on
    fold_c_ns: float
    fold_c_row_ns: float
    fold_c_floor_ns: float
    fold_c_floor_us: float
    fold_c_tile_us: float
    # kernel C's least time where it batches its block loads (one block
    # takes more than half an SM's shared memory, csrc/fold.cu): per (tree,
    # level) and a launch
    fold_c_batch_floor_ns: float
    fold_c_batch_floor_us: float
    # kernel C's least time, where rows are too few to fill the card: ns a
    # thread takes to stage each word of its row; ns a (tree, level) step's
    # floor changes a warp its block runs, from CAL_BLOCK_ROWS rows (both
    # floors above are taken at CAL_BLOCK_ROWS)
    fold_c_stage_ns: float
    fold_c_warp_ns: float
    # the deep kernel (csrc/fold_deep.cu), the same but tiles; and per load
    # of a (row, tree) descent past the L2 (model.deep_misses), over those
    # terms: a row's ns, and ns in a thread's chain where one block an SM
    # runs
    fold_deep_ns: float
    fold_deep_row_ns: float
    fold_deep_floor_ns: float
    fold_deep_floor_us: float
    fold_deep_miss_ns: float
    fold_deep_miss_floor_ns: float
    # kernel B (csrc/rank_fold.cu): per (row, tree, level) at one plane group
    # (int16 pair staging) and past it (byte staging); per (row, group)
    # staged; least time per (tree, level) and a launch
    rank_fold_ns: float
    rank_fold_bytes_ns: float
    rank_fold_row_ns: float
    rank_fold_floor_ns: float
    rank_fold_floor_us: float
    # the sparse kernel (csrc/sparse_rank.cu): per (row, tree, level)
    # visited; per row; least time per (tree, level) and a launch
    sparse_ns: float
    sparse_row_ns: float
    sparse_floor_ns: float
    sparse_floor_us: float
    # kernel A (csrc/rank_transform.cu): per (row, virtual feature); least
    # time of a launch
    rank_transform_ns: float
    rank_transform_floor_us: float
    # plain torch: a gather step per (row, tree, level) (HBM_DIRECT and the
    # CSR gather tier); the select-fold per (row, node), take (ROW_TILED)
    # and one-hot (TENSOR)
    gather_step_ns: float
    select_node_ns: float
    onehot_node_ns: float
    hbm_gbps: float
    # a graph replay: the device µs of one small torch op in it; the host's
    # µs to issue one graphed call of the shortest kernel path (two ops and
    # a launch) and µs a graph node adds to that; µs an event pair around a
    # call reads past its host issue, calls back to back
    op_device_us: float
    call_us: float
    node_us: float
    latency_us: float

    @staticmethod
    def default() -> "Calibration":
        # measured on an NVIDIA H100 80GB HBM3, 700.00 W power limit, by
        # measure() in the sweep of sweep_results_torch_h100.jsonl (its
        # "calibration" line; python -m tahoe_tpu_torch.perf_model.calibrate
        # prints one)
        return Calibration(
            fold_c_ns=0.0007689900864230973,
            fold_c_row_ns=0.04864043810150842,
            fold_c_floor_ns=29.733145493082706,
            fold_c_floor_us=1.717118673026563,
            fold_c_tile_us=0.2993002533912652,
            fold_c_batch_floor_ns=26.578680262900892,
            fold_c_batch_floor_us=1.7886621281504644,
            fold_c_stage_ns=22.410668432712555,
            fold_c_warp_ns=2.1843747596167735,
            fold_deep_ns=0.0013986685925850733,
            fold_deep_row_ns=0.04525433467838155,
            fold_deep_floor_ns=61.36904758889051,
            fold_deep_floor_us=4.676571062632969,
            fold_deep_miss_ns=0.007327590096362607,
            fold_deep_miss_floor_ns=349.1563538873284,
            rank_fold_ns=0.0008477677688283797,
            rank_fold_bytes_ns=0.0012498362810306606,
            rank_fold_row_ns=0.23407623720117463,
            rank_fold_floor_ns=57.40714592060873,
            rank_fold_floor_us=18.590169293539866,
            sparse_ns=0.0010839258819843151,
            sparse_row_ns=0.23415542908243608,
            sparse_floor_ns=76.68482139706612,
            sparse_floor_us=17.898285388946533,
            rank_transform_ns=0.015278820706626926,
            rank_transform_floor_us=12.628799676895142,
            gather_step_ns=0.045039639076094325,
            select_node_ns=0.015662836574392717,
            onehot_node_ns=0.02477903336739473,
            hbm_gbps=2963.9106548095288,
            op_device_us=1.6764426231384277,
            call_us=31.593880000002628,
            node_us=0.0027722305764483076,
            latency_us=10.998120216243024,
        )

    def summary(self) -> str:
        """One line of the main constants (the CLI's Calibration line)."""
        return (
            f"kernel C {self.fold_c_ns * 1e3:.3f} ps/visit, deep "
            f"{self.fold_deep_ns * 1e3:.3f}, kernel B {self.rank_fold_ns * 1e3:.3f}, "
            f"sparse {self.sparse_ns * 1e3:.3f}, kernel A "
            f"{self.rank_transform_ns * 1e3:.2f} ps/(row, feature), gather "
            f"{self.gather_step_ns:.4f} ns/step, select "
            f"{self.select_node_ns * 1e3:.2f} ps/node, HBM {self.hbm_gbps:.0f} "
            f"GB/s, op {self.op_device_us:.2f} us (device), graphed call "
            f"{self.call_us:.1f} us + {self.node_us:.3f} us a node (host)"
        )


def _slope(t1: float, t2: float, n1: int, n2: int) -> tuple[float, float]:
    """(slope, intercept >= 0) of a time that is intercept + slope x n."""
    slope = (t2 - t1) / (n2 - n1)
    return slope, max(0.0, t1 - slope * n1)


def measure(device="cuda") -> Calibration:
    """Micro-run each engine family on the card (tens of seconds, the
    kernels' build excepted). Its launches are not counted: each kernel's
    launch count is as it was before the call."""
    import torch

    from tahoe_tpu_torch.config import GpuLimits, resolve_device
    from tahoe_tpu_torch.forest import compiler, synthetic
    from tahoe_tpu_torch.ops.fold_kernel import (
        DEEP_KERNELS, FOLD_KERNELS, FoldKernelEngine, FoldLaunch, FoldTables,
        deep_launch, heap_tables,
        fold_c_table, fold_deep_cuda, fold_launch, fold_margins_cuda,
        fold_smem_bytes, fold_tables)
    from tahoe_tpu_torch.ops.gather_engine import GatherEngine
    from tahoe_tpu_torch.ops.graphed import graphed
    from tahoe_tpu_torch.ops.rank_kernel import (
        RANK_FOLD, rank_margins_cuda, rank_tables)
    from tahoe_tpu_torch.ops.rank_transform import RANK_PLANES, rank_planes_cuda
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.ops.sparse_kernel import (
        SPARSE_RANK, sparse_margins_cuda, sparse_tables)
    from tahoe_tpu_torch.ops.tensor_engine import TensorEngine
    from tahoe_tpu_torch.perf_model.model import (
        GATHER_CHUNK_OPS, GATHER_LEVEL_OPS, KERNEL_REGISTERS, SELECT_CHUNK_OPS,
        SELECT_LEVEL_OPS, blocks_per_sm, deep_misses, rank_b_geometry,
        register_query, sparse_geometry)
    from tahoe_tpu_torch.utils.profiling import cuda_device_ms, cuda_median_ms

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"calibration measures a CUDA card; got {dev}")
    kernels = [RANK_PLANES, RANK_FOLD, SPARSE_RANK, *FOLD_KERNELS.values(),
               *DEEP_KERNELS.values()]
    counts = [k.launches for k in kernels]
    limits = GpuLimits.for_device(dev)
    sms = limits.sm_count
    D = CAL_DEPTH
    forests = [synthetic.generate_forest(t, D, CAL_COLS, seed=5)
               for t in CAL_TREES]
    data = synthetic.generate_data(CAL_ROWS, CAL_WIDE_COLS, missing_prob=0.02,
                                   seed=6)
    rows_d = torch.as_tensor(data, device=dev)

    def ms(fn):
        return cuda_device_ms(fn)

    # -- a small torch op's device time in a graph (the plain torch
    # engines' calibrations below are taken less their ops') ------------
    with torch.cuda.device(dev):
        a = torch.rand(64, 8, device=dev)
        idx = torch.zeros(64, 8, dtype=torch.int64, device=dev)

        def ops():
            for _ in range(HOST_CALLS):
                y = torch.gather(a, 1, idx)
                torch.where(y >= a, y, a)

        op_device_us = ms(ops) * 1e3 / (3 * HOST_CALLS)

    def descent(fn_for, block_rows, per_sm, chains=None):
        """(ns per (row, tree, level), ns per row, floor ns per (tree,
        level), floor µs a launch) of a kernel of ``block_rows`` rows a
        block, ``per_sm`` blocks an SM at once: ``fn_for(i, rows)``
        launches it on forest i, of ``chains[i]`` (tree, level) steps a row
        (the two CAL_TREES forests' by default). Slope and intercept from two full waves
        (every SM running ``per_sm`` blocks), the floor from one block an
        SM."""
        chains = chains or [t * D for t in CAL_TREES]
        n = min(rows_d.shape[0], CAL_WAVES * per_sm * block_rows * sms)
        t = [ms(lambda i=i: fn_for(i, n)) * 1e6 / n for i in range(2)]
        unit, row = _slope(t[0], t[1], *chains)
        floor_rows = sms * block_rows
        f = [ms(lambda i=i: fn_for(i, floor_rows)) * 1e6 for i in range(2)]
        floor, base = _slope(f[0], f[1], *chains)
        return unit, row, floor, base * 1e-3

    with torch.cuda.device(dev):
        # -- kernel C and the deep kernel on the same fold tables ----------
        tabs = [fold_tables(f, device=dev) for f in forests]
        xs = [canonicalize_rows(rows_d[:, :CAL_COLS], f.missing, device=dev,
                                col_index=t.col_index, dual=t.form == "dual")
              for f, t in zip(forests, tabs)]
        c_table = [fold_c_table(t) for t in tabs]
        width = tabs[0].width
        c_rows = fold_launch(width, D, CAL_TREES[1], limits).rows_per_block
        if c_rows != CAL_BLOCK_ROWS:
            raise RuntimeError(f"kernel C's calibration block takes {c_rows} "
                               f"rows, not {CAL_BLOCK_ROWS}")

        def c_launch(i, tile):
            """Kernel C's block of c_rows rows in tiles of ``tile`` trees,
            the same for both forests, so that both wait on tiles."""
            return FoldLaunch(c_rows, tile, fold_smem_bytes(
                width, D, CAL_TREES[i], c_rows, tile))

        fold_c = list(descent(lambda i, n: fold_margins_cuda(
            xs[i][:n], tabs[i], c_table[i], c_launch(i, C_TILE)), c_rows,
            blocks_per_sm(c_launch(1, C_TILE).smem_bytes, c_rows, limits,
                          KERNEL_REGISTERS[register_query(
                              tabs[1].form, c_launch(1, C_TILE), limits)])))
        # a tile of trees waited on: the larger forest in tiles of half the
        # size, at one block an SM; the floor's slope less the tiles it
        # waited on
        n_f = sms * c_rows
        tiles = [-(-t // C_TILE) for t in CAL_TREES]
        half = ms(lambda: fold_margins_cuda(xs[1][:n_f], tabs[1], c_table[1],
                                            c_launch(1, C_TILE // 2)))
        full = ms(lambda: fold_margins_cuda(xs[1][:n_f], tabs[1], c_table[1],
                                            c_launch(1, C_TILE)))
        fold_c_tile_us = max(0.0, (half - full) * 1e3 / tiles[1])

        def less_tiles(floor, base):
            """A floor's slope and intercept less the tiles it waited on."""
            return (max(0.0, floor - fold_c_tile_us * 1e3 * (tiles[1] - tiles[0])
                        / ((CAL_TREES[1] - CAL_TREES[0]) * D)),
                    max(0.0, base - fold_c_tile_us * tiles[0]))

        fold_c[2], fold_c[3] = less_tiles(fold_c[2], fold_c[3])
        # the same floor with the block loads batched: the same launch given
        # more than half an SM's shared memory
        batch_smem = max(c_launch(1, C_TILE).smem_bytes, limits.smem_half_sm + 16)
        fb = [ms(lambda i=i: fold_margins_cuda(
            xs[i][:n_f], tabs[i], c_table[i],
            c_launch(i, C_TILE)._replace(smem_bytes=batch_smem))) * 1e6
            for i in range(2)]
        b_floor, b_base = _slope(fb[0], fb[1], *[t * D for t in CAL_TREES])
        fold_c_batch = less_tiles(b_floor, b_base * 1e-3)
        # the same batched floor in blocks of STAGE_ROWS rows: a step's
        # floor a warp of the block
        n_w = sms * STAGE_ROWS
        fw = [ms(lambda i=i: fold_margins_cuda(
            xs[i][:n_w], tabs[i], c_table[i],
            FoldLaunch(STAGE_ROWS, C_TILE, batch_smem))) * 1e6 for i in range(2)]
        # (both wait on the same tiles: their difference is the warps')
        w_floor, _ = _slope(fw[0], fw[1], *[t * D for t in CAL_TREES])
        fold_c_warp_ns = (b_floor - w_floor) / ((c_rows - STAGE_ROWS) / 32)
        # staging a block's rows: a sign-form forest's tables on rows of its
        # width and of STAGE_WIDTH (the same tables: its codes read the first
        # columns), one block an SM, both launches in the batched instance
        stage_forest = synthetic.generate_forest(CAL_TREES[0], D, STAGE_COLS,
                                                 seed=5)
        st = fold_tables(stage_forest, device=dev)
        if st.form != "sign":
            raise RuntimeError(f"the staging forest takes the {st.form} form")
        wide_t = dataclasses.replace(st, num_cols=STAGE_WIDTH)
        s_table = fold_c_table(st)
        n_st = sms * STAGE_ROWS
        x_st = torch.zeros(n_st, STAGE_WIDTH, device=dev)
        x_st[:, :st.width] = canonicalize_rows(
            rows_d[:n_st, :CAL_WIDE_COLS].repeat(1, 3)[:, :STAGE_COLS],
            stage_forest.missing, device=dev, col_index=st.col_index)
        s_smem = max(fold_smem_bytes(STAGE_WIDTH, D, CAL_TREES[0], STAGE_ROWS,
                                     STAGE_TILE), limits.smem_half_sm + 16)
        s_launch = FoldLaunch(STAGE_ROWS, STAGE_TILE, s_smem)
        narrow_x = x_st[:, :st.width].contiguous()
        t_narrow = ms(lambda: fold_margins_cuda(narrow_x, st, s_table, s_launch))
        t_wide = ms(lambda: fold_margins_cuda(x_st, wide_t, s_table, s_launch))
        fold_c_stage_ns = max(0.0, (t_wide - t_narrow) * 1e6
                              / ((STAGE_WIDTH | 1) - (st.width | 1)))
        # the floors were taken on rows of the calibration's width: less
        # their own staging
        own_stage_us = (width | 1) * fold_c_stage_ns * 1e-3
        fold_c[3] = max(0.0, fold_c[3] - own_stage_us)
        fold_c_batch = (fold_c_batch[0], max(0.0, fold_c_batch[1] - own_stage_us))
        del xs, c_table, tabs, x_st, narrow_x, s_table, st, wide_t
        # the deep kernel on forests of its own depth (its tables outgrow
        # L1 as a depth-8 forest's do not)
        deep_forests = [synthetic.generate_forest(t, DEEP_DEPTH, CAL_COLS, seed=5)
                        for t in DEEP_TREES]
        tabs = [fold_tables(f, device=dev) for f in deep_forests]
        xs = [canonicalize_rows(rows_d[:, :CAL_COLS], f.missing, device=dev,
                                col_index=t.col_index, dual=t.form == "dual")
              for f, t in zip(deep_forests, tabs)]
        d_launch = deep_launch(tabs[0].width, limits)
        heaps = [heap_tables(t) for t in tabs]
        d_per_sm = blocks_per_sm(d_launch.smem_bytes,
                                 d_launch.rows_per_block * d_launch.lanes, limits,
                                 KERNEL_REGISTERS[register_query(tabs[0].form,
                                                                 d_launch, limits)])
        fold_deep = descent(lambda i, n: fold_deep_cuda(
            xs[i][:n], tabs[i], heaps[i], d_launch), d_launch.rows_per_block,
            d_per_sm, [t * DEEP_DEPTH for t in DEEP_TREES])
        # the same kernel on random dual-form tables of DEEP_FAR_DEPTH, past
        # the L2: its time over what the terms above price, per load past
        # the L2, at full waves and at one block an SM
        T_far, D_far = DEEP_FAR_TREES, DEEP_FAR_DEPTH
        gen = torch.Generator(device=dev).manual_seed(7)
        nodes = (1 << D_far) - 1
        far = FoldTables(
            form="dual", col_index=None, num_cols=CAL_COLS,
            thresholds=torch.rand(T_far, nodes, device=dev, generator=gen) * 2 - 1,
            fids=torch.randint(0, 2 * CAL_COLS, (T_far, nodes), device=dev,
                               dtype=torch.int32, generator=gen),
            leaf=torch.randn(T_far, 1 << D_far, device=dev, generator=gen),
            depth=D_far)
        far_heap = heap_tables(far)
        chain = T_far * D_far

        def far_ms(n):
            """The far tables' launch on ``n`` rows, and its loads a row past
            the L2."""
            return (ms(lambda: fold_deep_cuda(xs[0][:n], far, far_heap, d_launch)),
                    T_far * deep_misses(T_far, D_far, n, limits.l2_bytes))

        n = min(rows_d.shape[0], CAL_WAVES * d_per_sm * d_launch.rows_per_block * sms)
        t_far, misses = far_ms(n)
        fold_deep_miss_ns = max(0.0, (t_far * 1e6 / n - fold_deep[1]
                                      - fold_deep[0] * chain) / misses)
        f_far, misses = far_ms(sms * d_launch.rows_per_block)
        fold_deep_miss_floor_ns = max(0.0, (f_far * 1e6 - fold_deep[2] * chain
                                            - fold_deep[3] * 1e3) / misses)
        del xs, heaps, tabs, far, far_heap

        # -- kernels A and B, one plane group and two --------------------
        rts = [rank_tables(f, device=dev) for f in forests]
        x_r = rts[0].rows(rows_d[:, :CAL_COLS], float("nan"))
        planes = [t.planes(rows_d[:, :CAL_COLS], float("nan")) for t in rts]
        rank_fold = descent(lambda i, n: rank_margins_cuda(
            planes[i][:n], rts[i].records, rts[i].leaf, D),
            *rank_b_geometry(1, limits))
        vcols = x_r.shape[1]
        t_a = ms(lambda: rank_planes_cuda(x_r, rts[0].thresholds, rts[0].counts))
        rank_transform_ns = t_a * 1e6 / (CAL_ROWS * vcols)
        n_a = min(CAL_ROWS, sms * RANK_TRANSFORM_TILE_ROWS)
        rank_transform_floor_us = ms(lambda: rank_planes_cuda(
            x_r[:n_a], rts[0].thresholds, rts[0].counts)) * 1e3
        wide = synthetic.generate_forest(CAL_TREES[1], D, CAL_WIDE_COLS, seed=5)
        wt = rank_tables(wide, device=dev)
        if wt.groups < 2:
            raise RuntimeError(f"the wide calibration forest takes {wt.groups} "
                               f"plane group; kernel B's byte staging needs 2")
        rpb, per_sm = rank_b_geometry(wt.groups, limits)
        n_w = min(rows_d.shape[0], CAL_WAVES * per_sm * rpb * sms)
        wp = wt.planes(rows_d[:n_w], float("nan"))
        t_w = ms(lambda: rank_margins_cuda(wp, wt.records, wt.leaf, D))
        rank_fold_bytes_ns = ((t_w * 1e6 / n_w - wt.groups * rank_fold[1])
                              / (CAL_TREES[1] * D))
        del rts, x_r, planes, wt, wp

        # -- the sparse kernel (complete trees: every walk visits D levels) -
        sts = [sparse_tables(f, device=dev) for f in forests]
        sp = [t.planes(rows_d[:, :CAL_COLS], float("nan")) for t in sts]
        sparse = descent(lambda i, n: sparse_margins_cuda(
            sp[i][:n], sts[i].slots, sts[i].roots.shape[0], sts[i].steps),
            *sparse_geometry(1, limits))
        del sts, sp

        # -- plain torch ---------------------------------------------------
        # (one row chunk each; NaN missing: no op of a finite sentinel)
        big = forests[1]
        n_g = 8192
        gat = GatherEngine(big, device=dev)
        gather_ops = GATHER_LEVEL_OPS * D + GATHER_CHUNK_OPS + 1
        gather_step_ns = ((ms(lambda: gat.margins(rows_d[:n_g, :CAL_COLS]))
                           - gather_ops * op_device_us * 1e-3)
                          * 1e6 / (n_g * big.num_trees * D))
        small = synthetic.generate_forest(CAL_TREES[0], 6, CAL_COLS, seed=5)
        lev = compiler.levelize(small)
        n_s = 4096
        nodes = small.num_trees << small.depth
        select = {}
        for mode in ("take", "onehot"):
            eng = TensorEngine(lev, select_mode=mode, device=dev)
            select_ops = SELECT_LEVEL_OPS[mode] * small.depth + SELECT_CHUNK_OPS[mode] + 1
            select[mode] = ((ms(lambda: eng.margins(rows_d[:n_s, :CAL_COLS]))
                             - select_ops * op_device_us * 1e-3)
                            * 1e6 / (n_s * nodes))
        del gat, eng

        # -- device memory -------------------------------------------------
        src = torch.empty(COPY_BYTES // 4, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        t_copy = cuda_median_ms(lambda: dst.copy_(src), warmup=2, iters=10)
        hbm_gbps = 2 * COPY_BYTES / (t_copy * 1e-3) / 1e9
        del src, dst

        # -- the host ----------------------------------------------------
        # a whole graphed call of the shortest kernel path: FoldKernelEngine's
        # predict on its staged route (dual rows: two ops, one launch, no
        # output op; its engine launches kernel C directly instead), issued
        # back to back
        tiny = synthetic.generate_forest(1, 1, 2, seed=5)
        teng = FoldKernelEngine(tiny, device=dev)
        tcall = graphed(teng._predict_staged, dev, teng._stage)
        trow = rows_d[:32, :2]

        def calls():
            for _ in range(HOST_CALLS):
                tcall(trow)

        call_us = host_us(calls, dev) / HOST_CALLS
        # a graph node's part of a replay's issue: graphs of 1 and of
        # GRAPH_NODES small ops
        y = torch.zeros(64, device=dev)
        issue = []
        for n in (1, GRAPH_NODES):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(n):
                    y.add_(1.0)

            def replays(g=g):
                for _ in range(HOST_CALLS // 4):
                    g.replay()

            replays()
            issue.append(host_us(replays, dev) / (HOST_CALLS // 4))
            del g
        node_us = max(0.0, (issue[1] - issue[0]) / (GRAPH_NODES - 1))
        # what an event pair around a call reads past its host issue, in
        # calls back to back as the enumeration times them
        latency_us = max(0.0, cuda_median_ms(lambda: tcall(trow),
                                             iters=HOST_CALLS) * 1e3 - call_us)
    for k, c in zip(kernels, counts):
        k.launches = c
    return Calibration(
        fold_c_ns=fold_c[0], fold_c_row_ns=fold_c[1], fold_c_floor_ns=fold_c[2],
        fold_c_floor_us=fold_c[3], fold_c_tile_us=fold_c_tile_us,
        fold_c_batch_floor_ns=fold_c_batch[0],
        fold_c_batch_floor_us=fold_c_batch[1],
        fold_deep_ns=fold_deep[0], fold_deep_row_ns=fold_deep[1],
        fold_deep_floor_ns=fold_deep[2], fold_deep_floor_us=fold_deep[3],
        fold_deep_miss_ns=fold_deep_miss_ns,
        fold_deep_miss_floor_ns=fold_deep_miss_floor_ns,
        rank_fold_ns=rank_fold[0], rank_fold_bytes_ns=rank_fold_bytes_ns,
        rank_fold_row_ns=rank_fold[1], rank_fold_floor_ns=rank_fold[2],
        rank_fold_floor_us=rank_fold[3],
        sparse_ns=sparse[0], sparse_row_ns=sparse[1], sparse_floor_ns=sparse[2],
        sparse_floor_us=sparse[3],
        rank_transform_ns=rank_transform_ns,
        rank_transform_floor_us=rank_transform_floor_us,
        gather_step_ns=gather_step_ns, select_node_ns=select["take"],
        onehot_node_ns=select["onehot"], hbm_gbps=hbm_gbps,
        fold_c_stage_ns=fold_c_stage_ns, fold_c_warp_ns=fold_c_warp_ns,
        op_device_us=op_device_us,
        call_us=call_us, node_us=node_us, latency_us=latency_us,
    )


def host_us(fn, dev, reps: int = 5) -> float:
    """Median host µs to issue ``fn()`` on an idle card: a synchronize
    before each, none after (the card runs on while the host's clock
    stops)."""
    import time

    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize(dev)
    return statistics.median(times)


def main() -> int:
    """Measure on the first card and print the calibration as one JSON line,
    beside the card's name; exit 2 without a card."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    cal = measure("cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      **dataclasses.asdict(cal)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
