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
  it waits on, µs a tile (the same forest in tiles of two sizes);
- kernel A, per (row, virtual feature), and its least time a launch;
- the plain torch engines by device time: ns per gather step (HBM_DIRECT)
  and per (row, node) of the select-fold (ROW_TILED's take, TENSOR's
  one-hot product);
- device memory, by a device-to-device copy of 256 MiB between two events
  (2 x bytes / time), the role of bandwidthTest.h:829-908;
- the host: µs to issue one kernel launch through its wrapper, one plain
  torch op and one whole call of the shortest kernel path (an event pair
  around 200 of them, which the card runs faster than the host issues),
  and the µs a call ends after its host issue ends (an event pair around
  one such call on an idle card, less its issue).

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
# kernel C's tile of trees in the calibration (and half of it)
C_TILE = 16
# the deep kernel's calibration forests: its own depth range (12-15)
DEEP_DEPTH = 12
DEEP_TREES = (8, 64)
COPY_BYTES = 256 << 20
HOST_CALLS = 200


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
    # the deep kernel (csrc/fold_deep.cu), the same but tiles
    fold_deep_ns: float
    fold_deep_row_ns: float
    fold_deep_floor_ns: float
    fold_deep_floor_us: float
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
    # the host: µs to issue one kernel launch through its wrapper, one plain
    # torch op, and one whole call of the shortest kernel path (two ops and
    # a launch); µs a call ends after its host issue ends
    launch_us: float
    op_us: float
    call_us: float
    latency_us: float

    @staticmethod
    def default() -> "Calibration":
        # measured on an NVIDIA H100 80GB HBM3, 700.00 W power limit, by
        # measure() in the sweep of sweep_results_torch_h100.jsonl (its
        # "calibration" line; python -m tahoe_tpu_torch.perf_model.calibrate
        # prints one)
        return Calibration(
            fold_c_ns=0.0007747303366414949,
            fold_c_row_ns=0.04891099033320878,
            fold_c_floor_ns=29.976897556999965,
            fold_c_floor_us=2.583113632031849,
            fold_c_tile_us=0.30010007321834564,
            fold_deep_ns=0.0014450037166610751,
            fold_deep_row_ns=0.03524192489285835,
            fold_deep_floor_ns=61.29286096741756,
            fold_deep_floor_us=4.4982850551605225,
            rank_fold_ns=0.0008490315464951507,
            rank_fold_bytes_ns=0.0012689058454286456,
            rank_fold_row_ns=0.23866908202783715,
            rank_fold_floor_ns=57.60982333283339,
            rank_fold_floor_us=18.68228571755545,
            sparse_ns=0.001085397337198622,
            sparse_row_ns=0.2332761154308186,
            sparse_floor_ns=76.93749752693942,
            sparse_floor_us=18.184001105172296,
            rank_transform_ns=0.01538858039286704,
            rank_transform_floor_us=12.638400495052338,
            gather_step_ns=0.06086940516070171,
            select_node_ns=0.022444724834258523,
            onehot_node_ns=0.03421363885536266,
            hbm_gbps=2955.8168174908787,
            launch_us=36.34671926498413,
            op_us=9.043786525726318,
            call_us=75.88479995727539,
            latency_us=13.251200765371323,
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
            f"GB/s, launch {self.launch_us:.1f} us, op {self.op_us:.1f} us, "
            f"call {self.call_us:.1f} us"
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
        DEEP_KERNELS, FOLD_KERNELS, FoldKernelEngine, FoldLaunch, deep_blocks,
        deep_launch,
        fold_c_table, fold_deep_cuda, fold_launch, fold_margins_cuda,
        fold_smem_bytes, fold_tables)
    from tahoe_tpu_torch.ops.gather_engine import GatherEngine
    from tahoe_tpu_torch.ops.rank_kernel import (
        RANK_FOLD, rank_margins_cuda, rank_tables)
    from tahoe_tpu_torch.ops.rank_transform import RANK_PLANES, rank_planes_cuda
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.ops.sparse_kernel import (
        SPARSE_RANK, sparse_margins_cuda, sparse_tables)
    from tahoe_tpu_torch.ops.tensor_engine import TensorEngine
    from tahoe_tpu_torch.perf_model.model import (
        blocks_per_sm, rank_b_geometry, sparse_geometry)
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

        def c_launch(i, tile):
            """Kernel C's block of c_rows rows in tiles of ``tile`` trees,
            the same for both forests, so that both wait on tiles."""
            return FoldLaunch(c_rows, tile, fold_smem_bytes(
                width, D, CAL_TREES[i], c_rows, tile))

        fold_c = list(descent(lambda i, n: fold_margins_cuda(
            xs[i][:n], tabs[i], c_table[i], c_launch(i, C_TILE)), c_rows,
            blocks_per_sm(c_launch(1, C_TILE).smem_bytes, c_rows, limits)))
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
        fold_c[2] = max(0.0, fold_c[2] - fold_c_tile_us * 1e3
                        * (tiles[1] - tiles[0]) / ((CAL_TREES[1] - CAL_TREES[0]) * D))
        fold_c[3] = max(0.0, fold_c[3] - fold_c_tile_us * tiles[0])
        del xs, c_table, tabs
        # the deep kernel on forests of its own depth (its tables outgrow
        # L1 as a depth-8 forest's do not)
        deep_forests = [synthetic.generate_forest(t, DEEP_DEPTH, CAL_COLS, seed=5)
                        for t in DEEP_TREES]
        tabs = [fold_tables(f, device=dev) for f in deep_forests]
        xs = [canonicalize_rows(rows_d[:, :CAL_COLS], f.missing, device=dev,
                                col_index=t.col_index, dual=t.form == "dual")
              for f, t in zip(deep_forests, tabs)]
        d_launch = deep_launch(tabs[0].width, limits)
        blocks = [deep_blocks(t) for t in tabs]
        fold_deep = descent(lambda i, n: fold_deep_cuda(
            xs[i][:n], tabs[i], blocks[i], d_launch), d_launch.rows_per_block,
            blocks_per_sm(d_launch.smem_bytes,
                          d_launch.rows_per_block * d_launch.lanes, limits),
            [t * DEEP_DEPTH for t in DEEP_TREES])
        del xs, blocks, tabs

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
        big = forests[1]
        n_g = 8192
        gat = GatherEngine(big, device=dev)
        gather_step_ns = (ms(lambda: gat.margins(rows_d[:n_g, :CAL_COLS]))
                          * 1e6 / (n_g * big.num_trees * D))
        small = synthetic.generate_forest(CAL_TREES[0], 6, CAL_COLS, seed=5)
        lev = compiler.levelize(small)
        n_s = 4096
        nodes = small.num_trees << small.depth
        select = {}
        for mode in ("take", "onehot"):
            eng = TensorEngine(lev, select_mode=mode, device=dev)
            select[mode] = (ms(lambda: eng.margins(rows_d[:n_s, :CAL_COLS]))
                            * 1e6 / (n_s * nodes))
        del gat, eng

        # -- device memory -------------------------------------------------
        src = torch.empty(COPY_BYTES // 4, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        t_copy = cuda_median_ms(lambda: dst.copy_(src), warmup=2, iters=10)
        hbm_gbps = 2 * COPY_BYTES / (t_copy * 1e-3) / 1e9
        del src, dst

        # -- the host ----------------------------------------------------
        tiny = synthetic.generate_forest(1, 1, 2, seed=5)
        tt = fold_tables(tiny, device=dev)
        tx = canonicalize_rows(rows_d[:32, :2], tiny.missing, device=dev,
                               col_index=tt.col_index, dual=tt.form == "dual")
        tl = fold_launch(tt.width, tt.depth, 1, limits)
        tc = fold_c_table(tt)

        def launches():
            for _ in range(HOST_CALLS):
                fold_margins_cuda(tx, tt, tc, tl)

        launch_us = cuda_median_ms(launches, warmup=1, iters=5) * 1e3 / HOST_CALLS
        a = torch.rand(64, 8, device=dev)
        idx = torch.zeros(64, 8, dtype=torch.int64, device=dev)

        def ops():
            for _ in range(HOST_CALLS):
                y = torch.gather(a, 1, idx)
                torch.where(y >= a, y, a)

        op_us = cuda_median_ms(ops, warmup=1, iters=5) * 1e3 / (3 * HOST_CALLS)
        # a whole call of the shortest kernel path: FoldKernelEngine's
        # predict (dual rows: two ops, one launch, no output op)
        teng = FoldKernelEngine(tiny, device=dev)
        trow = rows_d[:32, :2]

        def calls():
            for _ in range(HOST_CALLS):
                teng.predict(trow)

        call_us = cuda_median_ms(calls, warmup=1, iters=5) * 1e3 / HOST_CALLS
        lat = []
        for _ in range(50):
            torch.cuda.synchronize(dev)
            lat.append(cuda_median_ms(lambda: teng.predict(trow), warmup=0,
                                      iters=1))
        latency_us = max(0.0, statistics.median(lat) * 1e3 - call_us)
    for k, c in zip(kernels, counts):
        k.launches = c
    return Calibration(
        fold_c_ns=fold_c[0], fold_c_row_ns=fold_c[1], fold_c_floor_ns=fold_c[2],
        fold_c_floor_us=fold_c[3], fold_c_tile_us=fold_c_tile_us,
        fold_deep_ns=fold_deep[0], fold_deep_row_ns=fold_deep[1],
        fold_deep_floor_ns=fold_deep[2], fold_deep_floor_us=fold_deep[3],
        rank_fold_ns=rank_fold[0], rank_fold_bytes_ns=rank_fold_bytes_ns,
        rank_fold_row_ns=rank_fold[1], rank_fold_floor_ns=rank_fold[2],
        rank_fold_floor_us=rank_fold[3],
        sparse_ns=sparse[0], sparse_row_ns=sparse[1], sparse_floor_ns=sparse[2],
        sparse_floor_us=sparse[3],
        rank_transform_ns=rank_transform_ns,
        rank_transform_floor_us=rank_transform_floor_us,
        gather_step_ns=gather_step_ns, select_node_ns=select["take"],
        onehot_node_ns=select["onehot"], hbm_gbps=hbm_gbps,
        launch_us=launch_us, op_us=op_us, call_us=call_us,
        latency_us=latency_us,
    )


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
