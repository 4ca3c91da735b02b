#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tahoe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. the card's name and power limit;
2. build the CUDA kernels from the checkout (into build/tahoe_tpu_torch/),
   printing ptxas's registers per kernel, kernel B's on a line of its own,
   and holding the registers perf_model/model.py counts to the runtime's
   (cudaFuncGetAttributes);
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the SUSY-class main path (500 trees, depth 8, 18 features, 65,536
   rows, 2% missing), with both median times from CUDA events; kernel A,
   whose call is shorter than the host's time to issue it, by its device
   time (20 calls in a CUDA graph, utils/profiling.cuda_device_ms) here and
   on every path, against torch.searchsorted on the same table in
   alternating rounds; kernel C and the deep kernel both on the SUSY-class
   tables;
4. the main path through the user's entry points: Forest.from_files on the
   reference text formats, then SPLIT_FOREST (on the fold kernel fold_plan
   picks: kernel C's dual form since its redesign) and RANK_MXU (full
   predict and plane-resident) on 65,536 rows, each held to the numpy
   oracle at ORACLE_ATOL; every kernel's launch count over that run must
   be > 0;
5. the same at 4,096 rows on a forest with a finite missing sentinel, early
   leaves and AVG|SIGMOID|THRESHOLD output;
6. wide, the sign form: cup98-class (150 trees, depth 8, 479 columns, 300
   live) through SPLIT_FOREST from Forest.from_files, and svhn-class (200
   trees, depth 6, 100 features), each on fold_plan's kernel (kernel C's
   sign form), both sign-form kernels held to the plain version on each;
7. deep: deep15-class (30 trees, depth 15) in the dual (16 features) and
   the sign form (100 features) through SPLIT_FOREST on the deep kernel,
   which no tile of kernel C holds; then kernel C and the deep kernel at
   deep12-class (100, 12, 28), where fold_plan takes the deep kernel;
8. VMEM_FOREST: stumps-class (800 trees, depth 3, 10 features), the whole
   forest in one shared-memory tile of kernel C, and SPLIT_FOREST, which
   routes it to kernel C's dual form too;
9. DEPTH_BUCKETED: its rank variant on trained_mix-class (300 trees, depths
   6-12, 26 features; kernel A once, kernel B per bucket) and its fold
   variant on two mixed-depth forests of 90 columns (the non-ge form; depths
   5-10 and 9-13), each bucket on the kernel fold_plan picks (kernel C to
   depth 11, the deep kernel's non-ge instance deeper) and both held to the
   plain version per bucket;
10. SPARSE: rf_deep18-class (200 trained trees, depth 18, 24 features),
   which no dense strategy takes, through kernel A and the sparse kernel
   (over its 16-byte slots, ops/sparse_kernel.py sparse_blocks), with the
   records and the slots (each within one 32-byte sector) a descent reads
   per (row, tree); then a
   forest of 1,440 live features, past the rank planes, through the plain
   torch gather tier, which launches no kernel;
11. HBM_DIRECT, ROW_TILED and TENSOR, plain torch and launching no kernel,
   on the SUSY-class forest and on phase 5's forest;
12. the fused rank transform + traversal: RankFoldEngine(fuse_transform=
   True) on the SUSY-class forest and 65,536 rows, the fused kernel held to
   its plain version and bit for bit to kernels A then B, and timed against
   them (both captured in one CUDA graph) by device time in alternating
   rounds; the predictions bit-equal to the unfused engine's and within
   ORACLE_ATOL of the oracle, with only the fused kernel launching;
13. the probes of tahoe_tpu_torch/scripts (int8_cast_probe, overhead_bench,
   unit_bench) in-process, every probe kernel equal to its plain version,
   each printing its JSON line; the int8 probe and torch._int_mm by device
   time; kernel B's walk taken apart on its own launch at 16,384 and 65,536
   rows (noop, paths, stream, dot, descent, each by device time in the
   same alternating rounds as kernel B, with its share of kernel B's time
   and its bound; stream and dot also less the path words' own cost,
   paths - noop), beside kernel B's L1 lines, sectors and shared wavefronts a
   warp-visit reckoned from the walks of 2,048 rows
   (ops/rank_kernel.py rank_wavefronts) and the SM cycles a warp-visit;
14. the CLI protocol (tahoe_tpu_torch/cli.py) in-process on make_fixtures'
   susy_like pair (10,000 rows), with live calibration and 10 timed epochs
   a round: every strategy runs correct or is skipped with a reason, and
   every kernel of the engines that ran launched (counts set to 0 before
   the CLI, read after; the calibration's own launches are not counted);
   one JSON line of the model's pick, the measured best, each strategy's
   us/sample and build seconds. A misprediction is printed, not failed;
15. scripts/bench.py's main in-process (65,536 rows), its JSON line, which
   must hold max_err_vs_oracle <= ORACLE_ATOL;
16. sharded inference (parallel/): on a one-rank NCCL group, mesh (1, 1),
   the sharded fold and rank engines on the SUSY-class forest and the
   sparse one on phase 10's rf_deep18-class forest, 65,536 rows each, bit
   for bit the unsharded engines and within ORACLE_ATOL of the oracle, each
   engine's kernels launched; the host issue and event time of one NCCL
   all_reduce of 65,536 f32; then two ranks on the one card over gloo
   (scripts/run_multiproc.py), meshes (1, 2) and (2, 1), the fold and rank
   engines on SUSY-class: every shard's margins bit-equal to an unsharded
   engine on its trees, every rank's predictions within ORACLE_ATOL, and
   every kernel of a rank's engine launched in that rank (a correctness
   run: two ranks on one card time no multi-GPU figure);
17. the native text loader (forest/native_io.py): the SUSY-class model and
   65,536 x 18 rows written with io.save_model / io.save_data, read through
   the C++ parser and the numpy parser, bit-equal, with both load times;
18. one dispatch a predict (ops/graphed.py: a CUDA graph a shape): every
   engine of phases 4-12 and 16 (the same forests and rows; a sharded
   engine's own engine on its shard), at the phase's rows and at 2,000
   (mnist's sweep rows): its graphed predict, margins and, where it has
   one, predict_planes bit-equal to the un-graphed ``_*_impl``, predict
   within ORACLE_ATOL of the oracle, a repeated call at a shape making no
   new capture and a second shape one more, two results at one shape not
   aliased, a replay counting the eager call's launches, and by the
   profiler (path_time.profile_kernels), on every path of csrc's kernels,
   one replay of its predict running on the card the kernels of csrc one
   eager call runs, as many times, and as many as it counted; printed (not
   failed), one JSON line a path and row count: eager and graphed
   us/sample by CUDA events, the graphed predict's device time, the host's
   issue time of one replay on an idle card and the capture's seconds.
   Then scripts/pair_time.py through the graphed predicts (VMEM_FOREST
   against SPLIT_FOREST on gisette, stumps, ijcnn, mnist, cifar and letter
   at their sweep rows, by event and by device time) and the time of an
   eager launch through a kernel's ctypes wrapper (path_time.py).

Every phase's predicts go through the graph layer, so phases 4-17's launch
counts are those of replays (a capture counts what one eager call does;
phase 18 holds a replay's count against the kernels the card ran).

Phases 6-12 run 65,536 rows each (phase 11's second forest 4,096) against
the numpy oracle at ORACLE_ATOL,
with every kernel count set to 0 just before the path and read just after:
the path must launch exactly the kernels fold_plan (or the strategy) picks.
Every kernel a path runs is held to its plain version on that path's tables
and 65,536 rows, and every path is timed in us/sample with CUDA events,
beside the host's wall time to issue one call on an idle card. Beside
kernel C's time it prints the shared-memory wavefronts per (warp, tree)
reckoned from the walks of 2,048 rows (ops/fold_kernel.py fold_wavefronts)
in its layout and in the two-word layout it replaced.

The line before the last is the kernels' JSON record: each kernel's
launches on its path, its largest error against its plain version, its
time and its plain version's at its own path's shapes, its bound (the
larger of its bytes over 3.35 TB/s and its operations over the card's peak
for their type, counted from that check's inputs) and, where one PyTorch
call computes the same function, that call's time. The last line is
{"ok": true, "device": {...}}. It fails if any module of jax or of the JAX
package (tahoe_tpu) was loaded. Without a CUDA device it exits 2 and prints
no result.
"""
from __future__ import annotations

import contextlib
import io as pyio
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROWS = 65536
EDGE_ROWS = 4096
KERNEL_ATOL = 1e-5  # kernel vs plain version: f64 leaf sums on both sides

# an H100 SXM's published peaks (NVIDIA's data sheet, dense): device memory,
# int8 tensor-core operations, and f32 outside the tensor cores, the rate
# taken here for the kernels' scalar compares and integer steps
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SCALAR_OPS_PER_S = 67e12
# the descent probe's node hash a visit (csrc/probes.cu): a XOR, a
# multiply, a multiply-high, a shift, an AND and an add
DESCENT_HASH_OPS = 6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, *work):
    """(bound_ms, bound_by): the larger of ``moved`` bytes over the memory
    rate and the operations, given as (count, rate) pairs, over their
    rates."""
    mem_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(n / rate for n, rate in work) * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sm_clock_mhz():
    """The card's maximum SM clock in MHz (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return int(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def card_line(torch) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import numpy as np

    from tahoe_tpu_torch import ORACLE_ATOL, Forest, GpuLimits, Output, Strategy
    from tahoe_tpu_torch.forest import io, quantize, synthetic, train
    from tahoe_tpu_torch.forest.sparse import SparseGatherEngine
    from tahoe_tpu_torch.ops import _build
    from tahoe_tpu_torch.ops.bucketed import (
        DepthBucketedFoldEngine, DepthBucketedRankEngine)
    from tahoe_tpu_torch.ops.fold_kernel import (
        DEEP_KERNELS, FOLD, FOLD_DEEP, FOLD_DEEP_NONGE, FOLD_DEEP_SIGN,
        FOLD_KERNELS, FOLD_NONGE, FOLD_SIGN, FoldKernelEngine, deep_blocks,
        deep_launch, fold_c_table, fold_deep_cuda, fold_launch, fold_margins_cuda,
        fold_margins_plain, fold_wavefronts)
    from tahoe_tpu_torch.ops.probes import (
        PROBE_INT8, PROBE_OVERHEAD, PROBE_RANK_PARTS)
    from tahoe_tpu_torch.ops.rank_kernel import (
        RANK_FOLD, RANK_FUSED, RankFoldEngine, rank_margins_cuda,
        rank_margins_fused_cuda, rank_margins_fused_plain, rank_margins_plain,
        rank_row_words, rank_wavefronts)
    from tahoe_tpu_torch.ops.rank_transform import (
        RANK_PLANES, rank_planes_cuda, rank_planes_plain)
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.ops.sparse_kernel import (
        SPARSE_RANK, SparseRankEngine, record_depths, sparse_block_walk,
        sparse_leaves_plain, sparse_margins_cuda, sparse_margins_plain)
    from tahoe_tpu_torch import cli
    from tahoe_tpu_torch.engine import autotune
    from tahoe_tpu_torch.scripts import (
        bench, int8_cast_probe, make_fixtures, overhead_bench, unit_bench)
    from tahoe_tpu_torch.utils.profiling import (
        alternating, cuda_device_ms, cuda_median_ms)
    from tahoe_tpu_torch.perf_model.model import KERNEL_REGISTERS
    from tahoe_tpu_torch.ops import oracle

    dev = torch.device("cuda", 0)
    # the main path's kernels: RANK_MXU's kernels A and B, and the fold
    # kernel fold_plan picks for SPLIT_FOREST on the SUSY-class forest
    # (phase 3 adds it)
    kernels = {"rank_transform": RANK_PLANES, "rank_fold": RANK_FOLD}
    all_kernels = {**kernels, "fold_deep": FOLD_DEEP, "fold": FOLD,
                   "fold_sign": FOLD_SIGN, "fold_nonge": FOLD_NONGE,
                   "fold_deep_sign": FOLD_DEEP_SIGN,
                   "fold_deep_nonge": FOLD_DEEP_NONGE,
                   "sparse_rank": SPARSE_RANK, "rank_fused": RANK_FUSED,
                   "probe_int8": PROBE_INT8, "probe_overhead": PROBE_OVERHEAD,
                   "probe_rank_parts": PROBE_RANK_PARTS}

    # -- 1. device --------------------------------------------------------
    card = card_line(torch)
    print(card)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), {GpuLimits.for_device(dev)}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[2] built {lib.name} in {time.perf_counter() - t0:.1f} s")
    entry, kernel_b_regs = "", []
    for line in open(str(lib) + ".log"):
        if "Used" in line or "Compiling entry" in line:
            print("    ptxas:", line.strip().split("ptxas info    : ")[-1])
        if "Compiling entry" in line:
            entry = line
        elif "Used" in line and "rank_fold_kernel" in entry:
            kernel_b_regs.append(line.split("Used")[1].split("registers")[0].strip())
    if not kernel_b_regs:
        fail("no ptxas report for kernel B (rank_fold_kernel) in the build log")
    print(f"[2] kernel B (rank_fold_kernel, pair and byte stagings): "
          f"{' / '.join(kernel_b_regs)} registers")
    # the registers the performance model counts, against the runtime's
    regs = {key: _build.registers(*key) for key in KERNEL_REGISTERS}
    drift = {key: (KERNEL_REGISTERS[key], got) for key, got in regs.items()
             if got != KERNEL_REGISTERS[key]}
    if drift:
        fail(f"[2] registers a thread drifted from perf_model/model.py "
             f"KERNEL_REGISTERS ((model, cudaFuncGetAttributes)): {drift}")
    print(f"[2] registers a thread of the {len(regs)} kernel instances the model "
          f"prices agree with cudaFuncGetAttributes: "
          + ", ".join(f"{k[0][6:-10]}{list(k[1:])} {v}" for k, v in regs.items()))

    # -- 3. kernels vs plain versions at SUSY shapes -----------------------
    forest = synthetic.susy_class_forest(seed=0)
    data = synthetic.generate_data(ROWS, 18, missing_prob=0.02, seed=1)
    record = {}
    # phase 18's engines: (label, engine, its graphed methods, rows, spec,
    # the oracle's predictions of the rows or None, timed calls)
    dispatch = []
    BOTH = ("predict", "margins")

    # the bounds: bytes each input read once and each output written once;
    # operations as the inputs need them (a descent's visited nodes)
    def search_steps(counts):
        """Binary-search steps of one row over every feature's table."""
        return int(torch.ceil(torch.log2(counts.double() + 1)).sum())

    def rank_a_cost(x, thr, counts):
        out = x.shape[0] * 128 * -(-x.shape[1] // 30)
        return bound(nbytes(x, thr, counts) + out,
                     (x.shape[0] * search_steps(counts), SCALAR_OPS_PER_S))

    def descent_ops(rows, records, depth):
        """A visited node's closed-form diff (two multiply-adds), the compare
        and the step; an add per leaf."""
        trees = records.shape[0]
        return 4 * rows * trees * depth + rows * trees

    def rank_b_cost(planes, records, leaf, depth):
        return bound(nbytes(planes, records, leaf) + 4 * planes.shape[0],
                     (descent_ops(planes.shape[0], records, depth), SCALAR_OPS_PER_S))

    def fold_cost(x, t, *tables):
        """A compare per visited node (D a (row, tree) on the leveled
        forest) and an add per leaf; the bytes of the rows, the tables the
        kernel reads (the deep kernel's blocks and leaves, kernel C's
        table) and the margins."""
        rows, trees = x.shape[0], t.leaf.shape[0]
        return bound(nbytes(x, *(tables or (t.thresholds, t.fids, t.leaf)))
                     + 4 * rows,
                     (rows * trees * (t.depth + 1), SCALAR_OPS_PER_S))

    def wavefronts(x, t, launch):
        """Kernel C's shared-memory wavefronts per (warp, tree), reckoned
        from the walks of the first 2,048 rows: this layout (16-byte node
        blocks) and the two-word layout it replaced (a threshold and a code
        load a level), both with rows at an odd stride."""
        w = fold_wavefronts(x[:2048], t, launch.rows_per_block)["total_per_warp_tree"]
        return (f"{w['row_major_blocks']:.3f} wavefronts per (warp, tree) "
                f"(two words a node: {w['row_major_words']:.3f})")

    rank = RankFoldEngine(forest, device=dev)
    rt = rank.tables
    x = canonicalize_rows(data, forest.missing, device=dev,
                          col_index=rt.col_index)
    a_k = rank_planes_cuda(x, rt.thresholds, rt.counts)
    a_p = rank_planes_plain(x, rt.thresholds, rt.counts)
    a_err = int((a_k.int() - a_p.int()).abs().max())
    if a_k.shape != (ROWS, 128 * rt.groups) or a_err != 0:
        fail(f"rank transform kernel differs from its plain version "
             f"(max |diff| {a_err}, shape {tuple(a_k.shape)})")
    xt = x.t().contiguous()
    # kernel A and the ranks alone by one library call (no plane assembly),
    # on the same [F, K] table, in alternating rounds of device time: an
    # event pair around a call this short also times the host's issue
    a_times = alternating({
        "kernel A": lambda: rank_planes_cuda(x, rt.thresholds, rt.counts),
        "torch.searchsorted": lambda: torch.searchsorted(rt.thresholds, xt,
                                                         right=True)})
    for name, (med, rounds) in a_times.items():
        print(f"[3] {name} on {tuple(x.shape)} rows, [{rt.thresholds.shape[0]}, "
              f"{rt.thresholds.shape[1]}] table: device time median {med:.4f} ms, "
              f"rounds {', '.join(f'{r:.4f}' for r in rounds)} ({card})")
    print(f"[3] kernel A / torch.searchsorted: "
          f"{a_times['kernel A'][0] / a_times['torch.searchsorted'][0]:.4f}")
    record["rank_transform"] = [(
        "3", a_err, a_times["kernel A"][0],
        cuda_median_ms(lambda: rank_planes_plain(x, rt.thresholds, rt.counts),
                       warmup=1, iters=5),
        *rank_a_cost(x, rt.thresholds, rt.counts),
        a_times["torch.searchsorted"][0])]

    b_k = rank_margins_cuda(a_p, rt.records, rt.leaf, rt.depth)
    b_p = rank_margins_plain(a_p, rt.mats, rt.leaf, rt.depth)
    b_err = float((b_k - b_p).abs().max())
    if not (torch.isfinite(b_k).all() and b_err <= KERNEL_ATOL):
        fail(f"rank fold kernel differs from its plain version by {b_err}")
    record["rank_fold"] = [(
        "3", b_err,
        cuda_median_ms(lambda: rank_margins_cuda(a_p, rt.records, rt.leaf, rt.depth)),
        cuda_median_ms(lambda: rank_margins_plain(a_p, rt.mats, rt.leaf, rt.depth),
                       warmup=1, iters=5),
        *rank_b_cost(a_p, rt.records, rt.leaf, rt.depth), None)]

    # SPLIT_FOREST on the main path takes the fold kernel fold_plan picks;
    # the other one is held on the same tables
    fold = FoldKernelEngine(forest, device=dev)
    fold_name = next(n for n, k in all_kernels.items() if k is fold.kernel)
    if fold_name not in ("fold", "fold_deep"):
        fail(f"[3] SUSY-class SPLIT_FOREST runs {fold.kernel.symbol}, not a "
             f"dual-form fold kernel")
    kernels[fold_name] = fold.kernel
    ft = fold.tables
    x2 = fold.canonicalize(data)
    limits = GpuLimits.for_device(dev)
    c_launch = (fold.launch if fold.c_table is not None
                else fold_launch(ft.width, ft.depth, fold.num_trees, limits))
    c_table = fold.c_table if fold.c_table is not None else fold_c_table(ft)
    d_launch = (fold.launch if fold.blocks is not None
                else deep_launch(ft.width, limits))
    blocks = fold.blocks if fold.blocks is not None else deep_blocks(ft)
    c_p = fold_margins_plain(x2, ft)
    p_ms = cuda_median_ms(lambda: fold_margins_plain(x2, ft), warmup=1, iters=5)
    for name, fn, tables in (
            ("fold_deep", lambda: fold_deep_cuda(x2, ft, blocks, d_launch),
             (blocks, ft.leaf)),
            ("fold", lambda: fold_margins_cuda(x2, ft, c_table, c_launch),
             (c_table,))):
        c_k = fn()
        c_err = float((c_k - c_p).abs().max())
        if not (torch.isfinite(c_k).all() and c_err <= KERNEL_ATOL):
            fail(f"{name} kernel differs from its plain version by {c_err}")
        record[name] = [("3", c_err, cuda_median_ms(fn), p_ms,
                         *fold_cost(x2, ft, *tables), None)]
    print(f"[3] SPLIT_FOREST takes {fold.kernel.symbol}; deep kernel {d_launch}, "
          f"kernel C {c_launch}")
    tolerance = {"rank_transform": 0, "rank_fold": KERNEL_ATOL, "fold": KERNEL_ATOL,
                 "fold_deep": KERNEL_ATOL}
    for name, [(_, err, ms, plain_ms, b_ms, b_by, lib_ms)] in record.items():
        print(f"[3] {name}: max |kernel - plain| {err} (tolerance "
              f"{tolerance[name]}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), library {lib_ms} ms ({card})")
    del a_k, a_p, b_k, b_p, c_k, c_p, x, xt, x2, rank, fold, c_table, blocks

    # -- 4. main path through the facade ------------------------------------
    def drive(spec, rows_np, missing, tag, timed, **out_kw):
        with tempfile.TemporaryDirectory() as tmp:
            model_path = os.path.join(tmp, "model.txt")
            data_path = os.path.join(tmp, "data.txt")
            io.save_model(model_path, spec)
            io.save_data(data_path, rows_np, missing)
            f = Forest.from_files(model_path, data_path, device="cuda", **out_kw)
            rows, _ = io.load_data(data_path)
        want = f.predict_oracle(rows)
        rows_d = torch.as_tensor(rows, device=dev)
        for k in kernels.values():
            k.launches = 0
        eng = f.engine(Strategy.RANK_MXU)
        outs = {
            "SPLIT_FOREST": f.predict(rows_d, Strategy.SPLIT_FOREST),
            "RANK_MXU": f.predict(rows_d, Strategy.RANK_MXU),
        }
        planes = eng.transform(rows_d)
        outs["RANK_MXU planes"] = eng.predict_planes(planes)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        if min(launches.values()) < 1:
            fail(f"{tag}: a kernel was not launched on the main path: {launches}")
        dispatch.append((f"{tag} SPLIT_FOREST", f.engine(Strategy.SPLIT_FOREST),
                         BOTH, rows, f.spec, want, 20))
        dispatch.append((f"{tag} RANK_MXU", eng, BOTH + ("predict_planes",), rows,
                         f.spec, want, 20))
        # the planes against the numpy reference transform, on a slice
        n_ref = min(len(rows), 4096)
        xr = rows[:n_ref]
        if eng.tables.col_index is not None:
            xr = xr[:, eng.tables.col_index.cpu().numpy()]
        ref = quantize.encode_rank_planes_np(quantize.transform_rows_np(eng.q, xr))
        if not np.array_equal(planes[:n_ref].cpu().numpy(), ref):
            fail(f"{tag}: planes differ from the numpy reference transform")
        for name, pred in outs.items():
            got = pred.cpu().numpy()
            if got.shape != want.shape or not np.isfinite(got).all():
                fail(f"{tag} {name}: shape {got.shape} or non-finite output")
            err = float(np.abs(got - want).max())
            if err > ORACLE_ATOL:
                fail(f"{tag} {name}: max |pred - oracle| {err} > {ORACLE_ATOL}")
            line = f"[{tag}] {name}: max |pred - oracle| {err} (tolerance {ORACLE_ATOL})"
            if timed:
                if name == "RANK_MXU planes":
                    fn = lambda: eng.predict_planes(planes)  # noqa: E731
                else:
                    fn = lambda s=Strategy[name]: f.predict(rows_d, s)  # noqa: E731
                us = cuda_median_ms(fn) * 1e3 / len(rows)
                line += f", {us:.6f} us/sample over {len(rows)} rows ({card})"
            print(line)
        print(f"[{tag}] launches on the main path: {launches}")
        return want, launches

    susy_want, launches = drive(forest, data, float("nan"), "4", True)

    # -- 5. finite sentinel, early leaves, AVG|SIGMOID|THRESHOLD -------------
    out_flags = int(Output.AVG | Output.SIGMOID | Output.THRESHOLD)
    edge = synthetic.generate_forest(500, 8, 18, leaf_prob=0.05, missing=-999.0,
                                     output=out_flags, global_bias=0.01, seed=2)
    edge_data = synthetic.generate_data(EDGE_ROWS, 18, missing=-999.0,
                                        missing_prob=0.02, seed=3)
    want, _ = drive(edge, edge_data, -999.0, "5", False, output=out_flags,
                    global_bias=0.01, threshold=0.5)
    if not 0 < want.mean() < 1:
        fail("[5] the thresholded oracle output is constant: no check made")

    # -- 6-9: the other fold paths ------------------------------------------
    def run_path(tag, f, strategy, rows_np, want, expected, iters=20):
        """One predict through the facade with every count set to 0 before
        it; exactly the ``expected`` kernels must launch. Then the output
        against the oracle, and its time."""
        rows_d = torch.as_tensor(rows_np, device=dev)
        for k in all_kernels.values():
            k.launches = 0
        pred = f.predict(rows_d, strategy)
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in all_kernels.items()}
        if {n for n, c in counts.items() if c} != set(expected):
            fail(f"[{tag}] {strategy.name} launched {counts}, expected "
                 f"exactly {sorted(expected)}")
        got = pred.cpu().numpy()
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"[{tag}] {strategy.name}: shape {got.shape} or non-finite output")
        err = float(np.abs(got - want).max())
        if err > ORACLE_ATOL:
            fail(f"[{tag}] {strategy.name}: max |pred - oracle| {err} > {ORACLE_ATOL}")
        dispatch.append((f"{tag} {f.spec.num_trees} trees, depth {f.spec.depth}, "
                         f"{f.spec.num_cols} columns: {strategy.name}",
                         f.engine(strategy), BOTH, rows_np, f.spec, want, iters))
        ms = cuda_median_ms(lambda: f.predict(rows_d, strategy), iters=iters)
        print(f"[{tag}] {strategy.name}: max |pred - oracle| {err} (tolerance "
              f"{ORACLE_ATOL}), {ms * 1e3 / len(rows_np):.6f} us/sample over "
              f"{len(rows_np)} rows ({ms:.4f} ms a call; the host issues one "
              f"in {host_ms(lambda: f.predict(rows_d, strategy), iters):.4f} "
              f"ms), launches {counts} ({card})")
        return counts

    def host_ms(fn, iters):
        """Median host wall time to issue ``fn()`` on an idle card (a
        synchronize before each call, none after): where it passes the
        call's CUDA-event time, the path waits on the host."""
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    def hold(tag, kernel_fns, plain_fn, costs, atol=KERNEL_ATOL,
             timer=cuda_median_ms, notes=None):
        """Kernels against their plain version on the same inputs, the plain
        output computed once; each kernel's check (its error and time by
        ``timer``, the plain version's, and its bound from ``costs``) joins
        the kernel's record, printed with its ``notes``. No library call
        computes these functions."""
        p_out = plain_fn()
        plain_ms = cuda_median_ms(plain_fn, warmup=1, iters=3)
        for name, fn in kernel_fns.items():
            k_out = fn()
            err = float((k_out.double() - p_out.double()).abs().max())
            if not (k_out.shape == p_out.shape and torch.isfinite(k_out).all()
                    and err <= atol):
                fail(f"[{tag}] {name} differs from its plain version by {err}")
            ms = timer(fn)
            b_ms, b_by = costs[name]
            record.setdefault(name, []).append(
                (tag, err, ms, plain_ms, b_ms, b_by, None))
            note = f"; {notes[name]}" if notes and name in notes else ""
            print(f"[{tag}] {name}: max |kernel - plain| {err} (tolerance "
                  f"{atol}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}){note} ({card})")

    def descent_reads(st, planes):
        """What a descent reads per (row, tree), [R, T] each: the records of
        a walk one node a step (the plain version's), and
        the sparse kernel's slots, each within one 32-byte sector."""
        leaves = sparse_leaves_plain(planes, st.records, st.roots, st.max_depth)
        records = record_depths(st.records, st.max_depth)[leaves] + 1
        slots = sparse_block_walk(planes, st.slots, st.roots.shape[0], st.steps)[1]
        return records, slots

    def lane_share(reads, trees):
        """The share of a warp's lane-steps that read: a warp (32 rows) steps
        over each group of ``trees`` trees as long as its longest descent."""
        R, T = reads.shape
        padded = torch.nn.functional.pad(reads, (0, -T % trees, 0, -R % 32))
        steps = padded.view(-1, 32, padded.shape[1] // trees, trees).amax(dim=(1, 3))
        return float(reads.sum()) / float(steps.sum() * 32 * trees)

    def claim(names, counts):
        """The first path that launches a kernel gives its launches, and its
        check on that path (the kernel's last) goes first in its record."""
        for n in names:
            if n not in launches:
                launches[n] = counts[n]
                record[n].insert(0, record[n].pop())

    def name_of(kernel):
        return next(n for n, k in all_kernels.items() if k is kernel)

    def both_folds(tag, eng, x, note=True):
        """Kernel C and the deep kernel in the tables' form, each in the block
        fold_plan gives it where it takes the forest, else in its own, held
        to the plain version; their names, C's first."""
        t = eng.tables
        c_launch = (eng.launch if eng.c_table is not None else fold_launch(
            t.width, t.depth, eng.num_trees, limits))
        d_launch = (eng.launch if eng.blocks is not None
                    else deep_launch(t.width, limits))
        blocks = eng.blocks if eng.blocks is not None else deep_blocks(t)
        c_name, d_name = name_of(FOLD_KERNELS[t.form]), name_of(DEEP_KERNELS[t.form])
        fns = {d_name: lambda: fold_deep_cuda(x, t, blocks, d_launch)}
        costs = {d_name: fold_cost(x, t, blocks, t.leaf)}
        notes = {}
        print(f"[{tag}] {eng.num_trees} trees, depth {t.depth}, {t.num_cols} live "
              f"features ({t.form}): kernel C {c_launch}, deep kernel {d_launch}; "
              f"the route takes {eng.kernel.symbol}")
        if c_launch is not None:
            table = eng.c_table if eng.c_table is not None else fold_c_table(t)
            fns = {c_name: lambda: fold_margins_cuda(x, t, table, c_launch), **fns}
            costs[c_name] = fold_cost(x, t, table)
            if note:
                notes[c_name] = wavefronts(x, t, c_launch)
        hold(tag, fns, lambda: fold_margins_plain(x, t), costs, notes=notes)

    # 6. the sign form: cup98-class and svhn-class, each on fold_plan's
    # kernel, both kernels held to the plain version
    wide = synthetic.generate_forest(150, 8, 479, active_cols=300, seed=1)
    wide_rows = synthetic.generate_data(ROWS, 479, missing_prob=0.02, seed=4)
    with tempfile.TemporaryDirectory() as tmp:
        # the data file's header gives num_cols and the sentinel; 1,024 rows
        # keep the text file small, and round-trip exactly
        model_path = os.path.join(tmp, "model.txt")
        data_path = os.path.join(tmp, "data.txt")
        io.save_model(model_path, wide)
        io.save_data(data_path, wide_rows[:1024], float("nan"))
        f = Forest.from_files(model_path, data_path, device="cuda")
        head, _ = io.load_data(data_path)
    if not np.array_equal(head, wide_rows[:1024], equal_nan=True):
        fail("[6] the data file does not round-trip")
    shallow = synthetic.generate_forest(200, 6, 100, seed=1)
    shallow_rows = synthetic.generate_data(ROWS, 100, missing_prob=0.02, seed=10)
    for f, rows_np in ((f, wide_rows),
                       (Forest(shallow, device="cuda"), shallow_rows)):
        eng = f.engine(Strategy.SPLIT_FOREST)
        if eng.form != "sign":
            fail(f"[6] {f.spec.num_trees} trees take the {eng.form} form, not sign")
        x = eng.canonicalize(torch.as_tensor(rows_np, device=dev))
        both_folds("6", eng, x)
        own = name_of(eng.kernel)
        claim([own], run_path("6", f, Strategy.SPLIT_FOREST, rows_np,
                              f.predict_oracle(rows_np), {own}))
        del f, eng, x

    # 7. deep15-class in the dual and the sign form, which no tile of kernel
    # C holds, on the deep kernel; both kernels at deep12-class
    for cols, seed in ((16, 5), (100, 14)):
        deep = synthetic.generate_forest(30, 15, cols, seed=1)
        deep_rows = synthetic.generate_data(ROWS, cols, missing_prob=0.02, seed=seed)
        f = Forest(deep, device="cuda")
        eng = f.engine(Strategy.SPLIT_FOREST)
        if eng.blocks is None:
            fail(f"[7] deep15-class runs {eng.kernel.symbol}, not the deep kernel")
        x = eng.canonicalize(torch.as_tensor(deep_rows, device=dev))
        both_folds("7", eng, x)
        own = name_of(eng.kernel)
        claim([own], run_path("7", f, Strategy.SPLIT_FOREST, deep_rows,
                              f.predict_oracle(deep_rows), {own}))
        del f, eng, x

    d12_spec = synthetic.generate_forest(100, 12, 28, seed=1)
    d12 = FoldKernelEngine(d12_spec, device=dev)
    d12_rows = synthetic.generate_data(ROWS, 28, missing_prob=0.01, seed=6)
    x = d12.canonicalize(torch.as_tensor(d12_rows, device=dev))
    both_folds("7", d12, x, note=False)
    dispatch.append(("7 100 trees, depth 12, 28 columns: FoldKernelEngine", d12,
                     BOTH, d12_rows, d12_spec, None, 20))
    del d12, x

    # 8. VMEM_FOREST, stumps-class: the whole forest in one tile
    stumps = synthetic.generate_forest(800, 3, 10, seed=1)
    stump_rows = synthetic.generate_data(ROWS, 10, missing_prob=0.05, seed=7)
    f = Forest(stumps, device="cuda")
    eng = f.engine(Strategy.VMEM_FOREST)
    if eng.kernel is not FOLD or eng.launch.tile_trees != 800:
        fail(f"[8] VMEM_FOREST runs {eng.kernel.symbol} with {eng.launch}")
    print(f"[8] {eng.launch}; SPLIT_FOREST {f.engine(Strategy.SPLIT_FOREST).launch}")
    x = eng.canonicalize(torch.as_tensor(stump_rows, device=dev))
    both_folds("8", eng, x)
    want = f.predict_oracle(stump_rows)
    run_path("8", f, Strategy.VMEM_FOREST, stump_rows, want, {"fold"})
    split = name_of(f.engine(Strategy.SPLIT_FOREST).kernel)
    claim(["fold"], run_path("8", f, Strategy.SPLIT_FOREST, stump_rows, want,
                             {split}))
    del f, eng, x

    # 9. DEPTH_BUCKETED: rank variant, then the fold variant in non-ge form
    mix = synthetic.generate_mixed_depth_forest(300, 12, 26, seed=1)
    mix_rows = synthetic.generate_data(ROWS, 26, missing_prob=0.01, seed=8)
    f = Forest(mix, device="cuda")
    eng = f.engine(Strategy.DEPTH_BUCKETED)
    if not isinstance(eng, DepthBucketedRankEngine):
        fail(f"[9] trained_mix-class takes {type(eng).__name__}, not the rank variant")
    print(f"[9] rank variant buckets (trees, depth): {eng.bucket_plan}")
    # the one transform every bucket shares, then kernel B per bucket
    rt = eng.sub[0].tables
    x = canonicalize_rows(mix_rows, eng.sub[0].raw_missing, device=dev,
                          col_index=rt.col_index)
    hold("9", {"rank_transform": lambda: rank_planes_cuda(x, rt.thresholds,
                                                          rt.counts)},
         lambda: rank_planes_plain(x, rt.thresholds, rt.counts),
         {"rank_transform": rank_a_cost(x, rt.thresholds, rt.counts)}, atol=0,
         timer=cuda_device_ms)
    planes = rank_planes_plain(x, rt.thresholds, rt.counts)
    for e in eng.sub:
        bt = e.tables
        print(f"[9] bucket of {e.num_trees} trees at depth {bt.depth}")
        hold("9", {"rank_fold": lambda bt=bt: rank_margins_cuda(
            planes, bt.records, bt.leaf, bt.depth)},
            lambda bt=bt: rank_margins_plain(planes, bt.mats, bt.leaf, bt.depth),
            {"rank_fold": rank_b_cost(planes, bt.records, bt.leaf, bt.depth)})
    want = f.predict_oracle(mix_rows)
    run_path("9", f, Strategy.DEPTH_BUCKETED, mix_rows, want,
             {"rank_transform", "rank_fold"})
    run_path("9", f, Strategy.RANK_MXU, mix_rows, want,
             {"rank_transform", "rank_fold"})
    del f, eng, x, planes

    # the fold variant on mixed-depth forests of 90 columns (the non-ge
    # form), each bucket on the kernel fold_plan picks; the deeper forest's
    # deepest buckets take the deep kernel
    def nonge_path(forest, rows_np):
        f = Forest(forest, device="cuda")
        eng = f.engine(Strategy.DEPTH_BUCKETED)
        if not (isinstance(eng, DepthBucketedFoldEngine)
                and all(e.form == "nonge" for e in eng.sub)):
            fail(f"[9] the 90-column forest takes {type(eng).__name__}, not the "
                 f"non-ge fold variant")
        picked = {n for n, k in all_kernels.items()
                  if any(e.kernel is k for e in eng.sub)}
        print(f"[9] fold variant buckets (trees, depth): {eng.bucket_plan}, "
              f"kernels {[e.kernel.symbol for e in eng.sub]}, launches "
              f"{[e.launch for e in eng.sub]}")
        x = eng.sub[0].canonicalize(torch.as_tensor(rows_np, device=dev))
        held = {n: len(record.get(n, [])) for n in ("fold_nonge", "fold_deep_nonge")}
        own = {n: [] for n in held}
        for e in eng.sub:
            both_folds("9", e, x)
            for n in held:
                own[n].append(e.kernel is all_kernels[n])
        # the buckets are timed one at a time: one check sums those the
        # kernel takes on this path (every one it was held on, if none)
        for n, before in held.items():
            checks = record[n][before:]
            if not checks:  # no tile of kernel C holds a bucket's tree
                continue
            del record[n][before:]
            if len(checks) == len(own[n]) and any(own[n]):
                checks = [c for c, o in zip(checks, own[n]) if o]
            record[n].append(("9", max(c[1] for c in checks), sum(c[2] for c in checks),
                              sum(c[3] for c in checks), sum(c[4] for c in checks),
                              max(checks, key=lambda c: c[4])[5], None))
        claim(picked, run_path("9", f, Strategy.DEPTH_BUCKETED, rows_np,
                               f.predict_oracle(rows_np), picked))

    nonge_path(synthetic.generate_mixed_depth_forest(120, 10, 90, seed=1),
               synthetic.generate_data(ROWS, 90, missing_prob=0.02, seed=9))
    nonge_path(synthetic.generate_mixed_depth_forest(60, 13, 90, seed=2),
               synthetic.generate_data(ROWS, 90, missing_prob=0.02, seed=13))

    # 10. SPARSE: rf_deep18-class (scripts/run_sweep.py rf_deep18_like),
    # then the gather tier past the rank planes
    t0 = time.perf_counter()
    deep18 = train.train_forest(200, 18, 24, rows=2048, seed=1)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    f = Forest(deep18, device="cuda")
    reason = f.feasible(Strategy.SPLIT_FOREST)
    if reason is None or "depth 15" not in reason:
        fail(f"[10] SPLIT_FOREST on depth {f.spec.depth}: {reason!r}, not the depth cap")
    eng = f.engine(Strategy.SPARSE)
    if not isinstance(eng, SparseRankEngine):
        fail(f"[10] rf_deep18-class takes {type(eng).__name__}, not SparseRankEngine")
    t_tables = time.perf_counter() - t0
    st = eng.tables
    leaves = int((st.records[:, 2] < 0).sum())
    print(f"[10] rf_deep18-class: {f.spec.num_trees} trees, depth {f.spec.depth}, "
          f"pool of {st.records.shape[0]} nodes ({st.records.shape[0] - leaves} "
          f"internal), {st.groups} plane group(s), {st.q.max_ranks} thresholds "
          f"at most per feature; trained in {t_train:.1f} s, Forest and SPARSE "
          f"tables built in {t_tables:.1f} s (host)")
    print(f"[10] SPLIT_FOREST: {reason}")
    deep_rows = synthetic.generate_data(ROWS, 24, missing_prob=0.02, seed=11)
    x = canonicalize_rows(deep_rows, eng.raw_missing, device=dev,
                          col_index=st.col_index)
    hold("10", {"rank_transform": lambda: rank_planes_cuda(x, st.thresholds,
                                                           st.counts)},
         lambda: rank_planes_plain(x, st.thresholds, st.counts),
         {"rank_transform": rank_a_cost(x, st.thresholds, st.counts)}, atol=0,
         timer=cuda_device_ms)
    planes = rank_planes_plain(x, st.thresholds, st.counts)
    reads, slot_reads = descent_reads(st, planes)
    # a visited node: its closed-form diff (two multiply-adds), the compare
    # and the child step; an add per leaf. The bytes: the planes, the slots
    # and the margins
    sparse_bound = bound(nbytes(planes, st.slots) + 4 * ROWS,
                         (4 * int(reads.sum()) + reads.numel(), SCALAR_OPS_PER_S))
    T = st.roots.shape[0]
    hold("10", {"sparse_rank": lambda: sparse_margins_cuda(planes, st.slots, T,
                                                           st.steps)},
        lambda: sparse_margins_plain(planes, st.records, st.roots, st.max_depth),
        {"sparse_rank": sparse_bound})
    sparse_ms = record["sparse_rank"][0][2]
    sectors = int(slot_reads.sum())  # a slot of 32 bytes or less: one sector
    print(f"[10] {st.slots.shape[0]} slots of {st.slots.shape[1]} words, "
          f"{st.steps} at most a descent. Per (row, tree) a node-a-step descent "
          f"reads {float(reads.double().mean()):.3f} records ({int(reads.max())} "
          f"at most), the sparse kernel {float(slot_reads.double().mean()):.3f} "
          f"32-byte sectors ({int(slot_reads.max())} at most; {sectors * 32 / 1e9:.3f} "
          f"GB of sectors, {sectors * 32 / sparse_ms / 1e9:.3f} TB/s over the "
          f"kernel's {sparse_ms:.4f} ms); {lane_share(slot_reads, 8):.4f} of a "
          f"warp's lane-steps read a slot (8 trees in flight; records, 4 trees: "
          f"{lane_share(reads, 4):.4f})")
    t0 = time.perf_counter()
    want = f.predict_oracle(deep_rows)
    print(f"[10] numpy oracle in {time.perf_counter() - t0:.1f} s (host)")
    counts = run_path("10", f, Strategy.SPARSE, deep_rows, want,
                      {"rank_transform", "sparse_rank"})
    launches["sparse_rank"] = counts["sparse_rank"]
    deep18_want = want  # phase 16 shards this forest again
    del f, eng, st, x, planes

    wide = synthetic.generate_forest(40, 6, 3 * 480, seed=23)
    wide_rows = synthetic.generate_data(ROWS, 3 * 480, missing_prob=0.02, seed=12)
    f = Forest(wide, device="cuda")
    reason = SparseRankEngine.feasible(f.spec)
    if reason is None or not isinstance(f.engine(Strategy.SPARSE),
                                        SparseGatherEngine):
        fail("[10] the 1,440-feature forest does not take the gather tier")
    print(f"[10] 1,440 live features: {reason}; SPARSE takes SparseGatherEngine")
    run_path("10", f, Strategy.SPARSE, wide_rows, f.predict_oracle(wide_rows),
             set(), iters=5)
    del f, wide_rows

    # 11. the plain torch strategies, no kernel
    for spec, rows_np in ((forest, data), (edge, edge_data)):
        f = Forest(spec, device="cuda")
        want = f.predict_oracle(rows_np)
        for s in (Strategy.HBM_DIRECT, Strategy.ROW_TILED, Strategy.TENSOR):
            run_path("11", f, s, rows_np, want, set(), iters=5)
        del f

    # 12. the fused rank transform + traversal on SUSY-class rows
    fused = RankFoldEngine(forest, device=dev, fuse_transform=True)
    if not fused.fused:
        fail("[12] RankFoldEngine(fuse_transform=True) is not fused on the "
             "SUSY-class forest")
    ft = fused.tables
    x = ft.rows(data, fused.raw_missing)
    steps = search_steps(ft.counts)
    # the least work of the function: kernel B's records, not its columns
    fused_bound = bound(nbytes(x, ft.thresholds, ft.counts, ft.records, ft.leaf)
                        + 4 * ROWS,
                        (descent_ops(ROWS, ft.records, ft.depth), SCALAR_OPS_PER_S),
                        (ROWS * steps, SCALAR_OPS_PER_S))

    def fused_kernel():
        return rank_margins_fused_cuda(x, ft.thresholds, ft.counts,
                                       ft.fused_records, ft.leaf, ft.depth)

    def a_then_b():
        return rank_margins_cuda(rank_planes_cuda(x, ft.thresholds, ft.counts),
                                 ft.records, ft.leaf, ft.depth)

    hold("12", {"rank_fused": fused_kernel},
         lambda: rank_margins_fused_plain(x, ft.thresholds, ft.counts, ft.mats,
                                          ft.leaf, ft.depth),
         {"rank_fused": fused_bound}, timer=cuda_device_ms)
    two = a_then_b()
    if not torch.equal(fused_kernel(), two):
        fail("[12] the fused kernel is not bit-equal to kernels A then B")
    # the fused kernel against kernels A and B captured together, in
    # alternating rounds of device time
    ab_times = alternating({"fused": fused_kernel, "A + B": a_then_b})
    for name, (med, rounds) in ab_times.items():
        print(f"[12] {name}: device time median {med:.4f} ms, rounds "
              f"{', '.join(f'{r:.4f}' for r in rounds)} ({card})")
    print(f"[12] fused / (A + B): "
          f"{ab_times['fused'][0] / ab_times['A + B'][0]:.4f} ({card})")
    rows_d = torch.as_tensor(data, device=dev)
    unfused = RankFoldEngine(forest, device=dev)
    for k in all_kernels.values():
        k.launches = 0
    pred = fused.predict(rows_d)
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in all_kernels.items()}
    if {n for n, c in counts.items() if c} != {"rank_fused"}:
        fail(f"[12] the fused path launched {counts}, expected only rank_fused")
    launches["rank_fused"] = counts["rank_fused"]
    dispatch.append(("12 RANK_MXU fused", fused, BOTH, data, forest, susy_want, 20))
    if not torch.equal(pred, unfused.predict(rows_d)):
        fail("[12] fused predictions are not bit-equal to the unfused engine's")
    got = pred.cpu().numpy()
    err = float(np.abs(got - susy_want).max())
    if got.shape != susy_want.shape or not np.isfinite(got).all() or err > ORACLE_ATOL:
        fail(f"[12] fused predict: max |pred - oracle| {err} > {ORACLE_ATOL}")
    us_fused = cuda_median_ms(lambda: fused.predict(rows_d)) * 1e3 / ROWS
    us_unfused = cuda_median_ms(lambda: unfused.predict(rows_d)) * 1e3 / ROWS
    print(f"[12] RANK_MXU fused: max |pred - oracle| {err} (tolerance "
          f"{ORACLE_ATOL}), bit-equal to the unfused engine; {us_fused:.6f} "
          f"us/sample fused, {us_unfused:.6f} unfused, over {ROWS} rows; "
          f"launches {counts} ({card})")
    del fused, x, two, pred, rows_d

    # 13. the probes, in-process
    probes = {"probe_int8": (PROBE_INT8, int8_cast_probe),
              "probe_overhead": (PROBE_OVERHEAD, overhead_bench),
              "probe_rank_parts": (PROBE_RANK_PARTS, unit_bench)}
    for k in all_kernels.values():
        k.launches = 0
    results = {}
    for name, (kernel, script) in probes.items():
        results[name] = res = script.run(dev)
        print(f"[13] {script.__name__.rsplit('.', 1)[-1]}: {json.dumps(res)}")
        if not res["all_exact"]:
            fail(f"[13] a {name} kernel differs from its plain version")
    # the probes also time kernels A, B and the fused kernel beside theirs
    counts = {n: k.launches for n, k in all_kernels.items()}
    if min(counts[n] for n in probes) < 1:
        fail(f"[13] a probe kernel was not launched: {counts}")
    for name in probes:
        launches[name] = counts[name]
    # each probe's record: the mode that answers its question, at its shapes
    i8 = results["probe_int8"]["checks"]
    x32, _ = int8_cast_probe.inputs()
    m, k_ = x32.shape
    record["probe_int8"] = [(
        "13", max(c["max_abs_err"] for c in i8.values()),
        i8["scratch_dot_mma"]["ms"], i8["scratch_dot_mma"]["plain_ms"],
        *bound(m * k_ * 4 + k_ * k_ + m * k_ * 4, (2 * m * k_ * k_, INT8_OPS_PER_S)),
        results["probe_int8"]["library_int_mm_ms"])]
    # the walk probes: each mode's bound from its inputs at 65,536 rows, and
    # kernel B's L1 reckoning on the same tables and rows
    rt = unfused.tables
    planes = unfused.transform(data)
    visits = ROWS * rt.records.shape[0] * rt.depth
    staged = ROWS * rank_row_words(rt.groups)  # the staged sum's adds
    path_bytes = -(-rt.records.shape[0] // 8) * 8 * ROWS  # walk_paths
    walk_bytes = {"noop": nbytes(planes), "paths": nbytes(planes) + path_bytes,
                  "descent": nbytes(planes, rt.leaf)}
    walk_ops = {"noop": 0, "paths": ROWS * rt.records.shape[0],
                "stream": 2 * visits + ROWS * rt.records.shape[0],
                "dot": descent_ops(ROWS, rt.records, rt.depth),
                "descent": descent_ops(ROWS, rt.records, rt.depth)
                + DESCENT_HASH_OPS * visits}
    walk_bound = {
        m: bound(walk_bytes.get(m, nbytes(planes, rt.records, rt.leaf) + path_bytes)
                 + 4 * ROWS,
                 (walk_ops[m] + staged, SCALAR_OPS_PER_S))
        for m in walk_ops}
    modes = {**results["probe_overhead"]["rows"][str(ROWS)],
             **results["probe_rank_parts"]["rows"][str(ROWS)]}
    for name, mode in (("probe_overhead", "stream"), ("probe_rank_parts", "dot")):
        rows_res = results[name]["rows"].values()
        record[name] = [(
            "13", max(r[m]["max_abs_err"] for r in rows_res
                      for m in r if isinstance(r[m], dict)),
            modes[mode]["ms"], modes[mode]["plain_ms"], *walk_bound[mode], None)]
    waves = rank_wavefronts(planes, rt)
    clock = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warp_visits = -(-ROWS // 32) * rt.records.shape[0] * rt.depth

    def cycles(ms):
        """SM cycles a warp-visit at ``clock`` (the card's maximum SM clock):
        ms over the warp-visits each SM takes."""
        return ms * 1e-3 * clock * 1e6 * sms / warp_visits if clock else None

    WALK_ORDER = ("noop", "paths", "stream", "dot", "descent")
    for n in (str(r) for r in overhead_bench.ROWS):
        parts = {**results["probe_overhead"]["rows"][n],
                 **results["probe_rank_parts"]["rows"][n]}
        line = "; ".join(
            f"{m} {parts[m]['ms']:.4f} ms ({parts[m]['share_of_rank_fold']:.4f} "
            f"of kernel B" + (f", bound {walk_bound[m][0]:.4f} {walk_bound[m][1]}"
                              if n == str(ROWS) else "") + ")"
            for m in WALK_ORDER)
        b_ms = parts["rank_fold_ms"]
        print(f"[13] {n} rows: kernel B {b_ms:.4f} ms "
              f"(overhead_bench's rounds) / "
              f"{results['probe_rank_parts']['rows'][n]['rank_fold_ms']:.4f} "
              f"(unit_bench's); {line} ({card})")
        # stream and dot carry the path words, kernel B does not: their
        # times less the words' own cost (paths - noop, timed alone)
        words = parts["paths"]["ms"] - parts["noop"]["ms"]
        print(f"[13] {n} rows: the path words alone (paths - noop) {words:.4f} ms "
              f"({words / b_ms:.4f} of kernel B); less them: " + "; ".join(
                  f"{m} {parts[m]['ms'] - words:.4f} ms "
                  f"({(parts[m]['ms'] - words) / b_ms:.4f} of kernel B)"
                  for m in ("stream", "dot")) + f" ({card})")
    pv = waves["per_warp_visit"]
    print(f"[13] kernel B's L1 a warp-visit, reckoned from the walks of "
          f"{waves['rows']} rows: {pv['lines']:.3f} lines, {pv['sectors']:.3f} "
          f"sectors of records, {pv['wavefronts']:.3f} shared wavefronts; by "
          f"level: lines {[round(x, 3) for x in waves['per_level']['lines']]}, "
          f"wavefronts {[round(x, 3) for x in waves['per_level']['wavefronts']]}")
    if clock:
        print(f"[13] SM cycles a warp-visit an SM at {clock} MHz, {sms} SMs, "
              f"{warp_visits} warp-visits: kernel B "
              f"{cycles(modes['rank_fold_ms']):.3f}, " + ", ".join(
                  f"{m} {cycles(modes[m]['ms']):.3f}"
                  for m in WALK_ORDER)
              + f"; fused {cycles(results['probe_rank_parts']['rank_fused_ms']):.3f}"
              f" (CUDA events) ({card})")
    del rt, unfused, planes

    # -- 14. the CLI protocol on the card -------------------------------------
    def engine_kernels(eng):
        """The kernels an engine launches on the card."""
        if isinstance(eng, FoldKernelEngine):
            return {name_of(eng.kernel)}
        if isinstance(eng, RankFoldEngine):
            return {"rank_fused"} if eng.fused else {"rank_transform", "rank_fold"}
        if isinstance(eng, SparseRankEngine):
            return {"rank_transform", "sparse_rank"}
        if isinstance(eng, DepthBucketedRankEngine):
            return {"rank_transform", "rank_fold"}
        if isinstance(eng, DepthBucketedFoldEngine):
            return set().union(*(engine_kernels(e) for e in eng.sub))
        return set()  # the plain torch engines

    t14 = time.perf_counter()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        model_path, data_path = make_fixtures.write_fixture(tmp, "susy_like")
        for k in all_kernels.values():
            k.launches = 0
        rc = cli.main([model_path, data_path, "--epochs", "10"], report=report)
        counts = {n: k.launches for n, k in all_kernels.items()}
        f = Forest.from_files(model_path, data_path, device="cuda")
    if "results" not in report:
        fail("[14] the CLI enumerated no strategy")
    results, predicted = report["results"], report["predicted"]
    picked = set()
    for s, r in results.items():
        if r.error or (r.ran and not r.correct):
            fail(f"[14] {s.name}: {r.error or f'max |pred - oracle| {r.max_err}'}")
        if r.ran:
            picked |= engine_kernels(f.engine(s))
            f.drop_engines()
        elif not r.skipped_reason:
            fail(f"[14] {s.name} neither ran nor was skipped with a reason")
    unlaunched = sorted(n for n in picked if counts[n] < 1)
    if rc != 0 or unlaunched:
        fail(f"[14] CLI exit {rc}; kernels of the enumerated engines that did "
             f"not launch: {unlaunched} (launches {counts})")
    best = autotune.best_strategy(results)
    print(json.dumps({
        "phase": 14, "rows": 10000, "predicted": predicted.name,
        "measured_best": best.name, "model_correct": predicted == best,
        "strategies": {s.name: ({"us_per_sample": r.us_per_sample,
                                 "band": r.us_band, "build_s": r.build_s,
                                 "max_err": r.max_err} if r.ran
                                else {"skipped": r.skipped_reason})
                       for s, r in results.items()},
        "predicted_us": {s.name: c.total * 1e6 / 10000
                         for s, c in report["costs"].items() if c},
        "launches": {n: c for n, c in counts.items() if c},
        "card": card}))
    if predicted != best:
        print(f"[14] the model picked {predicted.name}, the enumeration measured "
              f"{best.name} the fastest: a finding, not a failure")
    print(f"[14] the CLI protocol on susy_like, 10,000 rows, in "
          f"{time.perf_counter() - t14:.1f} s; kernels launched: "
          f"{sorted(picked)} ({card})")
    del f, results, report

    # -- 15. the headline bench ---------------------------------------------
    t15 = time.perf_counter()
    out = pyio.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main([])
    text = out.getvalue().strip()
    print(text)
    try:
        line = json.loads(text.splitlines()[-1])
    except (IndexError, ValueError):
        fail(f"[15] bench printed no JSON line: {text[-500:]}")
    err = line.get("max_err_vs_oracle")
    if rc != 0 or err is None or not err <= ORACLE_ATOL:
        fail(f"[15] bench exit {rc}, max_err_vs_oracle {err}")
    print(f"[15] bench in {time.perf_counter() - t15:.1f} s ({card})")

    # -- 16. sharded inference ----------------------------------------------
    t16 = time.perf_counter()
    import torch.distributed as dist

    from tahoe_tpu_torch.ops.bucketed import subset_trees
    from tahoe_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from tahoe_tpu_torch.parallel.sharded import (
        ShardedForestEngine, ShardedRankEngine, ShardedSparseEngine)
    from tahoe_tpu_torch.scripts import run_multiproc

    by_symbol = {k.symbol: n for n, k in all_kernels.items()}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) a one-rank NCCL group, mesh (1, 1): each sharded engine bit for
        # bit the unsharded one, and within ORACLE_ATOL of the oracle
        init_distributed(f"file://{tmp}/rendezvous", 1, 0, backend="nccl",
                         device="cuda")
        grid = make_mesh(1, 1, device="cuda")
        for label, sharded_cls, plain_cls, spec, rows_np, want in (
                ("fold", ShardedForestEngine, FoldKernelEngine, forest, data,
                 susy_want),
                ("rank", ShardedRankEngine, RankFoldEngine, forest, data, susy_want),
                ("sparse", ShardedSparseEngine, SparseRankEngine, deep18,
                 deep_rows, deep18_want)):
            rows_d = torch.as_tensor(rows_np, device=dev)
            ref = plain_cls(spec, device=dev)
            ref_pred = ref.predict(rows_d)
            eng = sharded_cls(spec, grid)
            for k in all_kernels.values():
                k.launches = 0
            got = eng.predict(rows_d)
            torch.cuda.synchronize()
            counts = {n: k.launches for n, k in all_kernels.items() if k.launches}
            need = engine_kernels(ref)
            if need - set(counts):
                fail(f"[16] sharded {label}: kernels {sorted(need - set(counts))} "
                     f"did not launch ({counts})")
            if not torch.equal(got, ref_pred):
                fail(f"[16] sharded {label} on (1, 1) differs from the unsharded "
                     f"engine by {float((got - ref_pred).abs().max())}")
            err = float(np.abs(got.cpu().numpy() - want).max())
            if err > ORACLE_ATOL:
                fail(f"[16] sharded {label}: max |pred - oracle| {err}")
            dispatch.append((f"16 sharded {label} (1, 1): its shard's engine",
                             eng.engine, BOTH, rows_np, spec, want, 20))
            us = cuda_median_ms(lambda: eng.predict(rows_d)) * 1e3 / ROWS
            us_ref = cuda_median_ms(lambda: ref.predict(rows_d)) * 1e3 / ROWS
            print(f"[16] NCCL (1, 1) {label}: {spec.num_trees} trees, depth "
                  f"{spec.depth}, {ROWS} rows; bit-equal to the unsharded engine, "
                  f"max |pred - oracle| {err}; launches {counts}; {us:.6f} us/sample "
                  f"(unsharded {us_ref:.6f}) ({card})")
            del ref, eng, rows_d
        buf = torch.ones(ROWS, device=dev)
        for _ in range(5):
            dist.all_reduce(buf)
        issue = []
        for _ in range(50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(buf)
            issue.append((time.perf_counter() - t0) * 1e6)
        event_ms = cuda_median_ms(lambda: dist.all_reduce(buf))
        print(f"[16] one NCCL all_reduce of {ROWS} f32 on a one-rank group: host "
              f"issue {statistics.median(issue):.2f} us (median of 50), event time "
              f"{event_ms * 1e3:.2f} us (median of 20) ({card})")
        dist.destroy_process_group()
        del deep18

        # (b) two ranks on the one card over gloo (NCCL refuses two ranks on
        # one card), meshes (1, 2) and (2, 1): each shard bit for bit an
        # unsharded engine on its trees, the sum within ORACLE_ATOL, and
        # every kernel of each rank's engine launched in that rank
        t0 = time.perf_counter()
        reports = run_multiproc.launch(
            forest, data, nprocs=2, workdir=os.path.join(tmp, "gloo"),
            meshes=[(1, 2), (2, 1)], engines=["fold", "rank"], device="cuda",
            backend="gloo", timeout=600)
        t_ranks = time.perf_counter() - t0
        summary = run_multiproc.check(forest, data, reports, dev, want=susy_want)
        need = {}
        for rep in reports:
            for res in rep["results"]:
                # the kernels the unsharded engine on the rank's trees runs
                key = (res["engine"], *res["trees"])
                if key not in need:
                    cls = FoldKernelEngine if res["engine"] == "fold" else RankFoldEngine
                    need[key] = engine_kernels(cls(subset_trees(
                        forest, np.arange(*res["trees"])), device=dev))
                got = {by_symbol[s] for s in res["launches"]}
                if need[key] - got:
                    fail(f"[16] gloo rank {rep['rank']} {res['engine']} "
                         f"{res['mesh']}: kernels {sorted(need[key] - got)} "
                         f"did not launch ({res['launches']})")
        for key, s16 in summary.items():
            if not (s16["correct"] and s16["shards_bit_equal"]):
                fail(f"[16] gloo {key}: {s16}")
            print(f"[16] gloo {key}: every shard bit-equal to an unsharded engine "
                  f"on its trees, max |pred - oracle| {s16['max_err']}; launches "
                  f"by rank {s16['launches']}")
    print(f"[16] two gloo ranks on one card (correctness only, not a multi-GPU "
          f"figure): {t_ranks:.1f} s for both meshes; phase 16 in "
          f"{time.perf_counter() - t16:.1f} s ({card})")

    # -- 17. the native text loader -------------------------------------------
    from tahoe_tpu_torch.forest import native_io

    with tempfile.TemporaryDirectory() as tmp:
        model_path = os.path.join(tmp, "model.txt")
        data_path = os.path.join(tmp, "data.txt")
        io.save_model(model_path, forest)
        io.save_data(data_path, data, float("nan"))
        if not native_io.available():
            fail(f"[17] the native loader did not build: {native_io.build_error()}")

        def timed(fn):
            out, ts = None, []
            for _ in range(3):
                t0 = time.perf_counter()
                out = fn()
                ts.append(time.perf_counter() - t0)
            return out, statistics.median(ts)

        spec_np, t_model_np = timed(lambda: io.load_model(model_path, num_cols=18))
        spec_nat, t_model_nat = timed(lambda: native_io.load_spec(model_path,
                                                                  num_cols=18))
        (rows_np, miss_np), t_data_np = timed(lambda: io.load_data(data_path))
        (rows_nat, miss_nat), t_data_nat = timed(lambda: native_io.load_data(data_path))
        for name in ("values", "weights", "fids", "def_left", "is_leaf", "exchange"):
            a, b = getattr(spec_np, name), getattr(spec_nat, name)
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                fail(f"[17] the native loader's model {name} differs from the numpy "
                     f"parser's")
        if (rows_np.tobytes() != rows_nat.tobytes() or rows_np.shape != rows_nat.shape
                or not (np.isnan(miss_np) and np.isnan(miss_nat))):
            fail("[17] the native loader's rows differ from the numpy parser's")
        print(f"[17] SUSY-class model ({forest.num_trees} trees, "
              f"{os.path.getsize(model_path)} bytes) and {ROWS} x 18 rows "
              f"({os.path.getsize(data_path)} bytes), bit-equal through both "
              f"parsers; load, median of 3: model numpy {t_model_np:.3f} s, native "
              f"{t_model_nat:.3f} s; data numpy {t_data_np:.3f} s, native "
              f"{t_data_nat:.3f} s (host; {card})")

    # -- 18. one dispatch a predict -------------------------------------------
    from tahoe_tpu_torch.scripts import pair_time
    from tahoe_tpu_torch.scripts.path_time import profile_kernels, wrapper_launch_us

    t18 = time.perf_counter()
    SWEEP_ROWS = 2000

    def counted(fn):
        """``fn()`` with every count set to 0 before it; its result and the
        kernels it launched."""
        for k in all_kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {n: k.launches for n, k in all_kernels.items() if k.launches}

    ours = re.compile(r"^(void )?\(anonymous namespace\)::")  # csrc's kernels

    def ran(fn):
        """The kernels of csrc one ``fn()`` ran on the card, by the
        profiler: name -> count."""
        seen = profile_kernels(fn, 1)
        if not seen:
            fail("[18] the profiler recorded no device event")
        return {n: c for n, (c, _) in seen.items() if ours.match(n)}

    # the profiler holds csrc's kernels only: the replay adds copies of
    # torch's, and their counts in the profile differed by one kernel of
    # 1,298 and of 42,386 in two runs where both sides run the same Python.
    # Once this phase had timed the plain torch engines' paths (graphs of
    # tens of thousands of kernels), a profile came back empty in two runs,
    # so their paths come last
    plain = ("GatherEngine", "TensorEngine", "SparseGatherEngine")
    dispatch.sort(key=lambda d: type(d[1]).__name__ in plain)
    profiled = 0
    for label, eng, methods, rows_np, spec, want, iters in dispatch:
        for n in (len(rows_np), SWEEP_ROWS):
            x = torch.as_tensor(rows_np[:n], device=dev)
            want_n = (want[:n] if want is not None
                      else oracle.predict(spec, rows_np[:n]) if n == SWEEP_ROWS
                      else None)
            line = {"phase": 18, "path": label, "rows": n}
            for method in methods:
                g, impl = getattr(eng, f"_{method}"), getattr(eng, f"_{method}_impl")
                call = getattr(eng, method)
                inp = eng.transform(x) if method == "predict_planes" else x
                key = tuple(inp.shape)
                eager, eager_counts = counted(lambda: impl(inp))
                keys = set(g.graphs)
                first = call(inp)
                captured = g.graphs.get(key)
                r1, counts = counted(lambda: call(inp))
                r2 = call(inp)
                torch.cuda.synchronize()
                where = f"[18] {label}, {n} rows, {method}"
                if captured is None or set(g.graphs) != keys | {key} or g.graphs[key] is not captured:
                    fail(f"{where}: graphs {sorted(keys)} -> {sorted(g.graphs)}; "
                         f"one capture at {key} expected")
                if not all(torch.equal(r, eager) for r in (first, r1, r2)):
                    fail(f"{where}: the graphed result differs from _{method}_impl's")
                if r1.data_ptr() == r2.data_ptr() or first.data_ptr() == r1.data_ptr():
                    fail(f"{where}: two results at one shape share storage")
                if counts != eager_counts:
                    fail(f"{where}: a replay counted {counts}, the eager call "
                         f"{eager_counts}")
                # what the card ran, on each path of csrc's kernels: one
                # replay of its predict runs the kernels of csrc one eager
                # call runs, as many as it counted
                if method != "margins" and eager_counts:
                    ran_eager, ran_graph = ran(lambda: impl(inp)), ran(lambda: call(inp))
                    if ran_graph != ran_eager or sum(ran_graph.values()) != sum(counts.values()):
                        fail(f"{where}: a replay ran {ran_graph} on the card, the "
                             f"eager call {ran_eager}; its counts {counts}")
                    profiled += 1
                if method != "margins" and want_n is not None:
                    got = r1.cpu().numpy()
                    err = float(np.abs(got - want_n).max())
                    if got.shape != want_n.shape or not np.isfinite(got).all() or err > ORACLE_ATOL:
                        fail(f"{where}: max |pred - oracle| {err} > {ORACLE_ATOL}")
                    line[f"{method}_max_err"] = err
                if method != "predict":
                    continue
                line.update(
                    eager_us_per_sample=cuda_median_ms(lambda: impl(inp), iters=iters) * 1e3 / n,
                    graphed_us_per_sample=cuda_median_ms(lambda: call(inp), iters=iters) * 1e3 / n,
                    device_us_per_sample=cuda_device_ms(
                        lambda: call(inp), warmup=1, calls=20 if iters >= 20 else 2) * 1e3 / n,
                    replay_host_ms=host_ms(lambda: call(inp), iters),
                    capture_s=g.graphs[key].seconds, launches=counts)
            line.update(graphs={m: len(getattr(eng, f"_{m}").graphs) for m in methods},
                        card=card)
            print(json.dumps(line))
    # fault 2's pairs (one launch, one table), mnist's and cifar's (fault
    # 4) and letter's, graphed: event time against device time in the same
    # rounds
    for fam in ("gisette_like", "stumps_like", "ijcnn_like", "mnist_like",
                "cifar_like", "letter_like"):
        res = pair_time.run(dev, fam)
        print(json.dumps({"phase": 18, "pair_time": fam, "rows": res["rows"],
                          **{k: v for k, v in res.items() if k.endswith("_ratio")},
                          "strategies": {
                              s: {k: v["median"] for k, v in r.items()
                                  if isinstance(v, dict) and "median" in v}
                              for s, r in res["strategies"].items()},
                          "card": res["card"]}))
    print(f"[18] eager launches through a kernel's ctypes wrapper, 200 back "
          f"to back between two events: {wrapper_launch_us(dev):.2f} us a launch; "
          f"phase 18 in "
          f"{time.perf_counter() - t18:.1f} s ({card})")
    print(f"[18] by the profiler, a replay ran the kernels of csrc its eager call "
          f"ran, as many as it counted, on all {profiled} predicts of their paths "
          f"({card})")
    del dispatch

    for name, checks in record.items():
        print(f"[record] {name}: " + "; ".join(
            f"phase {tag} |err| {err} kernel {ms:.4f} ms plain {p:.4f} ms "
            f"bound {b:.4f} ms ({by}) library {lib}"
            for tag, err, ms, p, b, by, lib in checks))
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "jaxlib", "tahoe_tpu")
                    or m.startswith(("jax.", "jaxlib.", "tahoe_tpu.")))
    if leaked:
        fail(f"modules of jax or of the JAX package were loaded: {leaked}")
    # each kernel's time and bound are those of its first check, on the
    # path its launches were counted on; its error is the largest over every
    # check
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[name],
         "max_abs_err": max(c[1] for c in record[name]),
         "ms": record[name][0][2], "plain_ms": record[name][0][3],
         "bound_ms": record[name][0][4], "bound_by": record[name][0][5],
         "library_ms": record[name][0][6]}
        for name, k in all_kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
