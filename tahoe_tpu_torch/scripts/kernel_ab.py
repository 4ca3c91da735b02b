"""Probe: the port's kernels against other builds of them, on one card.

    python -m tahoe_tpu_torch.scripts.kernel_ab a OTHER.cu [--rounds 7]
    python -m tahoe_tpu_torch.scripts.kernel_ab b [--rounds 5]
    python -m tahoe_tpu_torch.scripts.kernel_ab sparse OTHER.cu [--rounds 5]
    python -m tahoe_tpu_torch.scripts.kernel_ab deep OTHER.cu [--rounds 5]
    python -m tahoe_tpu_torch.scripts.kernel_ab route [--rounds 5]

``a``: OTHER.cu is another version of ``csrc/rank_transform.cu`` (an earlier
commit's, unpacked with ``git archive``), with the ``common.cuh`` it includes
beside it, exporting the same ``tahoe_rank_planes``. In rounds, this tree's
kernel A, the other one and ``torch.searchsorted`` (the ranks alone, on the
same [F, K] table) are timed in turn; both kernels' planes must equal
``rank_planes_plain``.

``b``: this tree's ``csrc/rank_fold.cu`` rebuilt with every pair of
``TAHOE_RANK_TREES`` (trees in flight a thread: 4, 8, 16) and
``TAHOE_RANK_PAIR_GROUPS`` (0: the byte staging at every group count; 16:
the int16 pair staging at every one), timed in rounds beside this tree's
kernel B; every build's margins must equal kernel B's bit for bit.

``sparse``: OTHER.cu is an earlier ``csrc/sparse_rank.cu``, one 16-byte
record a node (``tahoe_sparse_rank(planes, rows, G, records, roots, T,
max_depth, out)``). This tree's is rebuilt at every pair of
``TAHOE_SPARSE_LEVELS`` (2, 3; the slots packed to match) and
``TAHOE_SPARSE_TREES`` (4, 8, 16), and at every pair of
``TAHOE_SPARSE_PAIR_GROUPS`` (0: the byte staging; 1: the int16 pairs at one
plane group) and ``TAHOE_SPARSE_ROWS`` (rows a block at most: 32, 64, 128,
256, each within 48 KB of staged rows). All are timed in rounds on rf_deep18-class
(``train_forest(200, 18, 24, rows=2048, seed=1)``), beside a 16 MB
device-to-device copy, which stays in L2: the yardstick of L2's rate. Every
build's margins must equal this tree's kernel's bit for bit, and the plain
version's within 1e-5. Each layout's reads per (row, tree) come from the
walks (``record_depths``, ``sparse_block_walk``), each read one 32-byte
sector.

``deep``: OTHER.cu is an earlier ``csrc/fold_deep.cu``, one 8-byte node a
level (``[T, 2^D - 1, 2]`` in level order; ``tahoe_fold_deep(x, rows, W,
nodes, leaf, T, D, rows_per_block, smem_bytes, out)`` and ``_sign``), run in
its own block (``parent_deep_launch``). This tree's is rebuilt at
``TAHOE_DEEP_TREES`` 4, 8 and 16, and its kernel also runs in the earlier
block and with the other number of lanes a row, on cup98-class (sign form),
deep15-class and deep12-class (dual), all on the same tables, margins bit
for bit this tree's kernel's.

``route``: kernel C (``fold_launch``: half an SM, else the whole opt-in
budget, for each row count) against the deep kernel (``deep_launch``) on the
same ``FoldTables``, on the shapes ``test_fold_plan_routes`` holds
``fold_plan`` to and those ``chip_smoke.py`` phases 3 and 6-8 route, with
``fold_plan``'s pick beside the faster one. Where kernel C's block in half an
SM alone (two blocks an SM) is another, it is timed too (``c_half``).

Every other build is compiled alone, with this tree's nvcc flags, into a
library of its own under ``build/tahoe_tpu_torch/``. Each time is
``utils/profiling.cuda_device_ms`` (device time of a call, 20 calls replayed
from a CUDA graph), on 65,536 rows already on the card: SUSY-class (one plane
group, depth 8), trained_mix-class (``generate_mixed_depth_forest(300, 12,
26, seed=1)`` as one forest, depth 12), two groups (45 features, depth 8)
and, in ``b``, sixteen groups (480 features, depth 8). Prints one JSON line;
exits 1 if a build disagrees, 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROWS = 65536
TREES = (4, 8, 16)
PAIR_GROUPS = (0, 16)
LEVELS = (2, 3)
SPARSE_ROWS = (32, 64, 128, 256)
KERNEL_ATOL = 1e-5
# route: name -> (form, features, depth, trees); the dual form's rows are
# twice its features wide. test_fold_plan_routes' shapes, chip_smoke.py's
# (susy, cup98, svhn, deep12, deep15, stumps) and a few between them
ROUTE_SHAPES = {
    "susy_dual": ("dual", 18, 8, 500),
    "cup98_sign": ("sign", 300, 8, 150),
    "svhn_sign": ("sign", 100, 6, 200),
    "gisette_sign": ("sign", 120, 6, 100),
    "cifar_sign": ("sign", 120, 7, 150),
    "covtype_dual": ("dual", 54, 9, 250),
    "narrow_depth9_dual": ("dual", 16, 9, 300),
    "deep12_dual": ("dual", 28, 12, 100),
    "deep15_dual": ("dual", 16, 15, 30),
    "wide_deep_sign": ("sign", 512, 12, 60),
    "stumps_dual": ("dual", 10, 3, 800),
    "depth6_dual": ("dual", 18, 6, 500),
    "depth7_dual": ("dual", 18, 7, 500),
    "covtype_d8_dual": ("dual", 54, 8, 250),
    "sign_d8": ("sign", 100, 8, 200),
    "dual_d10": ("dual", 28, 10, 100),
    "sign_d9": ("sign", 120, 9, 100),
}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def build_alone(builds: dict) -> dict:
    """name -> (source, [-D flags]): compile each source alone, all at once,
    into a library of its own; name -> loaded library."""
    from tahoe_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name, (source, defines) in builds.items():
        h = hashlib.sha256(" ".join([*_build.NVCC_FLAGS, *defines]).encode())
        for p in [source, *sorted(source.parent.glob("*.cuh"))]:
            h.update(p.read_bytes())
        libs[name] = _build.BUILD_DIR / f"libtahoe_alone_{h.hexdigest()[:16]}.so"
        if not libs[name].exists():
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o",
                   str(libs[name]), str(source)]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {builds[name][0]}:\n{log}")
    return {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}


def cases(with_sixteen: bool):
    from tahoe_tpu_torch.forest import synthetic

    out = {
        "susy": (synthetic.susy_class_forest(seed=0), 18, 0.02, 1),
        "trained_mix": (synthetic.generate_mixed_depth_forest(300, 12, 26, seed=1),
                        26, 0.01, 8),
        "two_groups": (synthetic.generate_forest(200, 8, 45, seed=3), 45, 0.02, 4),
    }
    if with_sixteen:
        out["sixteen_groups"] = (synthetic.generate_forest(100, 8, 480, seed=5),
                                 480, 0.02, 6)
    return out


def bind(lib, symbol: str, argtypes: list):
    fn = getattr(lib, symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def checked(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream():
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def timed_rounds(fns: dict, rounds: int) -> dict:
    """name -> (median, rounds) of device ms, the fns taken in turn."""
    from tahoe_tpu_torch.utils.profiling import cuda_device_ms

    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(cuda_device_ms(fn))
    return {k: {"median_ms": statistics.median(v), "rounds_ms": v}
            for k, v in times.items()}


def run_a(other_lib, rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.ops._build import ptr
    from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
    from tahoe_tpu_torch.ops.rank_transform import (
        LANE, RANK_PLANES, rank_planes_cuda, rank_planes_plain)
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.forest import synthetic

    fn = bind(other_lib, "tahoe_rank_planes", RANK_PLANES.argtypes)
    dev = torch.device("cuda", 0)
    out = {}
    for name, (forest, cols, missing, seed) in cases(False).items():
        t = RankFoldEngine(forest, device=dev).tables
        x = canonicalize_rows(
            synthetic.generate_data(ROWS, cols, missing_prob=missing, seed=seed),
            forest.missing, device=dev, col_index=t.col_index)
        xt = x.t().contiguous()

        def other(x=x, t=t):
            planes = torch.empty(x.shape[0], LANE * t.groups, dtype=torch.int8,
                                 device=dev)
            checked(fn(ptr(x), x.shape[0], x.shape[1], t.groups, ptr(t.thresholds),
                       t.thresholds.shape[1], ptr(t.counts), ptr(planes), stream()),
                    "other tahoe_rank_planes")
            return planes

        fns = {"this": lambda x=x, t=t: rank_planes_cuda(x, t.thresholds, t.counts),
               "other": other,
               "searchsorted": lambda t=t, xt=xt: torch.searchsorted(
                   t.thresholds, xt, right=True)}
        want = rank_planes_plain(x, t.thresholds, t.counts)
        res = timed_rounds(fns, rounds)
        med = {k: v["median_ms"] for k, v in res.items()}
        out[name] = {"x": list(x.shape), "table": list(t.thresholds.shape),
                     "exact": {k: bool(torch.equal(fns[k](), want))
                               for k in ("this", "other")},
                     "times": res,
                     "this_over_other": med["this"] / med["other"],
                     "this_over_searchsorted": med["this"] / med["searchsorted"],
                     "other_over_searchsorted": med["other"] / med["searchsorted"]}
    return out


def run_b(libs: dict, rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.ops._build import ptr
    from tahoe_tpu_torch.ops.rank_kernel import RANK_FOLD, RankFoldEngine, rank_margins_cuda
    from tahoe_tpu_torch.ops.rank_transform import rank_planes_cuda
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.forest import synthetic

    fns_c = {name: bind(lib, "tahoe_rank_fold", RANK_FOLD.argtypes)
             for name, lib in libs.items()}
    dev = torch.device("cuda", 0)
    out = {}
    for case, (forest, cols, missing, seed) in cases(True).items():
        t = RankFoldEngine(forest, device=dev).tables
        x = canonicalize_rows(
            synthetic.generate_data(ROWS, cols, missing_prob=missing, seed=seed),
            forest.missing, device=dev, col_index=t.col_index)
        planes = rank_planes_cuda(x, t.thresholds, t.counts)

        def build(fn, planes=planes, t=t):
            def call():
                m = torch.empty(planes.shape[0], dtype=torch.float32, device=dev)
                checked(fn(ptr(planes), planes.shape[0], t.groups, ptr(t.records),
                           t.records.shape[0], t.depth, ptr(t.leaf), ptr(m), stream()),
                        "tahoe_rank_fold")
                return m
            return call

        fns = {"this": lambda planes=planes, t=t: rank_margins_cuda(
            planes, t.records, t.leaf, t.depth)}
        fns.update({name: build(fn) for name, fn in fns_c.items()})
        want = fns["this"]()
        exact = {k: bool(torch.equal(fn(), want)) for k, fn in fns.items()}
        out[case] = {"groups": t.groups, "depth": t.depth,
                     "trees": t.records.shape[0], "exact": exact,
                     "times": timed_rounds(fns, rounds)}
    return out


def run_sparse(other_lib, libs: dict, levels: dict, rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.forest import synthetic, train
    from tahoe_tpu_torch.ops._build import ptr
    from tahoe_tpu_torch.ops.rank_transform import rank_planes_cuda
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.ops.sparse_kernel import (
        SPARSE_LEVELS, SPARSE_RANK, SparseRankEngine, record_depths, sparse_block_walk,
        sparse_blocks, sparse_leaves_plain, sparse_margins_cuda,
        sparse_margins_plain)

    dev = torch.device("cuda", 0)
    eng = SparseRankEngine(train.train_forest(200, 18, 24, rows=2048, seed=1),
                           device=dev)
    st = eng.tables
    T, G = st.roots.shape[0], st.groups
    x = canonicalize_rows(synthetic.generate_data(ROWS, 24, missing_prob=0.02,
                                                  seed=11),
                          eng.raw_missing, device=dev, col_index=st.col_index)
    planes = rank_planes_cuda(x, st.thresholds, st.counts)
    layouts = {}
    for lv in LEVELS:
        slots, _, steps = sparse_blocks(st.records.cpu().numpy(),
                                        st.roots.cpu().numpy(), lv)
        layouts[lv] = (torch.as_tensor(slots, device=dev), steps)
    old = bind(other_lib, "tahoe_sparse_rank",
               [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

    def other():
        out = torch.empty(ROWS, dtype=torch.float32, device=dev)
        checked(old(ptr(planes), ROWS, G, ptr(st.records), ptr(st.roots), T,
                    st.max_depth, ptr(out), stream()), "other tahoe_sparse_rank")
        return out

    def build(lib, lv):
        fn = bind(lib, "tahoe_sparse_rank", SPARSE_RANK.argtypes)
        slots, steps = layouts[lv]

        def call():
            out = torch.empty(ROWS, dtype=torch.float32, device=dev)
            checked(fn(ptr(planes), ROWS, G, ptr(slots), slots.shape[1], T, steps,
                       ptr(out), stream()), "tahoe_sparse_rank")
            return out
        return call

    src = torch.rand(4 << 20, device=dev)  # 16 MB: stays in the 50 MB L2
    dst = torch.empty_like(src)
    fns = {"this": lambda: sparse_margins_cuda(planes, st.slots, T, st.steps),
           "other": other}
    fns.update({name: build(lib, levels.get(name, SPARSE_LEVELS))
                for name, lib in libs.items()})
    fns["l2_copy_16mb"] = lambda: dst.copy_(src)
    want = fns["this"]()
    plain = sparse_margins_plain(planes, st.records, st.roots, st.max_depth)
    exact = {k: bool(torch.equal(fn(), want)) for k, fn in fns.items()
             if k != "l2_copy_16mb"}
    plain_err = float((want - plain).abs().max())
    times = timed_rounds(fns, rounds)
    leaves = sparse_leaves_plain(planes, st.records, st.roots, st.max_depth)
    records_read = record_depths(st.records, st.max_depth)[leaves] + 1
    reads = {"records_16B": float(records_read.double().mean())}
    for lv, (slots, steps) in layouts.items():
        reads[f"slots_levels{lv}"] = float(
            sparse_block_walk(planes, slots, T, steps)[1].double().mean())
    copy_ms = times["l2_copy_16mb"]["median_ms"]
    sectors = ROWS * T * 32  # bytes of one sector a read, per (row, tree)
    rates = {"l2_copy_tb_s": 2 * src.numel() * 4 / copy_ms / 1e9}
    for k, layout in (("other", "records_16B"), ("this", f"slots_levels{SPARSE_LEVELS}")):
        rates[f"{k}_sector_tb_s"] = (sectors * reads[layout]
                                     / times[k]["median_ms"] / 1e9)
    return {"rf_deep18": {
        "trees": T, "groups": G, "pool_nodes": st.records.shape[0],
        "slots": {lv: list(layouts[lv][0].shape) for lv in LEVELS},
        "steps": {lv: layouts[lv][1] for lv in LEVELS},
        "exact": exact, "max_abs_err_vs_plain": plain_err,
        "ok": all(exact.values()) and plain_err <= KERNEL_ATOL,
        "reads_per_row_tree": reads, "rates": rates, "times": times}}


def deep_cases():
    from tahoe_tpu_torch.forest import synthetic

    return {
        "cup98_sign": (synthetic.generate_forest(150, 8, 479, active_cols=300, seed=1),
                       synthetic.generate_data(ROWS, 479, missing_prob=0.02, seed=4)),
        "deep15_dual": (synthetic.generate_forest(30, 15, 16, seed=1),
                        synthetic.generate_data(ROWS, 16, missing_prob=0.02, seed=5)),
        "deep12_dual": (synthetic.generate_forest(100, 12, 28, seed=1),
                        synthetic.generate_data(ROWS, 28, missing_prob=0.01, seed=6)),
    }


def parent_deep_launch(width: int, limits):
    """The earlier deep kernel's block rule: the most rows of 256, 128, 64,
    32 whose staged rows fit half an SM, else the whole opt-in budget."""
    from tahoe_tpu_torch.ops.fold_kernel import DeepLaunch

    for b in (limits.smem_half_sm, limits.smem_per_block):
        for rows in (256, 128, 64, 32):
            if rows * (width | 1) * 4 <= b:
                return DeepLaunch(rows, rows * (width | 1) * 4)
    return None


def run_deep(other_lib, libs: dict, rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.config import GpuLimits
    from tahoe_tpu_torch.ops._build import ptr
    from tahoe_tpu_torch.ops.fold_kernel import (
        DEEP_KERNELS, deep_blocks, deep_launch, fold_deep_cuda, fold_margins_plain,
        fold_tables)
    from tahoe_tpu_torch.ops.rows import canonicalize_rows

    dev = torch.device("cuda", 0)
    limits = GpuLimits.for_device(dev)
    out = {}
    for case, (forest, data) in deep_cases().items():
        t = fold_tables(forest, device=dev)
        x = canonicalize_rows(data, forest.missing, device=dev,
                              col_index=t.col_index, dual=t.form == "dual")
        R, W = x.shape
        T = t.leaf.shape[0]
        launch = deep_launch(t.width, limits)
        parent = parent_deep_launch(t.width, limits)
        symbol = DEEP_KERNELS[t.form].symbol
        nodes = torch.stack([t.thresholds.view(torch.int32), t.fids],
                            dim=-1).contiguous()
        old = bind(other_lib, symbol,
                   [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p])
        blocks = deep_blocks(t)

        def call(fn, *block_args, table=blocks, x=x, t=t, T=T):
            def run():
                m = torch.empty(R, dtype=torch.float32, device=dev)
                checked(fn(ptr(x), R, W, ptr(table), ptr(t.leaf), T, t.depth,
                           *block_args, ptr(m), stream()), symbol)
                return m
            return run

        def this(lo, x=x, t=t):
            return lambda: fold_deep_cuda(x, t, blocks, lo)

        fns = {"this": this(launch),
               "this_parent_block": this(parent._replace(lanes=1)),
               f"this_lanes{3 - launch.lanes}": this(
                   launch._replace(lanes=3 - launch.lanes)),
               "other": call(old, parent.rows_per_block, parent.smem_bytes,
                             table=nodes)}
        fns.update({name: call(bind(lib, symbol, DEEP_KERNELS[t.form].argtypes),
                               launch.rows_per_block, launch.lanes,
                               launch.smem_bytes)
                    for name, lib in libs.items()})
        want = fns["this"]()
        plain_err = float((want - fold_margins_plain(x, t)).abs().max())
        exact = {k: bool(torch.equal(fn(), want)) for k, fn in fns.items()}
        out[case] = {"form": t.form, "width": W, "depth": t.depth, "trees": T,
                     "launch": list(launch), "parent_launch": list(parent),
                     "exact": exact, "max_abs_err_vs_plain": plain_err,
                     "ok": all(exact.values()) and plain_err <= KERNEL_ATOL,
                     "times": timed_rounds(fns, rounds)}
    return out


def run_route(rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.config import GpuLimits
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops.fold_kernel import (
        deep_blocks, deep_launch, fold_deep_cuda, fold_launch,
        fold_margins_cuda, fold_plan, fold_tables, tree_bytes)
    from tahoe_tpu_torch.ops.rows import canonicalize_rows

    dev = torch.device("cuda", 0)
    limits = GpuLimits.for_device(dev)
    out = {}
    for i, (name, (form, cols, depth, trees)) in enumerate(ROUTE_SHAPES.items()):
        forest = synthetic.generate_forest(trees, depth, cols, seed=100 + i)
        t = fold_tables(forest, device=dev)
        if t.form != form:
            raise RuntimeError(f"{name}: {t.form} form, not {form}")
        x = canonicalize_rows(
            synthetic.generate_data(ROWS, cols, missing_prob=0.02, seed=200 + i),
            forest.missing, device=dev, col_index=t.col_index, dual=form == "dual")
        launches = {"c": fold_launch(t.width, t.depth, trees, limits),
                    "c_half": fold_launch(t.width, t.depth, trees, limits,
                                          budget=limits.smem_half_sm),
                    "deep": deep_launch(t.width, limits)}
        if launches["c_half"] == launches["c"]:
            launches["c_half"] = None
        blocks = deep_blocks(t)
        fns = {"deep": lambda x=x, t=t, b=blocks, d=launches["deep"]:
               fold_deep_cuda(x, t, b, d)}
        for k in ("c", "c_half"):
            if launches[k] is not None:
                fns[k] = lambda x=x, t=t, c=launches[k]: fold_margins_cuda(x, t, c)
        m = {k: fn() for k, fn in fns.items()}
        err = max(float((v - m["deep"]).abs().max()) for v in m.values())
        times = timed_rounds(fns, rounds)
        med = {k: v["median_ms"] for k, v in times.items()}
        plan = fold_plan(form, t.width, t.depth, trees, limits)
        out[name] = {"form": form, "width": t.width, "depth": t.depth,
                     "trees": trees,
                     **{f"{k}_launch": list(v) if v else None
                        for k, v in launches.items()},
                     "staged_per_visit": {
                         k: tree_bytes(t.depth) / (launches[k].rows_per_block
                                                   * max(t.depth, 1))
                         for k in ("c", "c_half") if launches[k] is not None},
                     "c_vs_deep_max_abs_err": err, "ok": err <= KERNEL_ATOL,
                     **{f"{k}_ms": med.get(k) for k in launches},
                     "c_over_deep": med["c"] / med["deep"] if "c" in med else None,
                     "faster": min(med, key=med.get),
                     "plan": next((k for k, v in launches.items() if v == plan),
                                  str(plan)),
                     "times": times}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["a", "b", "sparse", "deep", "route"])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args()
    if args.mode in ("a", "sparse", "deep") and args.other is None:
        ap.error(f"mode {args.mode} takes OTHER.cu")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from tahoe_tpu_torch.ops import _build

    _build.build()
    if args.mode == "a":
        libs = build_alone({"other": (args.other.resolve(), [])})
        res = run_a(libs["other"], args.rounds or 7)
    elif args.mode == "b":
        src = _build.CSRC / "rank_fold.cu"
        libs = build_alone({
            f"trees{n}_{'pairs' if g else 'bytes'}": (
                src, [f"-DTAHOE_RANK_TREES={n}", f"-DTAHOE_RANK_PAIR_GROUPS={g}"])
            for n in TREES for g in PAIR_GROUPS})
        res = run_b(libs, args.rounds or 5)
    elif args.mode == "sparse":
        src = _build.CSRC / "sparse_rank.cu"
        levels, builds = {}, {}
        for lv in LEVELS:
            for n in TREES:
                levels[f"levels{lv}_trees{n}"] = lv
                builds[f"levels{lv}_trees{n}"] = (
                    src, [f"-DTAHOE_SPARSE_LEVELS={lv}", f"-DTAHOE_SPARSE_TREES={n}"])
        builds.update({f"{'pairs' if g else 'bytes'}_rows{r}": (
            src, [f"-DTAHOE_SPARSE_PAIR_GROUPS={g}", f"-DTAHOE_SPARSE_ROWS={r}"])
            for g in (0, 1) for r in SPARSE_ROWS})
        builds["other"] = (args.other.resolve(), [])
        libs = build_alone(builds)
        res = run_sparse(libs.pop("other"), libs, levels, args.rounds or 5)
    elif args.mode == "deep":
        src = _build.CSRC / "fold_deep.cu"
        builds = {f"trees{n}": (src, [f"-DTAHOE_DEEP_TREES={n}"]) for n in TREES}
        builds["other"] = (args.other.resolve(), [])
        libs = build_alone(builds)
        res = run_deep(libs.pop("other"), libs, args.rounds or 5)
    else:
        res = run_route(args.rounds or 5)
    if args.mode in ("a", "b"):
        ok = all(all(c["exact"].values()) for c in res.values())
    else:
        ok = all(c["ok"] for c in res.values())
    print(json.dumps({"mode": args.mode, "card": card_line(),
                      "torch": torch.__version__,
                      "other": str(args.other) if args.other else None,
                      "ok": ok, "cases": res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
