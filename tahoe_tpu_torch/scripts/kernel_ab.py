"""Probe: the port's kernels against other builds of them, on one card.

    python -m tahoe_tpu_torch.scripts.kernel_ab a OTHER.cu [--rounds 7]
    python -m tahoe_tpu_torch.scripts.kernel_ab b [OTHER.cu] [--rounds 5]
    python -m tahoe_tpu_torch.scripts.kernel_ab sparse OTHER.cu [--rounds 5]
    python -m tahoe_tpu_torch.scripts.kernel_ab deep OTHER.cu [--rounds 5] [--seeds 1]
    python -m tahoe_tpu_torch.scripts.kernel_ab c OTHER.cu [--rounds 5]
    python -m tahoe_tpu_torch.scripts.kernel_ab route [--rounds 5]
    python -m tahoe_tpu_torch.scripts.kernel_ab fused OTHER.cu [--rounds 5]
    python -m tahoe_tpu_torch.scripts.kernel_ab int8 OTHER.cu [--rounds 5]

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
kernel B; every build's margins must equal kernel B's bit for bit. With
OTHER.cu, an earlier ``csrc/rank_fold.cu`` (with the ``common.cuh`` it
includes beside it) is built alone and runs in the same rounds, held to the
same margins, and each kernel's SASS is compared with this tree's
(``sass_same``: a ``-cubin`` build of each source, ``cuobjdump -sass``).

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

``deep``: OTHER.cu is an earlier ``csrc/fold_deep.cu`` that walks the same
heap tables but takes its rows staged (``tahoe_fold_deep(x, rows, W,
blocks, leaf, T, D, rows_per_block, lanes, smem_bytes, out)``, ``_sign``,
``_nonge``: canonicalized rows, ``[x, -x]`` in the dual form), run in this
tree's block, with the ``fold.cu`` and ``common.cuh`` it includes beside it.
Like for like, on the same tables and the same raw rows (a device table,
as the benchmark's), by device time: the walk alone, this tree's kernel on
the raw rows where they lie (``fold_deep_at``, as the main path launches
it: ``this``) against the other on the staged rows (``other``), and this
one on the staged rows too (``this_staged``); and the whole predict's
device work, this tree's launch (``predict_this``) against the staged
route's (``predict_other``: the copy or column gather into a static input,
``finish_rows``' sentinel test and dual lanes, the other kernel, the clone
of its output). This tree's is also rebuilt at ``TAHOE_DEEP_TREES`` 4, 8
and 16, and its kernel runs with the other number of lanes a row, on
cup98-class (sign form, two lanes, 300 of 479 columns through the map),
deep15-class (dual and sign), deep12-class (dual), a depth-13 non-ge forest
of 90 columns (its rows' -999.0 a value, and again the forest's sentinel,
tested in the staging), and higgs_rf16-class (100 trees of
depth 16 over 28 columns, uniform rows, none missing) at ``--seeds`` forest
seeds; every build's margins must equal this tree's on the raw rows bit for
bit; beside the times, the distinct sectors and lines a warp-wide load
touches in heap order and in ``deep_blocks``' (``deep_sectors``, on the
first 2,048 rows). Kernel C's SASS is compared with that of the ``fold.cu``
beside OTHER.cu (``kernel_c_sass_same_as_other``), since both kernels'
row staging is one body in ``common.cuh``.

``c``: OTHER.cu is an earlier ``csrc/fold.cu`` (the one before the blocks: rows at an odd
stride, (threshold, code) tables a node, every thread staging each tile;
``tahoe_fold(x, rows, W, thr, fid, leaf, T, D, rows_per_block, tile_trees,
smem_bytes, out)``, ``_sign`` and ``_nonge``), run in its own block
(``parent_fold_launch``). This tree's kernel C runs as shipped and rebuilt
at ``TAHOE_FOLD_TREES`` 4 and 16 and ``TAHOE_FOLD_BATCH`` 0 and 2 (the
block loads never or always issued together; ``C_BUILDS``), in the same
block. On
stumps-class (dual), svhn-, gisette- and cifar-class (sign) and the four
non-ge buckets of the mixed 90-column forest (``chip_smoke.py`` phase 9),
every build's margins must equal the parent's bit for bit; beside the times,
each case's shared-memory wavefronts per (warp, tree), reckoned from the real
walks of 2,048 rows (``fold_wavefronts``).

``route``: kernel C (``fold_launch``: half an SM, else the whole opt-in
budget, for each row count) against the deep kernel (``deep_launch``) on the
same ``FoldTables``, on the shapes ``test_fold_plan_routes`` holds
``fold_plan`` to and those ``chip_smoke.py`` phases 3 and 6-9 route, with
``fold_plan``'s pick beside the faster one. Kernel C runs in ``fold_plan``'s
block (``c``), and where they differ from it also in the block of the most
rows in half an SM alone (two blocks an SM, ``c_half``) and in the whole
opt-in budget (``c_whole``), each with any tile of trees.

``fused``: OTHER.cu is an earlier ``csrc/rank_fused.cu``, which read each
visited node's int8 column (``tahoe_rank_fused(x, rows, F, thr, K, counts,
mats, T, D, leaf, out)``). This tree's fused kernel runs as shipped and
rebuilt at 128 rows a block (``FUSED_BUILDS``; the other layouts measured,
kernel B's full pair staging, x staged a warp at a time and persistent
blocks, lost or tied and were removed: PERF.md), beside kernels A and B
in one CUDA graph, on SUSY-class, trained_mix-class and the widest band (30
virtual features of 16,255 thresholds each, a 61 KB coarse index:
``generate_forest(470, 10, 15, seed=5)``). Every build's margins must
equal kernels A then B bit for bit.

``int8``: OTHER.cu is an earlier ``csrc/probes.cu``. Its ``tahoe_probe_int8``
and this tree's, each in all five modes, and ``torch._int_mm`` on the
scratch_dot operands (int8(x), W), at M = 256 (the probe's own inputs) and
M = 65,536; every output must equal the plain version exactly.

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
    "mnist_sign": ("sign", 400, 6, 100),
    # the mixed 90-column forest's DEPTH_BUCKETED buckets (chip_smoke.py
    # phase 9)
    "nonge_d7": ("nonge", 90, 7, 59),
    "nonge_d8": ("nonge", 90, 8, 17),
    "nonge_d9": ("nonge", 90, 9, 23),
    "nonge_d10": ("nonge", 90, 10, 21),
}
# c: the builds of this tree's kernel C, each one axis off the shipped one
# (the build of C_TREES_IN_FLIGHT trees is the shipped one, and skipped)
C_BUILDS = {
    "trees4": ["-DTAHOE_FOLD_TREES=4"],
    "trees8": ["-DTAHOE_FOLD_TREES=8"],
    "trees16": ["-DTAHOE_FOLD_TREES=16"],
    "batch_never": ["-DTAHOE_FOLD_BATCH=0"],
    "batch_always": ["-DTAHOE_FOLD_BATCH=2"],
}
WAVEFRONT_ROWS = 2048
# fused: the builds of this tree's fused kernel off the shipped one
FUSED_BUILDS = {"rows128": ["-DTAHOE_FUSED_ROWS=128"]}
INT8_ROWS = (256, 65536)


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


def sass_same(a: Path, b: Path) -> dict:
    """Kernel name -> whether sources ``a`` and ``b``, each compiled alone
    to a cubin with this tree's flags, give the same SASS instructions (the
    addresses and the anonymous namespace's hash left out)."""
    import re
    import shutil
    import tempfile

    from tahoe_tpu_torch.ops import _build

    dump = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    kernels = []
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for i, src in enumerate((a, b)):
            cubin = str(Path(tmp) / f"{i}.cubin")
            subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", cubin, str(src)],
                           check=True, capture_output=True)
            text = subprocess.run([dump, "-sass", cubin], check=True,
                                  capture_output=True, text=True).stdout
            funcs, name = {}, None
            for line in text.splitlines():
                m = re.match(r"\s*Function : (\S+)", line)
                if m:
                    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_", "", m.group(1))
                    funcs[name] = []
                elif name and (m := re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", line)):
                    funcs[name].append(m.group(1))
            kernels.append(funcs)
    return {n: kernels[0].get(n) == kernels[1].get(n)
            for n in sorted(set(kernels[0]) | set(kernels[1]))}


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


def deep_loads(paths, depth: int, order: str) -> dict:
    """The byte offsets that the deep kernel's loads read per (row, tree),
    from the level-order paths of ``descent_paths`` ([D + 1, R, T]):
    ``blocks``, one [R, T] tensor a group, within one table of every tree's
    16-byte blocks, and ``leaf``, within one table of every tree's 4-byte
    leaves; both in ``deep_blocks``' order (``"bits"``, the root's branch the
    lowest bit of a path) or in the deep kernel's heap order (``"heap"``,
    ops/fold_kernel.py ``heap_tables``)."""
    import torch

    from tahoe_tpu_torch.ops.fold_kernel import deep_block_count, deep_groups, heap_path

    def index(j, bits):
        return heap_path(j, bits) if order == "heap" else j

    tree = torch.arange(paths.shape[2], device=paths.device)
    B = deep_block_count(depth)
    blocks, off, d = [], 0, 0
    for size in deep_groups(depth):
        blocks.append(16 * (tree * B + off + index(paths[d], d)))
        off += 1 << d
        d += size
    return {"blocks": blocks,
            "leaf": 4 * ((tree << depth) + index(paths[depth], depth))}


def deep_sectors(x, t) -> dict:
    """The deep kernel's global-memory footprint per (warp, tree), reckoned
    from the real walks of ``x``'s rows (whole warps of 32): the distinct
    32-byte sectors and 128-byte lines that each warp-wide load touches,
    summed over a descent's block loads (one a group) and its leaf load,
    in either order of ``deep_loads``."""
    from tahoe_tpu_torch.ops.fold_kernel import deep_groups, descent_paths

    R = x.shape[0] // 32 * 32
    paths = descent_paths(x[:R], t)
    T = paths.shape[2]

    def distinct(addr, unit):  # [R, T] byte offsets -> [R / 32, T]
        s = (addr // unit).view(R // 32, 32, T).sort(dim=1).values
        return 1 + (s[:, 1:] != s[:, :-1]).sum(dim=1)

    out = {"rows": R, "loads_per_row_tree": len(deep_groups(t.depth)) + 1}
    for order in ("bits", "heap"):
        loads = deep_loads(paths, t.depth, order)
        loads["leaf"] = [loads["leaf"]]
        out[order] = {
            f"{what}_{unit_name}": float(sum(distinct(a, unit) for a in addrs)
                                         .double().mean())
            for what, addrs in loads.items()
            for unit_name, unit in (("sectors", 32), ("lines", 128))}
        for unit_name in ("sectors", "lines"):
            out[order][unit_name] = (out[order][f"blocks_{unit_name}"]
                                     + out[order][f"leaf_{unit_name}"])
    return out


def deep_cases(seeds: int):
    """name -> (forest, rows, ge_mode)."""
    from tahoe_tpu_torch.forest import synthetic

    out = {
        "cup98_sign": (synthetic.generate_forest(150, 8, 479, active_cols=300, seed=1),
                       synthetic.generate_data(ROWS, 479, missing_prob=0.02, seed=4),
                       True),
        "deep15_dual": (synthetic.generate_forest(30, 15, 16, seed=1),
                        synthetic.generate_data(ROWS, 16, missing_prob=0.02, seed=5),
                        True),
        "deep15_sign": (synthetic.generate_forest(30, 15, 100, seed=1),
                        synthetic.generate_data(ROWS, 100, missing_prob=0.02, seed=14),
                        True),
        "deep12_dual": (synthetic.generate_forest(100, 12, 28, seed=1),
                        synthetic.generate_data(ROWS, 28, missing_prob=0.01, seed=6),
                        True),
        "nonge_d13": (synthetic.generate_forest(20, 13, 90, seed=1),
                      synthetic.generate_data(ROWS, 90, missing=-999.0,
                                              missing_prob=0.05, seed=7),
                      False),
        # the same rows with -999.0 the forest's sentinel: the missing test
        # in the staging
        "nonge_d13_sentinel": (synthetic.generate_forest(20, 13, 90, missing=-999.0,
                                                         seed=1),
                               synthetic.generate_data(ROWS, 90, missing=-999.0,
                                                       missing_prob=0.05, seed=7),
                               False),
    }
    higgs_rows = synthetic.generate_data(ROWS, 28, missing_prob=0.0, seed=8)
    for i in range(seeds):
        out[f"higgs_rf16_seed{i}"] = (
            synthetic.generate_forest(100, 16, 28, seed=300 + i), higgs_rows, True)
    return out


# the earlier deep kernel's launchers, on staged rows
PARENT_DEEP_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def run_deep(other_lib, libs: dict, rounds: int, seeds: int) -> dict:
    import numpy as np
    import torch

    from tahoe_tpu_torch.config import GpuLimits
    from tahoe_tpu_torch.ops._build import ptr
    from tahoe_tpu_torch.ops.fold_kernel import (
        DEEP_KERNELS, deep_launch, fold_deep_at, fold_deep_cuda,
        fold_margins_plain, fold_tables, heap_tables)
    from tahoe_tpu_torch.ops.rows import finish_rows, stage_rows

    dev = torch.device("cuda", 0)
    limits = GpuLimits.for_device(dev)
    out = {}
    for case, (forest, data, ge_mode) in deep_cases(seeds).items():
        t = fold_tables(forest, device=dev, ge_mode=ge_mode)
        dual = t.form == "dual"
        raw = torch.as_tensor(data, device=dev)
        cols = None if t.col_index is None else t.col_index.to(torch.int32)
        staged_in = stage_rows(raw, device=dev, col_index=t.col_index).clone()
        x = finish_rows(staged_in, forest.missing, dual=dual)
        R, W = x.shape
        T = t.leaf.shape[0]
        launch = deep_launch(t.width, limits)
        symbol = DEEP_KERNELS[t.form].symbol
        argtypes = DEEP_KERNELS[t.form].argtypes
        heap = heap_tables(t)
        old = bind(other_lib, symbol, PARENT_DEEP_ARGS)

        def other(x=x, T=T, D=t.depth, heap=heap, launch=launch):
            m = torch.empty(R, dtype=torch.float32, device=dev)
            checked(old(ptr(x), R, W, ptr(heap.blocks), ptr(heap.leaf), T, D,
                        launch.rows_per_block, launch.lanes, launch.smem_bytes,
                        ptr(m), stream()), f"other {symbol}")
            return m

        def predict_other(staged_in=staged_in, t=t, missing=forest.missing):
            # the staged route: the rows into the static input, then (in
            # its graph) finish_rows and the kernel, then the clone
            stage_rows(raw, device=dev, col_index=t.col_index, out=staged_in)
            xs = finish_rows(staged_in, missing, dual=t.form == "dual")
            m = torch.empty(R, dtype=torch.float32, device=dev)
            checked(old(ptr(xs), R, W, ptr(heap.blocks), ptr(heap.leaf), T,
                        t.depth, launch.rows_per_block, launch.lanes,
                        launch.smem_bytes, ptr(m), stream()), f"other {symbol}")
            return m.clone()

        def build(fn, t=t, heap=heap, launch=launch, missing=forest.missing):
            def call():
                m = torch.empty(R, dtype=torch.float32, device=dev)
                ld = raw.stride(0)
                F = t.num_cols
                checked(fn(ptr(raw), ld, None if cols is None else ptr(cols), F,
                           float(np.float32(missing)), R, t.width,
                           ptr(heap.blocks), ptr(heap.leaf), T, t.depth,
                           launch.rows_per_block, launch.lanes, launch.smem_bytes,
                           ptr(m), stream()), symbol)
                return m
            return call

        def this(lo, t=t, heap=heap, missing=forest.missing):
            return lambda: fold_deep_at(raw, t, heap, lo, missing, cols)

        fns = {"this": this(launch),
               "other": other,
               "this_staged": lambda x=x, t=t, heap=heap, lo=launch:
                   fold_deep_cuda(x, t, heap, lo),
               f"this_lanes{3 - launch.lanes}": this(
                   launch._replace(lanes=3 - launch.lanes)),
               "predict_other": predict_other}
        fns.update({name: build(bind(lib, symbol, argtypes))
                    for name, lib in libs.items()})
        want = fns["this"]()
        # the plain fold evaluates 2^D nodes a (row, tree): to depth 15 only
        plain_err = (float((want - fold_margins_plain(x, t)).abs().max())
                     if t.depth <= 15 else None)
        exact = {k: bool(torch.equal(fn(), want)) for k, fn in fns.items()}
        times = timed_rounds(fns, rounds)
        med = {k: v["median_ms"] for k, v in times.items()}
        out[case] = {"form": t.form, "width": W, "depth": t.depth, "trees": T,
                     "raw_columns": raw.shape[1], "mapped": cols is not None,
                     "missing": float(forest.missing),
                     "launch": list(launch), "exact": exact,
                     "max_abs_err_vs_plain": plain_err,
                     "ok": all(exact.values()) and (plain_err is None
                                                     or plain_err <= KERNEL_ATOL),
                     # the walk: this kernel on raw rows over the other on
                     # staged rows; the whole predict (this launch is all of
                     # it) over the staged route's
                     "walk_this_over_other": med["this"] / med["other"],
                     "staged_this_over_other": med["this_staged"] / med["other"],
                     "predict_this_over_other": med["this"] / med["predict_other"],
                     "sectors": deep_sectors(x[:WAVEFRONT_ROWS], t),
                     "times": times}
        del t, x, raw, heap, fns, staged_in
    return out


def run_route(rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.config import GpuLimits
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops.fold_kernel import (
        deep_launch, fold_c_table, fold_deep_cuda, fold_launch,
        fold_margins_cuda, fold_plan, fold_tables, heap_tables, tree_bytes)
    from tahoe_tpu_torch.ops.rows import canonicalize_rows

    dev = torch.device("cuda", 0)
    limits = GpuLimits.for_device(dev)
    out = {}
    for i, (name, (form, cols, depth, trees)) in enumerate(ROUTE_SHAPES.items()):
        forest = synthetic.generate_forest(trees, depth, cols, seed=100 + i)
        t = fold_tables(forest, device=dev, ge_mode=form != "nonge")
        if t.form != form:
            raise RuntimeError(f"{name}: {t.form} form, not {form}")
        x = canonicalize_rows(
            synthetic.generate_data(ROWS, cols, missing_prob=0.02, seed=200 + i),
            forest.missing, device=dev, col_index=t.col_index, dual=form == "dual")
        launches = {"c": fold_launch(t.width, t.depth, trees, limits),
                    "c_half": fold_launch(t.width, t.depth, trees, limits,
                                          budget=limits.smem_half_sm),
                    "c_whole": fold_launch(t.width, t.depth, trees, limits,
                                           budget=limits.smem_per_block),
                    "deep": deep_launch(t.width, limits)}
        for k in ("c_half", "c_whole"):
            if launches[k] == launches["c"]:
                launches[k] = None
        blocks = heap_tables(t)
        table = fold_c_table(t)
        fns = {"deep": lambda x=x, t=t, b=blocks, d=launches["deep"]:
               fold_deep_cuda(x, t, b, d)}
        for k in ("c", "c_half", "c_whole"):
            if launches[k] is not None:
                fns[k] = lambda x=x, t=t, tb=table, c=launches[k]: fold_margins_cuda(
                    x, t, tb, c)
        m = {k: fn() for k, fn in fns.items()}
        exact = all(torch.equal(v, m["deep"]) for v in m.values())
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
                         for k in ("c", "c_half", "c_whole")
                         if launches[k] is not None},
                     "c_bit_equal_deep": exact, "ok": exact,
                     **{f"{k}_ms": med.get(k) for k in launches},
                     "c_over_deep": med["c"] / med["deep"] if "c" in med else None,
                     "faster": min(med, key=med.get),
                     "plan": next((k for k, v in launches.items() if v == plan),
                                  str(plan)),
                     "times": times}
    return out


def c_cases():
    """name -> (forest, rows, ge_mode) of kernel C's paths (chip_smoke.py
    phases 6, 8 and 9; gisette- and cifar-class as in route)."""
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.forest.compiler import reachable_depths, truncate_depth
    from tahoe_tpu_torch.ops.bucketed import plan_buckets, subset_trees

    names = list(ROUTE_SHAPES)
    out = {
        "stumps_dual": (synthetic.generate_forest(800, 3, 10, seed=1),
                        synthetic.generate_data(ROWS, 10, missing_prob=0.05, seed=7),
                        True),
        "svhn_sign": (synthetic.generate_forest(200, 6, 100, seed=1),
                      synthetic.generate_data(ROWS, 100, missing_prob=0.02, seed=10),
                      True),
    }
    for name in ("gisette_sign", "cifar_sign"):
        _, cols, depth, trees = ROUTE_SHAPES[name]
        i = names.index(name)
        out[name] = (synthetic.generate_forest(trees, depth, cols, seed=100 + i),
                     synthetic.generate_data(ROWS, cols, missing_prob=0.02,
                                             seed=200 + i), True)
    mix90 = synthetic.generate_mixed_depth_forest(120, 10, 90, seed=1)
    rows90 = synthetic.generate_data(ROWS, 90, missing_prob=0.02, seed=9)
    depths = reachable_depths(mix90)
    for idx in plan_buckets(depths):
        d = int(depths[idx].max(initial=0))
        if d:
            out[f"mixed90_nonge_d{d}"] = (
                truncate_depth(subset_trees(mix90, idx), d), rows90, False)
    return out


def parent_fold_launch(form: str, width: int, depth: int, T: int, limits):
    """The earlier kernel C's block: rows at an odd stride, (threshold, code) and a
    leaf a tree's node, tiles of min(T, 16) trees (one tree in the non-ge
    form), half an SM, else the whole opt-in budget."""
    from tahoe_tpu_torch.ops.fold_kernel import FoldLaunch

    per_tree = ((1 << depth) - 1) * 8 + (1 << depth) * 4
    min_tile = 1 if form == "nonge" else min(T, 16)
    for rows in (256, 128, 64, 32):
        xs = rows * (width | 1) * 4
        for b in (limits.smem_half_sm, limits.smem_per_block):
            tile = min(T, (b - xs) // per_tree)
            if tile >= min_tile:
                return FoldLaunch(rows, tile, xs + tile * per_tree)
    return None


def run_c(other_lib, libs: dict, rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.config import GpuLimits
    from tahoe_tpu_torch.ops._build import ptr
    from tahoe_tpu_torch.ops.fold_kernel import (
        FOLD_KERNELS, fold_c_table, fold_launch, fold_margins_cuda,
        fold_margins_plain, fold_tables, fold_wavefronts)
    from tahoe_tpu_torch.ops.rows import canonicalize_rows

    dev = torch.device("cuda", 0)
    limits = GpuLimits.for_device(dev)
    out = {}
    for case, (forest, data, ge_mode) in c_cases().items():
        t = fold_tables(forest, device=dev, ge_mode=ge_mode)
        x = canonicalize_rows(data, forest.missing, device=dev,
                              col_index=t.col_index, dual=t.form == "dual")
        R, W = x.shape
        T = t.leaf.shape[0]
        symbol = FOLD_KERNELS[t.form].symbol
        launch = fold_launch(W, t.depth, T, limits)
        parent = parent_fold_launch(t.form, W, t.depth, T, limits)
        old = bind(other_lib, symbol,
                   [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

        def other(x=x, t=t):
            m = torch.empty(R, dtype=torch.float32, device=dev)
            checked(old(ptr(x), R, W, ptr(t.thresholds), ptr(t.fids), ptr(t.leaf),
                        T, t.depth, parent.rows_per_block, parent.tile_trees,
                        parent.smem_bytes, ptr(m), stream()), f"other {symbol}")
            return m

        table = fold_c_table(t)
        fns = {"this": lambda x=x, t=t: fold_margins_cuda(x, t, table, launch),
               "other": other}
        for name, lib in libs.items():
            fn = bind(lib, symbol, FOLD_KERNELS[t.form].argtypes)

            def call(fn=fn, x=x, t=t):
                m = torch.empty(R, dtype=torch.float32, device=dev)
                # canonicalized rows: W columns, W apart, no map, nothing to test
                checked(fn(ptr(x), W, None, W, float("nan"), R, W, ptr(table), T,
                           t.depth, launch.rows_per_block, launch.tile_trees,
                           launch.smem_bytes, ptr(m), stream()),
                        symbol)
                return m
            fns[name] = call
        want = fns["other"]()
        plain_err = float((want - fold_margins_plain(x, t)).abs().max())
        exact = {k: bool(torch.equal(fn(), want)) for k, fn in fns.items()}
        times = timed_rounds(fns, rounds)
        med = {k: v["median_ms"] for k, v in times.items()}
        out[case] = {"form": t.form, "width": W, "depth": t.depth, "trees": T,
                     "launch": list(launch),
                     "parent_launch": list(parent),
                     "exact_vs_parent": exact,
                     "parent_max_abs_err_vs_plain": plain_err,
                     "ok": all(exact.values()) and plain_err <= KERNEL_ATOL,
                     "this_over_other": med["this"] / med["other"],
                     "wavefronts": fold_wavefronts(x[:WAVEFRONT_ROWS], t,
                                                   launch.rows_per_block),
                     "times": times}
    return out


def fused_cases():
    from tahoe_tpu_torch.forest import synthetic

    return {
        "susy": (synthetic.susy_class_forest(seed=0), 18, 0.02, 1),
        "trained_mix": (synthetic.generate_mixed_depth_forest(300, 12, 26, seed=1),
                        26, 0.01, 8),
        "widest_band": (synthetic.generate_forest(470, 10, 15, seed=5), 15, 0.02, 9),
    }


def run_fused(other_lib, libs: dict, rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.ops._build import ptr
    from tahoe_tpu_torch.ops.rank_kernel import (
        RANK_FUSED, RankFoldEngine, rank_margins_cuda, rank_margins_fused_cuda)
    from tahoe_tpu_torch.ops.rank_transform import rank_planes_cuda
    from tahoe_tpu_torch.forest import synthetic

    fns_c = {name: bind(lib, "tahoe_rank_fused", RANK_FUSED.argtypes)
             for name, lib in libs.items()}
    old = bind(other_lib, "tahoe_rank_fused", RANK_FUSED.argtypes)
    dev = torch.device("cuda", 0)
    out = {}
    for case, (forest, cols, missing, seed) in fused_cases().items():
        eng = RankFoldEngine(forest, device=dev, fuse_transform=True)
        t = eng.tables
        x = t.rows(synthetic.generate_data(ROWS, cols, missing_prob=missing,
                                           seed=seed), eng.raw_missing)

        def build(fn, records, x=x, t=t):
            def call():
                m = torch.empty(x.shape[0], dtype=torch.float32, device=dev)
                checked(fn(ptr(x), x.shape[0], x.shape[1], ptr(t.thresholds),
                           t.thresholds.shape[1], ptr(t.counts), ptr(records),
                           t.leaf.shape[0], t.depth, ptr(t.leaf), ptr(m), stream()),
                        "tahoe_rank_fused")
                return m
            return call

        fns = {"this": lambda x=x, t=t: rank_margins_fused_cuda(
            x, t.thresholds, t.counts, t.fused_records, t.leaf, t.depth)}
        fns.update({name: build(fn, t.fused_records) for name, fn in fns_c.items()})
        fns["other"] = build(old, t.mats)
        fns["a_then_b"] = lambda x=x, t=t: rank_margins_cuda(
            rank_planes_cuda(x, t.thresholds, t.counts), t.records, t.leaf, t.depth)
        want = fns["a_then_b"]()
        exact = {k: bool(torch.equal(fn(), want)) for k, fn in fns.items()}
        times = timed_rounds(fns, rounds)
        ab = times["a_then_b"]["median_ms"]
        out[case] = {"features": x.shape[1], "table": list(t.thresholds.shape),
                     "depth": t.depth, "trees": t.leaf.shape[0], "ok": all(exact.values()),
                     "exact": exact, "times": times,
                     "over_a_then_b": {k: v["median_ms"] / ab for k, v in times.items()}}
    return out


def run_int8(other_lib, rounds: int) -> dict:
    import torch

    from tahoe_tpu_torch.ops._build import ptr
    from tahoe_tpu_torch.ops.probes import (
        INT8_MODES, PROBE_INT8, int8_probe_cuda, int8_probe_plain)
    from tahoe_tpu_torch.scripts import int8_cast_probe

    old = bind(other_lib, "tahoe_probe_int8", PROBE_INT8.argtypes)
    dev = torch.device("cuda", 0)
    out = {}
    for m in INT8_ROWS:
        x32, w8 = int8_cast_probe.inputs(m)
        x = torch.as_tensor(x32, device=dev)
        w = torch.as_tensor(w8, device=dev)
        lhs = x.to(torch.int8)
        fns, exact = {}, {}
        for mode in INT8_MODES:
            i = INT8_MODES.index(mode)

            def other(mode=mode, i=i):
                o = torch.empty(m, 128, dtype=torch.int8 if i == 0 else torch.int32,
                                device=dev)
                checked(old(ptr(x), m, ptr(w), i, ptr(o), stream()), "tahoe_probe_int8")
                return o

            fns[f"this_{mode}"] = lambda mode=mode: int8_probe_cuda(x, w, mode)
            fns[f"other_{mode}"] = other
            want = int8_probe_plain(x, w, mode)
            exact[mode] = {k: bool(torch.equal(fns[f"{k}_{mode}"](), want))
                           for k in ("this", "other")}
        fns["int_mm"] = lambda: torch._int_mm(lhs, w)
        exact["int_mm"] = {"library": bool(torch.equal(
            fns["int_mm"](), int8_probe_plain(x, w, "scratch_dot_mma")))}
        times = timed_rounds(fns, rounds)
        bound_ms = (2 * m * 128 * 4) / 3.35e12 * 1e3  # x int32 in, int32 out
        out[str(m)] = {
            "ok": all(all(v.values()) for v in exact.values()), "exact": exact,
            "times": times, "bound_ms": bound_ms,
            "mma_over_int_mm": (times["this_scratch_dot_mma"]["median_ms"]
                                / times["int_mm"]["median_ms"]),
            "mma_over_bound": times["this_scratch_dot_mma"]["median_ms"] / bound_ms}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["a", "b", "sparse", "deep", "c", "route",
                                     "fused", "int8"])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=1,
                    help="deep: higgs_rf16-class forests, one a seed")
    args = ap.parse_args()
    if args.mode in ("a", "sparse", "deep", "c", "fused", "int8") and args.other is None:
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
            for n in TREES for g in PAIR_GROUPS}
            | ({"other": (args.other.resolve(), [])} if args.other else {}))
        res = run_b(libs, args.rounds or 5)
        if args.other:
            res["sass_same_as_other"] = sass_same(src, args.other.resolve())
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
        res = run_deep(libs.pop("other"), libs, args.rounds or 5, args.seeds)
        res["kernel_c_sass_same_as_other"] = sass_same(
            _build.CSRC / "fold.cu", args.other.resolve().parent / "fold.cu")
    elif args.mode == "c":
        from tahoe_tpu_torch.ops.fold_kernel import C_TREES_IN_FLIGHT

        src = _build.CSRC / "fold.cu"
        builds = {name: (src, defines) for name, defines in C_BUILDS.items()
                  if name != f"trees{C_TREES_IN_FLIGHT}"}
        builds["other"] = (args.other.resolve(), [])
        libs = build_alone(builds)
        res = run_c(libs.pop("other"), libs, args.rounds or 5)
    elif args.mode == "fused":
        src = _build.CSRC / "rank_fused.cu"
        builds = {name: (src, defines) for name, defines in FUSED_BUILDS.items()}
        builds["other"] = (args.other.resolve(), [])
        libs = build_alone(builds)
        res = run_fused(libs.pop("other"), libs, args.rounds or 5)
    elif args.mode == "int8":
        libs = build_alone({"other": (args.other.resolve(), [])})
        res = run_int8(libs["other"], args.rounds or 5)
    else:
        res = run_route(args.rounds or 5)
    sass = {n: v for n, v in res.items() if n.endswith("sass_same_as_other")}
    if args.mode in ("a", "b"):
        ok = all(all(c["exact"].values()) for n, c in res.items() if n not in sass)
    else:
        ok = all(c["ok"] for n, c in res.items() if n not in sass)
    if "kernel_c_sass_same_as_other" in sass:
        ok = ok and all(sass["kernel_c_sass_same_as_other"].values())
    print(json.dumps({"mode": args.mode, "card": card_line(),
                      "torch": torch.__version__,
                      "other": str(args.other) if args.other else None,
                      "ok": ok, "cases": res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
