"""Probe: the rank path's kernels against other builds of them, on one card.

    python -m tahoe_tpu_torch.scripts.kernel_ab a OTHER.cu [--rounds 7]
    python -m tahoe_tpu_torch.scripts.kernel_ab b [--rounds 5]

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

    fn = other_lib.tahoe_rank_planes
    fn.argtypes = [*RANK_PLANES.argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
            rc = fn(ptr(x), x.shape[0], x.shape[1], t.groups, ptr(t.thresholds),
                    t.thresholds.shape[1], ptr(t.counts), ptr(planes), stream())
            if rc != 0:
                raise RuntimeError(f"other tahoe_rank_planes: CUDA error {rc}")
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

    fns_c = {}
    for name, lib in libs.items():
        fn = lib.tahoe_rank_fold
        fn.argtypes = [*RANK_FOLD.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns_c[name] = fn
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
                rc = fn(ptr(planes), planes.shape[0], t.groups, ptr(t.records),
                        t.records.shape[0], t.depth, ptr(t.leaf), ptr(m), stream())
                if rc != 0:
                    raise RuntimeError(f"tahoe_rank_fold: CUDA error {rc}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["a", "b"])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args()
    if args.mode == "a" and args.other is None:
        ap.error("mode a takes OTHER.cu")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from tahoe_tpu_torch.ops import _build

    _build.build()
    if args.mode == "a":
        libs = build_alone({"other": (args.other.resolve(), [])})
        res = run_a(libs["other"], args.rounds or 7)
    else:
        src = _build.CSRC / "rank_fold.cu"
        libs = build_alone({
            f"trees{n}_{'pairs' if g else 'bytes'}": (
                src, [f"-DTAHOE_RANK_TREES={n}", f"-DTAHOE_RANK_PAIR_GROUPS={g}"])
            for n in TREES for g in PAIR_GROUPS})
        res = run_b(libs, args.rounds or 5)
    ok = all(all(c["exact"].values()) for c in res.values())
    print(json.dumps({"mode": args.mode, "card": card_line(),
                      "torch": torch.__version__,
                      "other": str(args.other) if args.other else None,
                      "ok": ok, "cases": res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
