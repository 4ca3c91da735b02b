"""Probe: one facade path's time against its kernel's, and the host's part.

    python -m tahoe_tpu_torch.scripts.path_time [--reps 5] [--tag NAME]
        [--path svhn cup98 deep15 deep15_sign mixed90_deep]

Each path runs on 65,536 rows already on the card, as chip_smoke.py drives
it (``PATHS``): svhn-class (200 trees, depth 6, 100 features;
scripts/run_sweep.py ``svhn_like``) through ``Forest.predict(rows,
Strategy.SPLIT_FOREST)``, phase 6's shortest kernel path (kernel C's sign
form, ~0.1 ms; the default); cup98-class (150 trees, depth 8, 300 of 479
columns used: the one path here whose rows are gathered); deep15-class in the dual and the sign form
(phase 7, the deep kernel); the mixed-depth 90-column forest of depth 9-13
through ``DEPTH_BUCKETED`` (phase 9, kernel C and the deep kernel's non-ge
form, a launch a bucket). For each path, each of ``--reps`` rounds gives:

- ``e2e_ms``: median of 20 predicts, each between two CUDA events
  (chip_smoke.py's us/sample times 65,536 / 1,000);
- ``kernel_ms``: median of 20 calls of the engine's kernels alone on the
  canonicalized rows (every bucket's, for DEPTH_BUCKETED), and
  ``kernel_device_ms``, each engine's (each bucket's) device time
  (``utils/profiling.cuda_device_ms``: without the host's issue time);
- ``host_ms``: median host wall time to issue one predict on an idle card
  (synchronized before the call, not after it);
- ``stream_ms``: wall time per predict of 200 issued back to back and one
  synchronize: the larger of host and device time per call;
- ``device_ms``: the predict by device time (``cuda_device_ms``);
- ``launch_us``: ``wrapper_launch_us``, a kernel launch through its ctypes
  wrapper (no model term reads it since one dispatch a predict);
- ``kernel_a_ms``: kernel A at SUSY-class shapes, median of 20 (phase 3's
  check).

Then the CUDA kernels of one predict, by name, count and device time, from
torch.profiler. It imports only what chip_smoke.py's phases 3, 6, 7 and 9
import, so one copy of it times two trees of the port on one card:
``PYTHONPATH=<tree> python tahoe_tpu_torch/scripts/path_time.py``. Prints
one JSON line a path; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

ROWS = 65536
ITERS = 20
STREAM_CALLS = 200
LAUNCHES = 200
PROFILED_CALLS = 10
# name -> (synthetic generator, (trees, depth, columns), forest seed, data
# seed, strategy, the generator's keywords), as chip_smoke.py phases 6, 7
# and 9 build them
PATHS = {
    "svhn": ("generate_forest", (200, 6, 100), 1, 10, "SPLIT_FOREST", {}),
    "cup98": ("generate_forest", (150, 8, 479), 1, 4, "SPLIT_FOREST",
              {"active_cols": 300}),
    "deep15": ("generate_forest", (30, 15, 16), 1, 5, "SPLIT_FOREST", {}),
    "deep15_sign": ("generate_forest", (30, 15, 100), 1, 14, "SPLIT_FOREST", {}),
    "mixed90_deep": ("generate_mixed_depth_forest", (60, 13, 90), 2, 13,
                     "DEPTH_BUCKETED", {}),
}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def profile_kernels(fn, calls: int) -> dict:
    """The CUDA kernels ``calls`` runs of ``fn`` launch, per call: name ->
    [count, device us]; empty if the profiler records no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kernels.setdefault(e.name[:80], [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    return {n: [c / calls, us / calls] for n, (c, us) in kernels.items()}


def wrapper_launch_us(device) -> float:
    """µs a launch of LAUNCHES eager launches of kernel C through its ctypes
    wrapper (``CudaKernel.launch``) take, back to back on a one-tree forest's
    32 rows, between two events: the card runs them faster than the host
    issues them. The kernel's launch count is as it was before."""
    from tahoe_tpu_torch import GpuLimits
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops.fold_kernel import (
        FOLD_KERNELS, fold_c_table, fold_launch, fold_margins_cuda, fold_tables)
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.utils.profiling import cuda_median_ms

    tiny = synthetic.generate_forest(1, 1, 2, seed=5)
    tt = fold_tables(tiny, device=device)
    tx = canonicalize_rows(synthetic.generate_data(32, 2, seed=6), tiny.missing,
                           device=device, col_index=tt.col_index,
                           dual=tt.form == "dual")
    tl = fold_launch(tt.width, tt.depth, 1, GpuLimits.for_device(device))
    tc = fold_c_table(tt)
    kernel = FOLD_KERNELS[tt.form]
    count = kernel.launches

    def launches():
        for _ in range(LAUNCHES):
            fold_margins_cuda(tx, tt, tc, tl)

    us = cuda_median_ms(launches, warmup=1, iters=5) * 1e3 / LAUNCHES
    kernel.launches = count
    return us


def run(device, reps: int = 5, path: str = "svhn") -> dict:
    import torch

    import tahoe_tpu_torch
    from tahoe_tpu_torch import Forest, Strategy
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops import _build
    from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
    from tahoe_tpu_torch.ops.rank_transform import rank_planes_cuda
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.utils.profiling import cuda_device_ms, cuda_median_ms

    _build.build()
    gen, shape, forest_seed, data_seed, strategy_name, kw = PATHS[path]
    strategy = Strategy[strategy_name]
    f = Forest(getattr(synthetic, gen)(*shape, seed=forest_seed, **kw),
               device=device)
    rows = torch.as_tensor(synthetic.generate_data(
        ROWS, shape[2], missing_prob=0.02, seed=data_seed), device=device)
    eng = f.engine(strategy)
    subs = getattr(eng, "sub", [eng])  # DEPTH_BUCKETED's engines, a bucket each
    x = subs[0].canonicalize(rows)

    def predict():
        return f.predict(rows, strategy)

    def kernels():
        return [e.margins_rows(x) for e in subs]

    susy = synthetic.susy_class_forest(seed=0)
    rt = RankFoldEngine(susy, device=device).tables
    sx = canonicalize_rows(synthetic.generate_data(ROWS, 18, missing_prob=0.02, seed=1),
                           susy.missing, device=device, col_index=rt.col_index)

    def host_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict()
        return (time.perf_counter() - t0) * 1e3

    def stream_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STREAM_CALLS):
            predict()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STREAM_CALLS

    rounds = []
    for _ in range(reps):
        rounds.append({
            "e2e_ms": cuda_median_ms(predict, iters=ITERS),
            "kernel_ms": cuda_median_ms(kernels, iters=ITERS),
            "kernel_device_ms": [cuda_device_ms(lambda e=e: e.margins_rows(x))
                                 for e in subs],
            "host_ms": statistics.median(host_ms() for _ in range(ITERS)),
            "stream_ms": stream_ms(),
            "device_ms": cuda_device_ms(predict),
            "launch_us": wrapper_launch_us(device),
            "kernel_a_ms": cuda_median_ms(
                lambda: rank_planes_cuda(sx, rt.thresholds, rt.counts), iters=ITERS),
        })
    out = {"path": path, "package": tahoe_tpu_torch.__file__, "card": card_line(),
           "torch": torch.__version__, "rows": ROWS,
           "kernels": [e.kernel.symbol for e in subs],
           "launches": [str(e.launch) for e in subs],
           "col_index": subs[0].tables.col_index is not None, "rounds": rounds}
    for key in rounds[0]:
        vals = [r[key] for r in rounds]
        out[f"median_{key}"] = ([statistics.median(v) for v in zip(*vals)]
                                if isinstance(vals[0], list) else statistics.median(vals))
    out["predict_kernels"] = profile_kernels(predict, PROFILED_CALLS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tag", default="")
    ap.add_argument("--path", nargs="+", choices=sorted(PATHS), default=["svhn"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    for path in args.path:
        res = run(torch.device("cuda", 0), args.reps, path)
        print(json.dumps({"tag": args.tag, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
