"""Probe: one facade path's time against its kernel's, and the host's part.

    python -m tahoe_tpu_torch.scripts.path_time [--reps 5] [--tag NAME]

The path is svhn-class (200 trees, depth 6, 100 features; scripts/run_sweep.py
``svhn_like``) through ``Forest.predict(rows, Strategy.SPLIT_FOREST)`` on
65,536 rows already on the card: chip_smoke.py's phase 6, its shortest
kernel path (kernel C's sign form, ~0.1 ms). Each of ``--reps`` rounds gives:

- ``e2e_ms``: median of 20 predicts, each between two CUDA events
  (chip_smoke.py's us/sample times 65,536 / 1,000);
- ``kernel_ms``: median of 20 calls of the engine's kernel alone on the
  canonicalized rows;
- ``host_ms``: median host wall time to issue one predict on an idle card
  (synchronized before the call, not after it);
- ``stream_ms``: wall time per predict of 200 issued back to back and one
  synchronize: the larger of host and device time per call;
- ``kernel_a_ms``: kernel A at SUSY-class shapes, median of 20 (phase 3's
  check).

Then the CUDA kernels of one predict, by name, count and device time, from
torch.profiler. It imports only what chip_smoke.py's phases 3 and 6 import,
so one copy of it times two trees of the port on one card:
``PYTHONPATH=<tree> python tahoe_tpu_torch/scripts/path_time.py``. Prints
one JSON line; exits 2 without a card.
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
PROFILED_CALLS = 10


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


def run(device, reps: int = 5) -> dict:
    import torch

    import tahoe_tpu_torch
    from tahoe_tpu_torch import Forest, Strategy
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops import _build
    from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
    from tahoe_tpu_torch.ops.rank_transform import rank_planes_cuda
    from tahoe_tpu_torch.ops.rows import canonicalize_rows
    from tahoe_tpu_torch.utils.profiling import cuda_median_ms

    _build.build()
    f = Forest(synthetic.generate_forest(200, 6, 100, seed=1), device=device)
    rows = torch.as_tensor(
        synthetic.generate_data(ROWS, 100, missing_prob=0.02, seed=10), device=device)
    eng = f.engine(Strategy.SPLIT_FOREST)
    x = eng.canonicalize(rows)

    def predict():
        return f.predict(rows, Strategy.SPLIT_FOREST)

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
            "kernel_ms": cuda_median_ms(lambda: eng.margins_rows(x), iters=ITERS),
            "host_ms": statistics.median(host_ms() for _ in range(ITERS)),
            "stream_ms": stream_ms(),
            "kernel_a_ms": cuda_median_ms(
                lambda: rank_planes_cuda(sx, rt.thresholds, rt.counts), iters=ITERS),
        })
    out = {"package": tahoe_tpu_torch.__file__, "card": card_line(),
           "torch": torch.__version__, "rows": ROWS,
           "kernel": eng.kernel.symbol, "launch": str(eng.launch),
           "col_index": eng.tables.col_index is not None, "rounds": rounds}
    for key in rounds[0]:
        out[f"median_{key}"] = statistics.median(r[key] for r in rounds)
    out["predict_kernels"] = profile_kernels(predict, PROFILED_CALLS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    res = run(torch.device("cuda", 0), args.reps)
    print(json.dumps({"tag": args.tag, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
