"""Headline benchmark of the port: SUSY-class per-sample latency on one card.

    python -m tahoe_tpu_torch.scripts.bench [--rows N] [--epochs N]
        [--warmup N] [--quick] [--device cuda|cpu]

The port's counterpart of bench.py (bench.py:39-180), printing its one JSON
line with the same keys. ``value`` is the best exact full-predict latency
on an arbitrary-threshold SUSY-class forest (500 trees, depth 8, 18
features; ``susy_class_forest(seed=0)``, rows from ``generate_data(...,
missing_prob=0.02, seed=1)``), against the reference's best published SUSY
strategy (0.120020 us/sample on its GPU, BASELINE.md); vs_baseline > 1
means faster. ``fold_kernel_us`` is SPLIT_FOREST on the kernel fold_plan
picks; ``rank_mxu_full_us`` the rank engine's full predict (kernel A inside
the call); ``rank_mxu_planes_us`` its traversal of planes encoded once
(the serving path, the analog of the reference timing device-resident
data, BaseTahoeTest.h:684-698).

Each of bench.py's keys is the median of three rounds of ``--epochs``
calls (after ``--warmup``) by utils/profiling.median_ms: on the card an
event pair around each call, the host's issue time included; its band is
the rounds' [min, max]. After them, each path again by bench.py's own
measure (bench.py:68-98): the median of three chained slopes
(utils/profiling.slope_time) over k1 = max(1, warmup) and k2 = k1 +
epochs serialized predicts (``predict_k``, ``predict_planes_k``), under
the keys ``*_slope_us`` and ``*_slope_band_us``. Exits 1 with bench.py's
error line when a path misses the oracle by more than 1e-3.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

REFERENCE_BEST_US = 0.120020  # Tahoe strategy 3 on SUSY, README.md:66-67
REFERENCE_FIL_US = 0.990169   # Tahoe's FIL-style dense baseline, README.md:58
PARITY_ATOL = 1e-3
ROUNDS = 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=None, help="65,536 (--quick 4,096)")
    p.add_argument("--epochs", type=int, default=None, help="24 (--quick 6)")
    p.add_argument("--warmup", type=int, default=None, help="3 (--quick 2)")
    p.add_argument("--quick", action="store_true",
                   help="small/fast defaults; a flag given explicitly wins")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for name, full, quick in (("rows", 65536, 4096), ("epochs", 24, 6),
                              ("warmup", 3, 2)):
        if getattr(args, name) is None:
            setattr(args, name, quick if args.quick else full)

    import numpy as np
    import torch

    from tahoe_tpu_torch.config import resolve_device
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops import oracle
    from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine
    from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
    from tahoe_tpu_torch.utils.profiling import median_ms, slope_time

    dev = resolve_device(args.device)
    forest = synthetic.susy_class_forest(seed=0)
    data = synthetic.generate_data(args.rows, 18, missing_prob=0.02, seed=1)
    want = oracle.predict(forest, data)
    rows = torch.as_tensor(data, device=dev)

    def median3(fn):
        """(median, min, max) us/sample over ROUNDS rounds, each the median
        of ``epochs`` calls, after ``warmup`` untimed calls."""
        for _ in range(args.warmup):
            fn()
        ts = sorted(median_ms(fn, dev, warmup=0, iters=args.epochs) * 1e3
                    / args.rows for _ in range(ROUNDS))
        return statistics.median(ts), ts[0], ts[-1]

    k1 = max(1, args.warmup)
    k2 = k1 + max(1, args.epochs)

    def slope3(run_k):
        """(median, min, max) us/sample of three chained slopes over k1 and
        k2 predicts: bench.py's median3."""
        ts = sorted(slope_time(run_k, k1, k2, device=dev) * 1e6 / args.rows
                    for _ in range(ROUNDS))
        return ts[1], ts[0], ts[-1]

    def err(pred):
        return float(np.abs(pred.cpu().numpy() - want).max())

    # primary: the f32 fold (SPLIT_FOREST), exact, no transform
    fold = FoldKernelEngine(forest, device=dev)
    us_fold, fold_lo, fold_hi = median3(lambda: fold.predict(rows))
    err_fold = err(fold.predict(rows))

    # secondary: the rank engine, full predict and planes encoded once
    rank = RankFoldEngine(forest, device=dev)
    us_rank, rank_lo, rank_hi = median3(lambda: rank.predict(rows))
    planes = rank.transform(rows)
    us_planes, pl_lo, pl_hi = median3(lambda: rank.predict_planes(planes))
    err_rank = err(rank.predict(rows))
    slopes = {
        "fold_kernel": slope3(lambda k: fold.predict_k(rows, k)),
        "rank_mxu_full": slope3(lambda k: rank.predict_k(rows, k)),
        "rank_mxu_planes": slope3(lambda k: rank.predict_planes_k(planes, k)),
    }

    if err_fold > PARITY_ATOL or err_rank > PARITY_ATOL:
        print(json.dumps({"metric": "SUSY-class per-sample latency",
                          "value": None, "unit": "us/sample",
                          "vs_baseline": 0.0,
                          "error": f"parity fold={err_fold} rank={err_rank}"}))
        return 1

    best = min(us_fold, us_rank)
    print(json.dumps({
        "metric": "SUSY-class (500 trees, depth 8, 18 feat) per-sample latency",
        "value": best,
        "unit": "us/sample",
        "vs_baseline": REFERENCE_BEST_US / best,
        "vs_reference_fil_baseline": REFERENCE_FIL_US / best,
        "fold_kernel_us": us_fold,
        "fold_band_us": [fold_lo, fold_hi],
        "rank_mxu_full_us": us_rank,
        "rank_band_us": [rank_lo, rank_hi],
        "rank_mxu_planes_us": us_planes,
        "planes_band_us": [pl_lo, pl_hi],
        "vs_baseline_serving": REFERENCE_BEST_US / us_planes,
        "max_err_vs_oracle": max(err_fold, err_rank),
        "rows": args.rows,
        "epochs": args.epochs,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        **{f"{path}_slope_us": us for path, (us, _, _) in slopes.items()},
        **{f"{path}_slope_band_us": [lo, hi]
           for path, (_, lo, hi) in slopes.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
