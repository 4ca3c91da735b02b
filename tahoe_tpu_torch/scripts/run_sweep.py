"""Dataset sweep over the synthetic families, on the port's CLI protocol.

    python -m tahoe_tpu_torch.scripts.run_sweep [--only a,b] [--out f.jsonl]
        [--epochs N] [--data-dir DIR] [--device cuda|cpu] [--strategies ...]

The port's copy of scripts/run_sweep.py (the reference's
run_all_15_examples.sh analog): ``SHAPES`` (its 25 families) and
``family_spec`` (:88-104), built on the port's forest/synthetic.py and
forest/train.py, bit-equal to the original's forests. Per family: calibrate
once, let the model pick a strategy, enumerate every strategy in-process
against the oracle and append one JSON line: the pick, the measured best,
every strategy's µs/sample and band (the chained slope, as the JAX
package's enumeration times it: engine/autotune.py), one round of its
event pairs around each call (``event_us``, the reading of the sweeps
before the slope), its predicted cost (a predict of a chain,
perf_model/model.py ``CostBreakdown.chained``) and its build time, beside
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time

# Synthetic shape family: (name, trees, depth, cols, rows, missing_prob)
# (optionally + {"active": N} for wide datasets whose trained forests
# reference only an informative subset), as in scripts/run_sweep.py:40-85:
# the reference's 15 dataset shapes (run_all_15_examples.sh:48-64) plus
# stress families.
SHAPES = [
    ("susy_like",    500, 8, 18,  10000, 0.02),
    ("higgs_like",   300, 8, 28,  10000, 0.02),
    ("hepmass_like", 400, 8, 28,  8000,  0.00),
    ("svhn_like",    200, 6, 100, 5000,  0.00),
    ("ijcnn_like",   100, 6, 22,  5000,  0.05),
    ("letter_like",  160, 7, 16,  4000,  0.00),
    ("covtype_like", 250, 9, 54,  6000,  0.00),
    ("year_like",    120, 7, 90,  4000,  0.01),
    ("hock_like",     300, 8, 30,   8000, 0.00),
    ("allstate_like", 250, 8, 130,  5000, 0.00),
    ("aloi_like",     200, 8, 128,  5000, 0.00),
    ("cup98_like",    150, 8, 479,  3000, 0.00, {"active": 300}),
    ("gisette_like",  100, 6, 5000, 1500, 0.00, {"active": 120}),
    ("phishing_like", 200, 7, 68,   6000, 0.00),
    ("deep12_like",  100, 12, 28, 4000,  0.01),
    ("deep14_like",  60,  14, 20, 2000,  0.00),
    ("deep13_like",  80,  13, 24, 3000,  0.00),
    ("cifar_like",   150, 7,  120, 3000, 0.00),
    ("mnist_like",   100, 6,  400, 2000, 0.00),
    ("stumps_like",  800, 3,  10, 20000, 0.05),
    ("deep15_like",  30,  15, 16, 1000,  0.00),
    # per-tree depths 6..12, stored complete at 12 (DEPTH_BUCKETED)
    ("trained_mix_like", 300, 12, 26, 4000, 0.01),
    # trained random forests (forest/train.py): early leaves throughout
    ("rf_trained_like", 300, 10, 24, 4000, 0.01),
    # trained and deep: SPARSE's pruned pool, or the deep kernel's dense
    # tables past the L2
    ("rf_deep16_like", 120, 16, 20, 1500, 0.00),
    ("rf_deep18_like", 200, 18, 24, 1500, 0.00),
]


def family_spec(shape, num_trees: int | None = None, seed: int = 1):
    """ForestSpec for one SHAPES entry, as scripts/run_sweep.py:88-104
    builds it (seeded generators, seed 1 there). ``num_trees`` replaces the
    entry's tree count (a cheaper forest of the same family)."""
    from tahoe_tpu_torch.forest import synthetic

    name, trees, depth, cols = shape[0], shape[1], shape[2], shape[3]
    trees = num_trees or trees
    extra = shape[6] if len(shape) > 6 else {}
    if name.startswith("trained_mix"):
        return synthetic.generate_mixed_depth_forest(trees, depth, cols, seed=seed)
    if name.startswith("rf_"):
        from tahoe_tpu_torch.forest.train import train_forest

        return train_forest(trees, depth, cols, rows=2048, seed=seed)
    return synthetic.generate_forest(trees, depth, cols, seed=seed,
                                     active_cols=extra.get("active"))


def shape_by_name(name: str):
    return next(s for s in SHAPES if s[0] == name)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, or why
    not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def sweep_record(label, spec, data, *, device, cal, epochs, warmup=2,
                 strategies=None) -> dict:
    """The CLI protocol on one data set: the model's pick, the enumeration,
    and the record of both."""
    import torch

    from tahoe_tpu_torch.config import GpuLimits, Strategy, resolve_device
    from tahoe_tpu_torch.engine import autotune
    from tahoe_tpu_torch.perf_model import model

    dev = resolve_device(device)
    limits = GpuLimits.for_device(dev)
    predicted, costs = model.choose_strategy(spec, data.shape[0], cal, limits)
    t0 = time.perf_counter()
    res = autotune.enumerate_strategies(spec, data, device=dev, warmup=warmup,
                                        epochs=epochs,
                                        strategies=strategies or tuple(Strategy))
    best = autotune.best_strategy(res)
    ranked = sorted((r for r in res.values() if r.ran and r.correct),
                    key=lambda r: r.us_per_sample)
    margin = (ranked[1].us_per_sample / ranked[0].us_per_sample - 1
              if len(ranked) > 1 else None)
    pred_r = res.get(predicted)
    within_5pct = bool(pred_r is not None and pred_r.ran and best is not None
                       and pred_r.us_per_sample <= res[best].us_per_sample * 1.05)
    return {
        "dataset": label,
        "trees": spec.num_trees,
        "depth": spec.depth,
        "cols": spec.num_cols,
        "rows": int(data.shape[0]),
        "predicted": predicted.name,
        "measured_best": best.name if best else None,
        "runner_up_margin": margin,
        "model_correct": bool(best == predicted),
        "model_within_5pct": bool(best == predicted) or within_5pct,
        # the sweep's rule: the pick is the best wherever the best beats its
        # runner-up by more than 5%
        "rule_met": bool(best == predicted) or (margin is not None
                                                and margin <= 0.05),
        "all_correct": all(r.correct for r in res.values() if r.ran),
        "strategies": {s.name: (r.us_per_sample if r.ran else None)
                       for s, r in res.items()},
        "bands": {s.name: r.us_band for s, r in res.items() if r.ran},
        "event_us": {s.name: r.event_us_per_sample for s, r in res.items()
                     if r.ran},
        "predicted_us": {s.name: (c.chained * 1e6 / data.shape[0] if c else None)
                         for s, c in costs.items()},
        "build_s": {s.name: r.build_s for s, r in res.items() if r.ran},
        "max_err": {s.name: r.max_err for s, r in res.items() if r.ran},
        "not_run": {s.name: (r.skipped_reason or r.error)
                    for s, r in res.items() if not r.ran},
        "wall_s": time.perf_counter() - t0,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card_line() if dev.type == "cuda" else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true", help="3 shapes")
    p.add_argument("--only", default=None,
                   help="comma-separated family names to run (subset of SHAPES)")
    p.add_argument("--data-dir", default=None,
                   help="directory with model_*.txt/data_*.txt pairs to sweep")
    p.add_argument("--out", default="sweep_results.jsonl")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-calibrate", action="store_true",
                   help="use Calibration.default()")
    p.add_argument("--strategies", nargs="*", default=None,
                   help="subset of strategy names to enumerate")
    args = p.parse_args(argv)

    from tahoe_tpu_torch.config import Strategy
    from tahoe_tpu_torch.engine.forest import peek_data_header
    from tahoe_tpu_torch.forest import io, synthetic
    from tahoe_tpu_torch.perf_model import calibrate

    strategies = (tuple(Strategy[s] for s in args.strategies)
                  if args.strategies else tuple(Strategy))
    cases = []
    if args.data_dir:
        for mp in sorted(glob.glob(os.path.join(args.data_dir, "model_*.txt"))):
            dp = mp.replace("model_", "data_")
            if os.path.exists(dp):
                cases.append(("file", mp, dp))
    else:
        shapes = SHAPES[:3] if args.quick else SHAPES
        if args.only:
            keep = set(args.only.split(","))
            unknown = keep - {s[0] for s in SHAPES}
            if unknown:
                p.error(f"unknown families: {sorted(unknown)}")
            shapes = [s for s in shapes if s[0] in keep]
        cases = [("synthetic", s[0], s) for s in shapes]

    cal = (calibrate.Calibration.default() if args.no_calibrate
           else calibrate.measure(args.device))
    print(f"Calibration: {cal.summary()}", flush=True)
    print(json.dumps({"calibration": dataclasses.asdict(cal)}), flush=True)

    results = []
    for kind, name, payload in cases:
        if kind == "file":
            _, cols, missing = peek_data_header(payload)
            spec = io.load_model(name, num_cols=cols, missing=missing)
            data, _ = io.load_data(payload)
            label = os.path.basename(name)
        else:
            spec = family_spec(payload)
            data = synthetic.generate_data(payload[4], payload[3],
                                           missing_prob=payload[5], seed=2)
            label = name
        print(f"=== {label}: {spec.num_trees} trees depth {spec.depth} "
              f"{spec.num_cols} cols, {data.shape[0]} rows", flush=True)
        rec = sweep_record(label, spec, data, device=args.device, cal=cal,
                           epochs=args.epochs, strategies=strategies)
        results.append(rec)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    n_ok = sum(r["all_correct"] for r in results)
    n_pred = sum(r["model_correct"] for r in results)
    print(f"\nSweep: {len(results)} datasets, {n_ok} fully correct, "
          f"model predicted best in {n_pred}/{len(results)}", flush=True)
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
