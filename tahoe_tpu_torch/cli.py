"""CLI driver: ``python -m tahoe_tpu_torch.cli MODEL DATA [--device cuda]``.

The port of tahoe_tpu/cli.py, the reference binary's run protocol and
output contract (main.cu:7-96): load model + data -> calibrate the card ->
the analytical model predicts a strategy -> CPU oracle -> exhaustive
strategy enumeration with per-strategy latency and correctness verdicts ->
report whether the model predicted the measured best, and the speedups over
the baselines.

The baseline is the HBM_DIRECT gather engine, the role the FIL-style
dense_forest plays in the reference (BaseTahoeTest.h:549-596). Every
strategy runs in this process on ``--device``; there is no subprocess, so
the JAX CLI's ``--no-isolation`` has no counterpart.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None, report: dict | None = None) -> int:
    """Run the protocol; with ``report``, also leave in it the model's pick
    (``predicted``), its cost table (``costs``) and the enumeration's
    results (``results``)."""
    p = argparse.ArgumentParser(
        prog="tahoe_tpu_torch",
        description="decision-forest inference engine on PyTorch and CUDA",
    )
    p.add_argument("model", help="model file (reference text format)")
    p.add_argument("data", help="data file (reference text format)")
    p.add_argument("--epochs", type=int, default=50,
                   help="timed epochs per strategy and round (reference: 50)")
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--strategies", nargs="*", default=None,
                   help="subset of strategy names to enumerate")
    p.add_argument("--no-calibrate", action="store_true",
                   help="use the calibration measured on an H100")
    p.add_argument("--tune-tiles", action="store_true",
                   help="also try each strategy's run-time variants")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    from tahoe_tpu_torch.config import GpuLimits, Strategy, resolve_device
    from tahoe_tpu_torch.engine import autotune
    from tahoe_tpu_torch.engine.forest import peek_data_header
    from tahoe_tpu_torch.forest import io
    from tahoe_tpu_torch.perf_model import calibrate, model

    device = resolve_device(args.device)
    print(f"Model: {args.model} , Data: {args.data}")

    t0 = time.perf_counter()
    _, num_cols, missing = peek_data_header(args.data)
    spec = io.load_model(args.model, num_cols=num_cols, missing=missing)
    data, _ = io.load_data(args.data)
    print(
        f"Loaded forest: {spec.num_trees} trees, depth {spec.depth}, "
        f"{spec.num_cols} features; data: {data.shape[0]} rows "
        f"({time.perf_counter() - t0:.2f}s)"
    )

    # the card's calibration (bandwidthTest analog), in this process
    if args.no_calibrate:
        cal = calibrate.Calibration.default()
    else:
        cal = calibrate.measure(device)
    print(f"Calibration: {cal.summary()}")

    predicted, costs = model.choose_strategy(
        spec, data.shape[0], cal, GpuLimits.for_device(device))
    print(f"Performance model chooses #{predicted.strategy_number} strategy "
          f"({predicted.name}).")

    strategies = (
        [Strategy[s] for s in args.strategies] if args.strategies else tuple(Strategy)
    )
    results = autotune.enumerate_strategies(
        spec, data,
        device=device,
        strategies=strategies,
        warmup=args.warmup, epochs=args.epochs,
        tune_tiles=args.tune_tiles,
    )
    if report is not None:
        report.update(predicted=predicted, costs=costs, results=results)

    best = autotune.best_strategy(results)
    if best is None:
        print("No strategy produced correct results — nothing to report.")
        return 1

    if predicted == best:
        print("Performance model predicts correctly")
    else:
        print(f"Performance model predicts incorrectly "
              f"(predicted #{predicted.strategy_number} {predicted.name}, "
              f"measured best #{best.strategy_number} {best.name})")

    winner = results[best]
    # The FIL analog is the best non-adaptive dense engine, the f32 fold
    # tiers (VMEM_FOREST/SPLIT_FOREST), which traverse the same float tables
    # a FIL-style kernel would; the HBM gather tier is the naive one
    # (tahoe_tpu/cli.py:100-106).
    fil_tiers = [
        results[s] for s in (Strategy.VMEM_FOREST, Strategy.SPLIT_FOREST)
        if s in results and results[s].ran and results[s].correct
    ]
    if fil_tiers and best not in (Strategy.VMEM_FOREST, Strategy.SPLIT_FOREST):
        fil = min(fil_tiers, key=lambda r: r.us_per_sample)
        print(f"tahoe-tpu brings {fil.us_per_sample / winner.us_per_sample:.2f}x "
              f"speedup over the FIL-analog f32 dense baseline "
              f"({winner.us_per_sample:.6f} vs {fil.us_per_sample:.6f} "
              f"us/sample, baseline #{fil.strategy.strategy_number} "
              f"{fil.strategy.name}).")
    baseline = results.get(Strategy.HBM_DIRECT)
    if baseline is not None and baseline.ran and best != Strategy.HBM_DIRECT:
        speedup = baseline.us_per_sample / winner.us_per_sample
        print(f"({speedup:.2f}x over the naive direct-HBM gather tier, "
              f"{baseline.us_per_sample:.6f} us/sample.)")
    print(f"Best strategy: #{best.strategy_number} {best.name} at "
          f"{winner.us_per_sample:.6f} us/sample.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
