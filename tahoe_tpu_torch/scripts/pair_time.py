"""Probe: strategies on one forest timed in the same interleaved rounds,
by event pairs and by device time.

    python -m tahoe_tpu_torch.scripts.pair_time [--family NAME ...]
        [--rows N] [--rounds 5] [--strategies VMEM_FOREST SPLIT_FOREST]

The sibling of path_time.py for the enumeration's pairs: each family is
scripts/run_sweep.py's (``family_spec``, its rows from ``generate_data``
with the sweep's seed, at the family's own row count or ``--rows``), and
each strategy's engine is built once through ``Forest``. Every round takes
the engines in turn and gives, per strategy:

- ``slope_ms``: the enumeration's own reading (engine/autotune.py): one
  predict by the chained slope over the engine's ``predict_k``
  (utils/profiling.slope_time), with the chains the enumeration sizes;
- ``event_ms``: the reading of earlier enumerations: the median of a round
  of event pairs around each predict (a replay of its CUDA graph,
  ops/graphed.py), as many calls as fill ``autotune.ROUND_S``, the host's
  issue time included;
- ``device_ms``: the same predict by device time (``cuda_device_ms``, 20
  calls in a CUDA graph, into which the graphed predict records its
  kernels inline): no host issue time;
- ``kernel_device_ms``: the engine's kernel alone on canonicalized rows.

Beside them each engine's launch (kernel, rows a block, trees a tile,
shared bytes), whether kernel C batches its block loads (one block an SM),
and the registers a thread of that kernel instance. VMEM_FOREST and
SPLIT_FOREST run one kernel on one table where the forest fits one tile
(gisette, stumps, ijcnn): there the two device times say whether a gap
between their slope or event times is the card's or the host's. Each
engine is warmed up (its graphs captured) before the rounds, so no capture
falls in a timed call. Prints one JSON line a family; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

FAMILIES = ["gisette_like", "stumps_like", "ijcnn_like"]
STRATEGIES = ["VMEM_FOREST", "SPLIT_FOREST"]


def run(device, family: str, rows: int | None = None, rounds: int = 5,
        strategies=tuple(STRATEGIES)) -> dict:
    import torch

    from tahoe_tpu_torch import Forest, Strategy
    from tahoe_tpu_torch.engine import autotune
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops import _build
    from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine, FoldLaunch
    from tahoe_tpu_torch.perf_model.model import fold_batches, register_query
    from tahoe_tpu_torch.scripts.run_sweep import card_line, family_spec, shape_by_name
    from tahoe_tpu_torch.utils.profiling import (
        cuda_device_ms, cuda_median_ms, slope_time)

    _build.build()
    shape = shape_by_name(family)
    n = rows or shape[4]
    f = Forest(family_spec(shape), device=device)
    x = torch.as_tensor(synthetic.generate_data(n, shape[3], missing_prob=shape[5],
                                                seed=2), device=device)
    engines, calls = {}, {}
    for name in strategies:
        eng = f.engine(Strategy[name])

        def predict(e=eng):
            return e.predict(x)

        def run_k(k, e=eng):
            return e.predict_k(x, k)

        engines[name] = eng
        calls[name] = (predict, run_k, *autotune.plan_timing(
            predict, run_k, device, autotune.WARMUP_EPOCHS,
            autotune.TIMED_EPOCHS))
    per = {name: {"slope_ms": [], "event_ms": [], "device_ms": [],
                  "kernel_device_ms": []}
           for name in strategies}
    for _ in range(rounds):
        for name, (predict, run_k, k1, k2, iters) in calls.items():
            eng = engines[name]
            per[name]["slope_ms"].append(
                slope_time(run_k, k1, k2, device=device) * 1e3)
            per[name]["event_ms"].append(cuda_median_ms(predict, warmup=0,
                                                        iters=iters))
            per[name]["device_ms"].append(cuda_device_ms(predict))
            if isinstance(eng, FoldKernelEngine):
                canon = eng.canonicalize(x)
                per[name]["kernel_device_ms"].append(
                    cuda_device_ms(lambda e=eng, c=canon: e.margins_rows(c)))
    out = {"family": family, "rows": n, "card": card_line(),
           "torch": torch.__version__, "strategies": {}}
    for name, eng in engines.items():
        rec = {k: {"median": statistics.median(v), "rounds": v}
               for k, v in per[name].items() if v}
        if isinstance(eng, FoldKernelEngine):
            launch = eng.launch
            batch = isinstance(launch, FoldLaunch) and fold_batches(launch.smem_bytes)
            rec.update(kernel=eng.kernel.symbol, launch=str(launch),
                       batched_loads=batch,
                       registers=_build.registers(
                           *register_query(eng.tables.form, launch)))
        out["strategies"][name] = rec
    names = list(per)
    if len(names) == 2:
        a, b = names
        for key in ("slope_ms", "event_ms", "device_ms", "kernel_device_ms"):
            if per[a][key] and per[b][key]:
                out[f"{key}_ratio"] = (statistics.median(per[a][key])
                                       / statistics.median(per[b][key]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", nargs="+", default=FAMILIES)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--strategies", nargs="+", default=STRATEGIES)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    for family in args.family:
        res = run(torch.device("cuda", 0), family, args.rows, args.rounds,
                  tuple(args.strategies))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
