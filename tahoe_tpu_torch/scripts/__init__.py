"""Probes of the port's kernels on the card, each run as

    python -m tahoe_tpu_torch.scripts.<name>

and each printing one JSON line: int8_cast_probe (are in-kernel int8
products exact, by __dp4a and by the tensor cores' mma), overhead_bench
(kernel B's launch geometry and table loads alone) and unit_bench (kernel
B's dot and descent apart, and the int8 tensor-core rate of one library
call as a yardstick). Without a CUDA device each exits 2 and prints no
result. ``chip_smoke.py`` runs their ``run`` functions in-process.
"""
from __future__ import annotations

import sys

SUSY_MISSING = 0.02  # the SUSY-class rows' missing share (chip_smoke.py)


def main(run) -> int:
    """Run ``run(device)`` on the first card and print its JSON line; exit 2
    without a card."""
    import json

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(json.dumps(run(torch.device("cuda", 0))), flush=True)
    return 0


def susy_rank_engine(device, **kw):
    """The SUSY-class forest (500 trees, depth 8, 18 features, seed 0) on the
    rank engine."""
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine

    return RankFoldEngine(synthetic.susy_class_forest(seed=0), device=device,
                          **kw)


def susy_rows(rows: int, seed: int):
    from tahoe_tpu_torch.forest import synthetic

    return synthetic.generate_data(rows, 18, missing_prob=SUSY_MISSING, seed=seed)
