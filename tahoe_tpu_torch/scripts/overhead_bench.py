"""Probe: the column walk's launch geometry and loads, without its work.

    python -m tahoe_tpu_torch.scripts.overhead_bench

The H100 counterpart of scripts/overhead_bench.py's ``noop_margins(False)``
and ``noop_margins(True)``. On the SUSY-class forest (500 trees, depth 8,
18 features, 2% missing) at 16,384 and 65,536 rows, with the launch of
the column walk kernel B ran before it read node records (a warp a row,
256 threads; csrc/probes.cu ``tahoe_probe_overhead``):

- ``noop``: each warp reads its row's planes and writes their sum: the
  launch, the rows and the write;
- ``stream``: the same, plus one 4-byte word a lane of every column the
  walk reads along the fixed path j = 0 (node 2^d - 1 of each level of each
  tree), with no __dp4a and no per-node shuffle: the loads' own cost,
  from L1/L2, as every row reads the same columns.

Each is held to its plain version exactly and timed (median of 20 calls,
CUDA events) beside kernel B (over its records) at the same rows. Prints
one JSON line.
"""
from __future__ import annotations

import sys

from tahoe_tpu_torch.scripts import main, susy_rank_engine, susy_rows

ROWS = (16384, 65536)


def run(device, rows=ROWS) -> dict:
    import torch

    from tahoe_tpu_torch.ops.probes import (
        OVERHEAD_MODES, overhead_probe_cuda, overhead_probe_plain)
    from tahoe_tpu_torch.ops.rank_kernel import rank_margins_cuda
    from tahoe_tpu_torch.utils.profiling import cuda_median_ms

    eng = susy_rank_engine(device)
    t = eng.tables
    out = {"card": torch.cuda.get_device_name(device), "rows": {}}
    for n in rows:
        planes = eng.transform(susy_rows(n, seed=1))
        res = {"rank_fold_ms": cuda_median_ms(
            lambda: rank_margins_cuda(planes, t.records, t.leaf, t.depth))}
        for mode in OVERHEAD_MODES:
            got = overhead_probe_cuda(planes, t.mats, t.depth, mode)
            plain = overhead_probe_plain(planes, t.mats, t.depth, mode)
            res[mode] = {
                "exact": bool(torch.equal(got, plain)),
                "max_abs_err": int((got.long() - plain.long()).abs().max()),
                "ms": cuda_median_ms(
                    lambda: overhead_probe_cuda(planes, t.mats, t.depth, mode)),
                "plain_ms": cuda_median_ms(
                    lambda: overhead_probe_plain(planes, t.mats, t.depth, mode),
                    warmup=1, iters=5),
            }
            res[mode]["share_of_rank_fold"] = res[mode]["ms"] / res["rank_fold_ms"]
        out["rows"][str(n)] = res
    out["all_exact"] = all(r[m]["exact"] for r in out["rows"].values()
                           for m in OVERHEAD_MODES)
    return out


if __name__ == "__main__":
    sys.exit(main(run))
