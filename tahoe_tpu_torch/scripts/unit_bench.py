"""Probe: the column walk's dot and descent apart, and the int8 tensor-core
rate.

    python -m tahoe_tpu_torch.scripts.unit_bench

The H100 counterpart of scripts/unit_bench.py's ``variant_margins`` and its
MXU-rate chains. On the SUSY-class forest at 65,536 rows, with the launch
of the column walk kernel B ran before it read node records and four trees
in flight (csrc/probes.cu ``tahoe_probe_rank_parts``):

- ``dot``: every visited column read whole, __dp4a and the warp sum, along
  a root-to-leaf path hashed from (row, tree) that does not wait on the
  conditions: the walk without its dependence;
- ``descent``: the dependent walk j += cond << d, cond a hash of the row's
  plane-word sum, the tree, the level and j, no column read, then the leaf:
  the walk without its loads and dots.

Each is held to its plain version exactly and timed (median of 20 calls,
CUDA events) beside kernel B (over its records) and the fused kernel on
the same rows. The yardstick for the int8 tensor-core rate is one library
call, torch._int_mm, at M = 1024, K = 128, N = 32768 and at K = 2048,
N = 8192 (scripts/unit_bench.py:89-119), with B row-major and
column-major; no engine of the port calls it. Prints one JSON line.
"""
from __future__ import annotations

import sys

from tahoe_tpu_torch.scripts import main, susy_rank_engine, susy_rows

ROWS = 65536
INT_MM_SHAPES = ((1024, 128, 32768), (1024, 2048, 8192))


def run(device, rows=ROWS) -> dict:
    import numpy as np
    import torch

    from tahoe_tpu_torch.ops.probes import (
        RANK_PARTS_MODES, rank_parts_probe_cuda, rank_parts_probe_plain)
    from tahoe_tpu_torch.ops.rank_kernel import (
        rank_margins_cuda, rank_margins_fused_cuda)
    from tahoe_tpu_torch.utils.profiling import cuda_median_ms

    eng = susy_rank_engine(device, fuse_transform=True)
    t = eng.tables
    data = susy_rows(rows, seed=1)
    x = t.rows(data, eng.raw_missing)
    planes = eng.transform(data)
    out = {"card": torch.cuda.get_device_name(device), "rows": rows,
           "rank_fold_ms": cuda_median_ms(
               lambda: rank_margins_cuda(planes, t.records, t.leaf, t.depth)),
           "rank_fused_ms": cuda_median_ms(lambda: rank_margins_fused_cuda(
               x, t.thresholds, t.counts, t.fused_records, t.leaf, t.depth))}
    for mode in RANK_PARTS_MODES:
        got = rank_parts_probe_cuda(planes, t.mats, t.leaf, t.depth, mode)
        plain = rank_parts_probe_plain(planes, t.mats, t.leaf, t.depth, mode)
        out[mode] = {
            "exact": bool(torch.equal(got, plain)),
            "max_abs_err": int((got.long() - plain.long()).abs().max()),
            "ms": cuda_median_ms(lambda: rank_parts_probe_cuda(
                planes, t.mats, t.leaf, t.depth, mode)),
            "plain_ms": cuda_median_ms(lambda: rank_parts_probe_plain(
                planes, t.mats, t.leaf, t.depth, mode), warmup=1, iters=3),
        }
        out[mode]["share_of_rank_fold"] = out[mode]["ms"] / out["rank_fold_ms"]
    rng = np.random.default_rng(0)
    for m, k, n in INT_MM_SHAPES:
        a = torch.as_tensor(rng.integers(-3, 3, (m, k)).astype(np.int8), device=device)
        b = torch.as_tensor(rng.integers(-3, 3, (k, n)).astype(np.int8), device=device)
        # B row-major [k, n], and the same values column-major (the layout
        # cuBLASLt's int8 GEMM takes without a transpose)
        for layout, bb in (("row", b), ("col", b.t().contiguous().t())):
            ms = cuda_median_ms(lambda: torch._int_mm(a, bb))
            out[f"int_mm_{m}x{k}x{n}_{layout}"] = {
                "ms": ms, "tops": 2 * m * k * n / ms / 1e9}
    out["all_exact"] = all(out[m]["exact"] for m in RANK_PARTS_MODES)
    return out


if __name__ == "__main__":
    sys.exit(main(run))
