"""Probe: kernel B's visit without the walk's dependence, its dependent walk
without the record loads, and the int8 tensor-core rate.

    python -m tahoe_tpu_torch.scripts.unit_bench

The H100 counterpart of scripts/unit_bench.py's ``variant_margins``
("matmul": the level products without the selects; "fold": the selects
without the products) and its MXU-rate chains. On the SUSY-class forest at
16,384 and 65,536 rows, on kernel B's own launch (csrc/probes.cu
``tahoe_probe_rank_parts``):

- ``dot``: kernel B's record loads on the real walk's path given in
  advance, as the ``stream`` mode of overhead_bench, and kernel B's own
  visit body on each (the shared read at the record's lane, diff and
  diff >= 0), all of a group's loads issued before any is used: the whole
  visit without the dependence. Against kernel B, what the dependence
  costs;
- ``descent``: kernel B's dependent walk n += (1 + cond) << d over the
  staged row, kRankTrees chains in flight, each node's lane and k hashed
  from (tree, node) with no record loaded, then the leaf: the walk without
  its global loads. Against kernel B, what the load in the chain costs.

Each is held to its plain version exactly and timed by device time beside
kernel B in alternating rounds (``walk_parts``), with its share of kernel
B's time; the fused kernel (CUDA events) beside them at 65,536 rows. The
yardstick for the int8 tensor-core rate is one library call,
torch._int_mm, at M = 1024, K = 128, N = 32768 and at K = 2048, N = 8192
(scripts/unit_bench.py:89-119), with B row-major and column-major; no
engine of the port calls it. Prints one JSON line.
"""
from __future__ import annotations

import sys

from tahoe_tpu_torch.scripts import main, susy_rank_engine, susy_rows, walk_parts

ROWS = (16384, 65536)
INT_MM_SHAPES = ((1024, 128, 32768), (1024, 2048, 8192))


def run(device, rows=ROWS) -> dict:
    import numpy as np
    import torch

    from tahoe_tpu_torch.ops.probes import RANK_PARTS_MODES
    from tahoe_tpu_torch.ops.rank_kernel import rank_margins_fused_cuda
    from tahoe_tpu_torch.utils.profiling import cuda_median_ms

    eng = susy_rank_engine(device, fuse_transform=True)
    t = eng.tables
    x = t.rows(susy_rows(max(rows), seed=1), eng.raw_missing)
    res = walk_parts(eng, RANK_PARTS_MODES, rows)
    out = {"card": torch.cuda.get_device_name(device), "rows": res,
           "rank_fused_rows": max(rows),
           "rank_fused_ms": cuda_median_ms(lambda: rank_margins_fused_cuda(
               x, t.thresholds, t.counts, t.fused_records, t.leaf, t.depth))}
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
    out["all_exact"] = all(r[m]["exact"] for r in res.values()
                           for m in RANK_PARTS_MODES)
    return out


if __name__ == "__main__":
    sys.exit(main(run))
