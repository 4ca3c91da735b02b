"""Probe: kernel B's launch and staging alone, then with its walk's record
loads, and the cost of the path words those loads are given.

    python -m tahoe_tpu_torch.scripts.overhead_bench

The H100 counterpart of scripts/overhead_bench.py's ``noop_margins(False)``
(a no-op body on the rank kernel's grid) and ``noop_margins(True)`` (the
same grid streaming the tables). On the SUSY-class forest (500 trees, depth
8, 18 features, 2% missing) at 16,384 and 65,536 rows, on kernel B's own
launch (a thread a row, its block, shared memory and row staging;
csrc/probes.cu ``tahoe_probe_overhead``):

- ``noop``: kernel B's staging, then each thread writes the sum of its
  staged row: the launch, the staging and the write, with no walk;
- ``stream``: the same, plus the D record loads a (row, tree) that kernel B
  makes, kRankTrees trees in flight, at the same addresses: each walk's
  leaf is given in advance (ops/rank_kernel.py ``walk_paths``), so no
  address waits on a condition, and all D x kRankTrees loads of a group of
  trees are issued before any is used: the walk's global loads alone;
- ``paths``: ``noop`` plus the given leaves alone (the path words read as
  ``stream`` and ``unit_bench``'s ``dot`` read them, no record and no leaf
  loaded): what the path words, which kernel B does not read, cost those
  two modes, paths - noop, timed alone.

Each is held to its plain version exactly and timed by device time beside
kernel B in alternating rounds (``walk_parts``), with its share of kernel
B's time. At 16,384 rows a block of 256 rows leaves 64 blocks for 132 SMs:
the occupancy the walk then has. Prints one JSON line.
"""
from __future__ import annotations

import sys

from tahoe_tpu_torch.scripts import main, susy_rank_engine, walk_parts

ROWS = (16384, 65536)


def run(device, rows=ROWS) -> dict:
    import torch

    from tahoe_tpu_torch.ops.probes import OVERHEAD_MODES

    res = walk_parts(susy_rank_engine(device), OVERHEAD_MODES, rows)
    return {"card": torch.cuda.get_device_name(device), "rows": res,
            "all_exact": all(r[m]["exact"] for r in res.values()
                             for m in OVERHEAD_MODES)}


if __name__ == "__main__":
    sys.exit(main(run))
