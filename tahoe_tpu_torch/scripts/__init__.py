"""Probes of the port's kernels on the card, each run as

    python -m tahoe_tpu_torch.scripts.<name>

and each printing one JSON line: int8_cast_probe (are in-kernel int8
products exact, by __dp4a and by the tensor cores' mma), overhead_bench
(kernel B's launch and staging alone, then with its walk's record loads,
and the given paths' own cost)
and unit_bench (kernel B's whole visit without the walk's dependence, and
its dependent walk without the record loads; the int8 tensor-core rate of
one library call as a yardstick). Without a CUDA device each exits 2 and
prints no result. ``chip_smoke.py`` runs their ``run`` functions in-process.
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


def walk_parts(eng, modes, rows, rounds: int = 5) -> dict:
    """Kernel B and the walk probe's ``modes`` (ops/probes.py) on ``eng``'s
    tables and SUSY-class rows (seed 1), at each row count of ``rows``, the
    path modes on the real walks (``walk_paths``): each mode held to its
    plain version, and all timed by device time
    (``cuda_device_ms``: a probe mode is shorter than the host's time to
    issue it) in the same alternating rounds as kernel B; each mode's share
    of kernel B's time."""
    import torch

    from tahoe_tpu_torch.ops.probes import walk_probe_cuda, walk_probe_plain
    from tahoe_tpu_torch.ops.rank_kernel import rank_margins_cuda, walk_paths
    from tahoe_tpu_torch.utils.profiling import alternating, cuda_median_ms

    t = eng.tables
    out = {}
    for n in rows:
        planes = eng.transform(susy_rows(n, seed=1))
        paths = walk_paths(planes, t.records, t.depth)
        fns = {"rank_fold": lambda p=planes: rank_margins_cuda(
            p, t.records, t.leaf, t.depth)}
        for mode in modes:
            fns[mode] = lambda p=planes, m=mode: walk_probe_cuda(
                p, t.records, t.leaf, t.depth, m, paths)
        times = alternating(fns, rounds=rounds)
        res = {"rank_fold_ms": times["rank_fold"][0],
               "rank_fold_rounds_ms": times["rank_fold"][1]}
        for mode in modes:
            got = fns[mode]()
            plain = walk_probe_plain(planes, t.records, t.leaf, t.depth, mode,
                                     paths)
            res[mode] = {
                "exact": bool(torch.equal(got, plain)),
                "max_abs_err": int((got.long() - plain.long()).abs().max()),
                "ms": times[mode][0], "rounds_ms": times[mode][1],
                "plain_ms": cuda_median_ms(
                    lambda p=planes, m=mode: walk_probe_plain(
                        p, t.records, t.leaf, t.depth, m, paths),
                    warmup=1, iters=3),
                "share_of_rank_fold": times[mode][0] / times["rank_fold"][0],
            }
        out[str(n)] = res
    return out
