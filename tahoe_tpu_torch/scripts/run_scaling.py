"""Weak scaling of sharded inference, measured where the ranks exist, with
the model's prediction beside each point.

    python -m tahoe_tpu_torch.scripts.run_scaling [--device cuda|cpu]
        [--coordinator HOST:PORT --nprocs N --pid I] [--backend nccl|gloo]
        [--axis data|model] [--rows-per-device R] [--iters 20]

The port of scripts/run_scaling.py. One process a rank: on several hosts or
cards, start it once a rank with the same ``--coordinator`` and
``--nprocs`` and its own ``--pid``; alone, it is a group of one. For each
rank count c = 1, 2, 4, ... up to the group's size, a ``(c, 1)`` mesh
(``--axis data``) or ``(1, c)`` (``--axis model``) over the first c ranks:
each of its ranks predicts ``--rows-per-device`` rows of its own through
``predict_local`` on the SUSY-class forest (500 trees, depth 8, 18
features), held to the numpy oracle; the slowest rank's median call (CUDA
events on a card) gives the mesh's rows a second and its efficiency
against c ranks alone. Beside each point, perf_model/scaling.py's
prediction. The device is the one asked for (``cuda`` by default) and a
missing card raises: there is no fallback to the CPU. Prints one JSON line
a point and a summary line; exits 1 if a point is wrong.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--axis", choices=("data", "model"), default="data")
    ap.add_argument("--rows-per-device", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from tahoe_tpu_torch.config import ORACLE_ATOL, resolve_device
    from tahoe_tpu_torch.forest import synthetic
    from tahoe_tpu_torch.ops import oracle
    from tahoe_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from tahoe_tpu_torch.parallel.sharded import ShardedForestEngine
    from tahoe_tpu_torch.perf_model.scaling import predict_scaling
    from tahoe_tpu_torch.utils.profiling import median_ms

    dev = resolve_device(args.device)
    live = init_distributed(args.coordinator, args.nprocs, args.pid,
                            backend=args.backend, device=dev.type)
    world = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    forest = synthetic.susy_class_forest(seed=0)
    n = args.rows_per_device
    rows = synthetic.generate_data(n, 18, missing_prob=0.02, seed=100 + rank)
    want = oracle.predict(forest, rows)
    counts = [c for c in (1, 2, 4, 8, 16, 32, 64) if c <= world]
    points, base = [], None
    for c in counts:
        shape = (c, 1) if args.axis == "data" else (1, c)
        mesh = make_mesh(*shape, device=dev.type)
        ms, err = 0.0, 0.0
        if mesh is not None:
            eng = ShardedForestEngine(forest, mesh)
            x = torch.as_tensor(rows, device=mesh.device)
            err = float(np.abs(eng.predict_local(x).cpu().numpy() - want).max())
            ms = median_ms(lambda: eng.predict_local(x), mesh.device, iters=args.iters)
        # the slowest rank's time and the largest error, over every rank
        t = torch.tensor([ms, err], dtype=torch.float64, device=dev)
        if live:
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        ms, err = float(t[0]), float(t[1])
        rate = (c if args.axis == "data" else 1) * n / (ms * 1e-3)
        base = base or rate
        pred = predict_scaling(forest, n, *shape)
        point = {"mesh": list(shape), "rows_per_device": n, "ms": ms,
                 "rows_per_s": rate, "efficiency": rate / (base * c),
                 "predicted_efficiency": pred.efficiency,
                 "predicted_ms": pred.total_s * 1e3, "max_err": err,
                 "correct": err <= ORACLE_ATOL}
        points.append(point)
        if rank == 0:
            print(json.dumps(point), flush=True)
    ok = all(p["correct"] for p in points)
    if rank == 0:
        card = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
        print(json.dumps({"ranks": world, "axis": args.axis, "device": card,
                          "backend": dist.get_backend() if live else None,
                          "points": len(points), "ok": ok}), flush=True)
    if live:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
