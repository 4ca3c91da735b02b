"""Multi-process check of the distributed layer: N ranks, a process each.

    python -m tahoe_tpu_torch.scripts.run_multiproc [--nprocs 2]
        [--mesh D M ...] [--device cuda|cpu] [--backend nccl|gloo]
        [--trees T] [--rows R] [--timeout S]

The port's counterpart of scripts/run_multiproc.py. It launches ``nprocs``
processes of its own, one rank each (PyTorch's model: a process and a
device a rank), which meet through a ``file://`` store in a fresh
directory, so that no TCP port is fixed. Every rank builds each mesh
(``--mesh``; by default ``(1, N)``, ``(N, 1)`` and, at four ranks,
``(2, 2)``) and on it all three sharded engines (parallel/sharded.py) on
the same seeded forest and rows, and reports its shard's raw margins, the
predictions of the whole batch and its own kernel launches, which are per
process. This process then checks every rank's predictions against the
numpy oracle (ORACLE_ATOL) and every shard's margins against an unsharded
engine built on that shard's trees, bit for bit, and prints one JSON line.

The backend is NCCL where every rank has a card of its own and gloo
otherwise: NCCL refuses two ranks on one card. On ``cuda`` this process
builds the kernel library once; the ranks load the same hashed file and
refuse to build one. ``launch`` and ``worker`` are what the tests and
chip_smoke.py run; a rank imports nothing of jax or of the JAX package and
fails if one was loaded. Exits 1 if a check fails, 2 without a card on
``cuda``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
ENGINES = ("fold", "rank", "sparse")


def kernels() -> dict:
    """Every CUDA kernel a sharded engine can launch, by its symbol."""
    from tahoe_tpu_torch.ops.fold_kernel import DEEP_KERNELS, FOLD_KERNELS
    from tahoe_tpu_torch.ops.rank_kernel import RANK_FOLD, RANK_FUSED
    from tahoe_tpu_torch.ops.rank_transform import RANK_PLANES
    from tahoe_tpu_torch.ops.sparse_kernel import SPARSE_RANK

    ks = [*FOLD_KERNELS.values(), *DEEP_KERNELS.values(), RANK_PLANES,
          RANK_FOLD, RANK_FUSED, SPARSE_RANK]
    return {k.symbol: k for k in ks}


def make_engine(kind: str, spec, mesh):
    from tahoe_tpu_torch.parallel import sharded

    cls = {"fold": sharded.ShardedForestEngine, "rank": sharded.ShardedRankEngine,
           "sparse": sharded.ShardedSparseEngine}[kind]
    return cls(spec, mesh)


def launch(spec, rows: np.ndarray, *, nprocs: int, workdir, meshes,
           engines=ENGINES, device: str = "cpu", backend: str | None = None,
           timeout: float = 120.0) -> list:
    """Run ``worker`` in ``nprocs`` processes on ``spec`` and ``rows``
    (written under ``workdir``), every mesh of ``meshes`` with every engine
    kind of ``engines``; return each rank's report, rank order. Raises when
    a rank fails or the ranks take more than ``timeout`` seconds, after
    every rank has been stopped."""
    from tahoe_tpu_torch.forest.spec import to_arrays

    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    np.savez(work / "forest.npz", **to_arrays(spec))
    np.save(work / "rows.npy", np.asarray(rows, np.float32))
    (work / "job.json").write_text(json.dumps({
        "meshes": [list(m) for m in meshes], "engines": list(engines),
        "device": device, "backend": backend}))
    if device == "cuda":
        from tahoe_tpu_torch.ops import _build

        _build.build()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    for r in range(nprocs):
        log = open(work / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tahoe_tpu_torch.scripts.run_multiproc",
             "--worker", str(work), "--rank", str(r), "--world", str(nprocs)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"the ranks took more than {timeout} s:\n"
                           + _logs(work, nprocs)) from None
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed:\n" + _logs(work, nprocs))
    out = []
    for r in range(nprocs):
        rep = json.loads((work / f"rank{r}.json").read_text())
        arrays = np.load(work / f"rank{r}.npz")
        for i, res in enumerate(rep["results"]):
            res["shard_margins"] = arrays[f"shard_{i}"]
            res["predictions"] = arrays[f"pred_{i}"]
        out.append(rep)
    return out


def _logs(work: Path, nprocs: int) -> str:
    return "\n".join(f"--- rank {r}:\n" + (work / f"rank{r}.log").read_text()[-3000:]
                     for r in range(nprocs) if (work / f"rank{r}.log").exists())


def worker(workdir, rank: int, world: int) -> int:
    """One rank: join the group, run every mesh and engine of the job,
    write this rank's report. No communication but the engines' own."""
    import torch
    import torch.distributed as dist

    from tahoe_tpu_torch.forest.spec import from_arrays
    from tahoe_tpu_torch.ops import _build
    from tahoe_tpu_torch.parallel.mesh import init_distributed, make_mesh

    work = Path(workdir)
    job = json.loads((work / "job.json").read_text())
    # ranks share the host's cores: one thread each
    torch.set_num_threads(1)
    device = job["device"]
    if device == "cuda" and not _build.library_path().exists():
        raise RuntimeError(f"{_build.library_path()} is not built: the launching "
                           f"process builds the kernel library, a rank never does")
    init_distributed(f"file://{work / 'rendezvous'}", world, rank,
                     backend=job["backend"], device=device)
    z = np.load(work / "forest.npz")
    spec = from_arrays({k: z[k][()] if z[k].ndim == 0 else z[k] for k in z.files})
    rows = np.load(work / "rows.npy")
    counters = kernels()
    results, arrays = [], {}
    for data, model in job["meshes"]:
        mesh = make_mesh(data, model, device=device)
        for kind in job["engines"]:
            if mesh is None:
                continue
            eng = make_engine(kind, spec, mesh)
            for k in counters.values():
                k.launches = 0
            shard = eng.shard_margins(rows)
            preds = eng.predict(rows)
            i = len(results)
            arrays[f"shard_{i}"] = shard.cpu().numpy()
            arrays[f"pred_{i}"] = preds.cpu().numpy()
            results.append({
                "mesh": [data, model], "engine": kind,
                "coords": [mesh.d, mesh.m], "device": str(mesh.device),
                "trees": [int(eng.trees[0]), int(eng.trees[-1]) + 1],
                "shard_trees": eng.shard_trees,
                "launches": {n: k.launches for n, k in counters.items() if k.launches}})
            del eng
    if device == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "jaxlib", "tahoe_tpu")
                    or m.startswith(("jax.", "jaxlib.", "tahoe_tpu.")))
    np.savez(work / f"rank{rank}.npz", **arrays)
    (work / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "world": world, "backend": dist.get_backend(),
        "results": results, "leaked": leaked}))
    dist.destroy_process_group()
    if leaked:
        raise RuntimeError(f"modules of jax or of the JAX package were loaded: {leaked}")
    return 0


def check(spec, rows: np.ndarray, reports: list, device, want=None) -> dict:
    """Every rank's predictions against the oracle (``want``, computed here
    when None), and every shard's margins bit for bit against an unsharded
    engine on its trees (built here on ``device``): a summary a (mesh,
    engine)."""
    from tahoe_tpu_torch.config import ORACLE_ATOL
    from tahoe_tpu_torch.ops import oracle
    from tahoe_tpu_torch.ops.bucketed import subset_trees
    from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine
    from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
    from tahoe_tpu_torch.ops.sparse_kernel import SparseRankEngine

    unsharded = {"fold": FoldKernelEngine, "rank": RankFoldEngine,
                 "sparse": SparseRankEngine}
    want = oracle.predict(spec, rows) if want is None else want
    refs, out = {}, {}
    for rep in reports:
        for res in rep["results"]:
            key = f"{res['engine']} {res['mesh'][0]}x{res['mesh'][1]}"
            lo, hi = res["trees"]
            ref_key = (res["engine"], lo, hi)
            if ref_key not in refs:
                eng = unsharded[res["engine"]](
                    subset_trees(spec, np.arange(lo, hi)), device=device)
                refs[ref_key] = eng.margins(rows).cpu().numpy()
            err = float(np.abs(res["predictions"] - want).max()) if len(want) else 0.0
            s = out.setdefault(key, {"max_err": 0.0, "correct": True,
                                     "shards_bit_equal": True, "launches": []})
            s["max_err"] = max(s["max_err"], err)
            s["correct"] &= err <= ORACLE_ATOL
            s["shards_bit_equal"] &= bool(np.array_equal(
                res["shard_margins"].view(np.int32), refs[ref_key].view(np.int32)))
            s["launches"].append(res["launches"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--mesh", type=int, nargs=2, action="append", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--trees", type=int, default=48)
    ap.add_argument("--rows", type=int, default=96)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args.worker, args.rank, args.world)

    import tempfile

    import torch

    from tahoe_tpu_torch.config import resolve_device
    from tahoe_tpu_torch.forest import synthetic

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    n = args.nprocs
    meshes = args.mesh or ([(1, n), (n, 1)] + ([(2, 2)] if n == 4 else []))
    backend = args.backend or ("nccl" if dev.type == "cuda"
                               and n <= torch.cuda.device_count() else "gloo")
    spec = synthetic.generate_forest(args.trees, 4, 12, leaf_prob=0.1, seed=7)
    rows = synthetic.generate_data(args.rows, 12, missing_prob=0.1, seed=8)
    with tempfile.TemporaryDirectory() as tmp:
        reports = launch(spec, rows, nprocs=n, workdir=tmp, meshes=meshes,
                         device=dev.type, backend=backend, timeout=args.timeout)
    summary = check(spec, rows, reports, dev)
    ok = all(s["correct"] and s["shards_bit_equal"] for s in summary.values())
    print(json.dumps({"processes": n, "device": dev.type, "backend": backend,
                      "trees": spec.num_trees, "rows": len(rows),
                      "meshes": [list(m) for m in meshes], "engines": summary,
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
