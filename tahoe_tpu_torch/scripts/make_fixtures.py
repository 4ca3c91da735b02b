"""Model/data fixture pairs in the reference text formats.

    python -m tahoe_tpu_torch.scripts.make_fixtures OUTDIR [--shape susy_like]
        [--rows N] [--seed S]

The port's copy of scripts/make_fixtures.py: it writes ``model_<shape>.txt``
and ``data_<shape>.txt`` through the port's forest/io.py. Every forest is
run_sweep.family_spec's (seed ``--seed``, 1 by default, the sweep's), so a
fixture holds the forest the sweep measures; the rows come from seed
``--seed`` + 1 (the sweep's 2). Unlike the JAX script, it takes the
seven-field SHAPES entries (cup98_like, gisette_like) with their active
columns, and builds every rf_* family by training.
"""
from __future__ import annotations

import argparse
import os
import sys

from tahoe_tpu_torch.scripts.run_sweep import SHAPES, family_spec, shape_by_name


def write_fixture(outdir: str, shape_name: str, rows: int | None = None,
                  seed: int = 1) -> tuple[str, str]:
    """Write one family's pair into ``outdir``; (model path, data path)."""
    from tahoe_tpu_torch.forest import io, synthetic

    shape = shape_by_name(shape_name)
    name, cols, mprob = shape[0], shape[3], shape[5]
    forest = family_spec(shape, seed=seed)
    data = synthetic.generate_data(rows or shape[4], cols, missing_prob=mprob,
                                   seed=seed + 1)
    os.makedirs(outdir, exist_ok=True)
    mp = os.path.join(outdir, f"model_{name}.txt")
    dp = os.path.join(outdir, f"data_{name}.txt")
    io.save_model(mp, forest)
    io.save_data(dp, data, missing=forest.missing)
    return mp, dp


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("outdir")
    p.add_argument("--shape", default="susy_like",
                   choices=[s[0] for s in SHAPES])
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    mp, dp = write_fixture(args.outdir, args.shape, args.rows, args.seed)
    print(f"wrote {mp} and {dp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
