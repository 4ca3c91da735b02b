"""The control of a cell's comparison: the plain reference computed in
bfloat16, the precision below the float32 the configurations state, put in
the program's place and judged as a run's predictions are. It has to come
out not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

For each seed it draws the cell's forest and rows as a run does, and
compares the bfloat16 reference's predictions with the float32 reference's
on the rows a run compares (the load's ``compared_rows``: every row of a
batch cell's table, which its window covers). One JSON line a seed: the widest gap, the configuration's
limit, and whether the control passed (it must not). The benchmark's own
runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import drive, reference
from portbench.generators import forest_of
from portbench.run import ROOT, cell_of, load_benchmark, load_kind, load_mix


def control_gap(root, workload: str, seed: int, device="cuda") -> dict:
    import torch

    bench = load_benchmark(root)
    cell = cell_of(bench, workload)
    config = json.loads((root / "portbench" / "configs"
                         / f"{cell['config']}.json").read_text())
    mix = load_mix(root, cell)
    forest = forest_of(config, [seed, drive.FOREST_STREAM])
    rows = torch.from_numpy(load_kind(root, mix).compared_rows(config, mix, seed)).to(device)
    want, _ = reference.predict(forest, rows)
    low, _ = reference.predict(forest, rows, dtype=torch.bfloat16)
    gap = drive.max_gap(low.float().cpu().numpy(), want.cpu().numpy())
    limit = float(config["max_abs_gap"])
    return {"workload": workload, "seed": seed, "rows": int(rows.shape[0]),
            "control_gap": gap, "limit": limit, "correct": gap <= limit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    failed_as_it_must = True
    for seed in (int(s) for s in args.seeds.split(",")):
        r = control_gap(ROOT, args.workload, seed, args.device)
        print(json.dumps(r), flush=True)
        failed_as_it_must &= not r["correct"]
    return 0 if failed_as_it_must else 1


if __name__ == "__main__":
    sys.exit(main())
