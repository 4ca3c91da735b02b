"""Re-rank a committed sweep with the current model: no card needed.

    python -m tahoe_tpu_torch.scripts.check_sweep_model \
        [sweep_results_torch_h100.jsonl] [--skip a,b]

The port's copy of scripts/check_sweep_model.py. It runs the current
performance model (perf_model/model.py ``choose_strategy``) with
``Calibration.default()``, the calibration of the committed sweep's run,
against the measured strategy tables of a sweep file, so that a change to
the model is held to the whole measured record without the card. Each
family is rebuilt through run_sweep.py's ``family_spec``, the constructor
the sweep used (seeded: the forest is the one measured); a record of a file
pair (``--data-dir``) is skipped. The last record of a family counts.

Per family: the model's pick now, the record's measured best (the
enumeration's, correct strategies only: never re-derived from raw times,
where a fast wrong strategy would win), both measured times, and the
verdicts: ``hit`` (the pick is the best), ``within 5%`` (its measured time
is within 5% of the best's: the JAX script's criterion) and the sweep's
rule (a hit wherever the best leads its runner-up by more than 5%; the
reference's "predicts correctly", main.cu:85-90). Exits 1 when a family
breaks the rule.
"""
from __future__ import annotations

import argparse
import json
import sys

RULE_MARGIN = 0.05


def latest_records(path: str) -> dict:
    """The last record of each family in a sweep file, by name."""
    latest = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                if "dataset" in rec:
                    latest[rec["dataset"]] = rec
    return latest


def rerank(rec: dict, cal=None) -> dict | None:
    """The current model's verdict on one sweep record, or None where the
    record is not a synthetic family or has no measured best."""
    from tahoe_tpu_torch.perf_model import model
    from tahoe_tpu_torch.scripts.run_sweep import SHAPES, family_spec

    shape = next((s for s in SHAPES if s[0] == rec.get("dataset")), None)
    meas = {k: v for k, v in (rec.get("strategies") or {}).items() if v is not None}
    best = rec.get("measured_best")
    if shape is None or best not in meas:
        return None
    pick, costs = model.choose_strategy(family_spec(shape), rec["rows"], cal)
    ranked = sorted(meas.values())
    margin = (rec.get("runner_up_margin") if rec.get("runner_up_margin") is not None
              else (ranked[1] / ranked[0] - 1 if len(ranked) > 1 else None))
    hit = pick.name == best
    return {
        "dataset": rec["dataset"], "rows": rec["rows"], "pick": pick.name,
        "best": best, "pick_us": meas.get(pick.name), "best_us": meas[best],
        "predicted_us": costs[pick].total * 1e6 / rec["rows"],
        "margin": margin, "hit": hit,
        "within_5pct": hit or (pick.name in meas
                               and meas[pick.name] <= meas[best] * (1 + RULE_MARGIN)),
        "rule_met": hit or (margin is not None and margin <= RULE_MARGIN),
        "recorded_pick": rec.get("predicted"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="sweep_results_torch_h100.jsonl")
    ap.add_argument("--skip", default=None,
                    help="comma-separated families (the trained ones take the host "
                         "seconds to minutes to build)")
    args = ap.parse_args(argv)
    from tahoe_tpu_torch.perf_model.calibrate import Calibration

    cal = Calibration.default()
    skip = set(args.skip.split(",")) if args.skip else set()
    rows = []
    for name, rec in latest_records(args.path).items():
        if name in skip:
            continue
        r = rerank(rec, cal)
        if r is None:
            print(f"--- {name}: not a synthetic family or no measured best; skipped")
            continue
        rows.append(r)
        flag = "hit " if r["hit"] else ("~5% " if r["within_5pct"] else "MISS")
        pick_us = r["pick_us"] if r["pick_us"] is not None else float("nan")
        margin = f"{r['margin']:+.1%}" if r["margin"] is not None else "-"
        print(f"{flag} {name:18s} pick {r['pick']:14s} ({pick_us:.4f} us) "
              f"best {r['best']:14s} ({r['best_us']:.4f} us, runner-up "
              f"{margin}) rule {'met' if r['rule_met'] else 'BROKEN'}; "
              f"recorded pick {r['recorded_pick']}")
    n = len(rows)
    hits = sum(r["hit"] for r in rows)
    w5 = sum(r["within_5pct"] for r in rows)
    rule = sum(r["rule_met"] for r in rows)
    print(f"\nmodel vs {args.path}: {hits}/{n} hits, {w5}/{n} within 5%, "
          f"rule met on {rule}/{n}")
    print(json.dumps({"families": n, "hits": hits, "within_5pct": w5,
                      "rule_met": rule, "records": rows}))
    return 0 if rule == n else 1


if __name__ == "__main__":
    sys.exit(main())
