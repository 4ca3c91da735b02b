"""Summarize a sweep file: one verdict line a family, and the counts.

    python -m tahoe_tpu_torch.scripts.sweep_summary [sweep_results_torch_h100.jsonl]

The port's copy of scripts/sweep_summary.py, stdlib only. The last record
of a family counts, as in check_sweep_model.py. Every verdict here is the
one the sweep recorded when it ran: the model's pick of that day and its
live calibration, not the current model's (check_sweep_model.py re-ranks
with the current one). Fields are read with ``.get``, so that a record
written by an older or a newer sweep, or one that lacks a field, is shown
with a dash rather than stopping the summary. Exits 1 unless every family
was correct on every strategy it ran.
"""
import json
import sys


def _flag(value) -> str:
    return "-" if value is None else ("Y" if value else "n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "sweep_results_torch_h100.jsonl"
    latest, order = {}, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            name = r.get("dataset")
            if name is None:
                continue
            if name not in latest:
                order.append(name)
            latest[name] = r

    counts = {"model_correct": 0, "model_within_5pct": 0, "rule_met": 0,
              "all_correct": 0}
    for name in order:
        r = latest[name]
        times = {k: v for k, v in (r.get("strategies") or {}).items() if v is not None}
        best_us = min(times.values()) if times else float("nan")
        for k in counts:
            counts[k] += bool(r.get(k))
        rank = (r.get("strategies") or {}).get("RANK_MXU")
        print(f"{name:18s} rows={r.get('rows', '-')!s:6s}"
              f" best={r.get('measured_best') or '-':14s} {best_us:8.4f}"
              f" pick={r.get('predicted') or '-':14s}"
              f" strict={_flag(r.get('model_correct'))}"
              f" w5={_flag(r.get('model_within_5pct'))}"
              f" rule={_flag(r.get('rule_met'))}"
              f" parity={_flag(r.get('all_correct'))}"
              f" rank={rank if rank is not None else '-'}"
              f" card={r.get('card') or r.get('device') or '-'}")
    n = len(order)
    print(f"\n{n} families, as recorded at sweep time: parity "
          f"{counts['all_correct']}/{n}, model strict {counts['model_correct']}/{n}, "
          f"within 5% {counts['model_within_5pct']}/{n}, rule met "
          f"{counts['rule_met']}/{n}")
    return 0 if counts["all_correct"] == n else 1


if __name__ == "__main__":
    sys.exit(main())
