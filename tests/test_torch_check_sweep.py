"""The port's sweep check scripts on the committed H100 sweep
(sweep_results_torch_h100.jsonl): the current model re-ranks every family
that builds in seconds, and no family whose recorded pick met the sweep's
5% rule breaks it now; sweep_summary reads every record, and records that
lack fields."""
import io as _io
import json
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from tahoe_tpu_torch.perf_model.calibrate import Calibration
from tahoe_tpu_torch.scripts import check_sweep_model, sweep_summary

ROOT = Path(__file__).resolve().parents[1]
SWEEP = ROOT / "sweep_results_torch_h100.jsonl"
RECORDS = check_sweep_model.latest_records(str(SWEEP))
# the trained families take the host tens of seconds to train
QUICK = sorted(n for n in RECORDS if not n.startswith("rf_"))


def test_the_sweep_holds_every_family():
    assert len(RECORDS) == 25
    assert all(r["all_correct"] for r in RECORDS.values())


@pytest.mark.parametrize("name", QUICK)
def test_a_rule_met_stays_met(name):
    rec = RECORDS[name]
    r = check_sweep_model.rerank(rec, Calibration.default())
    assert r is not None and r["best"] == rec["measured_best"]
    if rec["rule_met"]:
        assert r["rule_met"], r


def _missed(rec):
    """``rec`` with the model's pick made the runner-up: another strategy
    measured 20% faster than every one, so that the pick breaks the rule."""
    rec = json.loads(json.dumps(rec))
    pick = check_sweep_model.rerank(rec, Calibration.default())["pick"]
    times = rec["strategies"]
    other = next(k for k, v in times.items() if v is not None and k != pick)
    times[other] = min(v for v in times.values() if v is not None) / 1.2
    rec.update(measured_best=other, runner_up_margin=None)
    return rec


def test_check_sweep_model_main_on_a_file(tmp_path):
    """main() prints a verdict a family and one JSON summary line; a miss
    that breaks the rule makes it exit 1."""
    path = tmp_path / "sweep.jsonl"
    lines = [json.dumps(RECORDS["susy_like"]),
             json.dumps(_missed(RECORDS["ijcnn_like"]))]
    path.write_text("\n".join(lines) + "\n")
    out = _io.StringIO()
    with redirect_stdout(out):
        rc = check_sweep_model.main([str(path)])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert summary["families"] == 2 and summary["hits"] == 1
    assert summary["rule_met"] == 1 and rc == 1
    miss = summary["records"][1]
    assert miss["dataset"] == "ijcnn_like" and not miss["hit"] and miss["margin"] > 0.05
    with redirect_stdout(_io.StringIO()):
        assert check_sweep_model.main([str(path), "--skip", "ijcnn_like"]) == 0


def test_sweep_summary_reads_records_with_fields_missing(tmp_path):
    path = tmp_path / "sweep.jsonl"
    path.write_text(SWEEP.read_text() + json.dumps(
        {"dataset": "partial", "strategies": {"SPLIT_FOREST": 0.01},
         "all_correct": True}) + "\n" + json.dumps({"calibration": {}}) + "\n")
    out = _io.StringIO()
    with redirect_stdout(out):
        rc = sweep_summary.main([str(path)])
    text = out.getvalue()
    assert rc == 0
    assert "26 families, as recorded at sweep time: parity 26/26" in text
    assert "partial" in text and "pick=-" in text
