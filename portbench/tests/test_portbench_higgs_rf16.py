"""The higgs_rf16.batch cell: its entry in the benchmark, and a small copy
of it run through the harness on the CPU (the deep kernel's plain version:
depth 16, 28 columns, AVG, a few trees over a table of a few thousand
rows), added as new entries of a copied benchmark."""
from __future__ import annotations

import json

from portbench import run
from portbench.tests.conftest import ROOT, copy_benchmark

CELL = "higgs_rf16.batch"
SMALL = "small_higgs_rf16.batch"
PER_LAYER = ("predict_roofline_pct.batch", "mfu_pct.batch", "device_idle_pct.batch")


def add_small_cell(root) -> None:
    """SMALL: higgs_rf16 at its widths with 3 trees and 3,000 rows, in
    256-row batches, listed wherever higgs_rf16.batch is."""
    data = root / "portbench"
    cfg = json.loads((data / "configs" / "higgs_rf16.json").read_text())
    (data / "configs" / "small_higgs_rf16.json").write_text(
        json.dumps({**cfg, "trees": 3, "table_rows": 3000}))
    mix = json.loads((data / "traffic" / "batch.json").read_text())
    (data / "traffic" / "small_batch.json").write_text(json.dumps({**mix, "rows": 256}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": SMALL, "config": "small_higgs_rf16",
                               "traffic": "small_batch", "chips": 1,
                               "why": f"a small copy of {CELL}"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(SMALL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def test_a_small_copy_runs_correct_on_the_cpu(tmp_path):
    root = copy_benchmark(tmp_path)
    add_small_cell(root)
    result = run.run_cell(root, SMALL, 2**31 + 19, 0.3, False, device="cpu")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "rows_per_s"}
    assert result["checks"]["max_abs_gap"]["value"] < 1e-6


def test_the_cell_entry():
    bench = run.load_benchmark(ROOT)
    cell = run.cell_of(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("higgs_rf16", "batch", 1)
    config = next(c for c in bench["configs"] if c["name"] == "higgs_rf16")
    assert config["reduced"] == []
    assert config["file"] == "portbench/configs/higgs_rf16.json"
    e2e = {m["name"] for m in run.metrics_of(bench, cell, False)}
    assert e2e == {"rows_per_s", "setup_s"}
    assert {m["name"] for m in run.metrics_of(bench, cell, True)} == set(PER_LAYER)
