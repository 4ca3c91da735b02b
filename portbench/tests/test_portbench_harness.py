"""The harness on the CPU: a cell added as files and entries only, runs
that print no result, and nothing of jax or the JAX package loaded."""
from __future__ import annotations

import ast
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.conftest import ROOT, copy_benchmark

PORTBENCH = ROOT / "portbench"
BANNED = {"jax", "jaxlib", "flax", "tahoe_tpu"}


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_is_added_as_files_and_entries_only(tmp_path):
    """A configuration, a traffic mix of a kind of its own, and a metric,
    each a new file, with their entries: no file already there changes."""
    root = copy_benchmark(tmp_path)
    before = digests(root / "portbench")
    data = root / "portbench"
    (data / "configs" / "higgs_small.json").write_text(json.dumps({
        "source": "a small HIGGS-class forest", "trees": 16, "depth": 6,
        "num_cols": 28, "missing": "nan", "missing_prob": 0.02,
        "table_rows": 2000, "output": "RAW", "precision": "float32",
        "max_abs_gap": 0.001, "assumed": [], "reduced": []}))
    (data / "traffic" / "halves.json").write_text(json.dumps(
        {"kind": "halves", "rows": 600}))
    # a kind of load of its own: every other batch of half the rows
    (data / "kinds" / "halves.py").write_text(
        "from portbench.kinds.batch import compared_rows  # noqa: F401\n"
        "from portbench.kinds.batch import Load as Batch\n\n\n"
        "class Load(Batch):\n"
        "    def _step(self, strategy, span):\n"
        "        with span('predict'):\n"
        "            self.prog.predict(self.table[:self.batch // 2], strategy)\n"
        "        super()._step(strategy, span)\n")
    (data / "metrics" / "batches_per_s.py").write_text(
        "def read(r):\n    return r.load.window_batches / r.load.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "higgs_small", "source": "x",
                             "file": "portbench/configs/higgs_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "higgs_small.halves", "config": "higgs_small",
                               "traffic": "halves", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "batches_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["higgs_small.halves"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run.run_cell(root, "higgs_small.halves", 12, 0.3, False, device="cpu")
    assert set(result["metrics"]) == {"batches_per_s", "setup_s"}
    assert result["correct"] and result["attempted"] > 0
    assert result["metrics"]["batches_per_s"]["value"] > 0
    after = digests(root / "portbench")
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("cell", ["tiny_susy.batch", "tiny_cup98.batch"])
def test_a_sound_run_is_correct_and_reports_its_metrics(tiny_root, cell):
    result = run.run_cell(tiny_root, cell, 2**31 + 77, 0.3, False, device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "rows_per_s"}
    assert list(result)[-1] == "checks"
    assert result["checks"]["max_abs_gap"]["value"] < 1e-5


def test_a_mix_of_a_kind_with_no_file_gives_no_result(tiny_root):
    (tiny_root / "portbench" / "traffic" / "tiny_batch.json").write_text(
        json.dumps({"kind": "replay", "rows": 512}))
    with pytest.raises(run.NoResult):
        run.run_cell(tiny_root, "tiny_susy.batch", 1, 0.1, False, device="cpu")


def test_metrics_of_a_traced_run_are_the_per_layer_ones():
    bench = run.load_benchmark(ROOT)
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in run.metrics_of(bench, cell, False)}
        layer = run.metrics_of(bench, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "susy.batch", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "susy.batch", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_module_imports_jax_or_the_jax_package():
    for path in PORTBENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & BANNED, (path, names)


def test_a_rehearsal_loads_nothing_of_jax(tiny_root):
    code = ("import sys; from pathlib import Path; from portbench import run; "
            f"run.run_cell(Path({str(tiny_root)!r}), 'tiny_susy.batch', 3, 0.2, False, "
            "device='cpu'); print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "tahoe_tpu_torch" in loaded and not loaded & BANNED


def test_the_benchmark_file_is_well_formed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        assert (PORTBENCH / "traffic" / f"{w['traffic']}.json").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (PORTBENCH / "metrics" / f"{m['name']}.py").exists()
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
