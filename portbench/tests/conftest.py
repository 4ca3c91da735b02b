"""Fixtures of the benchmark's tests: a copy of the benchmark with cells
small enough for the CPU, and the card for the tests marked ``cuda``.

    python -m pytest portbench/tests -q            # here, on the CPU
    python -m pytest portbench/tests -q -m cuda    # on the card
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
# small cells of the two configurations: their widths, fewer trees and rows
TINY_CONFIGS = {
    "tiny_susy": ("susy", {"trees": 24, "depth": 6, "table_rows": 3000}),
    "tiny_cup98": ("cup98", {"trees": 12, "table_rows": 1500}),
}
TINY_MIXES = {
    "tiny_batch": ("batch", {"rows": 512}),
}
TINY_CELLS = {
    "tiny_susy.batch": ("tiny_susy", "tiny_batch", "susy.batch"),
    "tiny_cup98.batch": ("tiny_cup98", "tiny_batch", "cup98.batch"),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


def copy_benchmark(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's data and metric files under
    ``dest``, as a checkout holds them."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "kinds"):
        shutil.copytree(ROOT / "portbench" / sub, dest / "portbench" / sub)
    return dest


def add_tiny_cells(root: Path) -> None:
    """The TINY_CELLS in ``root``'s benchmark, each with the metrics of the
    cell it is a small copy of."""
    data = root / "portbench"
    for name, (base, change) in TINY_CONFIGS.items():
        cfg = json.loads((data / "configs" / f"{base}.json").read_text())
        (data / "configs" / f"{name}.json").write_text(json.dumps({**cfg, **change}))
    for name, (base, change) in TINY_MIXES.items():
        mix = json.loads((data / "traffic" / f"{base}.json").read_text())
        (data / "traffic" / f"{name}.json").write_text(json.dumps({**mix, **change}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, (config, mix, like) in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": mix,
                                   "chips": 1, "why": f"a small copy of {like}"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = copy_benchmark(tmp_path)
    add_tiny_cells(root)
    return root


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
