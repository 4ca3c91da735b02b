"""The port runs without JAX and without the JAX package: the machine with
the GPU has neither, and the port keeps its own copy of the numpy host
layer.

The test process itself has jax and tahoe_tpu loaded (tests/conftest.py and
the other tests), so the import check runs in a fresh interpreter."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tahoe_tpu_torch"

SCRIPT = r"""
import sys

import pytest
import numpy as np
import tahoe_tpu_torch
from tahoe_tpu_torch import Forest, Strategy
from tahoe_tpu_torch.forest import sparse, synthetic, train
from tahoe_tpu_torch.ops import bucketed, fold_kernel, rank_kernel, rank_transform  # noqa
from tahoe_tpu_torch.ops import gather_engine, oracle, probes, sparse_kernel  # noqa
from tahoe_tpu_torch.ops import tensor_engine  # noqa
from tahoe_tpu_torch.scripts import int8_cast_probe, overhead_bench, unit_bench  # noqa
from tahoe_tpu_torch.utils import debug, profiling  # noqa
from tahoe_tpu_torch import cli  # noqa
from tahoe_tpu_torch.engine import autotune  # noqa
from tahoe_tpu_torch.perf_model import calibrate, model  # noqa
from tahoe_tpu_torch.scripts import bench, make_fixtures, run_sweep  # noqa

forest = synthetic.generate_forest(9, 4, 6, leaf_prob=0.1, seed=1)
data = synthetic.generate_data(32, 6, missing_prob=0.1, seed=2)
f = Forest(forest, device="cpu")
want = f.predict_oracle(data)
for s in (Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST, Strategy.RANK_MXU,
          Strategy.SPARSE, Strategy.HBM_DIRECT, Strategy.ROW_TILED,
          Strategy.TENSOR):
    assert np.abs(f.predict(data, s).numpy() - want).max() <= 1e-3
deep = Forest(train.train_forest(3, 17, 6, rows=256, seed=5), device="cpu")
assert isinstance(deep.engine(Strategy.SPARSE), sparse_kernel.SparseRankEngine)
assert np.abs(deep.predict(data, Strategy.SPARSE).numpy()
              - deep.predict_oracle(data)).max() <= 1e-3
wide = Forest(synthetic.generate_forest(40, 6, 1440, seed=6), device="cpu")
rows = synthetic.generate_data(32, 1440, missing_prob=0.1, seed=7)
assert isinstance(wide.engine(Strategy.SPARSE), sparse.SparseGatherEngine)
assert np.abs(wide.predict(rows, Strategy.SPARSE).numpy()
              - wide.predict_oracle(rows)).max() <= 1e-3
for cols in (6, 90):  # DEPTH_BUCKETED, rank and fold variants
    mixed = Forest(synthetic.generate_mixed_depth_forest(12, 6, cols, seed=3),
                   device="cpu")
    rows = synthetic.generate_data(32, cols, missing_prob=0.1, seed=4)
    got = mixed.predict(rows, Strategy.DEPTH_BUCKETED).numpy()
    assert np.abs(got - mixed.predict_oracle(rows)).max() <= 1e-3
# the fused rank transform + traversal (one plane group, > 256 thresholds)
susy = synthetic.generate_forest(60, 6, 12, seed=91)
rows = synthetic.generate_data(64, 12, missing_prob=0.1, seed=92)
fused = rank_kernel.RankFoldEngine(susy, device="cpu", fuse_transform=True)
assert fused.fused
assert np.array_equal(fused.predict(rows).numpy(),
                      rank_kernel.RankFoldEngine(susy, device="cpu")
                      .predict(rows).numpy())
# the selection path: the model's pick, then the enumeration's verdicts
best, costs = model.choose_strategy(forest, 32, calibrate.Calibration.default())
res = autotune.enumerate_strategies(forest, data, device="cpu", warmup=0,
                                    epochs=1, verbose=False)
assert res[best].ran and all(r.correct for r in res.values() if r.ran)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "tahoe_tpu")
                or m.startswith(("jax.", "jaxlib.", "tahoe_tpu.")))
assert not leaked, leaked
print("no-jax-ok")
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_import_in_port_sources():
    bad = re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M)
    for path in _sources():
        assert not bad.search(path.read_text()), path


def test_no_jax_package_import_in_port_sources():
    """Not even the JAX package's numpy modules: the port has its own."""
    bad = re.compile(r"^\s*(from|import) tahoe_tpu(\.|\s|$)", re.M)
    for path in _sources():
        assert not bad.search(path.read_text()), path


def test_no_library_kernels_in_place_of_the_port_kernels():
    """No torch.compile or fused library operator stands in for a kernel."""
    bad = re.compile(r"torch\.compile|scaled_dot_product_attention|triton\.ops")
    for path in _sources():
        assert not bad.search(path.read_text()), path


def test_chip_smoke_imports_only_the_port():
    text = (ROOT / "chip_smoke.py").read_text()
    mods = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text, re.M)
    assert any(m.startswith("tahoe_tpu_torch") for m in mods)
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "tahoe_tpu")]


def test_cuda_sources_build_without_fast_math():
    """Flush-to-zero or approximate compares would change routing at the
    denormal thresholds ge_normalize writes."""
    from tahoe_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "sm_90a" in flags
    for bad in ("fast_math", "ftz=true", "prec-div=false", "prec-sqrt=false"):
        assert bad not in flags
    for path in (PORT / "csrc").glob("*.cu"):
        assert "cudaGetLastError" in path.read_text(), path


def test_failed_build_stops_every_compiler(tmp_path, monkeypatch):
    """One nvcc fails while another still runs: build() raises the failing
    compiler's error only after the other is killed and reaped, and leaves
    neither a library nor its object directory behind."""
    from tahoe_tpu_torch.ops import _build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("")
    (csrc / "b.cu").write_text("")
    pid_file = tmp_path / "b.pid"
    nvcc = tmp_path / "nvcc"
    # a.cu fails once b.cu's compiler has started; b.cu's never ends
    nvcc.write_text(
        "#!/bin/sh\n"
        'case "$*" in\n'
        f'  *a.cu*) while [ ! -s {pid_file} ]; do sleep 0.05; done\n'
        '          echo "a.cu: error: broken"; exit 1 ;;\n'
        f'  *) echo $$ > {pid_file}; exec sleep 300 ;;\n'
        "esac\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    with pytest.raises(RuntimeError, match="a.cu: error: broken"):
        _build.build()
    pid = int(pid_file.read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)  # killed and reaped, not left running
    assert list(out.iterdir()) == []
