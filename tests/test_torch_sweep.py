"""The port's sweep families, fixtures and headline bench on the CPU, held
to the JAX package's scripts/run_sweep.py, scripts/make_fixtures.py and
bench.py."""
import dataclasses
import importlib.util
import io as _io
import json
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from tahoe_tpu.forest import io as jax_io
from tahoe_tpu.forest.train import train_forest as jax_train_forest
from tahoe_tpu_torch.engine.forest import peek_data_header
from tahoe_tpu_torch.forest import io
from tahoe_tpu_torch.forest.spec import to_arrays
from tahoe_tpu_torch.scripts import bench, make_fixtures, run_sweep

ROOT = Path(__file__).resolve().parents[1]


def _jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_run_sweep", ROOT / "scripts" / "run_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_SWEEP = _jax_sweep()
# the trained families, at this many trees (training depth-18 trees takes
# about a second a tree here)
RF_TREES = 2


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(
                a[k], b[k], equal_nan=True), k
        else:
            assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), k


def test_shapes_equal_jax():
    assert run_sweep.SHAPES == JAX_SWEEP.SHAPES
    assert len(run_sweep.SHAPES) == 25


@pytest.mark.parametrize("name", [s[0] for s in JAX_SWEEP.SHAPES])
def test_family_spec_bit_equal_to_jax(name):
    shape = run_sweep.shape_by_name(name)
    if name.startswith("rf_"):
        # the JAX family_spec trains the entry's tree count, seed 1
        _, _, depth, cols = shape[:4]
        want = jax_train_forest(RF_TREES, depth, cols, rows=2048, seed=1)
        got = run_sweep.family_spec(shape, num_trees=RF_TREES)
    else:
        want = JAX_SWEEP.family_spec(shape)
        got = run_sweep.family_spec(shape)
    _same(to_arrays(got), dataclasses.asdict(want))


@pytest.mark.parametrize("name,rows", [("susy_like", 40), ("cup98_like", 25),
                                       ("trained_mix_like", 30)])
def test_fixture_loads_back_through_both_packages(tmp_path, name, rows):
    """A fixture of the port's make_fixtures: the seven-field cup98_like
    entry too, which the JAX script does not unpack. Both packages' readers
    give the same forest and rows, those family_spec built."""
    assert make_fixtures.main([str(tmp_path), "--shape", name, "--rows",
                               str(rows)]) == 0
    mp = str(tmp_path / f"model_{name}.txt")
    dp = str(tmp_path / f"data_{name}.txt")
    n, cols, missing = peek_data_header(dp)
    assert n == rows and cols == run_sweep.shape_by_name(name)[3]
    port = io.load_model(mp, num_cols=cols, missing=missing)
    jax = jax_io.load_model(mp, num_cols=cols, missing=missing)
    _same(to_arrays(port), dataclasses.asdict(jax))
    spec = run_sweep.family_spec(run_sweep.shape_by_name(name))
    np.testing.assert_array_equal(port.values, spec.values)
    np.testing.assert_array_equal(port.fids[~port.is_leaf],
                                  spec.fids[~spec.is_leaf])
    rows_p, _ = io.load_data(dp)
    rows_j, _ = jax_io.load_data(dp)
    np.testing.assert_array_equal(rows_p, rows_j)
    assert rows_p.shape == (rows, cols)


def _jax_bench_keys() -> list:
    """The keys of bench.py's success line, read off its source."""
    src = (ROOT / "bench.py").read_text()
    line = src[src.index('print(json.dumps({\n        "metric"'):]
    return re.findall(r'^\s+"(\w+)":', line[:line.index("}))")], re.M)


def test_bench_prints_the_jax_line():
    keys = _jax_bench_keys()
    assert "max_err_vs_oracle" in keys and "rank_mxu_planes_us" in keys
    out = _io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--quick", "--device", "cpu", "--rows", "96",
                         "--epochs", "1", "--warmup", "0"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    # bench.py's keys in its order, then its measure, the chained slope, of
    # each path under keys of their own
    paths = ("fold_kernel", "rank_mxu_full", "rank_mxu_planes")
    assert list(line) == keys + [f"{p}_slope_us" for p in paths] + [
        f"{p}_slope_band_us" for p in paths]
    assert line["max_err_vs_oracle"] <= 1e-3
    assert line["rows"] == 96 and line["device"] == "cpu"
    assert line["value"] == min(line["fold_kernel_us"], line["rank_mxu_full_us"])
    for band in ("fold_band_us", "rank_band_us", "planes_band_us"):
        lo, hi = line[band]
        assert 0 < lo <= hi
    for p in paths:
        lo, hi = line[f"{p}_slope_band_us"]
        assert 0 < lo <= line[f"{p}_slope_us"] <= hi


def test_sweep_record_on_the_cpu(tmp_path):
    """A fixture pair swept through --data-dir on the CLI protocol: the
    record's keys and its verdicts."""
    make_fixtures.main([str(tmp_path), "--shape", "ijcnn_like", "--rows", "48"])
    out = tmp_path / "sweep.jsonl"
    assert run_sweep.main(["--data-dir", str(tmp_path), "--device", "cpu",
                           "--no-calibrate", "--epochs", "1",
                           "--out", str(out)]) == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["dataset"] == "model_ijcnn_like.txt" and rec["rows"] == 48
    assert (rec["trees"], rec["depth"], rec["cols"]) == (100, 6, 22)
    assert rec["all_correct"] and rec["measured_best"] in rec["strategies"]
    assert rec["predicted"] in rec["predicted_us"]
    ran = {k for k, v in rec["strategies"].items() if v is not None}
    assert set(rec["bands"]) == set(rec["event_us"]) == ran
    assert all(rec["event_us"][k] > 0 for k in ran)
    assert set(rec["not_run"]) == {"DEPTH_BUCKETED"}
    assert rec["device"] == "cpu"
