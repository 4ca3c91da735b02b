"""The port's Forest facade on the CPU: text-format round trip, the
strategies against the numpy oracle under every output transform and a
finite missing sentinel, and feasibility against the JAX package's."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from tahoe_tpu.config import ORACLE_ATOL
from tahoe_tpu.config import Strategy as JaxStrategy
from tahoe_tpu.engine import feasibility as jax_feasibility
from tahoe_tpu.forest import compiler, io, synthetic
from tahoe_tpu.forest.spec import ForestSpec as JaxForestSpec
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.transform import apply_output_transform as np_transform
from tahoe_tpu_torch import Forest, Output, Strategy
from tahoe_tpu_torch.config import MISSING_EPS, resolve_device
from tahoe_tpu_torch.engine import feasibility
from tahoe_tpu_torch.engine.feasibility import ForestFacts
from tahoe_tpu_torch.forest.spec import from_arrays, to_arrays
from tahoe_tpu_torch.ops.bucketed import (
    DepthBucketedFoldEngine,
    DepthBucketedRankEngine,
)
from tahoe_tpu_torch.ops.fold_kernel import FOLD, FOLD_DEEP, FOLD_DEEP_SIGN, FOLD_SIGN
from tahoe_tpu_torch.ops.rows import canonicalize_rows
from tahoe_tpu_torch.ops.transform import apply_output_transform
from tahoe_tpu_torch.scripts.run_sweep import shape_by_name

# every ported strategy but DEPTH_BUCKETED, which needs mixed tree depths
PORTED = (Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST, Strategy.RANK_MXU)
OUTPUTS = [int(sum(c)) for n in range(4)
           for c in itertools.combinations(
               (Output.AVG, Output.SIGMOID, Output.THRESHOLD), n)]


def _port(spec):
    """A forest built by the JAX package, carried across to the port."""
    return from_arrays(dataclasses.asdict(spec))


def _jax(spec):
    """A port forest carried back to the JAX package."""
    return JaxForestSpec(**to_arrays(spec))


def _files(tmp_path, forest, data, missing):
    model, rows = tmp_path / "model.txt", tmp_path / "data.txt"
    io.save_model(str(model), forest)
    io.save_data(str(rows), data, missing)
    return str(model), str(rows)


@pytest.mark.parametrize("data_path", [None, "missing.txt"])
def test_from_files_without_a_data_file_matches_jax(tmp_path, data_path):
    """No data file, or a path to none: the model's own num_cols and NaN
    missing, the spec the JAX Forest.from_files loads."""
    from tahoe_tpu.engine.forest import Forest as JaxForest

    forest = synthetic.generate_forest(9, 4, 13, leaf_prob=0.1, seed=63)
    model = tmp_path / "model.txt"
    io.save_model(str(model), forest)
    rows = None if data_path is None else str(tmp_path / data_path)
    f = Forest.from_files(str(model), rows, device="cpu")
    want = JaxForest.from_files(str(model), rows).spec
    got = to_arrays(f.spec)
    for key, value in dataclasses.asdict(want).items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert np.isnan(f.spec.missing)


@pytest.mark.parametrize("missing", [float("nan"), -999.0])
def test_from_files_round_trip(tmp_path, missing):
    forest = synthetic.generate_forest(23, 5, 11, leaf_prob=0.15,
                                       missing=missing, seed=61)
    data = synthetic.generate_data(96, 11, missing=missing, missing_prob=0.1,
                                   seed=62)
    model, rows = _files(tmp_path, forest, data, missing)
    f = Forest.from_files(model, rows, device="cpu")
    assert f.spec.num_cols == 11
    assert np.isnan(f.spec.missing) if np.isnan(missing) else f.spec.missing == missing
    loaded, _ = io.load_data(rows)
    want = oracle.predict(forest, data)
    np.testing.assert_allclose(f.predict_oracle(loaded), want, atol=0, rtol=0)
    for s in PORTED:
        got = f.predict(loaded, s)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("strategy", PORTED, ids=lambda s: s.name)
@pytest.mark.parametrize("output", OUTPUTS)
def test_output_flags_and_sentinel(strategy, output):
    forest = synthetic.generate_forest(
        19, 4, 10, leaf_prob=0.1, output=output, global_bias=0.05,
        threshold=0.52, missing=-999.0, seed=63)
    data = synthetic.generate_data(80, 10, missing=-999.0, missing_prob=0.15,
                                   seed=64)
    data[1, 2] = np.float32(-999.0 + 5e-7)  # within MISSING_EPS of the sentinel
    got = Forest(_port(forest), device="cpu").predict(data, strategy).numpy()
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_from_files_output_transform(tmp_path):
    """The text model format carries no output transform: from_files takes
    it, as io.load_model does."""
    out = int(Output.AVG | Output.SIGMOID | Output.THRESHOLD)
    forest = synthetic.generate_forest(31, 5, 8, output=out, global_bias=0.01,
                                       missing=-999.0, leaf_prob=0.1, seed=65)
    data = synthetic.generate_data(128, 8, missing=-999.0, missing_prob=0.05,
                                   seed=66)
    model, rows = _files(tmp_path, forest, data, -999.0)
    f = Forest.from_files(model, rows, device="cpu", output=out,
                          global_bias=0.01)
    want = oracle.predict(forest, data)
    assert 0 < want.mean() < 1
    for s in PORTED:
        np.testing.assert_array_equal(f.predict(data, s).numpy(), want)


def test_unreachable_depth_truncated():
    forest = synthetic.generate_forest(9, 6, 5, seed=67)
    forest.is_leaf[:, forest.level_slice(3).start:] = True
    f = Forest(_port(forest), device="cpu")
    assert f.stored_depth == 6 and f.spec.depth == 3
    data = synthetic.generate_data(40, 5, missing_prob=0.1, seed=68)
    for s in PORTED:
        np.testing.assert_allclose(f.predict(data, s).numpy(),
                                   oracle.predict(forest, data),
                                   atol=ORACLE_ATOL, rtol=0)


# the strategies served since the facade took every strategy
LATER = (Strategy.HBM_DIRECT, Strategy.ROW_TILED, Strategy.TENSOR,
         Strategy.SPARSE)


@pytest.mark.parametrize("strategy", LATER, ids=lambda s: s.name)
def test_every_strategy_is_served(strategy):
    forest = synthetic.generate_forest(5, 3, 4, leaf_prob=0.1, seed=69)
    data = synthetic.generate_data(40, 4, missing_prob=0.1, seed=70)
    f = Forest(_port(forest), device="cpu")
    assert f.feasible(strategy) is None
    got = f.predict(data, strategy)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)
    assert (set(LATER) | set(PORTED) | {Strategy.DEPTH_BUCKETED}
            == set(Strategy))


def test_infeasible_fold_raises():
    """Depth 16: no block's shared memory holds a tree, so VMEM_FOREST is
    refused for it (the TPU's VMEM holds it: the JAX check admits it), and
    DEPTH_BUCKETED for the trees' uniform depth, as in the JAX check;
    SPLIT_FOREST runs on the deep kernel, and RANK_MXU too."""
    spec = synthetic.generate_forest(2, 16, 4, seed=70)
    f = Forest(_port(spec), device="cpu")
    for s, why in ((Strategy.VMEM_FOREST, "bytes of shared memory per block"),
                   (Strategy.DEPTH_BUCKETED, "uniform tree depth")):
        assert why in f.feasible(s)
        with pytest.raises(ValueError, match="infeasible"):
            f.engine(s)
    assert jax_feasibility.check(JaxStrategy.VMEM_FOREST, spec) is None
    for s in (Strategy.SPLIT_FOREST, Strategy.RANK_MXU):
        assert f.feasible(s) is None
        assert jax_feasibility.check(JaxStrategy[s.name], spec) is None
    assert f.engine(Strategy.SPLIT_FOREST).kernel is FOLD_DEEP


@pytest.mark.parametrize("depth", range(12, 19))
def test_feasibility_matches_jax_to_depth_18(depth):
    """Both packages' checks on all eight strategies, forests of uniform and
    of mixed reachable depth 12-18: they agree but for VMEM_FOREST, which
    no block's shared memory holds from depth 14 on (the TPU's VMEM holds
    it), refused for that reason. Past depth 15 SPLIT_FOREST and
    DEPTH_BUCKETED are admitted, as in the JAX package."""
    spec = synthetic.generate_forest(3, depth, 6, seed=depth)
    mixed = synthetic.generate_forest(3, depth, 6, seed=depth)
    mixed.is_leaf[0, mixed.level_slice(depth - 3).start:] = True
    for forest in (spec, mixed):
        port = ForestFacts(_port(forest))
        for s in Strategy:
            want = jax_feasibility.check(JaxStrategy[s.name], forest)
            got = feasibility.check(s, port)
            if s == Strategy.VMEM_FOREST and depth >= 14:
                assert want is None and "bytes of shared memory" in got
            else:
                assert (got is None) == (want is None), (s, got, want)
        if depth > 15:
            assert feasibility.check(Strategy.SPLIT_FOREST, port) is None
    assert feasibility.check(Strategy.DEPTH_BUCKETED, ForestFacts(_port(mixed))) is None


def test_depth15_split_forest_matches_oracle():
    """Depth 15 runs on the deep kernel's route (kernel C cannot stage one
    393 KB tree)."""
    forest = synthetic.generate_forest(2, 15, 4, leaf_prob=0.02, seed=70)
    data = synthetic.generate_data(64, 4, missing_prob=0.1, seed=71)
    f = Forest(_port(forest), device="cpu")
    assert f.feasible(Strategy.SPLIT_FOREST) is None
    assert f.engine(Strategy.SPLIT_FOREST).kernel is FOLD_DEEP
    np.testing.assert_allclose(f.predict(data).numpy(), f.predict_oracle(data),
                               atol=ORACLE_ATOL, rtol=0)


def test_vmem_forest_needs_the_whole_forest_in_one_block():
    susy = Forest(_port(synthetic.susy_class_forest(seed=0)), device="cpu")
    assert "shared memory" in susy.feasible(Strategy.VMEM_FOREST)
    stumps = synthetic.generate_forest(800, 3, 10, leaf_prob=0.05,
                                       missing=-999.0, seed=72)
    data = synthetic.generate_data(100, 10, missing=-999.0, missing_prob=0.1,
                                   seed=73)
    f = Forest(_port(stumps), device="cpu")
    eng = f.engine(Strategy.VMEM_FOREST)
    assert eng.kernel is FOLD and eng.launch.tile_trees == 800
    np.testing.assert_allclose(f.predict(data, Strategy.VMEM_FOREST).numpy(),
                               f.predict_oracle(data), atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("cols,variant", [(9, DepthBucketedRankEngine),
                                          (26, DepthBucketedRankEngine),
                                          (90, DepthBucketedFoldEngine)])
def test_depth_bucketed_through_the_facade(tmp_path, cols, variant):
    out = int(Output.AVG | Output.SIGMOID)
    forest = synthetic.generate_mixed_depth_forest(40, 9, cols, missing=-999.0,
                                                   seed=cols)
    forest.output, forest.global_bias = out, 0.02
    data = synthetic.generate_data(90, cols, missing=-999.0, missing_prob=0.1,
                                   seed=cols + 1)
    model, rows = _files(tmp_path, forest, data, -999.0)
    f = Forest.from_files(model, rows, device="cpu", output=out,
                          global_bias=0.02)
    assert f.feasible(Strategy.DEPTH_BUCKETED) is None
    assert isinstance(f.engine(Strategy.DEPTH_BUCKETED), variant)
    np.testing.assert_allclose(
        f.predict(data, Strategy.DEPTH_BUCKETED).numpy(),
        oracle.predict(forest, data), atol=ORACLE_ATOL, rtol=0)
    uniform = Forest(_port(synthetic.generate_forest(10, 4, cols, seed=1)),
                     device="cpu")
    assert "uniform" in uniform.feasible(Strategy.DEPTH_BUCKETED)


# sweep families (the port's scripts/run_sweep.py SHAPES), each with the
# kernel fold_plan takes, measured the faster on the H100 (PERF.md section 6)
SWEEP_SHAPES = {
    "susy_like": FOLD,
    "allstate_like": FOLD_SIGN,
    "cup98_like": FOLD_SIGN,
    "gisette_like": FOLD_SIGN,
    "mnist_like": FOLD_SIGN,
    "deep13_like": FOLD_DEEP,
    "deep15_like": FOLD_DEEP,
    "stumps_like": FOLD,
}


@pytest.mark.parametrize("name", sorted(SWEEP_SHAPES))
def test_split_forest_feasible_where_jax_is(name):
    shape = shape_by_name(name)
    trees, depth, cols = shape[1:4]
    active = shape[6]["active"] if len(shape) > 6 else None
    spec = synthetic.generate_forest(trees, depth, cols, active_cols=active,
                                     seed=1)
    f = Forest(_port(spec), device="cpu")
    assert jax_feasibility.check(JaxStrategy.SPLIT_FOREST, _jax(f.spec)) is None
    assert f.feasible(Strategy.SPLIT_FOREST) is None
    eng = f.engine(Strategy.SPLIT_FOREST)
    live = jax_feasibility.fold_cols(_jax(f.spec))[0]
    assert eng.tables.num_cols == live
    assert eng.form == ("dual" if live <= 64 else "sign")
    assert f.facts.fold[:2] == (live, eng.form)
    assert eng.kernel is SWEEP_SHAPES[name]


def test_depth_bucketed_feasible_where_jax_is():
    """trained_mix-class, the sweep's DEPTH_BUCKETED family."""
    spec = synthetic.generate_mixed_depth_forest(300, 12, 26, seed=1)
    f = Forest(_port(spec), device="cpu")
    assert jax_feasibility.check(JaxStrategy.DEPTH_BUCKETED, _jax(f.spec)) is None
    assert f.feasible(Strategy.DEPTH_BUCKETED) is None
    assert isinstance(f.engine(Strategy.DEPTH_BUCKETED), DepthBucketedRankEngine)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    forest = synthetic.generate_forest(5, 3, 4, seed=71)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Forest(_port(forest), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("missing", [float("nan"), 7.5])
def test_canonicalize_rows(missing):
    x = np.array([[1.0, np.nan, 7.5, 7.5 + 2e-6, 7.5 - 5e-7],
                  [-0.0, 2.0, 3.0, np.inf, -7.5]], np.float32)
    got = canonicalize_rows(x, missing, device=torch.device("cpu"),
                            col_index=torch.tensor([4, 2, 1, 0]),
                            dual=True).numpy()
    want = x[:, [4, 2, 1, 0]].copy()
    miss = (np.isnan(want) if np.isnan(missing)
            else np.abs(want - np.float32(missing)) <= np.float32(MISSING_EPS))
    want[miss] = np.nan
    np.testing.assert_array_equal(got, np.concatenate([want, -want], axis=1))


@pytest.mark.parametrize("output", OUTPUTS)
def test_output_transform_matches_numpy(output):
    m = np.linspace(-30, 30, 101).astype(np.float32)
    got = apply_output_transform(torch.as_tensor(m), 500, output, 0.125, 0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np_transform(m, 500, output, 0.125, 0.5),
                               atol=1e-7, rtol=0)
