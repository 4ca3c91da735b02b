"""The port's plain torch strategies on the CPU: GatherEngine (HBM_DIRECT)
and TensorEngine (ROW_TILED "take", TENSOR "onehot") against their JAX
counterparts on the same compiled or leveled forest, and the numpy oracle;
their feasibility reasons against the JAX package's.

Margins are held to JAX within 1e-5 (the per-node math is the same, the
f32 tree sums run in another order) and predictions to the oracle within
ORACLE_ATOL.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from tahoe_tpu.config import ORACLE_ATOL, Output
from tahoe_tpu.config import Strategy as JaxStrategy
from tahoe_tpu.engine import feasibility as jax_feasibility
from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.gather_engine import GatherEngine as JaxGatherEngine
from tahoe_tpu.ops.tensor_engine import TensorEngine as JaxTensorEngine
from tahoe_tpu_torch import Forest, Strategy
from tahoe_tpu_torch.engine import feasibility
from tahoe_tpu_torch.engine.feasibility import ForestFacts
from tahoe_tpu_torch.forest import compiler as port_compiler
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops import rows as rows_mod
from tahoe_tpu_torch.ops.fold_kernel import fold_table_bytes
from tahoe_tpu_torch.ops.gather_engine import GatherEngine
from tahoe_tpu_torch.ops.tensor_engine import TensorEngine

CPU = torch.device("cpu")
JAX_ATOL = 1e-5


def _port(spec):
    """A forest built by the JAX package, carried across to the port."""
    return from_arrays(dataclasses.asdict(spec))

# (depth, trees, cols, leaf_prob, missing, output) of tests/test_gather_engine.py
# and tests/test_tensor_engine.py, plus a finite sentinel and AVG|SIGMOID
CASES = {
    "stumps": (0, 3, 2, 0.0, float("nan"), 0),
    "depth1": (1, 4, 3, 0.0, float("nan"), 0),
    "early_leaves": (4, 17, 9, 0.2, float("nan"), 0),
    "depth6": (6, 40, 30, 0.1, float("nan"), 0),
    "sentinel": (5, 11, 5, 0.1, -999.0, 0),
    "avg_sigmoid": (3, 9, 6, 0.0, float("nan"),
                    int(Output.AVG | Output.SIGMOID)),
}


def _case(name):
    depth, trees, cols, leaf_prob, missing, output = CASES[name]
    forest = synthetic.generate_forest(trees, depth, cols, leaf_prob=leaf_prob,
                                       missing=missing, output=output,
                                       global_bias=0.1 if output else 0.0,
                                       seed=depth + trees)
    data = synthetic.generate_data(37, cols, missing=missing, missing_prob=0.15,
                                   seed=depth + 100)
    return forest, data


@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_engine_matches_jax(name):
    """Both run on the hot-swapped, clustered forest, as both facades do."""
    forest, data = _case(name)
    compiled = compiler.compile_forest(forest)[0]
    got = GatherEngine(_port(compiled), device=CPU).predict(data)
    assert got.dtype == torch.float32 and got.shape == (37,)
    want = np.asarray(JaxGatherEngine(compiled).predict(data))
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["take", "onehot"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_engine_matches_jax(name, mode):
    forest, data = _case(name)
    lev = compiler.levelize(compiler.hot_child_swap(forest))
    port_lev = port_compiler.levelize(port_compiler.hot_child_swap(_port(forest)))
    got = TensorEngine(port_lev, select_mode=mode, device=CPU).predict(data)
    want = np.asarray(JaxTensorEngine(lev, select_mode=mode,
                                      row_tile=16).predict(data))
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_onehot_selects_values_exactly():
    """The one-hot matmul selects every f32 value bit-exactly, so both modes
    give the same margins, bit for bit, even for values near the
    thresholds, infinities, -0.0 and denormals. (The JAX engine's matmul
    turns a row with an infinity into NaNs, inf * 0.)"""
    forest = compiler.hot_child_swap(synthetic.generate_forest(
        25, 6, 20, leaf_prob=0.1, seed=7))
    data = synthetic.generate_data(200, 20, missing_prob=0.1, seed=8) * 1e3
    data[0, :] = forest.values[0, :20]   # exact threshold hits
    data[1, :] = np.nextafter(forest.values[1, :20], np.float32(-np.inf))
    data[2, :4] = [np.inf, -np.inf, -0.0, 1e-40]
    data[3, :] = np.inf
    lev = port_compiler.levelize(_port(forest))
    take = TensorEngine(lev, select_mode="take", device=CPU).margins(data)
    onehot = TensorEngine(lev, select_mode="onehot", device=CPU).margins(data)
    assert torch.equal(take, onehot)
    np.testing.assert_allclose(take.numpy(), oracle.predict_margins(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_row_chunks_do_not_change_the_margins(monkeypatch):
    forest, data = _case("depth6")
    forest = _port(forest)
    lev = port_compiler.levelize(forest)
    engines = [GatherEngine(forest, device=CPU),
               TensorEngine(lev, select_mode="take", device=CPU),
               TensorEngine(lev, select_mode="onehot", device=CPU)]
    whole = [e.margins(data) for e in engines]
    monkeypatch.setattr(rows_mod, "ROW_CHUNK_BYTES", 1)
    sizes = []
    rows_mod.map_row_chunks(lambda c: sizes.append(len(c)) or c[:, 0],
                            torch.as_tensor(data), 100)
    assert sizes == [1] * 37
    for e, w in zip(engines, whole):
        assert torch.equal(e.margins(data), w)
        assert e.margins(data[:0]).shape == (0,)


def test_facade_builds_layouts_only_for_their_strategies():
    f = Forest(_port(synthetic.generate_forest(12, 5, 8, leaf_prob=0.1, seed=9)),
               device=CPU)
    data = synthetic.generate_data(30, 8, missing_prob=0.1, seed=10)
    for s in (Strategy.SPLIT_FOREST, Strategy.RANK_MXU, Strategy.SPARSE):
        f.predict(data, s)
    assert "compiled" not in vars(f) and "leveled" not in vars(f)
    f.predict(data, Strategy.HBM_DIRECT)
    assert "compiled" in vars(f) and "leveled" not in vars(f)
    assert isinstance(f.engine(Strategy.HBM_DIRECT), GatherEngine)
    np.testing.assert_array_equal(f.engine(Strategy.HBM_DIRECT).values.numpy(),
                                  f.compiled.values.T)
    f.predict(data, Strategy.TENSOR)
    assert f.engine(Strategy.TENSOR).select_mode == "onehot"
    assert f.engine(Strategy.ROW_TILED).select_mode == "take"


@pytest.mark.parametrize("depth,trees", [(14, 2), (15, 2)])
def test_leveled_depth_cap_matches_jax(depth, trees):
    spec = synthetic.generate_forest(trees, depth, 4, seed=11)
    for s in (Strategy.ROW_TILED, Strategy.TENSOR):
        jax_reason = jax_feasibility.check(JaxStrategy[s.name], spec)
        port_reason = feasibility.check(s, ForestFacts(_port(spec)))
        assert (jax_reason is None) == (port_reason is None)


@pytest.mark.parametrize("trees,depth,feasible", [(120, 16, True),
                                                  (200, 18, True),
                                                  (400, 18, True),
                                                  (500, 20, False)])
def test_fold_table_cap(trees, depth, feasible):
    """The fold strategies' tables at the deep kernel's route, 17.3 bytes
    a tree-node of 2^depth (thresholds, codes, one copy of the leaves,
    blocks): rf_deep16- (0.14 GB), rf_deep18-class (0.91 GB) and 400 trees
    of depth 18 (1.81 GB) pass the 2 GiB cap, 500 trees of depth 20
    (8.5 GiB) do not; the JAX package states no such cap for
    SPLIT_FOREST, so this refusal is the port's own."""
    nbytes = fold_table_bytes(trees, depth)
    assert 17.3 < nbytes / (trees << depth) < 17.4
    assert (nbytes <= feasibility.TABLE_CAP_BYTES) == feasible
    if not feasible:
        shape = types.SimpleNamespace(num_trees=trees, depth=depth)
        for s in (Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST):
            reason = feasibility.check(s, ForestFacts(shape))
            assert "dense fold tables" in reason and "> 2 GiB" in reason


@pytest.mark.parametrize("trees,depth,feasible", [(200, 18, True),
                                                  (500, 20, False)])
def test_table_caps(monkeypatch, trees, depth, feasible):
    """HBM_DIRECT's complete-tree tables are capped at 2 GiB, as in the JAX
    package, priced at the port's 9 bytes a node; the dense rank tables too
    (200 trees of depth 18 would take 6.7 GB)."""
    shape = types.SimpleNamespace(num_trees=trees, depth=depth)
    reason = feasibility.check(Strategy.HBM_DIRECT, ForestFacts(shape))
    assert (reason is None) == feasible
    assert (jax_feasibility.check(JaxStrategy.HBM_DIRECT, shape) is None) == feasible
    if not feasible:
        assert "dense node tables" in reason and "> 2 GiB" in reason
    # two depth-16 trees' rank tables take 2 x 65,535 x 128 + 2 x 65,536 x 4
    # bytes, 17.3 MB
    deep = ForestFacts(_port(synthetic.generate_forest(2, 16, 4, seed=12)))
    assert feasibility.check(Strategy.RANK_MXU, deep) is None
    monkeypatch.setattr(feasibility, "TABLE_CAP_BYTES", 17_300_000)
    assert "dense rank tables" in feasibility.check(Strategy.RANK_MXU, deep)
