"""Port rank engine (kernels A and B's plain versions on the CPU) vs the JAX
package's RankFoldEngine (interpret mode) and the numpy oracle.

Margins are held to the JAX engine within 1e-5 (f32 sums are taken in
another order: the port sums leaves in f64, the TPU kernels in f32 tiles)
and to the oracle within ORACLE_ATOL.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tahoe_tpu.config import ORACLE_ATOL
from tahoe_tpu.forest import compiler, quantize, synthetic
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.rank_kernel import RankFoldEngine as JaxRankFoldEngine
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops.rank_kernel import (
    RankFoldEngine,
    _int32_matmul,
    rank_margins_fused_plain,
    rank_tables,
)

CPU = torch.device("cpu")
JAX_ATOL = 1e-5


def _port(spec):
    """A forest built by the JAX package, carried across to the port."""
    return from_arrays(dataclasses.asdict(spec))

# (depth, trees, cols, leaf_prob, missing, hot_swap, band, JAX engine kwargs)
CASES = {
    "depth1": (1, 17, 9, 0.0, float("nan"), False, None,
               dict(row_tile=16, tree_tile=32)),
    "whole_level": (4, 17, 9, 0.2, float("nan"), False, None,
                    dict(row_tile=16, tree_tile=32)),
    "split_level": (6, 40, 18, 0.1, float("nan"), True, None,
                    dict(row_tile=16, tree_tile=32, split_level=2)),
    "sentinel": (5, 25, 12, 0.15, -999.0, False, None,
                 dict(row_tile=16, tree_tile=16)),
    "banded": (6, 30, 9, 0.1, float("nan"), True, 50,
               dict(row_tile=16, tree_tile=16)),
}


def _case(name):
    depth, trees, cols, leaf_prob, missing, swap, band, jkw = CASES[name]
    forest = synthetic.generate_forest(trees, depth, cols, leaf_prob=leaf_prob,
                                       missing=missing, seed=depth * 10 + trees)
    if swap:
        forest = compiler.hot_child_swap(forest)
    data = synthetic.generate_data(64, cols, missing=missing, missing_prob=0.1,
                                   seed=trees + 1)
    k = min(cols, forest.nodes_per_tree)
    data[0, :k] = forest.values[0, :k]  # exact threshold hits
    return forest, data, band, jkw


@pytest.mark.parametrize("name", sorted(CASES))
def test_predict_matches_jax_and_oracle(name):
    forest, data, band, jkw = _case(name)
    eng = RankFoldEngine(_port(forest), device=CPU, band=band)
    if band is not None:
        assert eng.q.spec.num_cols > forest.num_cols
    got = eng.predict(data).numpy()
    jeng = JaxRankFoldEngine(forest, band=band, interpret=True, **jkw)
    if "split_level" in jkw:
        assert jeng.split_level == jkw["split_level"]
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["whole_level", "split_level", "banded"])
def test_predict_planes_matches_jax(name):
    """The plane-resident path: planes encoded once on the host by numpy."""
    forest, data, band, jkw = _case(name)
    eng = RankFoldEngine(_port(forest), device=CPU, band=band)
    gather = (slice(None) if eng.tables.col_index is None
              else eng.tables.col_index.numpy())
    planes = quantize.encode_rank_planes_np(
        quantize.transform_rows_np(eng.q, data[:, gather]))
    got = eng.predict_planes(planes).numpy()
    jeng = JaxRankFoldEngine(forest, band=band, interpret=True, **jkw)
    np.testing.assert_allclose(got, np.asarray(jeng.predict_planes(planes)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_array_equal(got, eng.predict(data).numpy())


def test_wide_five_groups_matches_oracle():
    """> 120 live features: G >= 5 plane groups (a 640-lane contraction)."""
    forest = synthetic.generate_forest(30, 5, 150, leaf_prob=0.1, seed=162)
    data = synthetic.generate_data(48, 150, missing_prob=0.1, seed=163)
    eng = RankFoldEngine(_port(forest), device=CPU)
    assert eng.groups >= 5
    np.testing.assert_allclose(eng.predict(data).numpy(),
                               oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_tables_layout():
    """mats[t, 2^d - 1 + j] is column (t, j) of rank_normalize's level d."""
    forest = synthetic.generate_forest(7, 3, 5, leaf_prob=0.2, seed=9)
    t = rank_tables(_port(forest), device=CPU)
    lev = compiler.levelize(quantize.quantized_spec_for_engines(t.q))
    mats, leaf = compiler.rank_normalize(lev)
    assert t.mats.shape == (7, 7, 128) and t.leaf.shape == (7, 8)
    for d, m in enumerate(mats):
        for j in range(1 << d):
            assert np.array_equal(t.mats[:, (1 << d) - 1 + j, :].numpy(),
                                  m[:, :, j].T)
    assert np.array_equal(t.leaf.numpy(), leaf)


def test_int32_matmul_is_exact():
    """int8 @ int8 wraps in torch; the plain version needs int32 sums."""
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, (40, 256)).astype(np.int8)
    b = rng.integers(-128, 128, (256, 24)).astype(np.int8)
    a[0] = -128
    b[:, 0] = -128
    got = _int32_matmul(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_too_many_features_rejected():
    forest = synthetic.generate_forest(900, 4, 700, seed=159)
    with pytest.raises(NotImplementedError):
        RankFoldEngine(_port(forest), device=CPU)



# tests/test_rank_kernel.py:317-345: (forest args, seed, rows, missing share,
# data seed), with the JAX engine's fusion-eligible grid
FUSED_CASES = {
    "multi_tile": ((64, 6, 12), 91, 700, 0.1, 92),
    "single_row_tile": ((150, 6, 10), 93, 96, 0.05, 94),
}
JAX_FUSED_KW = dict(row_tile=128, tree_tile=8, split_level=4,
                    stream_once=False, fuse_transform=True, interpret=True)


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_predict_matches_unfused_and_jax(name):
    """The fused path (the fused kernel's plain version on the CPU) is bit
    for bit the two-kernel path, and within JAX_ATOL of the JAX fused engine
    in interpret mode (its kernels sum leaves in f32, the port in f64)."""
    args, seed, rows, miss, data_seed = FUSED_CASES[name]
    forest = synthetic.generate_forest(*args, seed=seed)
    data = synthetic.generate_data(rows, args[2], missing_prob=miss,
                                   seed=data_seed)
    fused = RankFoldEngine(_port(forest), device=CPU, fuse_transform=True)
    unfused = RankFoldEngine(_port(forest), device=CPU)
    jeng = JaxRankFoldEngine(forest, **JAX_FUSED_KW)
    assert fused.fused and not unfused.fused
    assert fused.fused == jeng._fuse
    got = fused.predict(data).numpy()
    np.testing.assert_array_equal(got, unfused.predict(data).numpy())
    t = fused.tables
    np.testing.assert_array_equal(
        fused.margins(data).numpy(),
        rank_margins_fused_plain(t.rows(data, fused.raw_missing), t.thresholds,
                                 t.counts, t.mats, t.leaf, t.depth).numpy())
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(40, 5, 45), (4, 6, 6)],
                         ids=["two_groups", "few_thresholds"])
def test_fused_gate_follows_jax(shape):
    """More than 30 virtual features (two plane groups), or at most 256
    thresholds in the widest feature (the JAX engine's flat transform),
    leave the fused kernel off, as the JAX gate does."""
    forest = synthetic.generate_forest(*shape, seed=95)
    eng = RankFoldEngine(_port(forest), device=CPU, fuse_transform=True)
    jeng = JaxRankFoldEngine(forest, **JAX_FUSED_KW)
    assert not eng.fused and not jeng._fuse
    data = synthetic.generate_data(40, shape[2], missing_prob=0.1, seed=96)
    np.testing.assert_allclose(eng.predict(data).numpy(),
                               oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)
