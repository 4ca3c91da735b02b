"""Port DEPTH_BUCKETED (ops/bucketed.py, plain versions on the CPU) vs the
JAX package's depth-bucketed engines (interpret mode) and the numpy oracle.

Margins are held to the JAX engines within 1e-5 and to the oracle within
ORACLE_ATOL.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tahoe_tpu.config import ORACLE_ATOL
from tahoe_tpu.config import Strategy as JaxStrategy
from tahoe_tpu.engine import feasibility as jax_feasibility
from tahoe_tpu.forest import synthetic
from tahoe_tpu.ops import bucketed as jax_bucketed
from tahoe_tpu.ops import oracle
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops.bucketed import (
    DepthBucketedFoldEngine,
    DepthBucketedRankEngine,
    make_depth_bucketed_engine,
    plan_buckets,
    subset_trees,
)
from tahoe_tpu_torch.config import Strategy
from tahoe_tpu_torch.engine import feasibility
from tahoe_tpu_torch.engine.feasibility import ForestFacts
from tahoe_tpu_torch.ops.fold_kernel import (
    FOLD,
    FOLD_DEEP,
    FOLD_DEEP_NONGE,
    FOLD_NONGE,
    deep_block_walk,
    fold_margins_plain,
    heap_tables,
)

CPU = torch.device("cpu")
JAX_ATOL = 1e-5


def _port(spec):
    """A forest built by the JAX package, carried across to the port."""
    return from_arrays(dataclasses.asdict(spec))


def _mixed_depth_forest(trees=24, stored=7, cols=9, seed=5, missing=float("nan")):
    """A third of the trees end by depth 3, a third by depth 5, the rest run
    the full stored depth (tests/test_bucketed.py's forest)."""
    f = synthetic.generate_forest(trees, stored, cols, leaf_prob=0.05,
                                  missing=missing, seed=seed)
    third = trees // 3
    f.is_leaf[:third, f.level_slice(3).start:] = True
    f.is_leaf[third:2 * third, f.level_slice(5).start:] = True
    return f


def _check(got, jeng, forest, data):
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("seed", range(6))
def test_plan_buckets_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    depths = rng.integers(0, 1 + int(rng.integers(1, 16)), n).astype(np.int32)
    max_buckets = int(rng.integers(1, 6))
    min_count = int(rng.choice([1, 8]))
    got = plan_buckets(depths, max_buckets, min_count)
    want = jax_bucketed.plan_buckets(depths, max_buckets, min_count)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_subset_trees_matches_jax():
    f = _mixed_depth_forest()
    idx = np.array([1, 5, 7, 20], np.int64)
    got, want = subset_trees(_port(f), idx), jax_bucketed.subset_trees(f, idx)
    for name in ("values", "weights", "fids", "def_left", "is_leaf", "exchange"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.num_cols == want.num_cols and got.depth == want.depth


@pytest.mark.parametrize("missing_prob", [0.0, 0.15])
def test_bucketed_fold_matches_jax(missing_prob):
    f = _mixed_depth_forest()
    data = synthetic.generate_data(70, f.num_cols, missing_prob=missing_prob,
                                   seed=7)
    eng = DepthBucketedFoldEngine(_port(f), device=CPU)
    assert eng.ge_mode and len(eng.sub) >= 2
    assert {e.kernel for e in eng.sub} <= {FOLD, FOLD_DEEP}
    jeng = jax_bucketed.DepthBucketedFoldEngine(f, row_tile=8, tree_tile=16,
                                                interpret=True)
    assert eng.bucket_plan == jeng.bucket_plan
    _check(eng.predict(data).numpy(), jeng, f, data)


def test_bucketed_fold_non_ge_matches_jax():
    """65-128 columns: every bucket in the non-ge form, on kernel C."""
    f = _mixed_depth_forest(trees=30, cols=90, seed=31, missing=-999.0)
    data = synthetic.generate_data(50, 90, missing=-999.0, missing_prob=0.1,
                                   seed=32)
    eng = DepthBucketedFoldEngine(_port(f), device=CPU)
    assert not eng.ge_mode
    assert all(e.form == "nonge" and e.kernel is FOLD_NONGE for e in eng.sub)
    jeng = jax_bucketed.DepthBucketedFoldEngine(f, row_tile=8, tree_tile=16,
                                                interpret=True)
    _check(eng.predict(data).numpy(), jeng, f, data)


def test_bucketed_fold_non_ge_deep_buckets():
    """A 90-column forest stored to depth 14: its shallow buckets in the
    non-ge form on kernel C, the depth-14 bucket, which no ring of kernel C
    holds, on the deep kernel's non-ge instance (fold_plan); the margins
    against the oracle, and the walk of the blocks both kernels read against
    the plain version bit for bit."""
    f = _mixed_depth_forest(trees=9, stored=14, cols=90, seed=33, missing=-999.0)
    data = synthetic.generate_data(24, 90, missing=-999.0, missing_prob=0.1,
                                   seed=34)
    port = _port(f)
    assert feasibility.check(Strategy.DEPTH_BUCKETED, ForestFacts(port)) is None
    eng = DepthBucketedFoldEngine(port, device=CPU)
    assert [e.tables.depth for e in eng.sub] == [3, 14]
    assert [e.kernel for e in eng.sub] == [FOLD_NONGE, FOLD_DEEP_NONGE]
    np.testing.assert_allclose(eng.predict(data).numpy(), oracle.predict(f, data),
                               atol=ORACLE_ATOL, rtol=0)
    x = eng.sub[0].canonicalize(data)
    for e in eng.sub:
        assert torch.equal(deep_block_walk(x, e.tables, heap_tables(e.tables)),
                           fold_margins_plain(x, e.tables))


def test_bucketed_fold_with_stump_bucket():
    f = _mixed_depth_forest(seed=11)
    f.is_leaf[:9, :] = True  # nine stumps: a bucket of constant margin
    data = synthetic.generate_data(25, f.num_cols, seed=12)
    eng = DepthBucketedFoldEngine(_port(f), device=CPU)
    assert eng.stumps_margin == pytest.approx(float(f.values[:9, 0].sum()),
                                              abs=1e-6)
    jeng = jax_bucketed.DepthBucketedFoldEngine(f, row_tile=8, tree_tile=16,
                                                interpret=True)
    _check(eng.predict(data).numpy(), jeng, f, data)


@pytest.mark.parametrize("missing_prob", [0.0, 0.15])
def test_bucketed_rank_matches_jax(missing_prob):
    f = _mixed_depth_forest()
    data = synthetic.generate_data(70, f.num_cols, missing_prob=missing_prob,
                                   seed=17)
    eng = DepthBucketedRankEngine(_port(f), device=CPU)
    assert len(eng.sub) >= 2
    # one threshold table, so one kernel-A transform, for every bucket
    for e in eng.sub[1:]:
        assert torch.equal(e.tables.thresholds, eng.sub[0].tables.thresholds)
    jeng = jax_bucketed.DepthBucketedRankEngine(f, row_tile=32, tree_tile=8,
                                                interpret=True)
    assert eng.bucket_plan == jeng.bucket_plan
    _check(eng.predict(data).numpy(), jeng, f, data)


def test_bucketed_rank_with_stump_bucket_and_sentinel():
    f = _mixed_depth_forest(seed=13, missing=-999.0)
    f.is_leaf[:9, :] = True  # nine stumps: a bucket of constant margin
    data = synthetic.generate_data(40, f.num_cols, missing=-999.0,
                                   missing_prob=0.1, seed=14)
    eng = DepthBucketedRankEngine(_port(f), device=CPU)
    assert eng.stumps_margin == pytest.approx(float(f.values[:9, 0].sum()),
                                              abs=1e-6)
    jeng = jax_bucketed.DepthBucketedRankEngine(f, row_tile=32, tree_tile=8,
                                                interpret=True)
    _check(eng.predict(data).numpy(), jeng, f, data)


@pytest.mark.parametrize("cols,variant", [(9, DepthBucketedRankEngine),
                                          (125, DepthBucketedFoldEngine)])
def test_make_depth_bucketed_engine_chooses_as_jax(cols, variant):
    f = _mixed_depth_forest(cols=cols, seed=21)
    eng = make_depth_bucketed_engine(_port(f), device=CPU)
    jeng = jax_bucketed.make_depth_bucketed_engine(f, row_tile=32,
                                                   interpret=True)
    assert isinstance(eng, variant)
    assert type(jeng).__name__ == variant.__name__
    data = synthetic.generate_data(30, cols, missing_prob=0.05, seed=22)
    _check(eng.predict(data).numpy(), jeng, f, data)


def test_rank_variant_refusal_falls_to_fold():
    """All stumps: the rank variant has no bucket to run, the fold variant
    returns the constant margin."""
    f = synthetic.generate_forest(10, 3, 5, seed=41)
    f.is_leaf[:] = True
    eng = make_depth_bucketed_engine(_port(f), device=CPU)
    assert isinstance(eng, DepthBucketedFoldEngine) and not eng.sub
    data = synthetic.generate_data(12, 5, seed=42)
    np.testing.assert_allclose(eng.predict(data).numpy(),
                               oracle.predict(f, data), atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("cols,variant", [(62, DepthBucketedFoldEngine),
                                          (9, DepthBucketedRankEngine)])
def test_depth17_bucket_matches_jax(cols, variant):
    """Eight trees that end by depth 4 and two of depth 17, in two buckets:
    the fold variant (62 live features take three plane groups) runs the
    depth-17 bucket on the deep kernel and the other on kernel C; the rank
    variant runs both on kernel B. Each against the JAX engine in
    interpret mode (the fold variant's depth-17 bucket through the JAX
    subtree-split fold) and the oracle; the feasibility checks of both
    packages admit the forest."""
    f = synthetic.generate_forest(10, 17, cols, leaf_prob=0.02, seed=3)
    f.is_leaf[:8, f.level_slice(4).start:] = True
    data = synthetic.generate_data(24, cols, missing_prob=0.1, seed=2)
    port = _port(f)
    assert feasibility.check(Strategy.DEPTH_BUCKETED, ForestFacts(port)) is None
    assert jax_feasibility.check(JaxStrategy.DEPTH_BUCKETED, f) is None
    eng = make_depth_bucketed_engine(port, device=CPU)
    jeng = jax_bucketed.make_depth_bucketed_engine(f, row_tile=8, interpret=True)
    assert isinstance(eng, variant) and type(jeng).__name__ == variant.__name__
    assert eng.bucket_plan == jeng.bucket_plan == [(8, 4), (2, 17)]
    if variant is DepthBucketedFoldEngine:
        assert [e.kernel for e in eng.sub] == [FOLD, FOLD_DEEP]
        x = eng.sub[0].canonicalize(data)
        deep = eng.sub[1]
        assert torch.equal(deep_block_walk(x, deep.tables, deep.heap),
                           fold_margins_plain(x, deep.tables))
    _check(eng.predict(data).numpy(), jeng, f, data)
