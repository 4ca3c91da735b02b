"""Port f32 fold (the plain version of kernel C and the deep kernel, on the
CPU) vs the JAX package's FoldKernelEngine in its dual, sign, non-ge and
subtree-split forms (interpret mode) and the numpy oracle.

Margins are held to the JAX engine within 1e-5 (the port sums leaves in f64,
the TPU kernel in f32 tiles) and to the oracle within ORACLE_ATOL.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tahoe_tpu.config import ORACLE_ATOL
from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.fold_kernel import FoldKernelEngine as JaxFoldKernelEngine
from tahoe_tpu_torch.config import GpuLimits
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops.fold_kernel import (
    FOLD,
    MAX_DUAL_COLS,
    FOLD_DEEP,
    FOLD_DEEP_SIGN,
    FOLD_NONGE,
    FOLD_SIGN,
    NONGE_FID,
    NONGE_FLIP,
    NONGE_SEL_LT,
    DeepLaunch,
    FoldKernelEngine,
    FoldLaunch,
    FoldTables,
    deep_block_count,
    deep_block_walk,
    deep_blocks,
    deep_groups,
    fold_launch,
    fold_margins_plain,
    fold_plan,
    fold_tables,
)

CPU = torch.device("cpu")
JAX_ATOL = 1e-5


def _port(spec):
    """A forest built by the JAX package, carried across to the port."""
    return from_arrays(dataclasses.asdict(spec))


def _forest(depth, trees, cols, leaf_prob, def_left, swap, missing, seed):
    forest = synthetic.generate_forest(trees, depth, cols, leaf_prob=leaf_prob,
                                       missing=missing, seed=seed)
    if def_left == "left":
        forest.def_left[:] = True
    elif def_left == "right":
        forest.def_left[:] = False
    return compiler.hot_child_swap(forest) if swap else forest


# (depth, trees, cols, leaf_prob, def_left, hot_swap, missing)
CASES = {
    "stumps": (0, 3, 2, 0.0, "mixed", False, float("nan")),
    "depth1": (1, 5, 3, 0.0, "mixed", False, float("nan")),
    "early_leaves": (4, 17, 9, 0.2, "mixed", False, float("nan")),
    "all_left_swapped": (5, 40, 18, 0.15, "left", True, float("nan")),
    "all_right_sentinel": (6, 25, 12, 0.1, "right", False, -999.0),
    "mixed_swapped_sentinel": (6, 33, 16, 0.3, "mixed", True, -999.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_predict_matches_jax_and_oracle(name):
    depth, trees, cols, leaf_prob, def_left, swap, missing = CASES[name]
    forest = _forest(depth, trees, cols, leaf_prob, def_left, swap, missing,
                     seed=depth + trees)
    data = synthetic.generate_data(64, cols, missing=missing, missing_prob=0.15,
                                   seed=trees)
    k = min(cols, forest.nodes_per_tree)
    data[0, :k] = forest.values[0, :k]  # exact threshold hits
    eng = FoldKernelEngine(_port(forest), device=CPU)
    assert eng.form == "dual" and eng.kernel is FOLD
    got = eng.predict(data).numpy()
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=16,
                               tree_tile=32, interpret=True)
    assert jeng.ge_mode and not jeng.sign_form
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_compacted_wide_forest_matches_jax():
    """100 columns, 30 live: the dual-lane form after feature compaction."""
    forest = synthetic.generate_forest(20, 5, 100, leaf_prob=0.1,
                                       active_cols=30, seed=41)
    data = synthetic.generate_data(64, 100, missing_prob=0.1, seed=42)
    eng = FoldKernelEngine(_port(forest), device=CPU)
    assert eng.tables.col_index is not None and eng.tables.num_cols <= 30
    got = eng.predict(data).numpy()
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=16,
                               tree_tile=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_zero_and_denormal_thresholds_match_oracle():
    """Thresholds at +-0 and at denormals; ge_normalize's negated-lane
    thresholds nextafter(-t, +inf) are denormal there. Exact against the
    numpy oracle (the JAX CPU interpret path flushes denormals). The
    tolerance only absorbs summation order: a wrong route moves a margin by
    the difference of two random leaves."""
    forest = _forest(3, 12, 4, 0.0, "mixed", True, float("nan"), seed=7)
    internal = ~forest.is_leaf
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40], np.float32)
    rng = np.random.default_rng(8)
    forest.values[internal] = rng.choice(special, internal.sum())
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 2e-45, 1e-40, -1e-40, 3e-40,
                     -3e-40, np.nan, 1.0, -1.0], np.float32)
    data = rng.choice(vals, (200, 4)).astype(np.float32)
    got = FoldKernelEngine(_port(forest), device=CPU).margins(data).numpy()
    np.testing.assert_allclose(got, oracle.predict_margins(forest, data),
                               atol=JAX_ATOL, rtol=0)


def test_tables_layout():
    """thresholds/fids[t, 2^d - 1 + j] is column (t, j) of ge_normalize's
    level d."""
    forest = synthetic.generate_forest(6, 3, 5, leaf_prob=0.2, seed=10)
    t = fold_tables(_port(forest), device=CPU)
    fid_l, thr_l, leaf = compiler.ge_normalize(compiler.levelize(forest))
    for d in range(3):
        sl = slice((1 << d) - 1, (2 << d) - 1)
        np.testing.assert_array_equal(t.thresholds[:, sl].numpy(), thr_l[d])
        np.testing.assert_array_equal(t.fids[:, sl].numpy(), fid_l[d])
    np.testing.assert_array_equal(t.leaf.numpy(), leaf)


def _sparse_wide_forest(trees, depth, num_cols, active, seed, **kw):
    """A forest over ``num_cols`` columns whose fids hit ``active`` of them
    (as tests/test_compact.py builds it)."""
    rng = np.random.default_rng(seed)
    f = synthetic.generate_forest(trees, depth, active, seed=seed, **kw)
    cols = np.sort(rng.choice(num_cols, size=active, replace=False))
    f.fids = cols[f.fids].astype(np.int32)
    f.num_cols = num_cols
    return f


# (trees, depth, num_cols, active, missing)
SIGN_CASES = {
    "live70": (30, 5, 70, 70, float("nan")),
    "live130_sentinel": (24, 5, 130, 130, -999.0),
    "cup98_class": (20, 5, 479, 300, float("nan")),
    "live512_sentinel": (40, 6, 600, 512, -999.0),
}


@pytest.mark.parametrize("name", sorted(SIGN_CASES))
def test_sign_form_matches_jax_and_oracle(name):
    trees, depth, num_cols, active, missing = SIGN_CASES[name]
    forest = compiler.hot_child_swap(_sparse_wide_forest(
        trees, depth, num_cols, active, seed=trees + active, leaf_prob=0.1,
        missing=missing))
    data = synthetic.generate_data(48, num_cols, missing=missing,
                                   missing_prob=0.1, seed=active)
    eng = FoldKernelEngine(_port(forest), device=CPU)
    assert eng.form == "sign" and eng.kernel in (FOLD_SIGN, FOLD_DEEP_SIGN)
    assert MAX_DUAL_COLS < eng.tables.num_cols <= 512
    assert eng.canonicalize(data).shape == (48, eng.tables.num_cols)
    got = eng.predict(data).numpy()
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=16,
                               tree_tile=32, interpret=True)
    assert jeng.sign_form and jeng.num_cols == eng.tables.num_cols
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


# (trees, depth, cols, leaf_prob, def_left, hot_swap, missing)
NONGE_CASES = {
    "small": (5, 3, 4, 0.0, "mixed", False, float("nan")),
    "left_swapped": (21, 5, 18, 0.15, "left", True, float("nan")),
    "right_sentinel": (17, 6, 40, 0.1, "right", False, -999.0),
    "cols90_swapped_sentinel": (30, 5, 90, 0.2, "mixed", True, -999.0),
}


@pytest.mark.parametrize("name", sorted(NONGE_CASES))
def test_non_ge_matches_jax_and_oracle(name):
    trees, depth, cols, leaf_prob, def_left, swap, missing = NONGE_CASES[name]
    forest = _forest(depth, trees, cols, leaf_prob, def_left, swap, missing,
                     seed=cols + trees)
    data = synthetic.generate_data(40, cols, missing=missing, missing_prob=0.15,
                                   seed=cols)
    data[0, :min(cols, 7)] = forest.values[0, :min(cols, 7)]  # threshold hits
    eng = FoldKernelEngine(_port(forest), device=CPU, ge_mode=False)
    assert eng.form == "nonge" and eng.kernel is FOLD_NONGE
    assert eng.tables.col_index is None  # no compaction up to 128 columns
    got = eng.predict(data).numpy()
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=8,
                               tree_tile=32, ge_mode=False, interpret=True)
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("split_level", [4, 5])
def test_deep_form_matches_jax_split(split_level):
    """The deep kernel's tables and plain version against the JAX subtree-
    split fold at depth 10 (tests/test_fold_kernel.py:95-109)."""
    forest = synthetic.generate_forest(12, 10, 12, leaf_prob=0.1, seed=91)
    data = synthetic.generate_data(33, 12, missing_prob=0.1, seed=92)
    got = FoldKernelEngine(_port(forest), device=CPU).predict(data).numpy()
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=8,
                               tree_tile=16, interpret=True,
                               split_level=split_level)
    assert jeng.split_level == split_level
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_deep_sign_form_matches_jax_split():
    """Wide and deep: the sign form through the JAX split fold."""
    forest = _sparse_wide_forest(16, 7, 600, 150, seed=9, missing=-999.0)
    data = synthetic.generate_data(40, 600, missing=-999.0, missing_prob=0.05,
                                   seed=5)
    got = FoldKernelEngine(_port(forest), device=CPU).predict(data).numpy()
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=8,
                               tree_tile=64, split_level=3, interpret=True)
    assert jeng.sign_form and jeng.split_level == 3
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)


def test_depth15_matches_oracle_on_the_deep_route():
    forest = synthetic.generate_forest(3, 15, 6, leaf_prob=0.02, seed=95)
    data = synthetic.generate_data(50, 6, missing_prob=0.1, seed=96)
    eng = FoldKernelEngine(_port(forest), device=CPU)
    assert eng.kernel is FOLD_DEEP and isinstance(eng.launch, DeepLaunch)
    blocks = eng.blocks.numpy()
    assert blocks.shape == (3, deep_block_count(15), 4)
    # the root group is level 0 alone; every other block holds 3 nodes
    thr = eng.tables.thresholds.numpy()
    assert np.array_equal(blocks[:, 0, 0].view(np.float32), thr[:, 0],
                          equal_nan=True)
    assert np.array_equal(np.sort(blocks[:, 1:, :3].reshape(3, -1).view(np.float32)),
                          np.sort(thr[:, 1:]), equal_nan=True)
    np.testing.assert_allclose(eng.predict(data).numpy(),
                               oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["sign", "nonge"])
def test_zero_and_denormal_thresholds_match_oracle_forms(form):
    """The ±0/denormal case of the dual form, repeated for the sign form
    (> 64 live features) and the non-ge form, held to numpy."""
    cols = 80 if form == "sign" else 6
    forest = _forest(5, 40, cols, 0.0, "mixed", True, float("nan"), seed=17)
    internal = ~forest.is_leaf
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40], np.float32)
    rng = np.random.default_rng(18)
    forest.values[internal] = rng.choice(special, internal.sum())
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 2e-45, 1e-40, -1e-40, 3e-40,
                     -3e-40, np.nan, 1.0, -1.0], np.float32)
    data = rng.choice(vals, (200, cols)).astype(np.float32)
    eng = FoldKernelEngine(_port(forest), device=CPU, ge_mode=form == "sign")
    assert eng.form == form
    np.testing.assert_allclose(eng.margins(data).numpy(),
                               oracle.predict_margins(forest, data),
                               atol=JAX_ATOL, rtol=0)


def test_sign_and_non_ge_tables_layout():
    """The sign form's code is f, or ~f for a negated node; the non-ge code
    packs levelize's fid with sel_lt = def_right ^ invert and flip =
    def_right."""
    forest = compiler.hot_child_swap(_sparse_wide_forest(
        40, 5, 200, 90, seed=31, leaf_prob=0.2))
    t = fold_tables(_port(forest), device=CPU)
    lev, _ = compiler.compact_leveled(compiler.levelize(forest))
    fid_l, thr_l, _ = compiler.ge_normalize(lev)
    F = lev.num_cols
    assert t.form == "sign" and t.num_cols == F and t.width == F
    for d in range(5):
        sl = slice((1 << d) - 1, (2 << d) - 1)
        code = t.fids[:, sl].numpy()
        np.testing.assert_array_equal(np.where(code < 0, ~code + F, code), fid_l[d])
        np.testing.assert_array_equal(t.thresholds[:, sl].numpy(), thr_l[d])
    small = compiler.hot_child_swap(synthetic.generate_forest(
        7, 3, 5, leaf_prob=0.2, seed=32))
    t = fold_tables(_port(small), device=CPU, ge_mode=False)
    lev = compiler.levelize(small)
    assert t.form == "nonge" and t.width == 5
    for d in range(3):
        code = t.fids[:, (1 << d) - 1:(2 << d) - 1].numpy()
        np.testing.assert_array_equal(code & NONGE_FID, lev.fid[d])
        np.testing.assert_array_equal((code & NONGE_SEL_LT) != 0,
                                      lev.def_right[d] ^ lev.invert[d])
        np.testing.assert_array_equal((code & NONGE_FLIP) != 0, lev.def_right[d])
    np.testing.assert_array_equal(t.leaf.numpy(), lev.leaf_values)


@pytest.mark.parametrize("what", ["live_features", "depth", "non_ge_width"])
def test_fold_caps_hold(what):
    """> 512 live features, depth >= 16 (SPARSE's range) and a non-ge form
    over > 128 live features raise."""
    if what == "live_features":
        forest = _sparse_wide_forest(200, 6, 700, 600, seed=88)
        kw = {}
    elif what == "depth":
        forest = synthetic.generate_forest(1, 16, 4, seed=89)
        kw = {}
    else:
        forest = synthetic.generate_forest(60, 4, 200, seed=90)
        kw = {"ge_mode": False}
    with pytest.raises(NotImplementedError, match="depth <= 15|<= 512|<= 128"):
        FoldKernelEngine(_port(forest), device=CPU, **kw)


# (form, width, depth, trees, whole_forest) -> kernel C block or deep kernel,
# and the kernel that `scripts/kernel_ab.py route` measured the faster on the
# shape (65,536 rows on an H100, PERF.md section 6; None where only one
# kernel serves it)
PLANS = {
    "susy_dual": ("dual", 36, 8, 500, False, DeepLaunch(256, 37888), "deep"),
    "cup98_sign": ("sign", 300, 8, 150, False, DeepLaunch(192, 231168, 2), "deep"),
    "svhn_sign": ("sign", 100, 6, 200, False, FoldLaunch(256, 16, 115584), "c"),
    "gisette_sign": ("sign", 120, 6, 100, False, FoldLaunch(256, 100, 199904), "c"),
    "cifar_sign": ("sign", 120, 7, 150, False, FoldLaunch(256, 71, 232392), "c"),
    "covtype_dual": ("dual", 108, 9, 250, False, DeepLaunch(256, 111616), "deep"),
    "narrow_depth9_dual": ("dual", 32, 9, 300, False, DeepLaunch(256, 33792), "deep"),
    "deep12_dual": ("dual", 56, 12, 100, False, DeepLaunch(256, 58368), "deep"),
    "deep15_dual": ("dual", 32, 15, 30, False, DeepLaunch(256, 33792), "deep"),
    "wide_deep_sign": ("sign", 512, 12, 60, False, DeepLaunch(96, 196992, 2),
                       "deep"),
    "stumps_dual": ("dual", 20, 3, 800, False, FoldLaunch(256, 800, 91904), "c"),
    "depth6_dual": ("dual", 36, 6, 500, False, FoldLaunch(256, 102, 115408), "c"),
    "depth7_dual": ("dual", 36, 7, 500, False, FoldLaunch(256, 50, 114288), "c"),
    "covtype_d8_dual": ("dual", 108, 8, 250, False, DeepLaunch(256, 111616), "deep"),
    "sign_d8": ("sign", 100, 8, 200, False, DeepLaunch(256, 103424), "deep"),
    "dual_d10": ("dual", 56, 10, 100, False, DeepLaunch(256, 58368), "deep"),
    "sign_d9": ("sign", 120, 9, 100, False, DeepLaunch(256, 123904), "deep"),
    "nonge_depth14": ("nonge", 90, 14, 40, False, FoldLaunch(64, 1, 219896), None),
    "nonge_depth15": ("nonge", 90, 15, 40, False, None, None),
    "stumps_whole": ("dual", 20, 3, 800, True, FoldLaunch(256, 800, 91904), None),
    "susy_whole": ("dual", 36, 8, 500, True, None, None),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fold_plan_routes(name):
    form, width, depth, trees, whole, want, measured = PLANS[name]
    limits = GpuLimits()
    got = fold_plan(form, width, depth, trees, limits, whole_forest=whole)
    assert got == want
    if measured is not None:
        assert isinstance(got, DeepLaunch if measured == "deep" else FoldLaunch)
    if want is not None and want.smem_bytes <= limits.smem_half_sm:
        # two such blocks and the runtime's reserve fit one SM
        assert 2 * (want.smem_bytes + limits.SMEM_RESERVED_PER_BLOCK) \
            <= limits.smem_per_sm


@pytest.mark.parametrize("depth,rows,fits", [
    (8, 256, True), (12, 256, True), (13, 256, True), (14, 128, True),
    (15, None, False),
])
def test_fold_launch_fits_shared_memory(depth, rows, fits):
    limits = GpuLimits()
    launch = fold_launch(36, depth, 500, limits)
    if not fits:
        assert launch is None
        return
    assert launch.rows_per_block == rows and launch.tile_trees >= 1
    assert launch.smem_bytes <= limits.smem_per_block
    per_tree = ((1 << depth) - 1) * 8 + (1 << depth) * 4
    assert launch.smem_bytes == rows * 37 * 4 + launch.tile_trees * per_tree



# (depth, trees, num_cols, live, leaf_prob, missing): the deep kernel's
# dual (<= 64 live) and sign forms at depth 9, 12 and 15, and at 10 and 11;
# at an odd depth the root group of its blocks is one level
DEEP_CASES = {
    "dual_d9": (9, 6, 12, 12, 0.1, float("nan")),
    "dual_d12": (12, 3, 20, 20, 0.05, -999.0),
    "dual_d15": (15, 2, 8, 8, 0.02, float("nan")),
    "sign_d9": (9, 5, 200, 90, 0.1, -999.0),
    "sign_d12": (12, 3, 300, 100, 0.05, float("nan")),
    "sign_d15": (15, 2, 150, 80, 0.02, float("nan")),
    "dual_d10": (10, 4, 16, 16, 0.1, float("nan")),
    "sign_d11": (11, 3, 120, 70, 0.1, -999.0),
}


@pytest.mark.parametrize("name", sorted(DEEP_CASES))
def test_deep_block_walk_matches_plain_and_jax(name):
    """The deep kernel's walk over its blocks (its arithmetic in torch) is
    the plain version's margins bit for bit; the predictions are within
    JAX_ATOL of the JAX engine in interpret mode."""
    depth, trees, num_cols, live, leaf_prob, missing = DEEP_CASES[name]
    forest = compiler.hot_child_swap(_sparse_wide_forest(
        trees, depth, num_cols, live, seed=depth + live, leaf_prob=leaf_prob,
        missing=missing))
    data = synthetic.generate_data(24, num_cols, missing=missing,
                                   missing_prob=0.1, seed=depth)
    eng = FoldKernelEngine(_port(forest), device=CPU)
    t = eng.tables
    assert t.depth == depth and t.form == name[:4]
    assert eng.kernel is (FOLD_DEEP_SIGN if t.form == "sign" else FOLD_DEEP)
    x = eng.canonicalize(data)
    blocks = deep_blocks(t)
    assert blocks.shape == (trees, deep_block_count(depth), 4)
    assert sum(deep_groups(depth)) == depth and set(deep_groups(depth)) <= {1, 2}
    assert torch.equal(eng.blocks, blocks)
    assert torch.equal(deep_block_walk(x, t, blocks), fold_margins_plain(x, t))
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=8,
                               tree_tile=16, interpret=True)
    np.testing.assert_allclose(eng.predict(data).numpy(),
                               np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["dual", "sign"])
def test_deep_block_walk_zero_and_denormal_thresholds(form):
    """Thresholds at +-0 and denormals on the deep route (depth 10): the
    walk equals the plain version bit for bit and routes as numpy does (the
    JAX CPU interpret path flushes denormals)."""
    cols = 80 if form == "sign" else 6
    forest = _forest(10, 6, cols, 0.05, "mixed", True, float("nan"), seed=19)
    internal = ~forest.is_leaf
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40], np.float32)
    rng = np.random.default_rng(20)
    forest.values[internal] = rng.choice(special, internal.sum())
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 2e-45, 1e-40, -1e-40, 3e-40,
                     -3e-40, np.nan, 1.0, -1.0], np.float32)
    data = rng.choice(vals, (200, cols)).astype(np.float32)
    eng = FoldKernelEngine(_port(forest), device=CPU)
    assert eng.form == form and isinstance(eng.launch, DeepLaunch)
    x = eng.canonicalize(data)
    walked = deep_block_walk(x, eng.tables, deep_blocks(eng.tables))
    assert torch.equal(walked, fold_margins_plain(x, eng.tables))
    np.testing.assert_allclose(walked.numpy(), oracle.predict_margins(forest, data),
                               atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_deep_blocks_pack_the_code_range(depth):
    """Sign-form codes at both ends of the 10-bit field (~511 = -512 and
    511) and thresholds at +-0 and denormals pack and unpack exactly; a code
    past the field is refused."""
    rng = np.random.default_rng(depth)
    T, F = 7, 512
    n = (1 << depth) - 1
    codes = rng.integers(-512, 512, (T, n)).astype(np.int32)
    codes[0, :] = -512
    codes[1, :] = 511
    thr = rng.choice(np.array([0.0, -0.0, 1e-45, -1e-40, 0.5, -0.5, np.nan],
                              np.float32), (T, n))
    t = FoldTables(form="sign", col_index=None, num_cols=F,
                   thresholds=torch.as_tensor(thr), fids=torch.as_tensor(codes),
                   leaf=torch.as_tensor(rng.normal(size=(T, 1 << depth)),
                                        dtype=torch.float32),
                   depth=depth)
    x = torch.as_tensor(rng.choice(np.array([0.0, -0.0, 1e-45, 2e-40, -1.0, 1.0,
                                             np.nan], np.float32), (64, F)))
    blocks = deep_blocks(t)
    assert blocks.shape == (T, deep_block_count(depth), 4)
    assert torch.equal(deep_block_walk(x, t, blocks), fold_margins_plain(x, t))
    bad = dataclasses.replace(t, fids=t.fids.clone().fill_(512))
    with pytest.raises(ValueError):
        deep_blocks(bad)
