"""Port f32 fold (the plain version of kernel C and the deep kernel, on the
CPU) vs the JAX package's FoldKernelEngine in its dual, sign, non-ge and
subtree-split forms (interpret mode) and the numpy oracle.

Margins are held to the JAX engine within 1e-5 (the port sums leaves in f64,
the TPU kernel in f32 tiles) and to the oracle within ORACLE_ATOL.
"""
import ctypes
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from tahoe_tpu.config import ORACLE_ATOL
from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.fold_kernel import FoldKernelEngine as JaxFoldKernelEngine
from tahoe_tpu_torch.config import GpuLimits
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops import fold_kernel
from tahoe_tpu_torch.ops.fold_kernel import (
    BLOCK_NONGE_FID,
    C_BARRIER_BYTES,
    DEEP_KERNELS,
    FOLD,
    FOLD_KERNELS,
    MAX_DUAL_COLS,
    FOLD_DEEP,
    FOLD_DEEP_NONGE,
    FOLD_DEEP_SIGN,
    FOLD_NONGE,
    FOLD_SIGN,
    NONGE_FID,
    NONGE_FLIP,
    NONGE_SEL_LT,
    TABLE_CAP_BYTES,
    DeepLaunch,
    FoldKernelEngine,
    FoldLaunch,
    FoldTables,
    HeapTables,
    block_codes,
    deep_block_count,
    deep_block_walk,
    deep_blocks,
    deep_groups,
    fold_c_table,
    fold_deep_at,
    fold_deep_cuda,
    fold_launch,
    fold_margins_plain,
    fold_plan,
    fold_rows_plain,
    fold_smem_bytes,
    fold_table_bytes,
    fold_tables,
    fold_wavefronts,
    deep_launch,
    heap_path,
    heap_tables,
    level_leaf,
    tree_bytes,
)
from tahoe_tpu_torch.ops.graphed import row_stride
from tahoe_tpu_torch.ops.transform import apply_output_transform
from tahoe_tpu_torch.scripts.kernel_ab import deep_sectors

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


# each form over rows wider than its compaction cap, so that its tables
# carry a column map: (trees, depth, num_cols, active, ge_mode)
RAW_FORMS = {"dual": (10, 4, 100, 30, True), "sign": (20, 5, 479, 300, True),
             "nonge": (10, 4, 150, 60, False)}
RAW_MISSING = {"nan": float("nan"), "sentinel": -999.0}


@functools.lru_cache(maxsize=None)
def _raw_case(form, missing):
    """A forest of ``form`` with a column map, 40 rows with missing values
    and exact threshold hits, and the JAX engine's predictions of them."""
    trees, depth, num_cols, active, ge_mode = RAW_FORMS[form]
    forest = _sparse_wide_forest(trees, depth, num_cols, active, seed=trees + depth,
                                 leaf_prob=0.1, missing=RAW_MISSING[missing])
    data = synthetic.generate_data(40, num_cols, missing=RAW_MISSING[missing],
                                   missing_prob=0.15, seed=active)
    data[0, forest.fids[0, :7]] = forest.values[0, :7]
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=8,
                               tree_tile=32, ge_mode=ge_mode, interpret=True)
    return forest, data, np.asarray(jeng.predict(data))


@pytest.mark.parametrize("pad", [0, 3], ids=["ld_cols", "ld_wider"])
@pytest.mark.parametrize("missing", sorted(RAW_MISSING))
@pytest.mark.parametrize("mapped", [True, False], ids=["map", "no_map"])
@pytest.mark.parametrize("form", sorted(RAW_FORMS))
def test_kernel_c_staging_of_raw_rows(form, mapped, missing, pad):
    """``fold_rows_plain``, kernel C's row staging from raw rows (the
    column map, a row stride, the missing test, the dual lanes), equals
    ``finish_rows(stage_rows(rows))`` bit for bit; the margins of its rows
    hold to the JAX engine and the oracle. Without a map the raw rows are
    the used columns already."""
    forest, data, jax_pred = _raw_case(form, missing)
    eng = FoldKernelEngine(_port(forest), device=CPU, ge_mode=RAW_FORMS[form][4])
    t = eng.tables
    assert eng.form == form and t.col_index is not None
    raw, cols = torch.as_tensor(data), t.col_index
    if not mapped:
        raw, cols = raw[:, cols], None
    R, C = raw.shape
    buf = torch.full((R, C + pad), 5.0)
    buf[:, :C] = raw
    got = fold_rows_plain(buf.reshape(-1), R, C + pad, cols, t.num_cols,
                          eng.missing, form == "dual")
    want = eng.canonicalize(data)
    assert got.shape == want.shape == (R, t.width)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    pred = eng._finish(fold_margins_plain(got, t)).numpy()
    np.testing.assert_allclose(pred, jax_pred, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(pred, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def _deep_engine(monkeypatch, form, missing, plain=False):
    """``_raw_case``'s forest in an engine sent to the deep kernel (its
    forms' depths are kernel C's by ``fold_plan``). With ``plain``, the
    engine's launch on raw rows (``in_place_launch``) is its plain version,
    which also checks that the engine hands it its own tables, heap
    tables, block, sentinel and int32 map."""
    forest, data, jax_pred = _raw_case(form, missing)
    monkeypatch.setattr(fold_kernel, "fold_plan",
                        lambda form, width, *a, **k: deep_launch(width, GpuLimits()))

    def plain_in_place(t, heap, launch, missing_, cols):
        def at(x):
            assert t is eng.tables and heap is eng.heap and launch is eng.launch
            assert (np.float32(missing_).tobytes()
                    == np.float32(forest.missing).tobytes())
            assert cols.dtype == torch.int32 and torch.equal(cols.long(), t.col_index)
            rows = fold_rows_plain(x.reshape(-1), x.shape[0], row_stride(x, CPU),
                                   cols, t.num_cols, missing_, t.form == "dual")
            return deep_block_walk(rows, t, heap)
        return at

    if plain:
        monkeypatch.setattr(fold_kernel, "in_place_launch", plain_in_place)
    eng = FoldKernelEngine(_port(forest), device=CPU, ge_mode=RAW_FORMS[form][4])
    assert isinstance(eng.launch, DeepLaunch) and eng.heap is not None
    return forest, data, jax_pred, eng


@pytest.mark.parametrize("missing", sorted(RAW_MISSING))
@pytest.mark.parametrize("form", sorted(RAW_FORMS))
def test_deep_engine_reads_raw_rows_in_place(monkeypatch, form, missing):
    """The deep kernel's engine offers the in-place route and launches
    the deep kernel on the raw rows with its column map and sentinel: on
    the plain version of the staging, its predictions equal those of the
    staged rows bit for bit and hold to the JAX engine and the oracle."""
    forest, data, jax_pred, eng = _deep_engine(monkeypatch, form, missing,
                                               plain=True)
    assert eng._predict.in_place is not None and eng._margins.in_place is not None
    got = eng._predict_in_place(torch.as_tensor(data))
    want = eng._finish(deep_block_walk(eng.canonicalize(data), eng.tables, eng.heap))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), jax_pred, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("what", ["strided", "f64", "narrow", "map_shape",
                                  "map_dtype", "blocks", "engine_narrow"])
def test_deep_kernel_refuses_raw_rows_it_cannot_read(monkeypatch, what):
    """``fold_deep_at`` refuses, before any launch, rows it cannot read in
    place (strided columns, f64), rows without a map that are not the
    features' width, a map of another length or type, and ``deep_blocks``
    in place of the heap tables; the engine refuses rows narrower than the
    columns its map reads."""
    forest, data, _, eng = _deep_engine(monkeypatch, "dual", "nan")
    t, heap, launch = eng.tables, eng.heap, eng.launch
    raw, cols = torch.as_tensor(data), eng._cols
    used = raw[:, t.col_index].contiguous()
    call, err, match = {
        "strided": ((raw.t().contiguous().t(), heap, cols), ValueError, "in place"),
        "f64": ((raw.double(), heap, cols), ValueError, "in place"),
        "narrow": ((used[:, :-1], heap, None), ValueError, "wide"),
        "map_shape": ((raw, heap, cols[:-1].contiguous()), ValueError, "column map"),
        "map_dtype": ((raw, heap, t.col_index), TypeError, "int32"),
        "blocks": ((used, deep_blocks(t), None), TypeError, "heap_tables"),
        "engine_narrow": (None, ValueError, "reads column"),
    }[what]
    with pytest.raises(err, match=match):
        if call is None:
            eng._margins_in_place(raw[:, :int(t.col_index.max())])
        else:
            x, tables, map_ = call
            fold_deep_at(x, t, tables, launch, forest.missing, map_)


class _LaunchRecorder:
    """A stand-in of a kernel's ``CudaKernel``: records each launch's
    arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def launch(self, dev, *args):
        self.calls.append((dev, args))


@pytest.mark.parametrize("kernel", ["kernel_c", "deep"])
def test_the_engine_checks_its_tables_once(monkeypatch, kernel):
    """The fold engine checks its tables, block and column map once, when
    it is built: a call on raw rows checks only the rows (no
    ``check_operand``), and launches the engine's kernel on the rows'
    pointer and stride, the map, the columns read and the sentinel, then
    the tables' arguments (csrc TAHOE_FOLD_EXPORT, TAHOE_FOLD_DEEP_EXPORT)."""
    if kernel == "deep":
        forest, data, _, eng = _deep_engine(monkeypatch, "dual", "sentinel")
        tables = (eng.heap.blocks.data_ptr(), eng.heap.leaf.data_ptr())
        block = (eng.launch.rows_per_block, eng.launch.lanes, eng.launch.smem_bytes)
    else:
        forest, data, _ = _raw_case("dual", "sentinel")
        eng = FoldKernelEngine(_port(forest), device=CPU)
        assert isinstance(eng.launch, FoldLaunch)
        tables = (eng.c_table.data_ptr(),)
        block = (eng.launch.rows_per_block, eng.launch.tile_trees,
                 eng.launch.smem_bytes)
    t = eng.tables
    recorder = eng._at.kernel = _LaunchRecorder()
    checked = []
    monkeypatch.setattr(fold_kernel, "check_operand",
                        lambda *a, **k: checked.append(a[1]))
    buf = torch.zeros(40, data.shape[1] + 3)
    x = buf[:, :data.shape[1]]
    x.copy_(torch.as_tensor(data))
    eng._margins_in_place(x)
    assert checked == []
    (dev, args), = recorder.calls
    assert dev == CPU
    values = [a.value if isinstance(a, ctypes.c_void_p) else a for a in args]
    assert values[:-1] == [x.data_ptr(), data.shape[1] + 3, eng._cols.data_ptr(),
                           t.num_cols, -999.0, 40, t.width, *tables,
                           t.leaf.shape[0], t.depth, *block]
    assert values[-1]  # the margins' pointer


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
    assert eng.form == "nonge" and eng.kernel in (FOLD_NONGE, FOLD_DEEP_NONGE)
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
    blocks = eng.heap.blocks.numpy()
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
    """> 512 live features, tables past the 2 GiB cap (500 trees of depth
    20, ~8.5 GiB: depth itself has no cap) and a non-ge form over > 128
    live features raise; the tables' cap before a table is built, so a
    shape stands in for the forest."""
    if what == "live_features":
        spec = _port(_sparse_wide_forest(200, 6, 700, 600, seed=88))
        kw = {}
    elif what == "depth":
        spec = types.SimpleNamespace(num_trees=500, depth=20)
        assert fold_table_bytes(500, 20) > TABLE_CAP_BYTES
        kw = {}
    else:
        spec = _port(synthetic.generate_forest(60, 4, 200, seed=90))
        kw = {"ge_mode": False}
    with pytest.raises(NotImplementedError, match="GiB > 2 GiB|<= 512|<= 128"):
        FoldKernelEngine(spec, device=CPU, **kw)


@pytest.mark.parametrize("depth", [16, 17])
def test_split_forest_past_depth_15_matches_jax(depth):
    """SPLIT_FOREST at depth 16 and 17 (an odd depth: its root group of
    blocks is one level) on the deep kernel's route, with missing values:
    the walk of its blocks bit-equal to the plain version, the predictions
    within JAX_ATOL of the JAX Forest.predict (the subtree-split fold in
    interpret mode) and within ORACLE_ATOL of the oracle."""
    from tahoe_tpu.config import Strategy as JaxStrategy
    from tahoe_tpu.engine.forest import Forest as JaxForest

    trees = 2 if depth == 16 else 3
    forest = synthetic.generate_forest(trees, depth, 6, leaf_prob=0.02,
                                       seed=depth)
    data = synthetic.generate_data(32, 6, missing_prob=0.1, seed=depth + 1)
    eng = FoldKernelEngine(_port(forest), device=CPU)
    t = eng.tables
    assert eng.kernel is FOLD_DEEP and t.depth == depth
    assert deep_groups(depth)[0] == 2 - depth % 2
    x = eng.canonicalize(data)
    assert torch.equal(deep_block_walk(x, t, eng.heap), fold_margins_plain(x, t))
    got = eng.predict(data).numpy()
    want = np.asarray(JaxForest(forest).predict(data, JaxStrategy.SPLIT_FOREST))
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_deep_blocks_layout_at_depth_18():
    """Depth 18: nine groups of two levels, 87,381 blocks a tree; block q of
    the group from level d holds node q of level d and its children q and
    q + 2^d of level d + 1 (thresholds' bits, then three 10-bit codes);
    every index stays within an int32, as csrc/fold_deep.cu reads it. The
    walk of the blocks is the plain fold bit for bit."""
    D, T, F = 18, 2, 4
    g = torch.Generator().manual_seed(18)
    nodes = (1 << D) - 1
    t = FoldTables(form="dual", col_index=None, num_cols=F,
                   thresholds=torch.rand(T, nodes, generator=g) * 2 - 1,
                   fids=torch.randint(0, 2 * F, (T, nodes), generator=g,
                                      dtype=torch.int32),
                   leaf=torch.randn(T, 1 << D, generator=g), depth=D)
    blocks = deep_blocks(t)
    assert deep_groups(D) == [2] * 9
    assert blocks.shape == (T, deep_block_count(D), 4) == (T, 87381, 4)
    assert T * deep_block_count(D) * 4 < 2**31 and T << D < 2**31
    thr = t.thresholds.view(torch.int32)
    off = 0
    for d in range(0, D, 2):
        q = torch.arange(1 << d)
        top, lo = (1 << d) - 1 + q, (2 << d) - 1 + q
        members = [top, lo, lo + (1 << d)]
        blk = blocks[:, off:off + (1 << d)]
        for n, node in enumerate(members):
            assert torch.equal(blk[..., n], thr[:, node])
        word = sum(t.fids[:, node] << (10 * n) for n, node in enumerate(members))
        assert torch.equal(blk[..., 3], word)
        off += 1 << d
    assert off == deep_block_count(D)
    x = torch.rand(16, 2 * F, generator=g) * 2 - 1
    x[:, F:] = -x[:, :F]
    x[3, [1, F + 1]] = float("nan")
    assert torch.equal(deep_block_walk(x, t, heap_tables(t)), fold_margins_plain(x, t))


# (form, width, depth, trees, whole_forest) -> kernel C block or deep kernel,
# and the kernel that `scripts/kernel_ab.py route` measured the faster on the
# shape (65,536 rows on an H100, PERF.md section 6; None where only one
# kernel serves it). The nonge_d* shapes are the mixed 90-column forest's
# DEPTH_BUCKETED buckets.
PLANS = {
    "susy_dual": ("dual", 36, 8, 500, False, FoldLaunch(256, 16, 114192), "c"),
    "cup98_sign": ("sign", 300, 8, 150, False, FoldLaunch(128, 16, 230416), "c"),
    "svhn_sign": ("sign", 100, 6, 200, False, FoldLaunch(256, 10, 115280), "c"),
    "gisette_sign": ("sign", 120, 6, 100, False, FoldLaunch(256, 100, 183120), "c"),
    "cifar_sign": ("sign", 120, 7, 150, False, FoldLaunch(256, 45, 231920), "c"),
    "covtype_dual": ("dual", 108, 9, 250, False, FoldLaunch(256, 12, 226448), "c"),
    "narrow_depth9_dual": ("dual", 32, 9, 300, False, FoldLaunch(256, 8, 110352),
                           "c"),
    "deep12_dual": ("dual", 56, 12, 100, False, DeepLaunch(256, 58368), "deep"),
    "deep15_dual": ("dual", 32, 15, 30, False, DeepLaunch(256, 33792), "deep"),
    "wide_deep_sign": ("sign", 512, 12, 60, False, FoldLaunch(64, 1, 207792), "c"),
    "stumps_dual": ("dual", 20, 3, 800, False, FoldLaunch(256, 800, 85520), "c"),
    "depth6_dual": ("dual", 36, 6, 500, False, FoldLaunch(256, 65, 114864), "c"),
    "depth7_dual": ("dual", 36, 7, 500, False, FoldLaunch(256, 32, 114704), "c"),
    "covtype_d8_dual": ("dual", 108, 8, 250, False, FoldLaunch(256, 25, 230832),
                        "c"),
    "sign_d8": ("sign", 100, 8, 200, False, FoldLaunch(256, 2, 112976), "c"),
    "dual_d10": ("dual", 56, 10, 100, False, FoldLaunch(256, 3, 115696), "c"),
    "sign_d9": ("sign", 120, 9, 100, False, FoldLaunch(256, 11, 229168), "c"),
    "mnist_sign": ("sign", 400, 6, 100, False, FoldLaunch(128, 22, 231376), "c"),
    "nonge_d7": ("nonge", 90, 7, 59, False, FoldLaunch(256, 9, 114800), "c"),
    "nonge_d8": ("nonge", 90, 8, 17, False, FoldLaunch(256, 4, 112272), "c"),
    "nonge_d9": ("nonge", 90, 9, 23, False, FoldLaunch(256, 2, 112336), "c"),
    "nonge_d10": ("nonge", 90, 10, 21, False, FoldLaunch(256, 1, 112304), "c"),
    "nonge_depth14": ("nonge", 90, 14, 40, False, DeepLaunch(256, 93184), None),
    "nonge_depth15": ("nonge", 90, 15, 40, False, DeepLaunch(256, 93184), None),
    "stumps_whole": ("dual", 20, 3, 800, True, FoldLaunch(256, 800, 85520), None),
    "susy_whole": ("dual", 36, 8, 500, True, None, None),
    # past depth 14 no block of kernel C holds a tree: the deep kernel
    # (rf_deep16- and rf_deep18-class), and no VMEM_FOREST block
    "rf_deep16_dual": ("dual", 40, 16, 120, False, DeepLaunch(256, 41984), None),
    "deep17_sign": ("sign", 100, 17, 10, False, DeepLaunch(256, 103424), None),
    "rf_deep18_dual": ("dual", 48, 18, 200, False, DeepLaunch(256, 50176), None),
    "wide_deep16_sign": ("sign", 512, 16, 3, False, DeepLaunch(96, 196992, 2),
                         None),
    "nonge_depth18": ("nonge", 90, 18, 5, False, DeepLaunch(256, 93184), None),
    "rf_deep16_whole": ("dual", 40, 16, 120, True, None, None),
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
    (8, 256, True), (12, 256, True), (13, 256, True), (14, None, False),
    (15, None, False),
])
def test_fold_launch_fits_shared_memory(depth, rows, fits):
    """Kernel C's ring of two buffers of whole trees (16-byte blocks of two
    levels, then the leaves) beside 256 rows at an odd stride: no longer a
    depth-14 tree, whose two buffers pass the opt-in budget (the deep
    kernel takes it)."""
    limits = GpuLimits()
    launch = fold_launch(36, depth, 500, limits)
    if not fits:
        assert launch is None
        return
    assert launch.rows_per_block == rows and launch.tile_trees >= 1
    assert launch.smem_bytes <= limits.smem_per_block
    per_tree = 16 * deep_block_count(depth) + 4 * (1 << depth)
    assert launch.smem_bytes == (2 * launch.tile_trees * per_tree + rows * 37 * 4
                                 + C_BARRIER_BYTES)



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
    # fold_plan takes kernel C up to depth 11 in 256-row blocks, the deep
    # kernel deeper; both read these blocks
    deep = depth > 11
    assert eng.kernel is (DEEP_KERNELS if deep else FOLD_KERNELS)[t.form]
    x = eng.canonicalize(data)
    blocks = deep_blocks(t)
    assert blocks.shape == (trees, deep_block_count(depth), 4)
    assert sum(deep_groups(depth)) == depth and set(deep_groups(depth)) <= {1, 2}
    heap = heap_tables(t)
    if deep:
        assert torch.equal(eng.heap.blocks, heap.blocks)
        assert torch.equal(eng.heap.leaf, heap.leaf)
    else:
        assert eng.heap is None
        assert torch.equal(eng.c_table, fold_c_table(t))
    assert torch.equal(deep_block_walk(x, t, heap), fold_margins_plain(x, t))
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=8,
                               tree_tile=16, interpret=True)
    np.testing.assert_allclose(eng.predict(data).numpy(),
                               np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["dual", "sign"])
def test_deep_block_walk_zero_and_denormal_thresholds(form):
    """Thresholds at +-0 and denormals at depth 10 (kernel C's route, over
    the blocks both kernels read): the walk equals the plain version bit for
    bit and routes as numpy does (the JAX CPU interpret path flushes
    denormals)."""
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
    assert eng.form == form and eng.kernel is FOLD_KERNELS[form]
    x = eng.canonicalize(data)
    walked = deep_block_walk(x, eng.tables, heap_tables(eng.tables))
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
    assert torch.equal(deep_block_walk(x, t, heap_tables(t)), fold_margins_plain(x, t))
    bad = dataclasses.replace(t, fids=t.fids.clone().fill_(512))
    with pytest.raises(ValueError):
        deep_blocks(bad)


@pytest.mark.parametrize("name", sorted(NONGE_CASES))
def test_non_ge_block_walk_matches_plain_and_jax(name):
    """The non-ge form's blocks (a 7-bit feature, sel_lt and flip in each
    10-bit code) walked as kernel C and the deep kernel walk them: the plain
    version's margins bit for bit, and within JAX_ATOL of the JAX engine."""
    trees, depth, cols, leaf_prob, def_left, swap, missing = NONGE_CASES[name]
    forest = _forest(depth, trees, cols, leaf_prob, def_left, swap, missing,
                     seed=cols + trees)
    data = synthetic.generate_data(40, cols, missing=missing, missing_prob=0.15,
                                   seed=cols)
    data[0, :min(cols, 7)] = forest.values[0, :min(cols, 7)]  # threshold hits
    eng = FoldKernelEngine(_port(forest), device=CPU, ge_mode=False)
    t = eng.tables
    x = eng.canonicalize(data)
    blocks = deep_blocks(t)
    assert blocks.shape == (trees, deep_block_count(depth), 4)
    walked = deep_block_walk(x, t, heap_tables(t))
    assert torch.equal(walked, fold_margins_plain(x, t))
    jeng = JaxFoldKernelEngine(compiler.levelize(forest), row_tile=8,
                               tree_tile=32, ge_mode=False, interpret=True)
    got = apply_output_transform(walked, eng.num_trees, eng.output,
                                 eng.global_bias, eng.threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)


def _special_tables(form, depth, F, rng, T=9):
    """FoldTables of ``form`` whose thresholds are +-0, denormals, NaN and
    ordinary values, codes drawn over the form's whole range."""
    n = (1 << depth) - 1
    thr = rng.choice(np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, np.nan,
                               0.5, -0.5], np.float32), (T, n))
    if form == "dual":
        codes = rng.integers(0, 2 * F, (T, n))
    elif form == "sign":
        codes = rng.integers(-F, F, (T, n))
    else:
        codes = (rng.integers(0, F, (T, n))
                 | rng.integers(0, 2, (T, n)) * NONGE_SEL_LT
                 | rng.integers(0, 2, (T, n)) * NONGE_FLIP)
    return FoldTables(form=form, col_index=None, num_cols=F,
                      thresholds=torch.as_tensor(thr),
                      fids=torch.as_tensor(codes.astype(np.int32)),
                      leaf=torch.as_tensor(rng.normal(size=(T, 1 << depth)),
                                           dtype=torch.float32),
                      depth=depth)


def _special_rows(t, rng, rows=96):
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 2e-45, 1e-40, -1e-40, 3e-40,
                     np.nan, 1.0, -1.0, 0.5, -0.5], np.float32)
    x = rng.choice(vals, (rows, t.num_cols)).astype(np.float32)
    if t.form == "dual":
        x = np.concatenate([x, -x], axis=1)
    return torch.as_tensor(x)


# the code field's ends in each form: the dual form's last lane at 64
# features, the sign form's ~511 (= -512) and 511, the non-ge form's
# feature 127 with sel_lt and flip
CODE_ENDS = {"dual": (64, [0, 127]),
             "sign": (512, [-512, 511]),
             "nonge": (128, [127, 127 | NONGE_SEL_LT | NONGE_FLIP])}


@pytest.mark.parametrize("depth", [0, 1, 2, 5, 6, 15, 16, 17])
@pytest.mark.parametrize("form", ["dual", "sign", "nonge"])
def test_block_walk_zero_denormal_nan_thresholds_all_forms(form, depth):
    """±0, denormal and NaN thresholds against ±0, denormal and NaN rows, in
    all three forms, at odd and even depths (a root group of one level or
    two) from a lone leaf to depth 17, with codes at both ends of the
    10-bit field: the deep kernel's walk of its heap-ordered tables routes
    as the plain version's compares, bit for bit."""
    rng = np.random.default_rng({"dual": 1, "sign": 2, "nonge": 3}[form] + 10 * depth)
    F, ends = CODE_ENDS[form]
    t = _special_tables(form, depth, F, rng, T=3 if depth > 6 else 9)
    if depth:
        fids = t.fids.clone()
        fids[0, ::2], fids[0, 1::2], fids[1] = ends[0], ends[1], ends[1]
        t = dataclasses.replace(t, fids=fids)
    x = _special_rows(t, rng, rows=64 if depth > 6 else 96)
    assert torch.equal(deep_block_walk(x, t, heap_tables(t)),
                       fold_margins_plain(x, t))


@pytest.mark.parametrize("depth", [0, 1, 2, 5, 16, 17])
def test_heap_tables_permute_deep_blocks(depth):
    """The heap tables hold each tree's ``deep_blocks`` rows and leaves,
    permuted: heap block h of the group from level d is block
    ``heap_path(h, d)`` of that group in ``deep_blocks``, heap leaf h is
    leaf ``heap_path(h, D)``; the root block stays first, the four
    successors of a block lie side by side, and kernel C's table keeps the
    order of ``deep_blocks``."""
    rng = np.random.default_rng(60 + depth)
    t = _special_tables("sign", depth, 40, rng, T=2 if depth > 5 else 4)
    blocks, heap = deep_blocks(t), heap_tables(t)
    assert isinstance(heap, HeapTables)
    assert heap.blocks.shape == blocks.shape and heap.leaf.shape == t.leaf.shape
    for T in range(blocks.shape[0]):  # the same rows, each once
        assert torch.equal(torch.unique(heap.blocks[T], dim=0),
                           torch.unique(blocks[T], dim=0))
        assert torch.equal(heap.leaf[T].view(torch.int32).sort().values,
                           t.leaf[T].view(torch.int32).sort().values)
    off, d = 0, 0
    for size in deep_groups(depth):
        h = torch.arange(1 << d)
        assert torch.equal(heap_path(heap_path(h, d), d), h)
        assert torch.equal(heap.blocks[:, off + h], blocks[:, off + heap_path(h, d)])
        off += 1 << d
        d += size
    h = torch.arange(1 << depth)
    assert torch.equal(heap.leaf, t.leaf[:, heap_path(h, depth)])
    if depth >= 3:  # the root block's successors: blocks 0-3 of the next group
        first = deep_groups(depth)[0]
        nxt = torch.arange(1 << first)
        assert torch.equal(heap.blocks[:, 1 + nxt], blocks[:, 1 + heap_path(nxt, first)])
    assert torch.equal(fold_c_table(t)[:, :4 * blocks.shape[1]],
                       blocks.reshape(blocks.shape[0], -1))


def test_deep_kernel_refuses_kernel_c_blocks():
    """``fold_deep_cuda`` takes the heap tables alone: ``deep_blocks``, in
    kernel C's order, is refused before any launch."""
    rng = np.random.default_rng(70)
    t = _special_tables("dual", 5, 8, rng)
    x = _special_rows(t, rng)
    launch = DeepLaunch(256, 256 * (t.width | 1) * 4)
    with pytest.raises(TypeError, match="heap_tables"):
        fold_deep_cuda(x, t, deep_blocks(t), launch)
    bad = HeapTables(blocks=deep_blocks(t)[:, 1:].contiguous(), leaf=t.leaf)
    with pytest.raises(ValueError, match="do not match"):
        fold_deep_cuda(x, t, bad, launch)


@pytest.mark.parametrize("depth,deep", [(8, False), (15, True)])
def test_heap_counter_counts_deep_engines(depth, deep):
    """An engine on the deep kernel's route holds one heap table, none on
    kernel C's; the deep engine keeps one copy of the leaves, the heap's,
    so that its tables take ``fold_table_bytes``, and its plain version
    reads them back in level order."""
    forest = _port(synthetic.generate_forest(3, depth, 6, leaf_prob=0.02, seed=depth))
    eng = FoldKernelEngine(forest, device=CPU)
    t, fresh = eng.tables, fold_tables(forest, device=CPU)
    assert (eng.heap is not None) == deep == isinstance(eng.launch, DeepLaunch)
    assert t.heap_leaf == deep
    assert torch.equal(level_leaf(t), fresh.leaf)
    x = eng.canonicalize(synthetic.generate_data(64, 6, missing_prob=0.1, seed=depth))
    assert torch.equal(fold_margins_plain(x, t), fold_margins_plain(x, fresh))
    if deep:
        assert t.leaf is eng.heap.leaf
        assert eng.heap.blocks.shape == (3, deep_block_count(depth), 4)
        held = {id(v): v.numel() * v.element_size()
                for v in (t.thresholds, t.fids, t.leaf, eng.heap.blocks, eng.heap.leaf)}
        assert sum(held.values()) == fold_table_bytes(3, depth)
        assert torch.equal(heap_tables(t).leaf, eng.heap.leaf)


def test_heap_order_touches_fewer_sectors():
    """On the walks of whole warps over a seeded depth-16, 28-column dual
    forest (higgs_rf16's widths, uniform rows, none missing), each
    warp-wide block load and leaf load of the deep kernel touches fewer
    distinct 32-byte sectors, on average per (warp, tree), with its tables
    in heap order than in the order of ``deep_blocks``."""
    forest = synthetic.generate_forest(4, 16, 28, seed=16)
    data = synthetic.generate_data(1024, 28, missing_prob=0.0, seed=17)
    eng = FoldKernelEngine(_port(forest), device=CPU)
    assert isinstance(eng.launch, DeepLaunch)
    x = eng.canonicalize(data)
    got = deep_sectors(x, eng.tables)
    assert got["rows"] == 1024 and got["loads_per_row_tree"] == 9
    bits, heap = got["bits"], got["heap"]
    for what in ("blocks_sectors", "leaf_sectors", "blocks_lines", "leaf_lines"):
        assert heap[what] < bits[what], what
    assert bits["sectors"] == bits["blocks_sectors"] + bits["leaf_sectors"]
    # nine loads of 32 lanes: at most 288 sectors, at least one a load
    assert 9 <= heap["sectors"] < bits["sectors"] <= 9 * 32


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_non_ge_code_field_ends(depth):
    """Feature 127 (the 7-bit field's last) with sel_lt and flip in every
    combination packs and unpacks exactly; feature 128 is refused."""
    rng = np.random.default_rng(40 + depth)
    T, F = 8, 128
    n = (1 << depth) - 1
    feature = rng.integers(0, F, (T, n))
    feature[:4] = F - 1
    sel = np.array([0, 1, 0, 1] + [0] * (T - 4))[:, None] * np.ones((1, n), int)
    flip = np.array([0, 0, 1, 1] + [1] * (T - 4))[:, None] * np.ones((1, n), int)
    codes = (feature | sel * NONGE_SEL_LT | flip * NONGE_FLIP).astype(np.int32)
    thr = rng.choice(np.array([0.0, -0.0, 1e-45, 0.5, -0.5, np.nan], np.float32),
                     (T, n))
    t = FoldTables(form="nonge", col_index=None, num_cols=F,
                   thresholds=torch.as_tensor(thr), fids=torch.as_tensor(codes),
                   leaf=torch.as_tensor(rng.normal(size=(T, 1 << depth)),
                                        dtype=torch.float32),
                   depth=depth)
    packed = block_codes(t)
    assert int(packed.max()) <= 511 and int(packed.min()) >= 0
    assert torch.equal(packed[:4] & BLOCK_NONGE_FID,
                       torch.full((4, n), F - 1, dtype=torch.int32))
    x = _special_rows(t, rng, rows=64)
    assert torch.equal(deep_block_walk(x, t, heap_tables(t)),
                       fold_margins_plain(x, t))
    bad = dataclasses.replace(t, fids=t.fids.clone().fill_(F))
    with pytest.raises(ValueError):
        deep_blocks(bad)


@pytest.mark.parametrize("depth", [0, 1, 3, 6, 7, 10])
def test_c_table_layout(depth):
    """Kernel C's table: a row a tree of its blocks then its leaves (padded
    to 4), every tree a whole number of 16-byte units."""
    rng = np.random.default_rng(depth)
    t = _special_tables("sign", depth, 40, rng, T=5)
    table = fold_c_table(t)
    B = deep_block_count(depth)
    per_tree = tree_bytes(depth)
    assert per_tree % 16 == 0 and table.shape == (5, per_tree // 4)
    assert per_tree == 16 * B + 4 * max(1 << depth, 4)
    assert torch.equal(table[:, :4 * B], deep_blocks(t).reshape(5, -1))
    leaves = table[:, 4 * B:]
    assert torch.equal(leaves[:, :1 << depth], t.leaf.view(torch.int32))
    assert not leaves[:, 1 << depth:].any()


def test_c_tree_bytes_and_whole_forest_tile():
    """The sizes of one tree's blocks (depth 3, 6, 7, 10: 48, 336,
    688, 5,456 bytes) and 800 stumps-class trees in one tile: one buffer, no
    ring, beside 256 rows of [x, -x] over 10 features at an odd stride."""
    for depth, blocks in ((3, 48), (6, 336), (7, 688), (10, 5456)):
        assert tree_bytes(depth) == blocks + 4 * (1 << depth)
    limits = GpuLimits()
    launch = fold_launch(20, 3, 800, limits)
    assert launch == FoldLaunch(256, 800, 800 * 80 + 256 * 21 * 4 + C_BARRIER_BYTES)
    assert launch.smem_bytes <= limits.smem_half_sm
    assert fold_plan("dual", 20, 3, 800, limits, whole_forest=True) == launch
    # a ring of two buffers once the forest passes one tile
    ring = fold_launch(20, 3, 8000, limits)
    assert ring.tile_trees < 8000
    assert ring.smem_bytes == fold_smem_bytes(20, 3, 8000, 256, ring.tile_trees)
    assert ring.smem_bytes == (2 * ring.tile_trees * 80 + 256 * 21 * 4
                               + C_BARRIER_BYTES)


def test_fold_wavefronts_reckoning():
    """The wavefront reckoning on real walks: feature-major rows are
    one wavefront a gather whatever the walk; at an odd stride the stumps
    class's gathers cost more; blocks need no more wavefronts than the
    two-word layout, in fewer loads."""
    forest = synthetic.generate_forest(80, 3, 10, seed=1)
    data = synthetic.generate_data(512, 10, missing_prob=0.05, seed=7)
    eng = FoldKernelEngine(_port(forest), device=CPU)
    x = eng.canonicalize(data)
    w = fold_wavefronts(x, eng.tables)
    assert w["rows"] == 512
    assert w["per_gather"]["feature_major"] == 1.0
    assert 1.0 < w["per_gather"]["row_major"] <= 32.0
    per = w["per_warp_tree"]
    assert per["nodes_blocks"] <= per["nodes_words"]
    assert w["loads_per_row_tree"] == {"words": 10, "blocks": 6}
    tot = w["total_per_warp_tree"]
    assert tot["feature_major_blocks"] == min(tot.values())
