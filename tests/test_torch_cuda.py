"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` mark and skips without a GPU. The file
imports no JAX, so it also runs on a GPU machine that has none; there
tests/conftest.py (which imports jax) is left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import ctypes

import numpy as np
import pytest
import torch

from tahoe_tpu_torch import ORACLE_ATOL, Forest, GpuLimits, Output, Strategy
from tahoe_tpu_torch.forest import compiler, quantize, synthetic, train
from tahoe_tpu_torch.forest.sparse import SparseGatherEngine
from tahoe_tpu_torch.ops._build import library, ptr
from tahoe_tpu_torch.ops.bucketed import (
    DepthBucketedFoldEngine,
    DepthBucketedRankEngine,
)
from tahoe_tpu_torch.ops.fold_kernel import (
    DEEP_KERNELS,
    FOLD,
    FOLD_DEEP,
    FOLD_DEEP_NONGE,
    FOLD_DEEP_SIGN,
    FOLD_KERNELS,
    FOLD_NONGE,
    FOLD_SIGN,
    FoldKernelEngine,
    FoldLaunch,
    deep_blocks,
    deep_launch,
    fold_c_table,
    fold_deep_cuda,
    fold_launch,
    fold_margins_cuda,
    fold_margins_plain,
    fold_smem_bytes,
    fold_tables,
)
from tahoe_tpu_torch.ops.probes import (
    INT8_MODES,
    OVERHEAD_MODES,
    PROBE_INT8,
    PROBE_OVERHEAD,
    PROBE_RANK_PARTS,
    RANK_PARTS_MODES,
    int8_probe_cuda,
    int8_probe_plain,
    walk_probe_cuda,
    walk_probe_plain,
)
from tahoe_tpu_torch.ops.rank_kernel import (
    RANK_FOLD,
    RANK_FUSED,
    RECORD_LANE_MASK,
    RankFoldEngine,
    rank_margins_cuda,
    rank_margins_fused_cuda,
    rank_margins_fused_plain,
    rank_block_rows,
    rank_margins_plain,
    rank_row_words,
    walk_paths,
)
from tahoe_tpu_torch.ops.rank_transform import (
    RANK_PLANES,
    rank_planes_cuda,
    rank_planes_plain,
    threshold_table,
)
from tahoe_tpu_torch.ops.rows import canonicalize_rows
from tahoe_tpu_torch.ops.sparse_kernel import (
    SPARSE_RANK,
    SparseRankEngine,
    sparse_margins_cuda,
    sparse_margins_plain,
)
from tahoe_tpu_torch.scripts import int8_cast_probe

KERNEL_ATOL = 1e-5  # both sides sum leaves in f64; only the last rounding differs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _data(rows, cols, seed, missing=float("nan")):
    data = synthetic.generate_data(max(rows, 3), cols, missing=missing,
                                   missing_prob=0.05, seed=seed)
    data[0, 0] = -0.0
    data[1, 1] = np.inf
    data[2, 2] = 1e-40
    return data[:rows]


@pytest.mark.parametrize("cols", [18, 150])
def test_rank_transform_kernel(dev, cols):
    forest = synthetic.generate_forest(60, 8, cols, seed=cols)
    q = quantize.quantize(forest)
    data = _data(1000, cols, cols + 1)
    data[3, 0] = q.tables[0][0]
    thr, counts = threshold_table(q.tables, device=dev)
    x = torch.as_tensor(data, device=dev)
    before = RANK_PLANES.launches
    got = rank_planes_cuda(x, thr, counts)
    torch.cuda.synchronize()
    assert RANK_PLANES.launches == before + 1
    assert torch.equal(got, rank_planes_plain(x, thr, counts))
    want = quantize.encode_rank_planes_np(quantize.transform_rows_np(q, data))
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("cols,band", [(18, None), (9, 50), (150, None)])
def test_rank_fold_kernel(dev, cols, band):
    forest = compiler.hot_child_swap(synthetic.generate_forest(
        40, 6, cols, leaf_prob=0.1, seed=cols + 2))
    data = _data(777, cols, cols + 3)
    eng = RankFoldEngine(forest, device=dev, band=band)
    t = eng.tables
    planes = eng.transform(data)
    got = rank_margins_cuda(planes, t.records, t.leaf, t.depth)
    torch.cuda.synchronize()
    want = rank_margins_plain(planes, t.mats, t.leaf, t.depth)
    assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_allclose(eng.predict(data).cpu().numpy(),
                               Forest(forest, device="cpu").predict_oracle(data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("cols,depth", [(18, 1), (18, 8), (45, 8), (480, 8),
                                        (18, 12), (45, 12), (480, 12), (18, 14)])
def test_rank_fold_kernel_records(dev, cols, depth):
    """Kernel B over its records at 1, 2 and 16 plane groups and depth 1 to
    14, on forests where a third of the nodes end early (pass-through
    records past the row) and the missing routes mix def_left and
    exchange."""
    trees = {1: 40, 8: 60, 12: 12, 14: 4}[depth]
    # enough internal nodes at 480 columns that every feature stays live
    forest = compiler.hot_child_swap(synthetic.generate_forest(
        trees, depth, cols, leaf_prob=0.15 if cols == 480 else 0.3,
        seed=cols + depth))
    data = _data(1500, cols, cols + depth)
    eng = RankFoldEngine(forest, device=dev)
    t = eng.tables
    assert eng.groups == {18: 1, 45: 2, 480: 16}[cols]
    if depth > 1:  # pass-through records below the early leaves
        assert bool(((t.records & RECORD_LANE_MASK) == 128 * eng.groups).any())
    planes = eng.transform(data)
    before = RANK_FOLD.launches
    got = rank_margins_cuda(planes, t.records, t.leaf, t.depth)
    torch.cuda.synchronize()
    assert RANK_FOLD.launches == before + 1
    want = rank_margins_plain(planes, t.mats, t.leaf, t.depth)
    assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    if depth == 8 and cols == 18:  # one group, a partial last block
        assert torch.equal(rank_margins_cuda(planes[:77].contiguous(), t.records,
                                             t.leaf, t.depth), got[:77])


@pytest.mark.parametrize("depth,trees", [(0, 3), (8, 64), (12, 9)])
def test_fold_kernel(dev, depth, trees):
    forest = compiler.hot_child_swap(synthetic.generate_forest(
        trees, depth, 18, leaf_prob=0.1, seed=depth + 4))
    data = _data(3000, 18, depth + 5)
    eng = FoldKernelEngine(forest, device=dev)
    x2 = eng.canonicalize(data)
    t = eng.tables
    # kernel C's own block, also at depth 12, where the engine takes the
    # deep kernel
    launch = fold_launch(t.width, t.depth, trees, GpuLimits.for_device(dev))
    got = fold_margins_cuda(x2, t, fold_c_table(t), launch)
    torch.cuda.synchronize()
    want = fold_margins_plain(x2, t)
    assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)


def test_facade_counts_launches(dev):
    out = int(Output.AVG | Output.SIGMOID)
    forest = synthetic.generate_forest(50, 7, 18, leaf_prob=0.05, output=out,
                                       missing=-999.0, seed=11)
    data = _data(2048, 18, 12, missing=-999.0)
    f = Forest(forest, device=dev)
    want = f.predict_oracle(data)
    counts = [k.launches for k in (RANK_PLANES, RANK_FOLD, FOLD)]
    for s in (Strategy.SPLIT_FOREST, Strategy.RANK_MXU):
        np.testing.assert_allclose(f.predict(data, s).cpu().numpy(), want,
                                   atol=ORACLE_ATOL, rtol=0)
    assert [k.launches for k in (RANK_PLANES, RANK_FOLD, FOLD)] == [
        c + 1 for c in counts]


def test_kernels_reject_bad_operands(dev):
    forest = synthetic.generate_forest(5, 3, 4, seed=13)
    eng = RankFoldEngine(forest, device=dev)
    t = eng.tables
    x = torch.zeros(8, 4, device=dev)
    with pytest.raises(TypeError):
        rank_planes_cuda(x.double(), t.thresholds, t.counts)
    with pytest.raises(ValueError):
        rank_planes_cuda(x.cpu(), t.thresholds, t.counts)
    with pytest.raises(ValueError):
        rank_planes_cuda(torch.zeros(4, 8, device=dev).t(), t.thresholds,
                         t.counts)
    # the launcher itself takes only aligned 16-threshold windows
    out = torch.empty(8, 128, dtype=torch.int8, device=dev)
    for thr in (t.thresholds[:, :7].contiguous(),
                torch.empty(4 * 16 + 1, device=dev)[1:].view(4, 16)):
        with pytest.raises(RuntimeError):
            RANK_PLANES.launch(dev, ptr(x), 8, 4, 1, ptr(thr), thr.shape[1],
                               ptr(t.counts), ptr(out))
    planes = eng.transform(torch.zeros(8, 4, device=dev))
    with pytest.raises(TypeError):  # kernel B takes records, not columns
        rank_margins_cuda(planes, t.mats, t.leaf, t.depth)
    with pytest.raises(TypeError):
        rank_margins_cuda(planes, t.records.long(), t.leaf, t.depth)
    with pytest.raises(ValueError):
        rank_margins_cuda(planes, t.records[:, :3].contiguous(), t.leaf, t.depth)
    with pytest.raises(ValueError):
        rank_margins_cuda(planes[:, :100].contiguous(), t.records, t.leaf,
                          t.depth)
    with pytest.raises(ValueError):
        rank_margins_cuda(planes.cpu(), t.records, t.leaf, t.depth)


def _table(rng, F, K, counts, dev, misaligned=False):
    """A sorted [F, K] threshold table, +inf past each count; with
    ``misaligned`` its storage starts 4 bytes past a 16-byte boundary."""
    thr = np.full((F, K), np.inf, np.float32)
    for f, c in enumerate(counts):
        v = np.unique(rng.uniform(-1.0, 1.0, 2 * c + 8).astype(np.float32))[:c]
        if c > 3:
            v[:3] = np.sort(np.array([-0.0, 1e-40, 1e-38], np.float32))[:3]
            v = np.unique(v)
            v = np.concatenate([v, np.full(c - v.size, 2.0, np.float32)])
        thr[f, :c] = np.sort(v)
    t = torch.as_tensor(thr, device=dev)
    if misaligned:
        flat = torch.empty(F * K + 1, device=dev)
        flat[1:] = t.reshape(-1)
        t = flat[1:].view(F, K)
    return t, torch.as_tensor(np.asarray(counts, np.int32), device=dev)


def _edge_rows(rng, rows, F, thr):
    """Rows at the table's thresholds and around them, with +-inf, +-0.0,
    denormals and NaN."""
    t = thr.cpu().numpy()
    x = rng.uniform(-1.1, 1.1, (rows, F)).astype(np.float32)
    for f in range(F):
        finite = t[f][np.isfinite(t[f])]
        if finite.size:
            pick = rng.integers(0, finite.size, rows // 4)
            x[: rows // 4, f] = finite[pick]
    edges = np.array([np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 1e-45,
                      np.nan, 2.0, 1e-38], np.float32)
    x[-len(edges):, :] = edges[:, None]
    x[rng.random(x.shape) < 0.05] = np.nan
    return torch.as_tensor(x, device=thr.device)


@pytest.mark.parametrize("F,K,misaligned", [
    (18, 1, False), (18, 7, False), (18, 31, False), (18, 32, False),
    (30, 1101, False), (30, 1104, False), (31, 96, True), (45, 600, False),
    (480, 40, False), (30, 70000, False)])
def test_rank_transform_kernel_edges(dev, F, K, misaligned):
    """Kernel A on hand-built tables: K = 1, below and above its 16-wide
    window, past 32 x 32, not a multiple of 16 or misaligned (the wrapper
    pads them), counts below K, up to 16 groups, and a table too long for a
    16-threshold coarse index (K = 70,000): bit-equal to its plain version."""
    rng = np.random.default_rng(F * 7 + K)
    counts = [int(c) for c in rng.integers(0, K + 1, F)]
    counts[0], counts[-1] = K, 0
    thr, cnt = _table(rng, F, K, counts, dev, misaligned)
    x = _edge_rows(rng, 700, F, thr)
    before = RANK_PLANES.launches
    got = rank_planes_cuda(x, thr, cnt)
    torch.cuda.synchronize()
    assert RANK_PLANES.launches == before + 1
    assert got.shape == (700, 128 * max(1, -(-F // 30)))
    assert torch.equal(got, rank_planes_plain(x, thr, cnt))


def _wide_forest(trees, depth, num_cols, active, seed, **kw):
    """``active`` of ``num_cols`` columns live (cup98-class usage)."""
    rng = np.random.default_rng(seed)
    f = synthetic.generate_forest(trees, depth, active, seed=seed, **kw)
    f.fids = np.sort(rng.choice(num_cols, active, replace=False))[f.fids].astype(np.int32)
    f.num_cols = num_cols
    return f


@pytest.mark.parametrize("depth", [6, 8])
def test_fold_sign_kernel(dev, depth):
    """Kernel C's sign form in its own block (cup98-class rows route to the
    deep kernel, tested below)."""
    forest = compiler.hot_child_swap(_wide_forest(
        60, depth, 479, 300, seed=depth, leaf_prob=0.05, missing=-999.0))
    data = _data(2500, 479, depth + 1, missing=-999.0)
    eng = FoldKernelEngine(forest, device=dev)
    x = eng.canonicalize(data)
    t = eng.tables
    assert t.form == "sign"
    launch = fold_launch(t.width, t.depth, 60, GpuLimits.for_device(dev))
    before = FOLD_SIGN.launches
    got = fold_margins_cuda(x, t, fold_c_table(t), launch)
    torch.cuda.synchronize()
    assert FOLD_SIGN.launches == before + 1
    want = fold_margins_plain(x, t)
    assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_allclose(eng.predict(data).cpu().numpy(),
                               Forest(forest, device="cpu").predict_oracle(data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("depth,cols", [(6, 90), (13, 40)])
def test_fold_nonge_kernel(dev, depth, cols):
    """The non-ge form on kernel C (where a tile holds a tree) and on the
    deep kernel, each in its own block, and through the engine on the
    kernel fold_plan picks."""
    forest = compiler.hot_child_swap(synthetic.generate_forest(
        24, depth, cols, leaf_prob=0.1, missing=-999.0, seed=depth + cols))
    data = _data(2000, cols, depth, missing=-999.0)
    eng = FoldKernelEngine(forest, device=dev, ge_mode=False)
    assert eng.kernel in (FOLD_NONGE, FOLD_DEEP_NONGE)
    x = eng.canonicalize(data)
    t = eng.tables
    limits = GpuLimits.for_device(dev)
    want = fold_margins_plain(x, t)
    c_launch = fold_launch(t.width, t.depth, 24, limits)
    if c_launch is not None:
        got = fold_margins_cuda(x, t, fold_c_table(t), c_launch)
        torch.cuda.synchronize()
        assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    got = fold_deep_cuda(x, t, deep_blocks(t), deep_launch(t.width, limits))
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_allclose(eng.predict(data).cpu().numpy(),
                               Forest(forest, device="cpu").predict_oracle(data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("depth,cols,active", [(12, 28, 28), (15, 16, 16),
                                               (12, 479, 300)])
def test_fold_deep_kernel(dev, depth, cols, active):
    """The deep kernel in its own block; the engine on fold_plan's kernel
    (kernel C for the 300-wide rows, which leave the deep kernel fewer than
    256 rows a block)."""
    forest = compiler.hot_child_swap(_wide_forest(
        9, depth, cols, active, seed=depth, leaf_prob=0.02))
    data = _data(1500, cols, depth + 2)
    eng = FoldKernelEngine(forest, device=dev)
    t = eng.tables
    kernel = FOLD_DEEP_SIGN if active > 64 else FOLD_DEEP
    assert DEEP_KERNELS[t.form] is kernel
    assert eng.kernel is (FOLD_SIGN if active > 64 else FOLD_DEEP)
    x = eng.canonicalize(data)
    before = kernel.launches
    got = fold_deep_cuda(x, t, deep_blocks(t),
                         deep_launch(t.width, GpuLimits.for_device(dev)))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = fold_margins_plain(x, t)
    assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_allclose(eng.predict(data).cpu().numpy(),
                               Forest(forest, device="cpu").predict_oracle(data),
                               atol=ORACLE_ATOL, rtol=0)


def test_kernel_c_and_deep_kernel_agree_at_depth_12(dev):
    """Both kernels take a depth-12 dual forest; on the same tables they give
    the same margins."""
    forest = synthetic.generate_forest(10, 12, 28, leaf_prob=0.02, seed=21)
    data = _data(1200, 28, 22)
    eng = FoldKernelEngine(forest, device=dev)
    t = eng.tables
    x = eng.canonicalize(data)
    limits = GpuLimits.for_device(dev)
    c = fold_margins_cuda(x, t, fold_c_table(t),
                          fold_launch(t.width, t.depth, 10, limits))
    deep = fold_deep_cuda(x, t, deep_blocks(t), deep_launch(t.width, limits))
    assert torch.allclose(c, deep, atol=KERNEL_ATOL, rtol=0)


def test_facade_vmem_and_bucketed_count_launches(dev):
    stumps = synthetic.generate_forest(800, 3, 10, leaf_prob=0.05, seed=23)
    mixed9 = synthetic.generate_mixed_depth_forest(60, 10, 9, seed=24)
    mixed90 = synthetic.generate_mixed_depth_forest(40, 9, 90, seed=25)
    shallow_wide = synthetic.generate_forest(60, 6, 100, seed=27)
    deep_wide = _wide_forest(8, 15, 479, 300, seed=28)  # no tile of kernel C
    for forest, strategy, engine_type, kernels in (
            (shallow_wide, Strategy.SPLIT_FOREST, FoldKernelEngine, (FOLD_SIGN,)),
            (deep_wide, Strategy.SPLIT_FOREST, FoldKernelEngine,
             (FOLD_DEEP_SIGN,)),
            (stumps, Strategy.VMEM_FOREST, FoldKernelEngine, (FOLD,)),
            (mixed9, Strategy.DEPTH_BUCKETED, DepthBucketedRankEngine,
             (RANK_PLANES, RANK_FOLD)),
            (mixed90, Strategy.DEPTH_BUCKETED, DepthBucketedFoldEngine, None)):
        data = _data(1024, forest.num_cols, 26)
        f = Forest(forest, device=dev)
        eng = f.engine(strategy)
        assert isinstance(eng, engine_type)
        if kernels is None:  # the non-ge buckets: each on fold_plan's kernel
            kernels = tuple({e.kernel for e in eng.sub})
            assert set(kernels) <= {FOLD_NONGE, FOLD_DEEP_NONGE}
        counts = [k.launches for k in kernels]
        np.testing.assert_allclose(f.predict(data, strategy).cpu().numpy(),
                                   f.predict_oracle(data), atol=ORACLE_ATOL,
                                   rtol=0)
        assert all(k.launches > c for k, c in zip(kernels, counts))


@pytest.mark.parametrize("case", ["trained_deep", "exchange", "banded",
                                  "wide_groups", "single_tree"])
def test_sparse_rank_kernel(dev, case):
    """The sparse kernel against its plain version (the TPU kernel's matmul
    and masked descent) on the same planes and records."""
    forest, band = {
        "trained_deep": (train.train_forest(30, 16, 12, rows=512, seed=3), None),
        "exchange": (compiler.hot_child_swap(synthetic.generate_forest(
            40, 7, 18, leaf_prob=0.15, missing=-999.0, seed=31)), None),
        "banded": (synthetic.generate_forest(20, 6, 6, seed=32), 64),
        "wide_groups": (synthetic.generate_forest(10, 5, 480, leaf_prob=0.15,
                                                  seed=33), None),
        "single_tree": (train.train_forest(1, 12, 8, rows=256, seed=34), None),
    }[case]
    data = _data(3000, forest.num_cols, 35, missing=forest.missing)
    eng = SparseRankEngine(forest, device=dev, band=band)
    t = eng.tables
    planes = eng.transform(data)
    before = SPARSE_RANK.launches
    got = sparse_margins_cuda(planes, t.slots, t.roots.shape[0], t.steps)
    torch.cuda.synchronize()
    assert SPARSE_RANK.launches == before + 1
    want = sparse_margins_plain(planes, t.records, t.roots, t.max_depth)
    if forest.num_trees == 1:  # one leaf per row: the same f32 value
        assert torch.equal(got, want)
    assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_allclose(eng.predict(data).cpu().numpy(),
                               Forest(forest, device="cpu").predict_oracle(data),
                               atol=ORACLE_ATOL, rtol=0)


def test_sparse_rank_kernel_rejects_bad_operands(dev):
    eng = SparseRankEngine(synthetic.generate_forest(5, 4, 6, seed=36), device=dev)
    t = eng.tables
    planes = eng.transform(_data(64, 6, 37))
    T = t.roots.shape[0]
    with pytest.raises(ValueError):
        sparse_margins_cuda(planes, t.slots[:, :3].contiguous(), T, t.steps)
    with pytest.raises(ValueError):
        sparse_margins_cuda(planes[:, :100].contiguous(), t.slots, T, t.steps)
    with pytest.raises(TypeError):
        sparse_margins_cuda(planes, t.slots.long(), T, t.steps)
    with pytest.raises(ValueError):
        sparse_margins_cuda(planes, t.slots, t.slots.shape[0] + 1, t.steps)
    # the launcher refuses slots of another width than it was built for
    with pytest.raises(RuntimeError):
        sparse_margins_cuda(planes, torch.cat([t.slots, t.slots], dim=1), T,
                            t.steps)


def test_facade_sparse_and_plain_strategies(dev):
    """SPARSE launches kernel A and the sparse kernel; its gather tier and
    the three plain torch strategies launch no kernel."""
    deep = train.train_forest(12, 17, 10, rows=512, seed=38)
    wide = synthetic.generate_forest(40, 6, 1440, seed=39)
    shallow = synthetic.generate_forest(30, 6, 18, leaf_prob=0.1, seed=40)
    kernels = (RANK_PLANES, RANK_FOLD, FOLD, FOLD_SIGN, FOLD_NONGE, FOLD_DEEP,
               FOLD_DEEP_SIGN, FOLD_DEEP_NONGE, SPARSE_RANK)
    for forest, strategy, engine_type, launched in (
            (deep, Strategy.SPARSE, SparseRankEngine, {RANK_PLANES, SPARSE_RANK}),
            (wide, Strategy.SPARSE, SparseGatherEngine, set()),
            (shallow, Strategy.HBM_DIRECT, object, set()),
            (shallow, Strategy.ROW_TILED, object, set()),
            (shallow, Strategy.TENSOR, object, set())):
        data = _data(1024, forest.num_cols, 41)
        f = Forest(forest, device=dev)
        assert isinstance(f.engine(strategy), engine_type)
        counts = [k.launches for k in kernels]
        got = f.predict(data, strategy)
        torch.cuda.synchronize()
        assert got.device == dev
        np.testing.assert_allclose(got.cpu().numpy(), f.predict_oracle(data),
                                   atol=ORACLE_ATOL, rtol=0)
        assert {k for k, c in zip(kernels, counts) if k.launches > c} == launched


def _fused_edge_rows(data, missing):
    """Rows that every search must rank as kernel A does: one all missing
    (the forest's own ``missing`` value), one of +0.0 and one of -0.0,
    denormals of both signs, +inf and -inf."""
    data = data.copy()
    data[3] = missing
    data[4] = 0.0
    data[5] = -0.0
    data[6, ::2], data[6, 1::2] = 1e-40, -1e-40
    data[7] = np.inf
    data[8] = -np.inf
    return data


@pytest.mark.parametrize("case", ["susy_like", "sentinel_swapped", "banded",
                                  "widest_band"])
def test_rank_fused_kernel(dev, case):
    """The fused kernel is bit for bit kernel A then kernel B on the same
    rows and tables, and within KERNEL_ATOL of its plain version: at the
    widest band too (30 virtual features of 16,255 thresholds, a coarse
    index of stride 32 and 61 KB), at row counts that are not a multiple of
    the block's, on rows all missing and on +-0.0, denormals and +-inf."""
    forest, band = {
        "susy_like": (synthetic.generate_forest(60, 8, 18, seed=51), None),
        "sentinel_swapped": (compiler.hot_child_swap(synthetic.generate_forest(
            40, 7, 12, leaf_prob=0.1, missing=-999.0, seed=52)), None),
        "banded": (synthetic.generate_forest(30, 6, 9, seed=53), 80),
        "widest_band": (synthetic.generate_forest(470, 10, 15, seed=5), None),
    }[case]
    data = _fused_edge_rows(_data(3000, forest.num_cols, 54, missing=forest.missing),
                            forest.missing)
    eng = RankFoldEngine(forest, device=dev, band=band, fuse_transform=True)
    t = eng.tables
    assert eng.groups == 1 and eng.fused == (band is None)
    if case == "widest_band":
        assert tuple(t.thresholds.shape) == (30, 16256)
    x = t.rows(data, eng.raw_missing)
    assert bool(torch.isnan(x[3]).all())
    for rows in (3000, 1, 257):
        xr = x[:rows].contiguous()
        before = RANK_FUSED.launches
        got = rank_margins_fused_cuda(xr, t.thresholds, t.counts, t.fused_records,
                                      t.leaf, t.depth)
        torch.cuda.synchronize()
        assert RANK_FUSED.launches == before + 1
        assert got.shape == (rows,)
        two = rank_margins_cuda(rank_planes_cuda(xr, t.thresholds, t.counts),
                                t.records, t.leaf, t.depth)
        assert torch.equal(got, two)
        want = rank_margins_fused_plain(xr, t.thresholds, t.counts, t.mats,
                                        t.leaf, t.depth)
        assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_allclose(eng.predict(data).cpu().numpy(),
                               Forest(forest, device="cpu").predict_oracle(data),
                               atol=ORACLE_ATOL, rtol=0)


def test_fused_engine_launches_only_the_fused_kernel(dev):
    forest = synthetic.generate_forest(60, 8, 18, leaf_prob=0.05, seed=55)
    data = _data(2048, 18, 56)
    eng = RankFoldEngine(forest, device=dev, fuse_transform=True)
    unfused = RankFoldEngine(forest, device=dev)
    assert eng.fused
    counts = [k.launches for k in (RANK_PLANES, RANK_FOLD, RANK_FUSED)]
    got = eng.predict(data)
    torch.cuda.synchronize()
    assert [k.launches for k in (RANK_PLANES, RANK_FOLD, RANK_FUSED)] == [
        counts[0], counts[1], counts[2] + 1]
    assert torch.equal(got, unfused.predict(data))
    with pytest.raises(ValueError, match="one plane group"):
        x = torch.zeros(8, 40, device=dev)
        thr = torch.zeros(40, 16, device=dev)
        rank_margins_fused_cuda(x, thr, torch.zeros(40, dtype=torch.int32,
                                                    device=dev),
                                eng.tables.fused_records, eng.tables.leaf,
                                eng.tables.depth)


@pytest.mark.parametrize("mode", INT8_MODES)
def test_probe_int8_kernel(dev, mode):
    """Each mode exact against numpy and the plain version, at the probe's
    256 rows (two 128-row tiles), at 272 (a last tile of one warp's 16 rows)
    and at 65,536 (each block looping over several tiles)."""
    for rows in (256, 272, 65536):
        x32, w8 = int8_cast_probe.inputs(rows)
        x = torch.as_tensor(x32, device=dev)
        w = torch.as_tensor(w8, device=dev)
        before = PROBE_INT8.launches
        got = int8_probe_cuda(x, w, mode)
        torch.cuda.synchronize()
        assert PROBE_INT8.launches == before + 1
        assert torch.equal(got, int8_probe_plain(x, w, mode))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      int8_cast_probe.numpy_reference(x32, w8, mode))


def _probe_tables(dev, cols):
    """Rank tables of 1, 2 or 16 plane groups (18, 45, 480 columns) and the
    planes of 1,500 rows: no multiple of kernel B's block (256 rows; 32 at
    sixteen groups)."""
    forest = synthetic.generate_forest(50, 8, cols, leaf_prob=0.05, seed=cols)
    eng = RankFoldEngine(forest, device=dev)
    t = eng.tables
    assert t.groups == {18: 1, 45: 2, 480: 16}[cols]
    return eng.transform(_data(1500, cols, cols + 1)), t


@pytest.mark.parametrize("cols", [18, 45, 480])
@pytest.mark.parametrize("mode", OVERHEAD_MODES)
def test_probe_overhead_kernel(dev, mode, cols):
    planes, t = _probe_tables(dev, cols)
    paths = walk_paths(planes, t.records, t.depth)
    before = PROBE_OVERHEAD.launches
    got = walk_probe_cuda(planes, t.records, t.leaf, t.depth, mode, paths)
    torch.cuda.synchronize()
    assert PROBE_OVERHEAD.launches == before + 1
    assert torch.equal(got, walk_probe_plain(planes, t.records, t.leaf, t.depth,
                                             mode, paths))


@pytest.mark.parametrize("cols", [18, 45, 480])
@pytest.mark.parametrize("mode", RANK_PARTS_MODES)
def test_probe_rank_parts_kernel(dev, mode, cols):
    planes, t = _probe_tables(dev, cols)
    paths = walk_paths(planes, t.records, t.depth)
    before = PROBE_RANK_PARTS.launches
    got = walk_probe_cuda(planes, t.records, t.leaf, t.depth, mode, paths)
    torch.cuda.synchronize()
    assert PROBE_RANK_PARTS.launches == before + 1
    assert torch.equal(got, walk_probe_plain(planes, t.records, t.leaf, t.depth,
                                             mode, paths))


def test_rank_block_reckoning_matches_the_library(dev):
    """ops/rank_kernel.py's copy of kernel B's block sizing (rows a block,
    staged words a row) is the built library's at every group count."""
    fn = library().tahoe_rank_launch_shape
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    for groups in range(1, 17):
        block, words = ctypes.c_int(), ctypes.c_int()
        fn(groups, ctypes.byref(block), ctypes.byref(words))
        assert (block.value, words.value) == (rank_block_rows(groups),
                                              rank_row_words(groups)), groups


@pytest.mark.parametrize("rows", [1, 31, 65537])
def test_redesigned_kernels_at_row_counts(dev, rows):
    """The sparse kernel and both deep-kernel forms (one and two threads a
    row) against their plain versions at one row, a partial warp, and one
    row past 65,536."""
    sparse = SparseRankEngine(train.train_forest(20, 14, 12, rows=512, seed=71),
                              device=dev)
    st = sparse.tables
    planes = sparse.transform(_data(rows, 12, 72))
    got = sparse_margins_cuda(planes, st.slots, st.roots.shape[0], st.steps)
    want = sparse_margins_plain(planes, st.records, st.roots, st.max_depth)
    assert got.shape == (rows,)
    assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)
    for forest, kernel in (
            (synthetic.generate_forest(6, 13, 16, leaf_prob=0.05, seed=73),
             FOLD_DEEP),
            (_wide_forest(8, 9, 300, 120, seed=74, missing=-999.0),
             FOLD_DEEP_SIGN)):
        eng = FoldKernelEngine(forest, device=dev)
        assert DEEP_KERNELS[eng.form] is kernel
        x = eng.canonicalize(_data(rows, forest.num_cols, 75,
                                   missing=forest.missing))
        want = fold_margins_plain(x, eng.tables)
        blocks = deep_blocks(eng.tables)
        # one thread a row and two, each in a partial last block
        for lanes in (1, 2):
            launch = deep_launch(eng.tables.width, GpuLimits.for_device(dev))._replace(
                rows_per_block=48, lanes=lanes)
            got = fold_deep_cuda(x, eng.tables, blocks, launch)
            torch.cuda.synchronize()
            assert got.shape == (rows,)
            assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)


def test_launchers_capture_in_a_cuda_graph(dev):
    """The launchers that grant shared memory (kernels A and B, the fused
    kernel on SUSY-class tables, kernel C in its dual, sign and non-ge
    forms, the deep kernel in its sign and non-ge forms, the sparse kernel,
    both walk probes in every mode at two plane groups, past 48 KB a block)
    give inside a CUDA graph what they give outside
    it: no attribute call falls in the capture. Kernel C's forms take the
    whole opt-in budget back to back, the sign form the smaller, so that a
    grant keyed by anything less than the kernel leaves the sign form's
    launch refused."""
    limits = GpuLimits.for_device(dev)
    rank = RankFoldEngine(synthetic.generate_forest(60, 8, 18, seed=61), device=dev)
    rt = rank.tables
    x = rt.rows(_data(4096, 18, 62), rank.raw_missing)
    planes = rank_planes_cuda(x, rt.thresholds, rt.counts)
    susy = RankFoldEngine(synthetic.susy_class_forest(seed=0), device=dev,
                          fuse_transform=True)
    ft = susy.tables
    xf = ft.rows(_data(4096, 18, 62), susy.raw_missing)
    dual = FoldKernelEngine(synthetic.generate_forest(200, 8, 18, seed=63),
                            device=dev)
    sign = FoldKernelEngine(_wide_forest(200, 7, 300, 120, seed=64), device=dev)
    nonge = FoldKernelEngine(synthetic.generate_forest(40, 9, 90, seed=71),
                             device=dev, ge_mode=False)
    xd = dual.canonicalize(_data(4096, 18, 65))
    xs = sign.canonicalize(_data(4096, 300, 66))
    xn = nonge.canonicalize(_data(4096, 90, 72))
    tables = {e: fold_c_table(e.tables) for e in (dual, sign, nonge)}
    dl = fold_launch(dual.tables.width, 8, 200, limits, budget=limits.smem_per_block)
    sl = fold_launch(sign.tables.width, 7, 200, limits,
                     budget=limits.smem_per_block - 4096)
    nl = fold_launch(nonge.tables.width, 9, 40, limits, budget=limits.smem_per_block)
    assert 48 * 1024 < sl.smem_bytes < dl.smem_bytes
    assert nl.smem_bytes > 48 * 1024 and nl.tile_trees < 40  # a ring
    deep = FoldKernelEngine(_wide_forest(30, 10, 479, 300, seed=67), device=dev)
    deep_blocks_w = deep_blocks(deep.tables)
    deep_launch_w = deep_launch(deep.tables.width, limits)
    assert deep_launch_w.smem_bytes > 48 * 1024
    xw = deep.canonicalize(_data(4096, 479, 68))
    nonge_launch = deep_launch(nonge.tables.width, limits)
    assert nonge_launch.smem_bytes > 48 * 1024
    nonge_blocks = deep_blocks(nonge.tables)
    sparse = SparseRankEngine(synthetic.generate_forest(40, 6, 480, seed=69),
                              device=dev)
    st = sparse.tables
    assert st.groups >= 12  # 32-row blocks of staged bytes, past 48 KB
    sp = sparse.transform(_data(4096, 480, 70))
    wp, wt = _probe_tables(dev, 45)
    wpaths = walk_paths(wp, wt.records, wt.depth)
    calls = {
        "rank_transform": lambda: rank_planes_cuda(x, rt.thresholds, rt.counts),
        "rank_fold": lambda: rank_margins_cuda(planes, rt.records, rt.leaf, rt.depth),
        "rank_fused": lambda: rank_margins_fused_cuda(xf, ft.thresholds, ft.counts,
                                                      ft.fused_records, ft.leaf,
                                                      ft.depth),
        "fold dual, fold sign, fold nonge": lambda: torch.stack([
            fold_margins_cuda(xd, dual.tables, tables[dual], dl),
            fold_margins_cuda(xs, sign.tables, tables[sign], sl),
            fold_margins_cuda(xn, nonge.tables, tables[nonge], nl)]),
        "fold_deep_sign": lambda: fold_deep_cuda(xw, deep.tables, deep_blocks_w,
                                                 deep_launch_w),
        "fold_deep_nonge": lambda: fold_deep_cuda(xn, nonge.tables, nonge_blocks,
                                                  nonge_launch),
        "sparse_rank": lambda: sparse_margins_cuda(sp, st.slots, st.roots.shape[0],
                                                   st.steps),
        "probe_overhead, probe_rank_parts": lambda: torch.stack([
            walk_probe_cuda(wp, wt.records, wt.leaf, wt.depth, mode, wpaths)
            for mode in OVERHEAD_MODES + RANK_PARTS_MODES]),
    }
    for name, fn in calls.items():
        want = fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


# (form, columns, depth) of kernel C's ring tests
RING_FORMS = {"dual": (18, 6), "sign": (120, 7), "nonge": (90, 5)}


@pytest.mark.parametrize("tile", [1, 3, 4, 5, 11])
@pytest.mark.parametrize("form", sorted(RING_FORMS))
def test_kernel_c_ring_of_tiles(dev, form, tile):
    """Kernel C in each form at tiles of 1, 3, 4, 5 and 11 trees (8 in
    flight: a tile of fewer descends only its own), 7 tiles so that each of
    the ring's two buffers is refilled at least three times, the last tile
    short; at one row, a partial warp and one row past 65,536 in 64-row
    blocks: against the plain version, and each kernel launch counted."""
    cols, depth = RING_FORMS[form]
    T = 6 * tile + max(tile - 1, 1)
    forest = compiler.hot_child_swap(synthetic.generate_forest(
        T, depth, cols, leaf_prob=0.1, missing=-999.0, seed=tile + depth))
    t = fold_tables(forest, device=dev, ge_mode=form != "nonge")
    assert t.form == form
    table = fold_c_table(t)
    launch = FoldLaunch(64, tile, fold_smem_bytes(t.width, depth, T, 64, tile))
    kernel = FOLD_KERNELS[form]
    for rows in (1, 31, 65537):
        x = canonicalize_rows(_data(rows, cols, rows + tile, missing=-999.0),
                              forest.missing, device=dev, col_index=t.col_index,
                              dual=form == "dual")
        before = kernel.launches
        got = fold_margins_cuda(x, t, table, launch)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert got.shape == (rows,)
        assert torch.allclose(got, fold_margins_plain(x, t), atol=KERNEL_ATOL,
                              rtol=0)


@pytest.mark.parametrize("depth", [9, 13])
def test_fold_deep_nonge_kernel(dev, depth):
    """The deep kernel's non-ge instance against the plain version, one and
    two threads a row, in partial last blocks."""
    forest = compiler.hot_child_swap(synthetic.generate_forest(
        10, depth, 90, leaf_prob=0.05, missing=-999.0, seed=depth))
    eng = FoldKernelEngine(forest, device=dev, ge_mode=False)
    t = eng.tables
    x = eng.canonicalize(_data(3001, 90, depth, missing=-999.0))
    blocks = deep_blocks(t)
    want = fold_margins_plain(x, t)
    for lanes in (1, 2):
        launch = deep_launch(t.width, GpuLimits.for_device(dev))._replace(
            rows_per_block=48, lanes=lanes)
        before = FOLD_DEEP_NONGE.launches
        got = fold_deep_cuda(x, t, blocks, launch)
        torch.cuda.synchronize()
        assert FOLD_DEEP_NONGE.launches == before + 1
        assert torch.allclose(got, want, atol=KERNEL_ATOL, rtol=0)


def test_register_queries_match_the_model(dev):
    """perf_model/model.py's registers a thread of every kernel instance it
    prices are the runtime's (cudaFuncGetAttributes); a bad query raises."""
    from tahoe_tpu_torch.ops._build import registers
    from tahoe_tpu_torch.perf_model.model import KERNEL_REGISTERS

    got = {key: registers(*key) for key in KERNEL_REGISTERS}
    assert got == KERNEL_REGISTERS
    with pytest.raises(RuntimeError, match="CUDA error"):
        registers("tahoe_fold_registers", 3, 0)


@pytest.mark.parametrize("kind", ["fold", "rank", "sparse"])
def test_sharded_engines_on_one_process(dev, kind):
    """A (1, 1) grid without a process group on the card: each sharded
    engine runs its unsharded engine's kernels and predicts bit for bit as
    it does; a 13-tree forest keeps every kernel's tree count odd."""
    from tahoe_tpu_torch.parallel.mesh import make_mesh
    from tahoe_tpu_torch.parallel import sharded

    spec = synthetic.generate_forest(13, 6, 20, leaf_prob=0.1, seed=41)
    rows = torch.as_tensor(_data(1000, 20, 42), device=dev)
    cls, ref = {"fold": (sharded.ShardedForestEngine, FoldKernelEngine),
                "rank": (sharded.ShardedRankEngine, RankFoldEngine),
                "sparse": (sharded.ShardedSparseEngine, SparseRankEngine)}[kind]
    grid = make_mesh(1, 1, device="cuda")
    eng = cls(spec, grid)
    assert eng.device == dev
    before = {k: k.launches for k in (RANK_PLANES, RANK_FOLD, SPARSE_RANK,
                                      *FOLD_KERNELS.values(), *DEEP_KERNELS.values())}
    got = eng.predict(rows)
    assert sum(k.launches - n for k, n in before.items()) >= 1
    assert torch.equal(got, ref(spec, device=dev).predict(rows))
