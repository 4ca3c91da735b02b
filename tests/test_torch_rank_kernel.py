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
from tahoe_tpu_torch.forest import compiler as port_compiler
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops.rank_kernel import (
    RECORD_LANE_BITS,
    RECORD_LANE_MASK,
    RankFoldEngine,
    _int32_matmul,
    fused_records,
    pack_records,
    rank_margins_fused_cuda,
    rank_margins_fused_plain,
    rank_margins_plain,
    rank_records,
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


def _record_columns(records, groups):
    """Kernel B's records [T, N] -> the rank columns [T, N, 128*G] they stand
    for: 127 and 1 at ``lane`` and ``lane + 30``, and (c127, c1) at lanes
    120 and 121 from k = 127*c127 + c1 (rank = -k in the pos form, k + 1 in
    the neg form); a pass-through (lane 128*G) holds c1 = -1 alone."""
    r = records.reshape(-1).astype(np.int64)
    lane, k = r & RECORD_LANE_MASK, r >> RECORD_LANE_BITS
    K = 128 * groups
    cols = np.zeros((r.size, K), np.int8)
    feat = lane < K
    neg = feat & (lane % 128 >= port_compiler.RANK_LANE_NQH)
    rank = np.where(neg, k + 1, -k)
    rh, rl = rank // 127, rank % 127
    j = np.flatnonzero(feat)
    cols[j, lane[j]] = 127
    cols[j, lane[j] + 30] = 1
    cols[j, 120] = np.where(neg, rh, -rh)[j]
    cols[j, 121] = np.where(neg, rl - 1, -rl)[j]
    cols[~feat, 121] = -1
    assert (k[~feat] == -1).all() and (lane[~feat] == K).all()
    return cols.reshape(*records.shape, K)


def _record_walk(planes, records, leaf, depth):
    """A torch twin of kernel B's walk: the same decode and arithmetic, a
    pass-through record reading the zeros past the row; leaves summed in
    f64 as the plain version sums them."""
    R = planes.shape[0]
    T = records.shape[0]
    p = torch.nn.functional.pad(planes.to(torch.int32), (0, 32))
    tree = torch.arange(T)
    n = torch.zeros(R, T, dtype=torch.int64)
    for d in range(depth):
        r = records[tree, n].to(torch.int64)
        lane = r & RECORD_LANE_MASK
        diff = (127 * torch.gather(p, 1, lane) + torch.gather(p, 1, lane + 30)
                + (r >> RECORD_LANE_BITS))
        n += (1 + (diff >= 0).long()) << d
    return leaf[tree, n - ((1 << depth) - 1)].double().sum(dim=1).float()


# (trees, depth, cols, leaf_prob, hot_swap, band): SUSY-class at small size;
# early leaves (pass-through nodes); def_left mixed with exchange (neg form);
# banded features; two plane groups
RECORD_CASES = {
    "susy_small": (40, 8, 18, 0.0, False, None),
    "early_leaves": (30, 7, 12, 0.35, False, None),
    "neg_form": (30, 6, 18, 0.1, True, None),
    "banded": (30, 6, 9, 0.1, True, 50),
    "two_groups": (20, 6, 45, 0.2, True, None),
}


def _record_case(name):
    trees, depth, cols, leaf_prob, swap, band = RECORD_CASES[name]
    forest = synthetic.generate_forest(trees, depth, cols, leaf_prob=leaf_prob,
                                       seed=trees + depth + cols)
    if swap:
        forest = compiler.hot_child_swap(forest)
    return forest, band


@pytest.mark.parametrize("name", sorted(RECORD_CASES))
def test_rank_records_rebuild_mats(name):
    """Every record gives back its node's column byte for byte."""
    forest, band = _record_case(name)
    t = rank_tables(_port(forest), band, device=CPU)
    G = t.groups
    assert t.records.dtype == torch.int32
    assert t.records.shape == t.mats.shape[:2]
    assert np.array_equal(_record_columns(t.records.numpy(), G), t.mats.numpy())
    lanes = t.records.numpy() & RECORD_LANE_MASK
    if name == "early_leaves":
        assert (lanes == 128 * G).any()
    if name in ("neg_form", "two_groups"):
        assert (lanes % 128 >= port_compiler.RANK_LANE_NQH).any()
    if name == "two_groups":
        assert G == 2 and (lanes // 128 == 1).any()


def test_record_packing_edges():
    """k = -RANK_MAX and RANK_MAX - 1 (the ends of the ranks' range), the
    top lanes of 16 plane groups and the pass-through lane 128*16, packed
    and decoded as kernel B decodes them; out-of-range fields refused."""
    rmax = port_compiler.RANK_MAX
    k = np.array([-rmax, rmax - 1, rmax, -1, 0, -1])
    lane = np.array([2009, 1949, 2047, 2048, 0, 128])
    r = pack_records(k, lane)
    assert r.dtype == np.int32
    assert np.array_equal(r & RECORD_LANE_MASK, lane)
    assert np.array_equal(r >> RECORD_LANE_BITS, k)
    rt = torch.as_tensor(r)
    assert torch.equal(rt & RECORD_LANE_MASK, torch.as_tensor(lane, dtype=torch.int32))
    assert torch.equal(rt >> RECORD_LANE_BITS, torch.as_tensor(k, dtype=torch.int32))
    for bad_k, bad_lane in ((rmax + 1, 0), (0, 4096), (0, -1)):
        with pytest.raises(ValueError):
            pack_records(np.array([bad_k]), np.array([bad_lane]))
    # columns at both ends of the rank range in group 15 (pos form at rank
    # RANK_MAX, neg form at RANK_MAX), and a pass-through
    cols = np.zeros((1, 3, 128 * 16), np.int8)
    rh, rl = divmod(rmax, 127)
    cols[0, 0, [1920 + 29, 1920 + 59, 120, 121]] = [127, 1, -rh, -rl]
    cols[0, 1, [1920 + 89, 1920 + 119, 120, 121]] = [127, 1, rh, rl - 1]
    cols[0, 2, 121] = -1
    rec = rank_records(cols)
    assert np.array_equal(rec & RECORD_LANE_MASK, [[1949, 2009, 2048]])
    assert np.array_equal(rec >> RECORD_LANE_BITS, [[-rmax, rmax - 1, -1]])
    assert np.array_equal(_record_columns(rec, 16), cols)
    cols[0, 1, 1920 + 100] = 3  # a fifth nonzero: not rank_normalize's form
    with pytest.raises(ValueError):
        rank_records(cols)


@pytest.mark.parametrize("name", ["early_leaves", "neg_form", "banded",
                                  "two_groups"])
def test_record_walk_matches_plain_and_jax(name):
    """The record walk (kernel B's arithmetic in torch) is bit for bit the
    plain version's margins, and within JAX_ATOL of the JAX engine in
    interpret mode."""
    forest, band = _record_case(name)
    data = synthetic.generate_data(64, forest.num_cols, missing_prob=0.1,
                                   seed=forest.num_trees + 5)
    k = min(forest.num_cols, forest.nodes_per_tree)
    data[0, :k] = forest.values[0, :k]  # exact threshold hits
    eng = RankFoldEngine(_port(forest), device=CPU, band=band)
    t = eng.tables
    planes = eng.transform(data)
    walked = _record_walk(planes, t.records, t.leaf, t.depth)
    assert torch.equal(walked, rank_margins_plain(planes, t.mats, t.leaf, t.depth))
    jeng = JaxRankFoldEngine(forest, band=band, interpret=True, row_tile=16,
                             tree_tile=16)
    np.testing.assert_allclose(eng._finish(walked).numpy(),
                               np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)


def _fused_walk(x, t):
    """A torch twin of the fused kernel: kernel A's ranks (the plain
    version's search), staged as the kernel stages them, 2F + 1 values a row
    (q at i, -q at F + i, -16384 in both for a missing value, 0 at 2F), then
    kernel B's walk over ``fused_records``; leaves summed in f64."""
    R, F = x.shape
    q = torch.searchsorted(t.thresholds, x.t().contiguous(), right=True).t()
    q = torch.minimum(q, t.counts.to(q.dtype))
    miss = torch.isnan(x)
    v = torch.cat([torch.where(miss, -16384, q), torch.where(miss, -16384, -q),
                   torch.zeros(R, 1, dtype=q.dtype)], dim=1)
    records = t.fused_records
    T = records.shape[0]
    tree = torch.arange(T)
    n = torch.zeros(R, T, dtype=torch.int64)
    for d in range(t.depth):
        r = records[tree, n].to(torch.int64)
        diff = torch.gather(v, 1, r & RECORD_LANE_MASK) + (r >> RECORD_LANE_BITS)
        n += (1 + (diff >= 0).long()) << d
    return t.leaf[tree, n - ((1 << t.depth) - 1)].double().sum(dim=1).float()


# (trees, depth, cols, leaf_prob, hot_swap, missing): early leaves (pass-
# through records), hot-child-swapped nodes (the neg form), a finite
# sentinel, one feature and thirty (a whole plane group)
FUSED_WALK_CASES = {
    "susy_small": (40, 8, 18, 0.0, False, float("nan")),
    "early_leaves": (30, 7, 12, 0.35, False, float("nan")),
    "hot_swapped": (30, 6, 18, 0.1, True, float("nan")),
    "sentinel": (25, 6, 12, 0.15, True, -999.0),
    "one_feature": (20, 5, 1, 0.1, True, float("nan")),
    "thirty_features": (40, 7, 30, 0.1, True, float("nan")),
}


@pytest.mark.parametrize("name", sorted(FUSED_WALK_CASES))
def test_fused_records_walk_matches_plain(name):
    """The fused kernel's records (remapped on the host by fused_records),
    walked over the 2F + 1 staged values, give the plain version's margins
    bit for bit, on rows with -0.0, +0.0, denormals, +-inf and a row all
    missing."""
    trees, depth, cols, leaf_prob, swap, missing = FUSED_WALK_CASES[name]
    forest = synthetic.generate_forest(trees, depth, cols, leaf_prob=leaf_prob,
                                       missing=missing, seed=trees + depth + cols)
    if swap:
        forest = compiler.hot_child_swap(forest)
    data = synthetic.generate_data(96, cols, missing=missing, missing_prob=0.1,
                                   seed=cols + 7)
    k = min(cols, forest.nodes_per_tree)
    data[0, :k] = forest.values[0, :k]  # exact threshold hits
    data[1], data[2, ::2], data[3] = missing, 1e-40, np.inf
    data[4], data[5], data[6, ::2] = -0.0, 0.0, -np.inf
    eng = RankFoldEngine(_port(forest), device=CPU)
    t = eng.tables
    x = t.rows(data, eng.raw_missing)
    F = x.shape[1]
    assert F == cols and t.fused_records.shape == t.records.shape
    lanes = t.fused_records.numpy() & RECORD_LANE_MASK
    assert lanes.max() <= 2 * F
    if name == "early_leaves":
        assert (lanes == 2 * F).any()
    if swap:
        assert ((lanes >= F) & (lanes < 2 * F)).any()
    want = rank_margins_fused_plain(x, t.thresholds, t.counts, t.mats, t.leaf,
                                    t.depth)
    assert torch.equal(_fused_walk(x, t), want)
    assert torch.equal(want, rank_margins_plain(eng.transform(data), t.mats,
                                                t.leaf, t.depth))


def test_fused_records_remap_lanes():
    """QH lane i -> i, NQH lane 60 + i -> F + i, the pass-through lane 128 ->
    2F, each k kept; a QL lane, a lane past F or an F past one group is
    refused; tables past one plane group have no fused records."""
    rmax = port_compiler.RANK_MAX
    rec = pack_records(np.array([[-rmax, 5, rmax - 1, -1]]),
                       np.array([[0, 64, 66, 128]]))
    got = fused_records(rec, 7)
    assert np.array_equal(got & RECORD_LANE_MASK, [[0, 11, 13, 14]])
    assert np.array_equal(got >> RECORD_LANE_BITS, [[-rmax, 5, rmax - 1, -1]])
    for lane, F in ((30, 7), (7, 7), (67, 7), (0, 0), (0, 31)):
        with pytest.raises(ValueError):
            fused_records(pack_records(np.array([[0]]), np.array([[lane]])), F)
    two = rank_tables(_port(synthetic.generate_forest(20, 6, 45, seed=3)), None,
                      device=CPU)
    assert two.groups == 2 and two.fused_records is None


def test_fused_wrapper_refuses_other_tables():
    """The fused kernel's wrapper takes only kernel A's aligned table (K a
    multiple of 16, 16-byte aligned) and rows of one plane group: it raises
    before any launch."""
    forest = synthetic.generate_forest(30, 6, 12, seed=97)
    eng = RankFoldEngine(_port(forest), device=CPU, fuse_transform=True)
    t = eng.tables
    x = t.rows(synthetic.generate_data(16, 12, seed=98), eng.raw_missing)
    rest = (t.counts, t.fused_records, t.leaf, t.depth)
    K = t.thresholds.shape[1]
    assert K % 16 == 0 and t.thresholds.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="aligned table"):
        rank_margins_fused_cuda(x, t.thresholds[:, :K - 1].contiguous(), *rest)
    shifted = torch.empty(t.thresholds.numel() + 1)[1:].view(t.thresholds.shape)
    shifted.copy_(t.thresholds)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned table"):
        rank_margins_fused_cuda(x, shifted, *rest)
    wide = RankFoldEngine(_port(synthetic.generate_forest(20, 6, 45, seed=3)),
                          device=CPU, fuse_transform=True)
    wt = wide.tables
    xw = wt.rows(synthetic.generate_data(16, 45, seed=99), wide.raw_missing)
    with pytest.raises(ValueError, match="one plane group"):
        rank_margins_fused_cuda(xw, wt.thresholds, wt.counts, t.fused_records,
                                wt.leaf, wt.depth)
