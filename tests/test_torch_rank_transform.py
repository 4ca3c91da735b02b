"""Port rank transform (kernel A's plain version on the CPU) vs the numpy
reference and the JAX package's Pallas transforms (interpret mode).

Planes must be bit-identical: a rank off by one at a threshold tie routes a
row down the other branch. The numpy reference is
``encode_rank_planes_np(transform_rows_np(q, x))`` (bench.py:132-134).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tahoe_tpu.forest import quantize, synthetic
from tahoe_tpu.ops.rank_kernel import RankFoldEngine as JaxRankFoldEngine
from tahoe_tpu.ops.rank_kernel import _x_lanes
from tahoe_tpu.ops.rank_transform import (
    build_bucket_tables,
    pad_threshold_tables,
    rank_planes_kernel,
    rank_planes_kernel_v2,
)
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
from tahoe_tpu_torch.ops.rank_transform import (
    TABLE_ALIGN,
    aligned_table,
    assemble_planes,
    rank_planes,
    rank_planes_plain,
    threshold_table,
)
from tahoe_tpu_torch.ops.rows import canonicalize_rows

CPU = torch.device("cpu")


def _port(spec):
    """A forest built by the JAX package, carried across to the port."""
    return from_arrays(dataclasses.asdict(spec))


def _numpy_planes(tables, x):
    """Reference planes for canonical rows x (NaN = missing)."""
    ranks = np.stack([np.searchsorted(tables[f], x[:, f], side="right")
                      for f in range(x.shape[1])], axis=1).astype(np.float32)
    ranks[np.isnan(x)] = np.nan
    return quantize.encode_rank_planes_np(ranks)


def _port_planes(tables, x):
    thr, counts = threshold_table(tables, device=CPU)
    return rank_planes(torch.as_tensor(x), thr, counts).numpy()


def _jax_v1(tables, x):
    xp = np.pad(x, ((0, 0), (0, 128 - x.shape[1])))
    u = jnp.asarray(pad_threshold_tables(tables, x.shape[1]))
    return np.asarray(rank_planes_kernel(jnp.asarray(xp), u,
                                         row_tile=x.shape[0], interpret=True))


def _jax_v2(tables, x, row_tile):
    xp = np.pad(x, ((0, 0), (0, _x_lanes(x.shape[1]) - x.shape[1])))
    cmax, digs, S, paired = build_bucket_tables(tables, x.shape[1])
    return np.asarray(rank_planes_kernel_v2(jnp.asarray(xp), cmax, digs, S,
                                            paired, row_tile=row_tile,
                                            interpret=True))


def _rows_with_edges(rows, cols, tables, seed, missing=float("nan")):
    data = synthetic.generate_data(rows, cols, missing=missing,
                                   missing_prob=0.1, seed=seed)
    data[0, 0] = tables[0][0]      # exact threshold tie
    data[1, 1] = -0.0              # signed zero
    data[2, 2] = 0.0
    data[3, 3] = np.inf
    data[4, 4] = -np.inf
    return data


@pytest.mark.parametrize("missing", [float("nan"), -999.0])
@pytest.mark.parametrize("cols", [9, 18])
def test_engine_planes_match_numpy_and_jax_v1(missing, cols):
    """<= 256 thresholds per feature: the JAX engine's flat v1 regime."""
    forest = synthetic.generate_forest(17, 4, cols, leaf_prob=0.1,
                                       missing=missing, seed=cols)
    eng = RankFoldEngine(_port(forest), device=CPU)
    data = _rows_with_edges(64, cols, eng.q.tables, cols + 1, missing)
    got = eng.transform(data).numpy()
    gather = (np.arange(cols) if eng.tables.col_index is None
              else eng.tables.col_index.numpy())
    want = quantize.encode_rank_planes_np(
        quantize.transform_rows_np(eng.q, data[:, gather]))
    assert np.array_equal(got, want)
    x = canonicalize_rows(data, missing, device=CPU,
                          col_index=eng.tables.col_index).numpy()
    assert np.array_equal(got, _jax_v1(eng.q.tables, x))


@pytest.mark.parametrize("cols,trees", [(6, 40), (18, 40)])
def test_planes_match_jax_v2_large_tables(cols, trees):
    """> 256 thresholds per feature: the bucketed v2 regime of the SUSY path
    (paired digit slots at 18 features, unpaired at 6)."""
    forest = synthetic.generate_forest(trees, 8, cols, seed=cols + 20)
    q = quantize.quantize(forest)
    assert q.max_ranks > 256
    data = _rows_with_edges(64, cols, q.tables, cols + 21)
    got = _port_planes(q.tables, data)
    assert np.array_equal(got, _numpy_planes(q.tables, data))
    assert np.array_equal(got, _jax_v2(q.tables, data, row_tile=64))


@pytest.mark.parametrize("cols", [121, 150])
def test_five_plus_plane_groups(cols):
    """121+ virtual features: G >= 5 plane groups, the JAX package's
    group-streamed v2 grid."""
    rng = np.random.default_rng(cols)
    tables = [np.unique(rng.uniform(-1, 1, int(rng.integers(3, 40)))
                        .astype(np.float32)) for _ in range(cols)]
    data = rng.uniform(-1.2, 1.2, (32, cols)).astype(np.float32)
    data[rng.random(data.shape) < 0.1] = np.nan
    data[0, 0] = tables[0][0]
    got = _port_planes(tables, data)
    assert got.shape == (32, 128 * 5)
    assert np.array_equal(got, _numpy_planes(tables, data))
    assert np.array_equal(got, _jax_v2(tables, data, row_tile=16))


def test_signed_zero_and_denormals_vs_numpy():
    """Thresholds at 0 and at denormals, rows at +-0.0 and denormals: exact
    against numpy. (The JAX package's CPU interpret path is not the
    reference here: XLA's CPU runtime flushes denormals and folds x + 0.0.)"""
    t = np.array([-1e-38, -1e-40, 0.0, 1e-45, 1e-40, 0.5], np.float32)
    tables = [t, t[1:], t[:4]]
    vals = np.array([-0.0, 0.0, 1e-45, -1e-45, 1e-40, 2e-40, -1e-40, -2e-40,
                     1e-38, 0.5, np.nan, np.inf, -np.inf, 5e-41, -5e-41, 3.0],
                    np.float32)
    data = np.stack([vals, vals[::-1], np.roll(vals, 3)], axis=1)
    got = _port_planes(tables, data)
    assert np.array_equal(got, _numpy_planes(tables, data))
    # spot-check the ranks themselves: -0.0 ties with the 0.0 threshold
    ranks = got[:, 0].astype(np.int64) * 127 + got[:, 30]
    assert ranks[0] == 3 and ranks[1] == 3 and ranks[2] == 4 and ranks[3] == 2


def test_banded_features_match_numpy_and_jax():
    """Features with more thresholds than ``band`` split into banded virtual
    features; rows expand through the column gather."""
    forest = synthetic.generate_forest(30, 6, 9, leaf_prob=0.1, seed=31)
    data = synthetic.generate_data(64, 9, missing_prob=0.1, seed=32)
    eng = RankFoldEngine(_port(forest), device=CPU, band=50)
    assert eng.q.spec.num_cols > 9
    gather = eng.tables.col_index.numpy()
    got = eng.transform(data).numpy()
    want = quantize.encode_rank_planes_np(
        quantize.transform_rows_np(eng.q, data[:, gather]))
    assert np.array_equal(got, want)
    jeng = JaxRankFoldEngine(forest, row_tile=16, tree_tile=16, band=50,
                             interpret=True)
    jax_planes = np.asarray(jeng._transform(jeng.rank_tables, jnp.asarray(data)))
    assert np.array_equal(got, jax_planes[:64])


def test_assemble_planes_lane_map():
    q = torch.tensor([[0, 126, 127, 16255], [5, 0, 0, 0]], dtype=torch.int32)
    miss = torch.tensor([[False, False, False, False], [False, True, False, False]])
    p = assemble_planes(q, miss).numpy()
    assert p.shape == (2, 128)
    assert list(p[0, :4]) == [0, 0, 1, 127] and list(p[0, 30:34]) == [0, 126, 0, 126]
    assert list(p[0, 60:64]) == [0, 0, -1, -127]
    assert p[1, 1] == p[1, 31] == p[1, 61] == p[1, 91] == -128
    assert (p[:, 120] == 127).all() and (p[:, 121] == 1).all()
    assert (p[:, 122:] == 0).all() and (p[:, 4:30] == 0).all()


def test_plus_inf_row_is_bounded_by_counts():
    """+inf pads never count: an x of +inf ranks at the feature's count."""
    tables = [np.array([0.5], np.float32), np.array([], np.float32)]
    thr, counts = threshold_table(tables, device=CPU)
    x = torch.tensor([[np.inf, np.inf]], dtype=torch.float32)
    p = rank_planes_plain(x, thr, counts).numpy()
    assert p[0, 30] == 1 and p[0, 31] == 0



@pytest.mark.parametrize("k,offset", [(1, 0), (7, 0), (31, 0), (32, 0), (96, 1)])
def test_aligned_table_keeps_the_planes(k, offset):
    """Kernel A takes K a multiple of TABLE_ALIGN on 16-byte storage; the
    wrapper copies any other table with +inf appended, and the counts keep
    the pad out of every rank: the planes are unchanged, +inf rows too."""
    rng = np.random.default_rng(k)
    counts = rng.integers(0, k + 1, 5).astype(np.int32)
    counts[0] = k
    thr = np.full((5, k), np.inf, np.float32)
    for f, c in enumerate(counts):
        thr[f, :c] = np.sort(rng.uniform(-1, 1, c).astype(np.float32))
    flat = torch.empty(5 * k + offset)
    flat[offset:] = torch.as_tensor(thr).reshape(-1)
    t = flat[offset:].view(5, k)
    got = aligned_table(t)
    assert got.shape[1] % TABLE_ALIGN == 0 and got.data_ptr() % 16 == 0
    assert (got is t) == (k % TABLE_ALIGN == 0 and offset == 0)
    assert torch.equal(got[:, :k], t) and torch.isinf(got[:, k:]).all()
    x = torch.as_tensor(rng.uniform(-1.2, 1.2, (40, 5)).astype(np.float32))
    x[0], x[1], x[2, 1] = np.inf, -np.inf, np.nan
    c = torch.as_tensor(counts)
    assert torch.equal(rank_planes_plain(x, got, c), rank_planes_plain(x, t, c))
