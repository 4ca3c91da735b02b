"""The port's SPARSE strategy on the CPU: SparseRankEngine (kernel A's and
the sparse kernel's plain versions) against the JAX package's
SparseRankEngine in interpret mode and the numpy oracle, the node records
against the rank columns of the JAX build_sparse_leveled, the gather tier
against the JAX SparseGatherEngine, and deep forests through the facade.

Predictions are held to JAX within 1e-5 (the TPU kernel sums f32 partials
per 128-tree tile, the port sums leaves in f64) and to the oracle within
ORACLE_ATOL. A single tree's margin is one leaf value, so there the port
must equal the oracle bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tahoe_tpu.config import ORACLE_ATOL
from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.forest import sparse as jax_sparse
from tahoe_tpu.forest.sparse import SparseGatherEngine as JaxSparseGatherEngine
from tahoe_tpu.forest.spec import ForestSpec as JaxForestSpec
from tahoe_tpu.forest.train import train_forest
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.sparse_kernel import SparseRankEngine as JaxSparseRankEngine
from tahoe_tpu.ops.sparse_kernel import _node_column
from tahoe_tpu_torch import Forest, Strategy
from tahoe_tpu_torch.forest import sparse
from tahoe_tpu_torch.forest.quantize import quantized_spec_for_engines
from tahoe_tpu_torch.forest.spec import from_arrays, to_arrays
from tahoe_tpu_torch.ops.rank_kernel import pack_records, rank_quantize
from tahoe_tpu_torch.ops.sparse_kernel import (
    LEAF_BASE,
    PASS_WORD,
    SPARSE_LEVELS,
    SparseRankEngine,
    node_columns,
    record_depths,
    sparse_block_walk,
    sparse_blocks,
    sparse_leaves_plain,
    sparse_margins,
    sparse_margins_plain,
    sparse_rank_reason,
    sparse_records,
    sparse_tables,
)
from tahoe_tpu_torch.ops.transform import apply_output_transform

CPU = torch.device("cpu")
JAX_ATOL = 1e-5


def _port(spec):
    """A forest built by the JAX package, carried across to the port."""
    return from_arrays(dataclasses.asdict(spec))


def _hot(forest):
    return compiler.hot_child_swap(forest)


# the cases of tests/test_sparse_kernel.py: (forest, rows, band)
CASES = {
    "early_leaves": lambda: (
        synthetic.generate_forest(20, 5, 10, leaf_prob=0.25, seed=1),
        synthetic.generate_data(64, 10, missing_prob=0.1, seed=2), None),
    "trained_deep": lambda: (
        train_forest(12, 9, 12, rows=512, seed=3),
        synthetic.generate_data(64, 12, missing_prob=0.05, seed=4), None),
    "finite_sentinel": lambda: (
        synthetic.generate_forest(10, 4, 8, leaf_prob=0.2, seed=5,
                                  missing=-999.0),
        synthetic.generate_data(48, 8, missing_prob=0.2, seed=6,
                                missing=-999.0), None),
    "exchange_bits": lambda: (
        _hot(synthetic.generate_forest(12, 5, 9, leaf_prob=0.15, seed=7)),
        synthetic.generate_data(48, 9, missing_prob=0.15, seed=8), None),
    "multi_tile_trees": lambda: (
        train_forest(130, 5, 8, rows=256, seed=9),
        synthetic.generate_data(32, 8, missing_prob=0.1, seed=10), None),
    "banded": lambda: (
        synthetic.generate_forest(30, 6, 6, seed=11),
        synthetic.generate_data(32, 6, seed=12), 64),
    "wide_groups": lambda: (
        synthetic.generate_forest(10, 5, 160, leaf_prob=0.15, seed=21),
        synthetic.generate_data(32, 160, missing_prob=0.1, seed=22), None),
    "full_depth12_pool": lambda: (
        synthetic.generate_forest(8, 12, 10, seed=13),
        synthetic.generate_data(16, 10, missing_prob=0.05, seed=14), None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sparse_matches_jax_and_oracle(name):
    forest, data, band = CASES[name]()
    eng = SparseRankEngine(_port(forest), device=CPU, band=band)
    got = eng.predict(data)
    assert got.dtype == torch.float32 and got.shape == (data.shape[0],)
    jeng = JaxSparseRankEngine(forest, interpret=True, row_tile=8, band=band)
    np.testing.assert_allclose(got.numpy(), np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)
    assert eng.groups == jeng.groups
    if name == "banded":
        assert eng.q.spec.num_cols > forest.num_cols
    if name == "wide_groups":
        assert eng.groups >= 5
    if name == "multi_tile_trees":
        assert eng.tables.roots.shape == (130,) and jeng.lv.n_tiles == 2


@pytest.mark.parametrize("make", [
    lambda: train_forest(1, 14, 10, rows=1024, seed=31),
    lambda: _hot(synthetic.generate_forest(1, 9, 12, leaf_prob=0.1,
                                           missing=-999.0, seed=32)),
    lambda: synthetic.generate_forest(1, 6, 40, leaf_prob=0.2, seed=33),
])
def test_single_tree_margins_equal_the_oracle(make):
    forest = make()
    data = synthetic.generate_data(300, forest.num_cols, missing=forest.missing,
                                   missing_prob=0.1, seed=34)
    got = SparseRankEngine(_port(forest), device=CPU).margins(data).numpy()
    np.testing.assert_array_equal(got, oracle.predict_margins(forest, data))


@pytest.mark.parametrize("name", ["exchange_bits", "finite_sentinel",
                                  "wide_groups", "banded"])
def test_records_expand_to_the_jax_columns(name):
    """Every internal node's column, expanded from its record, is the one
    the JAX build_sparse_leveled writes for that node
    (sparse_kernel.py:130-144, with its swap and form, :224-235)."""
    forest, _, band = CASES[name]()
    q, _ = rank_quantize(_port(forest), band)
    G = compiler.rank_groups(q.spec.num_cols)
    sf = sparse.from_dense(quantized_spec_for_engines(q))
    records, pos = sparse_records(sf)
    cols = node_columns(torch.as_tensor(records), G).numpy()
    col_of = np.cumsum(records[:, 2] >= 0) - 1
    internal = np.nonzero(~sf.is_leaf)[0]
    want = np.zeros((128 * G, internal.size), np.int8)
    for j, n in enumerate(internal):
        swapped = (not sf.def_left[n]) ^ bool(sf.exchange[n])
        neg = bool(sf.exchange[n]) ^ swapped
        _node_column(want, j, int(sf.values[n]), int(sf.fids[n]), neg, G)
    np.testing.assert_array_equal(cols[:, col_of[pos[internal]]], want)
    # children are stored as a pair; a swapped pair trades places
    li = sf.left_idx[internal]
    assert (records[pos[internal], 2] == li).all()
    swapped = ~sf.def_left[internal] ^ sf.exchange[internal]
    np.testing.assert_array_equal(pos[li], np.where(swapped, li + 1, li))
    leaf = sf.is_leaf
    np.testing.assert_array_equal(records[pos[leaf], 3].view(np.float32),
                                  sf.values[leaf])


def test_plain_margins_chunk_rows(monkeypatch):
    """The plain version's row chunks do not change the margins."""
    from tahoe_tpu_torch.ops import sparse_kernel

    forest, data, _ = CASES["trained_deep"]()
    eng = SparseRankEngine(_port(forest), device=CPU)
    t = eng.tables
    planes = eng.transform(data)
    whole = sparse_margins(planes, t)
    leaves, reads = sparse_block_walk(planes, t.slots, t.roots.shape[0], t.steps)
    monkeypatch.setattr(sparse_kernel, "PLAIN_CHUNK_BYTES", 1)
    chunked = sparse_margins(planes, t)
    assert torch.equal(whole, chunked)
    walked = sparse_block_walk(planes, t.slots, t.roots.shape[0], t.steps)
    assert torch.equal(walked[0], leaves) and torch.equal(walked[1], reads)


def test_all_leaf_forest():
    forest = synthetic.generate_forest(6, 3, 5, seed=35)
    forest.is_leaf[:] = True
    t = sparse_tables(_port(forest), device=CPU)
    assert t.max_depth == 0 and t.records.shape[0] == 6
    data = synthetic.generate_data(10, 5, seed=36)
    got = SparseRankEngine(_port(forest), device=CPU).predict(data).numpy()
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("missing", [float("nan"), -999.0])
def test_gather_tier_matches_jax(missing):
    """The plain torch CSR descent against the JAX SparseGatherEngine on a
    forest of 1,440 columns, past the rank planes' 480."""
    forest = _hot(synthetic.generate_forest(40, 6, 1440, leaf_prob=0.1,
                                            missing=missing, seed=23))
    data = synthetic.generate_data(50, 1440, missing=missing, missing_prob=0.1,
                                   seed=24)
    sf = sparse.from_dense(_port(forest))
    eng = sparse.SparseGatherEngine(sf, device=CPU)
    got = eng.predict(data).numpy()
    want = np.asarray(JaxSparseGatherEngine(jax_sparse.from_dense(forest))
                      .predict(data))
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(eng.margins(data).numpy(),
                               sparse.predict_margins_np(sf, data),
                               atol=ORACLE_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


def test_facade_picks_the_tier_by_feasibility():
    """SPARSE takes the rank engine where its planes hold the forest, the
    gather tier otherwise, by sparse_rank_reason."""
    forest = train_forest(20, 9, 12, rows=512, seed=20)
    f = Forest(_port(forest), device=CPU)
    assert isinstance(f.engine(Strategy.SPARSE), SparseRankEngine)
    wide = Forest(_port(synthetic.generate_forest(40, 6, 1440, seed=23)),
                  device=CPU)
    assert "virtual features > 480" in SparseRankEngine.feasible(wide.spec)
    assert sparse_rank_reason(wide.facts.vcols) == SparseRankEngine.feasible(wide.spec)
    assert isinstance(wide.engine(Strategy.SPARSE), sparse.SparseGatherEngine)
    for fo in (f, wide):
        data = synthetic.generate_data(40, fo.spec.num_cols, missing_prob=0.05,
                                       seed=21)
        np.testing.assert_allclose(fo.predict(data, Strategy.SPARSE).numpy(),
                                   fo.predict_oracle(data), atol=ORACLE_ATOL,
                                   rtol=0)


def test_deep_trained_forest_through_the_facade():
    """Depth > 15: SPARSE serves it (and agrees with JAX), and so does
    SPLIT_FOREST on the deep kernel; VMEM_FOREST gives the shared-memory
    reason, the leveled strategies theirs."""
    forest = train_forest(10, 17, 10, rows=512, seed=25)
    f = Forest(_port(forest), device=CPU)
    assert f.spec.depth > 15
    data = synthetic.generate_data(48, 10, missing_prob=0.05, seed=26)
    assert f.feasible(Strategy.SPARSE) is None
    got = f.predict(data, Strategy.SPARSE).numpy()
    np.testing.assert_allclose(got, f.predict_oracle(data), atol=ORACLE_ATOL,
                               rtol=0)
    jeng = JaxSparseRankEngine(JaxForestSpec(**to_arrays(f.spec)),
                               interpret=True, row_tile=8)
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    assert f.feasible(Strategy.SPLIT_FOREST) is None
    np.testing.assert_allclose(f.predict(data, Strategy.SPLIT_FOREST).numpy(),
                               got, atol=JAX_ATOL, rtol=0)
    assert "shared memory" in f.feasible(Strategy.VMEM_FOREST)
    for s in (Strategy.ROW_TILED, Strategy.TENSOR):
        assert "leveled form of depth" in f.feasible(s)
        with pytest.raises(ValueError, match="infeasible"):
            f.engine(s)


def _leaves_at(forest, leaf):
    """``forest`` with ``leaf`` (a [T, nodes] mask) made leaves."""
    forest.is_leaf[leaf] = True
    return forest


# the sparse kernel's layout cases beside CASES: (forest, rows, band)
BLOCK_CASES = {
    **CASES,
    "all_leaf": lambda: (
        _leaves_at(synthetic.generate_forest(6, 3, 5, seed=35), slice(None)),
        synthetic.generate_data(10, 5, seed=36), None),
    "single_node_tree": lambda: (
        _leaves_at(synthetic.generate_forest(4, 5, 7, leaf_prob=0.1, seed=41),
                   (1, 0)),
        synthetic.generate_data(40, 7, missing_prob=0.1, seed=42), None),
    "leaves_every_depth": lambda: (
        synthetic.generate_forest(30, 9, 8, leaf_prob=0.3, seed=43),
        synthetic.generate_data(48, 8, missing_prob=0.1, seed=44), None),
    "swapped_sentinel": lambda: (
        _hot(synthetic.generate_forest(20, 7, 10, leaf_prob=0.2,
                                       missing=-999.0, seed=45)),
        synthetic.generate_data(48, 10, missing=-999.0, missing_prob=0.2,
                                seed=46), None),
    "depth18_few_trees": lambda: (
        train_forest(3, 18, 10, rows=2048, seed=47),
        synthetic.generate_data(40, 10, missing_prob=0.05, seed=48), None),
}


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_walk_matches_plain_and_jax(name):
    """The slot walk (the sparse kernel's arithmetic in torch) reaches the
    plain descent's leaf in every (row, tree), reading ceil(depth / b) + 1
    slots (b = SPARSE_LEVELS), so its margins are the plain version's bit for
    bit; the predictions are within JAX_ATOL of the JAX engine in interpret
    mode."""
    forest, data, band = BLOCK_CASES[name]()
    eng = SparseRankEngine(_port(forest), device=CPU, band=band)
    t = eng.tables
    T = t.roots.shape[0]
    planes = eng.transform(data)
    slots, start, steps = sparse_blocks(t.records.numpy(), t.roots.numpy())
    assert torch.equal(torch.as_tensor(slots), t.slots) and steps == t.steps
    leaves, reads = sparse_block_walk(planes, t.slots, T, t.steps)
    want = sparse_leaves_plain(planes, t.records, t.roots, t.max_depth)
    assert torch.equal(torch.as_tensor(start)[leaves], want)
    depth = record_depths(t.records, t.max_depth)
    assert torch.equal(reads, -(-depth[want] // SPARSE_LEVELS) + 1)
    value = t.slots[:, 0].contiguous().view(torch.float32)
    walked = value[leaves].double().sum(dim=1).float()
    assert torch.equal(walked, sparse_margins_plain(planes, t.records, t.roots,
                                                    t.max_depth))
    got = apply_output_transform(walked, eng.num_trees, eng.output,
                                 eng.global_bias, eng.threshold).numpy()
    np.testing.assert_allclose(got, oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)
    if name == "all_leaf":  # no internal node: the JAX pool is empty
        assert t.steps == 1 and (t.slots[:, -1] == LEAF_BASE).all()
        return
    jeng = JaxSparseRankEngine(forest, interpret=True, row_tile=8, band=band)
    np.testing.assert_allclose(got, np.asarray(jeng.predict(data)),
                               atol=JAX_ATOL, rtol=0)
    leaf_depths = depth[t.records[:, 2] < 0]
    if name == "leaves_every_depth":
        assert set((leaf_depths % 3).tolist()) == {0, 1, 2}
        assert set((leaf_depths % 2).tolist()) == {0, 1}
        assert bool((t.slots == PASS_WORD).any())
    if name == "single_node_tree":
        assert int(t.slots[1, -1]) == LEAF_BASE
    if name == "depth18_few_trees":
        assert t.max_depth >= 16
        assert t.steps == -(-t.max_depth // SPARSE_LEVELS) + 1


@pytest.mark.parametrize("levels", [2, 3])
def test_sparse_blocks_layout(levels):
    """Slot t is tree t's root; a leaf slot holds its value and LEAF_BASE; a
    block's first word is its node's record; the blocks' children tile the
    slots after the roots in order, each block's in its exits' order."""
    forest = _hot(synthetic.generate_forest(15, 7, 9, leaf_prob=0.25, seed=49))
    t = sparse_tables(_port(forest), device=CPU)
    records, roots = t.records.numpy(), t.roots.numpy()
    slots, start, steps = sparse_blocks(records, roots, levels)
    W = 1 << levels
    assert slots.shape == (start.size, W) and slots.dtype == np.int32
    np.testing.assert_array_equal(start[:roots.size], roots)
    leaf = slots[:, W - 1] == LEAF_BASE
    np.testing.assert_array_equal(leaf, records[start, 2] < 0)
    np.testing.assert_array_equal(slots[leaf, 0], records[start[leaf], 3])
    blocks = np.flatnonzero(~leaf)
    top = records[start[blocks]]
    np.testing.assert_array_equal(slots[blocks, 0], pack_records(top[:, 1], top[:, 0]))
    base = slots[blocks, W - 1] >> W
    count = np.array([bin(m).count("1") for m in slots[blocks, W - 1] & ((1 << W) - 1)])
    assert base[0] == roots.size and (base[1:] == base[:-1] + count[:-1]).all()
    assert base[-1] + count[-1] == slots.shape[0]
    # the pass-through word decodes to lane 0 and a k below any planes' sum
    assert PASS_WORD & 0xFFF == 0 and (PASS_WORD >> 12) < -(127 * 128 + 128)
    assert bool((slots[blocks, :W - 1] == PASS_WORD).any())
    with pytest.raises(ValueError):
        sparse_blocks(records, roots, 4)
