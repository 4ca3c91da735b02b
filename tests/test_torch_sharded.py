"""The port's sharded inference (tahoe_tpu_torch/parallel/) on gloo CPU ranks,
held to the JAX package's sharded engines on the conftest's 8 virtual
devices at the same meshes, to the numpy oracle, and shard by shard to the
port's unsharded engines.

Each forest runs once, in 2 or 4 processes of run_multiproc.launch (a rank
a process, meeting through a file store under tmp_path), every mesh and
engine of the forest in one launch; each launch has its own timeout, so a
rendezvous that hangs fails its tests and not the run. The ranks import
nothing of jax or of the JAX package, and report so."""
import dataclasses

import numpy as np
import pytest

from tahoe_tpu.forest import compiler as jax_compiler
from tahoe_tpu.forest import synthetic as jax_synthetic
from tahoe_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tahoe_tpu.parallel.sharded import (
    ShardedForestEngine as JaxShardedForest,
    ShardedRankEngine as JaxShardedRank,
    ShardedSparseEngine as JaxShardedSparse,
)
from tahoe_tpu_torch.config import ORACLE_ATOL, Output
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops import oracle
from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine
from tahoe_tpu_torch.parallel import sharded
from tahoe_tpu_torch.parallel.mesh import make_mesh
from tahoe_tpu_torch.scripts import run_multiproc

# each launch's limit: the ranks start, build and predict in seconds here
LAUNCH_TIMEOUT = 90.0
MESHES = [(2, 1), (1, 2), (2, 2)]


def _port(spec):
    return from_arrays(dataclasses.asdict(spec))


def _jax_data(rows, cols, seed):
    return jax_synthetic.generate_data(rows, cols, missing_prob=0.1, seed=seed)


# name -> (JAX forest, rows, meshes, engines, ranks): tests/test_sharded.py's
# forest and rows; its sparse test's 256-tree forest (two of the JAX
# engine's 128-tree tiles); a depth-13 forest, the deep kernel's regime; a
# forest of 50 trees with every output transform and a bias, over shards
# that do not divide it
def _cases():
    tst = jax_synthetic.generate_forest(48, 4, 12, leaf_prob=0.1, seed=101)
    mixed = jax_synthetic.generate_mixed_depth_forest(
        256, 6, 10, min_depth=2, leaf_prob=0.25, seed=111)
    deep = jax_synthetic.generate_forest(16, 13, 10, leaf_prob=0.1, seed=103)
    out = dataclasses.replace(
        jax_synthetic.generate_forest(50, 4, 12, leaf_prob=0.1, seed=105),
        output=int(Output.AVG | Output.SIGMOID | Output.THRESHOLD),
        global_bias=0.25, threshold=0.565)
    return {
        "test_sharded": (tst, _jax_data(96, 12, 102), MESHES,
                         ["fold", "rank", "sparse"], 4),
        "sparse256": (mixed, _jax_data(48, 10, 112), MESHES, ["sparse"], 4),
        "deep13": (deep, _jax_data(32, 10, 104), [(1, 2)], ["fold"], 2),
        "transforms": (out, _jax_data(96, 12, 106), [(1, 3), (1, 4), (2, 2)],
                       ["fold", "rank", "sparse"], 4),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's launch, lazily: case -> (port forest, rows, reports)."""
    done = {}

    def get(name):
        if name not in done:
            jf, rows, meshes, engines, ranks = CASES[name]
            spec = _port(jf)
            reports = run_multiproc.launch(
                spec, rows, nprocs=ranks, workdir=tmp_path_factory.mktemp(name),
                meshes=meshes, engines=engines, device="cpu",
                timeout=LAUNCH_TIMEOUT)
            done[name] = (spec, rows, reports)
        return done[name]

    return get


def _results(reports, engine, mesh):
    return [res for rep in reports for res in rep["results"]
            if res["engine"] == engine and tuple(res["mesh"]) == tuple(mesh)]


def _jax_sharded(name, engine, mesh):
    jf, rows, *_ = CASES[name]
    m = jax_make_mesh(data=mesh[0], model=mesh[1])
    if engine == "fold":
        eng = JaxShardedForest(jax_compiler.levelize(jf), m, row_tile=8, tree_tile=8)
    elif engine == "rank":
        eng = JaxShardedRank(jf, m, row_tile=8, tree_tile=8)
    else:
        eng = JaxShardedSparse(jf, m, row_tile=8)
    return np.asarray(eng.predict(rows))


JAX_CASES = ([("test_sharded", e, m) for e in ("fold", "rank") for m in MESHES]
             + [("sparse256", "sparse", m) for m in MESHES]
             + [("deep13", "fold", (1, 2))])


@pytest.mark.parametrize("name,engine,mesh", JAX_CASES)
def test_matches_the_jax_sharded_engine(runs, name, engine, mesh):
    """Every rank returns every row's prediction, within ORACLE_ATOL of the
    JAX sharded engine at the same mesh and of the oracle."""
    spec, rows, reports = runs(name)
    want = _jax_sharded(name, engine, mesh)
    res = _results(reports, engine, mesh)
    assert len(res) == mesh[0] * mesh[1]
    truth = oracle.predict(spec, rows)
    for r in res:
        assert r["predictions"].shape == (len(rows),)
        np.testing.assert_allclose(r["predictions"], want, atol=ORACLE_ATOL, rtol=0)
        np.testing.assert_allclose(r["predictions"], truth, atol=ORACLE_ATOL, rtol=0)


SHARD_CASES = ([("test_sharded", e, m) for e in ("fold", "rank", "sparse")
                for m in MESHES]
               + [("sparse256", "sparse", m) for m in MESHES]
               + [("deep13", "fold", (1, 2))]
               + [("transforms", e, m) for e in ("fold", "rank", "sparse")
                  for m in [(1, 3), (1, 4), (2, 2)]])


@pytest.mark.parametrize("name,engine,mesh", SHARD_CASES)
def test_shard_margins_equal_an_engine_on_its_trees(runs, name, engine, mesh):
    """Each rank's raw shard margins are bit-equal to the port's unsharded
    engine built on that shard's trees; the shards cover every tree once."""
    spec, rows, reports = runs(name)
    summary = run_multiproc.check(spec, rows, reports, "cpu")
    key = f"{engine} {mesh[0]}x{mesh[1]}"
    assert summary[key]["shards_bit_equal"], summary[key]
    assert summary[key]["correct"], summary[key]
    res = _results(reports, engine, mesh)
    covered = sorted({tuple(r["trees"]) for r in res})
    assert covered[0][0] == 0 and covered[-1][1] == spec.num_trees
    assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))


@pytest.mark.parametrize("engine", ["fold", "rank", "sparse"])
def test_output_transform_runs_once_with_every_tree(runs, engine):
    """AVG | SIGMOID | THRESHOLD with a bias, trees over 4 shards: the
    transform runs once on the summed margins, AVG dividing by all 50
    trees and the bias added once; the raw sum is the shards' sum."""
    spec, rows, reports = runs("transforms")
    res = _results(reports, engine, (1, 4))
    total = np.sum([r["shard_margins"].astype(np.float64) for r in res], axis=0)
    raw = dataclasses.replace(spec, output=int(Output.RAW), global_bias=0.0)
    np.testing.assert_allclose(total, oracle.predict(raw, rows), atol=ORACLE_ATOL,
                               rtol=0)
    score = 1 / (1 + np.exp(-(total / spec.num_trees + spec.global_bias)))
    # no row within rounding of the threshold, so that the check is exact
    assert np.abs(score - spec.threshold).min() > 1e-4
    want = (score > spec.threshold).astype(np.float32)
    assert 0 < want.sum() < len(want)
    for r in res:
        np.testing.assert_array_equal(r["predictions"], want)


def test_shards_are_padded_where_the_trees_do_not_divide(runs):
    """50 trees over 3 and 4 shards: shards of 17, 17, 16 and 13, 13, 12,
    12 trees, each padded to the largest with trees of one zero leaf; a
    rank past the (1, 3) grid builds no engine."""
    spec, _, reports = runs("transforms")
    for mesh, sizes in (((1, 3), [17, 17, 16]), ((1, 4), [13, 13, 12, 12])):
        res = _results(reports, "fold", mesh)
        assert [b - a for a, b in (r["trees"] for r in res)] == sizes
        assert {r["shard_trees"] for r in res} == {max(sizes)}
    assert not _results([reports[3]], "fold", (1, 3))
    assert all(not rep["leaked"] for rep in reports)


def test_tree_shards_and_padding():
    """The JAX engines raise on 48 trees over 5 shards (test_sharded.py);
    here the shards differ by one tree and pad, and only an empty shard
    raises."""
    assert [len(s) for s in sharded.tree_shards(48, 5)] == [10, 10, 10, 9, 9]
    with pytest.raises(ValueError, match="empty"):
        sharded.tree_shards(3, 4)
    spec = _port(jax_synthetic.generate_forest(7, 3, 5, leaf_prob=0.1, seed=9))
    shards = sharded.tree_shards(7, 3)
    padded = sharded.padded_forest(spec, shards)
    assert padded.num_trees == 9
    rows = _jax_data(40, 5, 10)
    # the oracle's f32 sum over more terms may round otherwise
    np.testing.assert_allclose(oracle.predict(padded, rows),
                               oracle.predict(spec, rows), atol=1e-6, rtol=0)
    # shards [0, 1, 2], [3, 4, pad], [5, 6, pad]
    assert padded.is_leaf[[5, 8]].all() and not padded.values[[5, 8]].any()
    assert sharded.padded_forest(spec, sharded.tree_shards(7, 1)) is spec
    assert [sharded.row_slice(10, 3, d) for d in range(3)] == [
        slice(0, 4), slice(4, 8), slice(8, 10)]


def test_too_few_ranks_raises():
    with pytest.raises(ValueError, match="need 4 ranks, have 1"):
        make_mesh(2, 2, device="cpu")


def test_one_rank_without_a_group_is_the_unsharded_engine():
    """A (1, 1) mesh in this process alone: no collective, and the
    predictions of the unsharded engine bit for bit."""
    spec = _port(CASES["test_sharded"][0])
    rows = CASES["test_sharded"][1]
    mesh = make_mesh(1, 1, device="cpu")
    assert (mesh.d, mesh.m, mesh.model_group, mesh.data_group) == (0, 0, None, None)
    eng = sharded.ShardedForestEngine(spec, mesh)
    want = FoldKernelEngine(spec, device="cpu").predict(rows).numpy()
    np.testing.assert_array_equal(eng.predict(rows).numpy(), want)
    local = sharded.batch_sharded_put(rows, mesh)
    np.testing.assert_array_equal(eng.predict_local(local).numpy(), want)
