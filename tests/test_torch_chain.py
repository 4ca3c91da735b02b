"""The port's chain of k predicts (ops/graphed.py ``graphed.chain``,
``GraphedEngine.predict_k``, ``RankFoldEngine.predict_planes_k``) and the
chained-slope timing (utils/profiling.py ``slope_time``) on the CPU.

Every engine's ``predict_k(rows, k)`` for k in {1, 3} is held to the JAX
engine's ``predict_k`` (``_chain_impl``; ``_chain_planes_impl`` for the
planes) on the same forest and rows, the Pallas kernels in interpret mode:
within JAX_ATOL = 1e-5, since both sides sum the same leaves in another
order, and bit for bit to the port's own ``predict``, which each step of
the chain is. The plan of a chain's graphs, its launch counts on stand-in
kernels and the slope's noise guard run without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tahoe_tpu.config import ORACLE_ATOL
from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.forest import sparse as jax_sparse
from tahoe_tpu.forest.sparse import SparseGatherEngine as JaxSparseGatherEngine
from tahoe_tpu.forest.train import train_forest
from tahoe_tpu.ops import bucketed as jax_bucketed
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.fold_kernel import FoldKernelEngine as JaxFoldKernelEngine
from tahoe_tpu.ops.gather_engine import GatherEngine as JaxGatherEngine
from tahoe_tpu.ops.rank_kernel import RankFoldEngine as JaxRankFoldEngine
from tahoe_tpu.ops.sparse_kernel import SparseRankEngine as JaxSparseRankEngine
from tahoe_tpu.ops.tensor_engine import TensorEngine as JaxTensorEngine
from tahoe_tpu_torch.forest import compiler as port_compiler
from tahoe_tpu_torch.forest import sparse
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops import _build, graphed
from tahoe_tpu_torch.ops.bucketed import (
    DepthBucketedFoldEngine,
    DepthBucketedRankEngine,
)
from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine
from tahoe_tpu_torch.ops.gather_engine import GatherEngine
from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
from tahoe_tpu_torch.ops.sparse_kernel import SparseRankEngine
from tahoe_tpu_torch.ops.tensor_engine import TensorEngine
from tahoe_tpu_torch.utils import profiling

CPU = torch.device("cpu")
JAX_ATOL = 1e-5


def _port(spec):
    """A forest built by the JAX package, carried across to the port."""
    return from_arrays(dataclasses.asdict(spec))


def _mixed_depth(trees=24, stored=7, cols=9, seed=5, missing=float("nan")):
    """tests/test_torch_bucketed.py's forest: a third of the trees end by
    depth 3, a third by depth 5."""
    f = synthetic.generate_forest(trees, stored, cols, leaf_prob=0.05,
                                  missing=missing, seed=seed)
    third = trees // 3
    f.is_leaf[:third, f.level_slice(3).start:] = True
    f.is_leaf[third:2 * third, f.level_slice(5).start:] = True
    return f


def _rows(cols, n=40, seed=2, missing=float("nan")):
    return synthetic.generate_data(n, cols, missing=missing, missing_prob=0.1,
                                   seed=seed)


def _fold():
    f = synthetic.generate_forest(20, 5, 10, leaf_prob=0.1, missing=-999.0,
                                  seed=41)
    return (FoldKernelEngine(_port(f), device=CPU),
            JaxFoldKernelEngine(compiler.levelize(f), row_tile=16, tree_tile=32,
                                interpret=True),
            f, _rows(10, missing=-999.0))


def _rank(fuse=False):
    def make():
        if fuse:  # tests/test_torch_rank_kernel.py FUSED_CASES "single_row_tile"
            f = synthetic.generate_forest(150, 6, 10, seed=93)
            jkw = dict(row_tile=128, tree_tile=8, split_level=4,
                       stream_once=False, fuse_transform=True)
        else:
            f = synthetic.generate_forest(40, 6, 18, leaf_prob=0.1, seed=46)
            jkw = dict(row_tile=16, tree_tile=32, split_level=2)
        eng = RankFoldEngine(_port(f), device=CPU, fuse_transform=fuse)
        assert eng.fused == fuse
        return (eng, JaxRankFoldEngine(f, interpret=True, **jkw), f,
                _rows(f.num_cols))
    return make


def _bucketed_fold():
    f = _mixed_depth()
    return (DepthBucketedFoldEngine(_port(f), device=CPU),
            jax_bucketed.DepthBucketedFoldEngine(f, row_tile=8, tree_tile=16,
                                                 interpret=True),
            f, _rows(f.num_cols))


def _bucketed_rank():
    f = _mixed_depth(seed=13, missing=-999.0)
    return (DepthBucketedRankEngine(_port(f), device=CPU),
            jax_bucketed.DepthBucketedRankEngine(f, row_tile=32, tree_tile=8,
                                                 interpret=True),
            f, _rows(f.num_cols, missing=-999.0))


def _sparse_rank():
    f = train_forest(12, 9, 12, rows=512, seed=3)
    return (SparseRankEngine(_port(f), device=CPU),
            JaxSparseRankEngine(f, interpret=True, row_tile=8), f, _rows(12))


def _sparse_gather():
    f = synthetic.generate_forest(12, 5, 600, leaf_prob=0.1, seed=23)
    return (sparse.SparseGatherEngine(sparse.from_dense(_port(f)), device=CPU),
            JaxSparseGatherEngine(jax_sparse.from_dense(f)), f, _rows(600, n=24))


def _gather():
    f = compiler.compile_forest(synthetic.generate_forest(
        17, 4, 9, leaf_prob=0.2, seed=21))[0]
    return GatherEngine(_port(f), device=CPU), JaxGatherEngine(f), f, _rows(9)


def _tensor(mode):
    def make():
        f = synthetic.generate_forest(9, 3, 6, seed=12)
        lev = compiler.levelize(compiler.hot_child_swap(f))
        port_lev = port_compiler.levelize(
            port_compiler.hot_child_swap(_port(f)))
        return (TensorEngine(port_lev, select_mode=mode, device=CPU),
                JaxTensorEngine(lev, select_mode=mode, row_tile=16), f, _rows(6))
    return make


ENGINES = {
    "fold": _fold,
    "rank": _rank(),
    "rank_fused": _rank(fuse=True),
    "bucketed_fold": _bucketed_fold,
    "bucketed_rank": _bucketed_rank,
    "sparse_rank": _sparse_rank,
    "sparse_gather": _sparse_gather,
    "gather": _gather,
    "tensor_take": _tensor("take"),
    "tensor_onehot": _tensor("onehot"),
}


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_predict_k_matches_jax(name, k):
    """predict_k against the JAX engine's within JAX_ATOL (1e-5), bit for
    bit the port's predict, and the oracle within ORACLE_ATOL."""
    eng, jeng, forest, data = ENGINES[name]()
    got = eng.predict_k(data, k)
    assert got.dtype == torch.float32 and got.shape == (data.shape[0],)
    assert torch.equal(got, eng.predict(data))
    np.testing.assert_allclose(got.numpy(), np.asarray(jeng.predict_k(data, k)),
                               atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle.predict(forest, data),
                               atol=ORACLE_ATOL, rtol=0)


@pytest.mark.parametrize("k", [1, 3])
def test_predict_planes_k_matches_jax(k):
    """predict_planes_k against the JAX engine's _chain_planes_impl on the
    planes kernel A writes (exact on both sides, tests/test_torch_rank_kernel
    .py): within JAX_ATOL (1e-5), and bit for bit predict_planes."""
    eng, jeng, forest, data = _rank()()
    planes = eng.transform(data)
    got = eng.predict_planes_k(planes, k)
    assert torch.equal(got, eng.predict_planes(planes))
    want = np.asarray(jeng._predict_planes_k(jeng.tables, planes.numpy(), k=k))
    np.testing.assert_allclose(got.numpy(), want[:data.shape[0]], atol=JAX_ATOL,
                               rtol=0)


@pytest.mark.parametrize("k", [0, -2])
def test_a_chain_takes_at_least_one_call(k):
    eng = _gather()[0]
    with pytest.raises(ValueError, match="k >= 1"):
        eng.predict_k(_rows(9), k)


def test_a_chain_on_the_cpu_runs_k_calls_and_returns_the_last():
    seen = []

    def stage(x, out=None):
        assert out is None
        return x

    def fn(x):
        seen.append(x)
        return torch.full((2,), float(len(seen)))

    g = graphed.graphed(fn, "cpu", stage)
    rows = torch.zeros(2, 3)
    assert torch.equal(g.chain(rows, 4), torch.full((2,), 4.0))
    assert len(seen) == 4 and all(x is rows for x in seen)
    assert g.chains == {} and g.graphs == {}


@pytest.mark.parametrize("k,m", [(1, 1), (5, 1), (1, 8), (8, 8), (9, 8),
                                 (17, 8), (1000, 37)])
def test_a_chain_replays_graphs_of_m_steps_then_the_rest(k, m):
    runs = graphed.chain_runs(k, m)
    assert sum(runs) == k
    assert runs[:-1] == [m] * (len(runs) - 1) and 1 <= runs[-1] <= m
    assert len(runs) == -(-k // m)


def test_the_chain_key_includes_m():
    """A chain's graph is keyed by (rows, columns, m): the graphs of one
    shape and of different step counts are kept apart."""
    key = (2000, 18)
    assert graphed.chain_key(key, 8) == (2000, 18, 8)
    assert graphed.chain_key(key, 8) != graphed.chain_key(key, 9)
    assert {graphed.chain_key(key, n) for n in graphed.chain_runs(19, 8)} == {
        (2000, 18, 8), (2000, 18, 3)}


@pytest.mark.parametrize("replay_s,capture_s,m", [
    (1e-5, 1e-3, 100),      # a host-bound step: many steps a replay
    (4e-4, 1e-3, 3),        # a device-bound step of 0.4 ms
    (3e-3, 1e-3, 1),        # a call of milliseconds: one step
    (1e-5, 0.2, 2),         # a slow capture bounds the steps
    (1e-5, 1.92, 1),        # TensorEngine at 65,536 rows (PERF.md section 5)
    (1e-9, 1e-9, graphed.CHAIN_MAX_STEPS),
])
def test_the_steps_a_replay(replay_s, capture_s, m):
    assert graphed.chain_steps(replay_s, capture_s) == m


def _stand_ins(n):
    return [_build.CudaKernel(f"stand_in_{i}", [], source="none",
                              replaces="none") for i in range(n)]


@pytest.mark.parametrize("k,m", [(1, 1), (3, 2), (11, 4), (64, 64)])
def test_a_chain_counts_k_calls_launches(monkeypatch, k, m):
    """What a chain's captures and replays do to the counts: each graph of
    n steps takes back n calls' launches at its capture, each replay adds
    them; the chain counts k times one call's."""
    kernels = _stand_ins(2)
    monkeypatch.setattr(_build, "KERNELS", kernels)

    def call():  # one call: kernel 0 twice, kernel 1 once
        kernels[0].launches += 2
        kernels[1].launches += 1

    graphs = {}
    for n in set(graphed.chain_runs(k, m)):
        before = graphed.launch_counts()
        for _ in range(n):
            call()
        graphs[n] = graphed.take_launches(before)
    assert [kn.launches for kn in kernels] == [0, 0]
    for n in graphed.chain_runs(k, m):
        graphed.add_launches(graphs[n])
    assert [kn.launches for kn in kernels] == [2 * k, k]


def test_a_cpu_chain_counts_k_calls_launches(monkeypatch):
    kernels = _stand_ins(1)
    monkeypatch.setattr(_build, "KERNELS", kernels)

    def fn(x):
        kernels[0].launches += 1
        return x.sum(1)

    g = graphed.graphed(fn, "cpu", lambda x, out=None: x)
    g.chain(torch.ones(4, 2), 7)
    assert kernels[0].launches == 7


class _Clock:
    """A clock that ``run_k`` moves: a chain of k steps takes ``fixed`` +
    ``step`` x k seconds, plus the next of ``noise``."""

    def __init__(self, fixed, step, noise=(0.0,)):
        self.now, self.fixed, self.step = 0.0, fixed, step
        self.noise, self.runs = list(noise), []

    def __call__(self):
        return self.now

    def run_k(self, k):
        self.runs.append(k)
        self.now += self.fixed + self.step * k + self.noise[len(self.runs) % len(self.noise)]


def test_the_slope_cancels_what_every_chain_pays():
    clock = _Clock(fixed=40e-6, step=1e-3)
    s = profiling.slope_time(clock.run_k, 3, 27, device="cpu", clock=clock,
                             min_delta_s=1e-3)
    assert s == pytest.approx(1e-3, rel=1e-9)
    # one untimed run of each length, then three timed
    assert clock.runs == [3] * 4 + [27] * 4


def test_the_noise_guard_stretches_k2():
    """A delta below the least delta grows k2, as the JAX guard does,
    until the delta passes it; the slope is then read over the long chain."""
    clock = _Clock(fixed=30e-6, step=2e-6)
    s = profiling.slope_time(clock.run_k, 2, 6, device="cpu", clock=clock,
                             min_delta_s=5e-3)
    lengths = sorted(set(clock.runs))
    assert lengths[0] == 2 and lengths[-1] > 6 and len(lengths) >= 3
    assert (lengths[-1] - 2) * 2e-6 >= 5e-3
    assert s == pytest.approx(2e-6, rel=1e-6)


def test_the_noise_guard_stops_at_its_tries_and_its_longest_chain():
    clock = _Clock(fixed=0.0, step=1e-9)
    profiling.slope_time(clock.run_k, 1, 2, device="cpu", clock=clock,
                         min_delta_s=1.0)
    assert len(set(clock.runs)) == 2 + profiling.SLOPE_TRIES
    slow = _Clock(fixed=0.0, step=0.5)
    profiling.slope_time(slow.run_k, 1, 2, device="cpu", clock=slow,
                         min_delta_s=10.0)
    # a chain of 2 x 0.5 s: growing it past SLOPE_MAX_CHAIN_S is refused
    assert set(slow.runs) == {1, 2}


def test_the_slope_is_read_through_noise():
    """Chains whose times spread by +-20 us: a delta of 100 spreads reads
    the step within 1%."""
    clock = _Clock(fixed=50e-6, step=10e-6, noise=(20e-6, -20e-6, 0.0, 15e-6))
    s = profiling.slope_time(clock.run_k, 5, 25, device="cpu", clock=clock,
                             min_delta_s=100 * 20e-6)
    assert s == pytest.approx(10e-6, rel=0.01)


@pytest.mark.parametrize("k1,k2", [(0, 3), (3, 3), (4, 2)])
def test_the_slope_needs_two_lengths(k1, k2):
    with pytest.raises(ValueError):
        profiling.slope_time(lambda k: None, k1, k2)


def test_us_per_sample_times_predict_k():
    eng = _gather()[0]
    data = _rows(9, n=32)
    calls = []
    real = eng.predict_k

    def predict_k(rows, k):
        calls.append(k)
        return real(rows, k)

    eng.predict_k = predict_k
    us = profiling.us_per_sample(eng, data, 1, 3, min_delta_s=0.0)
    assert us > 0 and set(calls) == {1, 3}
