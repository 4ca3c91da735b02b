"""ops/graphed.py, the port's counterpart of ``jax.jit`` over an engine's
``_predict_impl``: one CUDA graph a shape on the card, the function as it
is on the CPU.

On the CPU: every strategy's engine builds its predict (and margins, and
RankFoldEngine's predict_planes) through ``graphed``, its result equals
``_predict_impl``'s bit for bit and the JAX package's ``Forest.predict``
(Pallas in interpret mode) within ORACLE_ATOL; the launch-count
bookkeeping that replays rely on, on stand-in kernels. The ``cuda`` tests
skip here and run on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_graphed.py
"""
import gc

import numpy as np
import pytest
import torch

from tahoe_tpu_torch import ORACLE_ATOL, Forest, Strategy
from tahoe_tpu_torch.forest import synthetic
from tahoe_tpu_torch.forest.spec import to_arrays
from tahoe_tpu_torch.ops import _build, graphed
from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine

# each strategy's graphed methods
METHODS = {s: ("predict", "margins") for s in Strategy}
METHODS[Strategy.RANK_MXU] = ("predict", "margins", "predict_planes")


def _forest(seed=1):
    """A small mixed-depth forest every strategy takes (DEPTH_BUCKETED
    needs depths that differ), with a finite sentinel."""
    return synthetic.generate_mixed_depth_forest(12, 6, 9, missing=-999.0,
                                                 seed=seed)


def _rows(n, seed=2):
    return synthetic.generate_data(n, 9, missing=-999.0, missing_prob=0.1,
                                   seed=seed)


def _input(eng, method, rows):
    """What ``method`` takes: raw rows, or RankFoldEngine's planes."""
    return eng.transform(rows) if method == "predict_planes" else rows


@pytest.mark.parametrize("rows", [np.zeros((3, 2), np.float32), [[1.0, 2.0]],
                                  "not rows"])
def test_graphed_on_cpu_calls_its_function_as_it_is(rows):
    seen = []

    def stage(x, out=None):
        assert out is None
        seen.append(("stage", x))
        return x

    def fn(x):
        seen.append(("fn", x))
        return x

    g = graphed.graphed(fn, "cpu", stage)
    assert g.fn is fn and g.stage is stage
    assert g(rows) is rows and seen == [("stage", rows), ("fn", rows)]
    assert g.graphs == {}


@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.name)
def test_every_engine_builds_its_calls_through_graphed(strategy):
    eng = Forest(_forest(), device="cpu").engine(strategy)
    data = _rows(8)
    for method in METHODS[strategy]:
        g = getattr(eng, f"_{method}")
        assert isinstance(g, graphed.graphed), method
        assert g.device.type == "cpu"
        # the graph's function on the staged rows is the eager call
        x = _input(eng, method, data)
        assert torch.equal(g.fn(g.stage(x)), getattr(eng, f"_{method}_impl")(x)), method
        assert g.name.startswith(type(eng).__name__ + "."), g.name


@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.name)
def test_staging_into_a_buffer_equals_staging(strategy):
    """What a replay does to its rows: the engine's staging step written
    into the static input gives the rows a fresh staging gives."""
    eng = Forest(_forest(), device="cpu").engine(strategy)
    for method in METHODS[strategy]:
        g = getattr(eng, f"_{method}")
        x = _input(eng, method, _rows(16, seed=3))
        fresh = g.stage(x)
        buf = torch.full_like(fresh, 7)
        assert g.stage(x, buf) is buf and torch.equal(buf, fresh), method
        assert torch.equal(g.fn(buf), getattr(eng, f"_{method}_impl")(x)), method


@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.name)
def test_predict_is_predict_impl_and_the_jax_forest(strategy):
    from tahoe_tpu.engine.forest import Forest as JaxForest
    from tahoe_tpu.config import Strategy as JaxStrategy
    from tahoe_tpu.forest.spec import ForestSpec as JaxForestSpec

    spec = _forest()
    data = _rows(96)
    f = Forest(spec, device="cpu")
    eng = f.engine(strategy)
    for method in METHODS[strategy]:
        x = _input(eng, method, data)
        got = getattr(eng, method)(x)
        assert torch.equal(got, getattr(eng, f"_{method}_impl")(x)), method
    want = np.asarray(JaxForest(JaxForestSpec(**to_arrays(spec)))
                      .predict(data, JaxStrategy[strategy.name]))
    np.testing.assert_allclose(f.predict(data, strategy).numpy(), want,
                               atol=ORACLE_ATOL, rtol=0)
    np.testing.assert_allclose(f.predict(data, strategy).numpy(),
                               f.predict_oracle(data), atol=ORACLE_ATOL, rtol=0)


# the strategies whose engine is FoldKernelEngine, which reads raw rows in
# place on the card on either of its kernels
IN_PLACE = {Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST}


@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.name)
def test_only_kernel_c_takes_the_in_place_route(strategy):
    """FoldKernelEngine offers the in-place route (on _forest() kernel C;
    the deep kernel's, test_the_deep_kernel_route_stages); every other
    engine, DEPTH_BUCKETED's fold buckets included, stages. A graph's
    function on the staged rows is the eager call either way."""
    eng = Forest(_forest(), device="cpu").engine(strategy)
    for method in ("predict", "margins"):
        g = getattr(eng, f"_{method}")
        assert (g.in_place is not None) == (strategy in IN_PLACE), method
        if g.in_place is not None:
            assert g.in_place.__func__ is getattr(type(eng), f"_{method}_in_place")


def test_the_deep_kernel_route_stages():
    """Past depth 14 SPLIT_FOREST runs the deep kernel, which no longer
    takes its rows staged: like kernel C's, its engine offers the in-place
    route, its own ``_predict_in_place`` and ``_margins_in_place``."""
    from tahoe_tpu_torch.ops.fold_kernel import DeepLaunch

    spec = synthetic.generate_forest(2, 15, 9, seed=4)
    eng = Forest(spec, device="cpu").engine(Strategy.SPLIT_FOREST)
    assert isinstance(eng.launch, DeepLaunch) and eng.heap is not None
    for method in ("predict", "margins"):
        g = getattr(eng, f"_{method}")
        assert g.in_place is not None, method
        assert g.in_place.__func__ is getattr(type(eng), f"_{method}_in_place")


def test_row_stride_reads_only_f32_rows_with_adjacent_columns():
    cpu = torch.device("cpu")
    table = torch.zeros(10, 12)
    assert graphed.row_stride(table, cpu) == 12
    assert graphed.row_stride(table[2:7], cpu) == 12
    assert graphed.row_stride(table[:, 3:9], cpu) == 12  # a row stride past C
    assert graphed.row_stride(table[4:5, 3:9], cpu) == 6  # one row: C
    assert graphed.row_stride(table[:, :1], cpu) == 12  # one column
    assert graphed.row_stride(table.t(), cpu) is None  # strided columns
    assert graphed.row_stride(table[:, ::2], cpu) is None
    assert graphed.row_stride(table.double(), cpu) is None
    assert graphed.row_stride(table.numpy(), cpu) is None
    assert graphed.row_stride(table[0], cpu) is None
    assert graphed.row_stride(table, torch.device("cuda", 0)) is None


def _stand_ins(n):
    return [_build.CudaKernel(f"stand_in_{i}", [], source="none",
                              replaces="none") for i in range(n)]


def test_a_capture_takes_its_launches_and_a_replay_adds_them(monkeypatch):
    kernels = _stand_ins(3)
    monkeypatch.setattr(_build, "KERNELS", kernels)
    kernels[0].launches, kernels[1].launches = 5, 2
    before = graphed.launch_counts()
    assert before == {kernels[0]: 5, kernels[1]: 2, kernels[2]: 0}
    # what a capture records: two launches of one kernel, one of another
    kernels[0].launches += 2
    kernels[2].launches += 1
    delta = graphed.take_launches(before)
    assert sorted((k.symbol, n) for k, n in delta) == [("stand_in_0", 2),
                                                        ("stand_in_2", 1)]
    assert [k.launches for k in kernels] == [5, 2, 0]  # the capture ran nothing
    for replays in (1, 2, 3):
        graphed.add_launches(delta)
        assert [k.launches for k in kernels] == [5 + 2 * replays, 2, replays]


def test_a_kernel_made_during_a_capture_is_taken_too(monkeypatch):
    monkeypatch.setattr(_build, "KERNELS", _stand_ins(1))
    before = graphed.launch_counts()
    late = _stand_ins(1)[0]
    _build.KERNELS.append(late)
    late.launches = 4
    assert graphed.take_launches(before) == [(late, 4)]
    assert late.launches == 0


def test_every_kernel_is_registered():
    from tahoe_tpu_torch.ops import fold_kernel, probes, rank_kernel, rank_transform, sparse_kernel  # noqa: F401

    made = {k.symbol for k in _build.KERNELS}
    assert {"tahoe_fold", "tahoe_fold_sign", "tahoe_fold_nonge",
            "tahoe_fold_deep", "tahoe_fold_deep_sign", "tahoe_fold_deep_nonge",
            "tahoe_rank_planes", "tahoe_rank_fold", "tahoe_rank_fused",
            "tahoe_sparse_rank", "tahoe_probe_int8", "tahoe_probe_overhead",
            "tahoe_probe_rank_parts"} <= made


def test_drop_engines_releases_every_graph():
    f = Forest(_forest(), device="cpu")
    engines = [f.engine(s) for s in Strategy]
    held = []
    for eng in engines:
        for value in vars(eng).values():
            if isinstance(value, graphed.graphed):
                value.graphs[(1, 9)] = object()  # a capture's stand-in
                held.append(value)
    assert len(held) >= 2 * len(engines)
    f.drop_engines()
    assert all(g.graphs == {} for g in held)


def test_a_graph_does_not_keep_its_engine_alive():
    eng = RankFoldEngine(_forest(), device="cpu")
    g = eng._predict
    del eng
    gc.collect()
    with pytest.raises(RuntimeError, match="RankFoldEngine._predict_staged"):
        g(_rows(4))


def test_sharded_margins_go_through_the_engine_graph():
    """A sharded engine's shard margins are its engine's graphed margins;
    release reaches the engine it wraps."""
    from tahoe_tpu_torch.parallel.sharded import _Sharded

    inner = RankFoldEngine(_forest(), device="cpu")
    outer = _Sharded()
    outer.engine = inner
    data = _rows(16)
    assert torch.equal(outer.shard_margins(data), inner._margins_impl(data))
    inner._margins.graphs[(16, 9)] = object()
    graphed.release(outer)
    assert inner._margins.graphs == {}


# -- on the card ----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _card_forest():
    return synthetic.generate_mixed_depth_forest(60, 8, 18, missing=-999.0,
                                                 seed=3)


def _card_rows(n, seed):
    return synthetic.generate_data(n, 18, missing=-999.0, missing_prob=0.05,
                                   seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.name)
def test_graphed_equals_eager_and_captures_once_a_shape(dev, strategy):
    """A staging engine captures once a shape; on the in-place route
    (kernel C) a call captures nothing."""
    f = Forest(_card_forest(), device=dev)
    eng = f.engine(strategy)
    want = f.predict_oracle(_card_rows(1000, 5))
    for method in METHODS[strategy]:
        g = getattr(eng, f"_{method}")
        impl = getattr(eng, f"_{method}_impl")
        first = {}
        for n, seed in ((1000, 5), (1000, 6), (333, 7), (1000, 5), (333, 8)):
            x = _input(eng, method, torch.as_tensor(_card_rows(n, seed), device=dev))
            assert torch.equal(getattr(eng, method)(x), impl(x)), (method, n, seed)
            key = tuple(x.shape)
            if g.in_place is None:
                assert g.graphs[key] is first.setdefault(key, g.graphs[key])
        assert len(g.graphs) == (2 if g.in_place is None else 0), method
    np.testing.assert_allclose(eng.predict(_card_rows(1000, 5)).cpu().numpy(),
                               want, atol=ORACLE_ATOL, rtol=0)


@pytest.mark.cuda
def test_results_do_not_alias(dev):
    eng = Forest(_card_forest(), device=dev).engine(Strategy.SPLIT_FOREST)
    a_rows, b_rows = (torch.as_tensor(_card_rows(512, s), device=dev)
                      for s in (8, 9))
    a = eng.predict(a_rows)
    a2 = eng.predict(a_rows)
    keep = a2.clone()
    b = eng.predict(b_rows)
    assert a.data_ptr() != a2.data_ptr() != b.data_ptr()
    assert torch.equal(a2, keep) and not torch.equal(a2, b)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.name)
def test_a_replay_counts_the_eager_launches(dev, strategy):
    eng = Forest(_card_forest(), device=dev).engine(strategy)
    x = torch.as_tensor(_card_rows(777, 10), device=dev)
    eager = graphed.launch_counts()
    eng._predict_impl(x)
    eager = {k: k.launches - n for k, n in eager.items()}
    for _ in range(3):  # the capture's call, then replays
        before = graphed.launch_counts()
        eng.predict(x)
        assert {k: k.launches - n for k, n in before.items()} == eager


@pytest.mark.cuda
def test_a_graphed_predict_inside_cuda_device_ms(dev):
    from tahoe_tpu_torch.utils.profiling import cuda_device_ms

    eng = Forest(_card_forest(), device=dev).engine(Strategy.RANK_MXU)
    x = torch.as_tensor(_card_rows(2048, 11), device=dev)
    ms = cuda_device_ms(lambda: eng.predict(x))
    assert ms > 0 and list(eng._predict.graphs) == [(2048, 18)]


@pytest.mark.cuda
def test_drop_engines_frees_the_graphs(dev):
    f = Forest(_card_forest(), device=dev)
    x = torch.as_tensor(_card_rows(4096, 12), device=dev)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    eng = f.engine(Strategy.HBM_DIRECT)
    eng.predict(x)
    eng.predict(x)
    g = eng._predict
    assert g.graphs
    del eng
    f.drop_engines()
    assert g.graphs == {}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) <= base


@pytest.mark.cuda
def test_the_shapes_of_one_callable_share_one_pool(dev):
    """Three shapes, each with a 64 MiB intermediate, reserve about what
    one does: the graphs of one callable share their memory pool."""
    def fn(x):
        big = x.new_ones(16 << 20) * 2.0
        return x.sum(1) + big[:1]

    def stage(x, out=None):
        return x if out is None else out.copy_(x)

    def grown(shapes):
        g = graphed.graphed(fn, dev, stage)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved(dev)
        for n in shapes:
            g(torch.ones(n, 3, device=dev))
        gc.collect()
        torch.cuda.empty_cache()
        grew = torch.cuda.memory_reserved(dev) - base
        assert len(g.graphs) == len(shapes)
        g.release()
        return grew

    one = grown([8])
    assert one >= 64 << 20
    assert grown([8, 9, 10]) < 1.5 * one


@pytest.mark.cuda
def test_a_failed_capture_raises_and_names_the_key(dev):
    def syncs(x):
        return x * float(x.sum())  # a host synchronisation: not capturable

    g = graphed.graphed(syncs, dev, lambda x, out=None: x if out is None else out.copy_(x))
    with pytest.raises(RuntimeError, match=r"syncs.*\(8, 3\)"):
        g(torch.ones(8, 3, device=dev))
    assert g.graphs == {}


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.name)
def test_a_chain_is_k_predicts(dev, strategy):
    """predict_k for k in {1, 2, m + 1} bit-equal to predict, counting k
    times one call's launches; its graphs keyed by (rows, columns, steps)."""
    eng = Forest(_card_forest(), device=dev).engine(strategy)
    x = torch.as_tensor(_card_rows(1500, 13), device=dev)
    want = eng.predict(x)
    before = graphed.launch_counts()
    eng.predict(x)
    one = {k: k.launches - n for k, n in before.items()}
    g = eng._predict
    assert torch.equal(eng.predict_k(x, 1), want)
    m = g._chain_shapes[(1500, 18)].steps
    for k in (1, 2, m + 1):
        before = graphed.launch_counts()
        assert torch.equal(eng.predict_k(x, k), want), k
        assert {kn: kn.launches - n for kn, n in before.items()} == {
            kn: k * n for kn, n in one.items()}, k
    assert set(g.chains) <= {(1500, 18, n) for n in (1, 2, m)}
    assert (1500, 18, m) in g.chains
    assert list(g.graphs) == ([(1500, 18)] if g.in_place is None else [])


@pytest.mark.cuda
def test_a_chain_holds_about_one_steps_memory(dev):
    """A chain of many steps, each with 64 MiB intermediates, reserves
    about what a chain of one step does: the steps share the callable's
    pool, each reusing the last one's intermediates."""
    def fn(x):
        big = x.new_ones(16 << 20) * 2.0
        return x.sum(1) + big[:1]

    def stage(x, out=None):
        return x if out is None else out.copy_(x)

    def grown(k):
        g = graphed.graphed(fn, dev, stage)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved(dev)
        out = g.chain(torch.ones(8, 3, device=dev), k)
        assert torch.equal(out, torch.full((8,), 5.0, device=dev))
        gc.collect()
        torch.cuda.empty_cache()
        grew = torch.cuda.memory_reserved(dev) - base
        steps = g._chain_shapes[(8, 3)].steps
        g.release()
        return grew, steps

    one, _ = grown(1)
    many, steps = grown(50)
    assert steps > 2 and one >= 64 << 20
    assert many < 1.5 * one, (many, one, steps)


@pytest.mark.cuda
def test_a_failed_chain_capture_raises_and_names_the_key(dev):
    def syncs(x):
        return x * float(x.sum())  # a host synchronisation: not capturable

    g = graphed.graphed(syncs, dev, lambda x, out=None: x if out is None else out.copy_(x))
    with pytest.raises(RuntimeError, match=r"syncs.*chain.*\(8, 3\), m 1"):
        g.chain(torch.ones(8, 3, device=dev), 4)
    assert g.chains == {}


@pytest.mark.cuda
def test_queued_in_place_predicts_read_their_own_rows(dev):
    """Twenty predicts on twenty slices of one device table, queued back to
    back behind 20 ms of work with no synchronize: each launch reads the
    rows of its own call, with no graph and nothing staged; each call is
    served (a replay's count) by a direct launch."""
    eng = Forest(_card_forest(), device=dev).engine(Strategy.SPLIT_FOREST)
    assert eng._predict.in_place is not None
    table = torch.as_tensor(_card_rows(20 * 512, 14), device=dev)
    slices = [table[i * 512:(i + 1) * 512] for i in range(20)]
    eng.predict(slices[0])
    torch.cuda.synchronize()
    before = graphed.counters()
    torch.cuda._sleep(int(4e7))
    got = [eng.predict(x) for x in slices]
    torch.cuda.synchronize()
    after = graphed.counters()
    for i, (x, pred) in enumerate(zip(slices, got)):
        assert torch.equal(pred, eng._predict_impl(x)), i
    assert after["direct_calls"] - before["direct_calls"] == 20
    assert after["replays"] - before["replays"] == 20
    assert after["captures"] == before["captures"]
    assert after["staged_bytes"] == before["staged_bytes"]
    assert eng._predict.graphs == {}


@pytest.mark.cuda
def test_the_in_place_route_takes_any_rows(dev):
    """Rows it cannot read in place (numpy, strided columns, f64) are made
    a contiguous f32 tensor on the card first; rows at a row stride past
    their columns are read in place; predict_k reads its own copy. Every
    result equals the eager call's, and no call captures a graph."""
    eng = Forest(_card_forest(), device=dev).engine(Strategy.SPLIT_FOREST)
    data = _card_rows(700, 15)
    x = torch.as_tensor(data, device=dev)
    want = eng._predict_impl(x)
    wide = torch.zeros(700, 25, device=dev)
    wide[:, 3:21] = x
    before = graphed.counters()
    for rows in (data, data, x.t().contiguous().t(), x.double(),
                 wide[:, 3:21], wide[:, 3:21]):
        assert torch.equal(eng.predict(rows), want)
    after = graphed.counters()
    g = eng._predict
    assert g.graphs == {}
    assert after["replays"] - before["replays"] == 6
    assert after["staged_bytes"] - before["staged_bytes"] == 4 * 700 * 18 * 4
    assert after["direct_calls"] - before["direct_calls"] == 2
    for k in (1, 3):
        assert torch.equal(eng.predict_k(x, k), want), k
        assert torch.equal(eng.predict_k(data, k), want), k
    assert g._chain_shapes[(700, 18)].staged is None
    # a call after a chain reads its own rows, not the chain's copy
    assert torch.equal(eng.predict(wide[:, 3:21]), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["depth_bucketed"])
def test_staged_routes_make_no_direct_call(dev, case):
    """DEPTH_BUCKETED keeps the staged route: every replay stages its rows,
    none is read in place."""
    eng = Forest(_card_forest(), device=dev).engine(Strategy.DEPTH_BUCKETED)
    assert eng._predict.in_place is None
    x = torch.as_tensor(_card_rows(640, 16), device=dev)
    want = eng._predict_impl(x)
    before = graphed.counters()
    for _ in range(3):
        assert torch.equal(eng.predict(x), want)
    after = graphed.counters()
    assert after["direct_calls"] == before["direct_calls"]
    assert (after["staged_bytes"] - before["staged_bytes"]
            == 2 * eng._predict.graphs[(640, 18)].static_in.nbytes)


@pytest.mark.cuda
def test_the_deep_kernel_route_reads_in_place(dev):
    """The deep kernel's SPLIT_FOREST (depth 16, a finite sentinel) takes
    the in-place route: three predicts are three direct calls, each served
    as a replay, with no graph captured and nothing staged, and each equals
    the staged eager call bit for bit."""
    from tahoe_tpu_torch.ops.fold_kernel import DeepLaunch

    spec = synthetic.generate_forest(4, 16, 18, missing=-999.0, seed=6)
    eng = Forest(spec, device=dev).engine(Strategy.SPLIT_FOREST)
    assert isinstance(eng.launch, DeepLaunch)
    assert eng._predict.in_place is not None
    x = torch.as_tensor(_card_rows(640, 16), device=dev)
    want = eng._predict_impl(x)
    before = graphed.counters()
    for _ in range(3):
        assert torch.equal(eng.predict(x), want)
    after = graphed.counters()
    assert after["direct_calls"] - before["direct_calls"] == 3
    assert after["replays"] - before["replays"] == 3
    assert after["captures"] == before["captures"]
    assert after["staged_bytes"] == before["staged_bytes"]
    assert eng._predict.graphs == {}
