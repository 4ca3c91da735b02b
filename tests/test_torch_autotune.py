"""The port's strategy enumeration and parity gate on the CPU, held to the
JAX package's (tahoe_tpu/engine/autotune.py, tahoe_tpu/utils/debug.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from tahoe_tpu.engine import autotune as jax_autotune
from tahoe_tpu.forest import synthetic
from tahoe_tpu.utils import debug as jax_debug
from tahoe_tpu_torch import Strategy
from tahoe_tpu_torch.engine import autotune
from tahoe_tpu_torch.forest import synthetic as port_synthetic
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.utils import debug

# tests/test_engine_facade.py's forest and rows
FACADE_FOREST = dict(num_trees=20, depth=4, num_cols=10, leaf_prob=0.15, seed=91)


@pytest.fixture(scope="module")
def facade():
    spec = synthetic.generate_forest(**FACADE_FOREST)
    data = synthetic.generate_data(40, 10, missing_prob=0.1, seed=92)
    return spec, data


def test_enumeration_matches_jax(facade):
    """Every strategy, in-process on both sides: the same strategies run,
    and every verdict is correct."""
    spec, data = facade
    want = jax_autotune.enumerate_strategies(
        spec, data, subprocess_isolation=False, warmup=1, epochs=2,
        verbose=False)
    got = autotune.enumerate_strategies(
        from_arrays(dataclasses.asdict(spec)), data, device="cpu", warmup=1,
        epochs=2, verbose=False)
    assert [s.name for s in got] == [s.name for s in want]
    ran = {s.name for s, r in got.items() if r.ran}
    assert ran == {s.name for s, r in want.items() if r.ran}
    assert ran, "no strategy ran"
    for s, r in got.items():
        if r.ran:
            assert r.correct and r.max_err <= 1e-3, s
            assert r.us_band[0] <= r.us_per_sample <= r.us_band[1]
            assert r.build_s is not None and r.build_s >= 0
            assert r.variant is None
        else:
            assert r.skipped_reason and r.error is None, (s, r.error)
    assert autotune.best_strategy(got) in {s for s in got if got[s].ran}


def test_the_enumeration_times_by_the_slope(monkeypatch, facade):
    """Each strategy's us/sample is the median of ROUNDS chained slopes over
    its engine's predict_k (utils/profiling.slope_time), its band their
    [min, max]; one round of event pairs is kept beside it."""
    spec, data = facade
    slopes = iter([3e-6, 1e-6, 2e-6, 9e-6, 7e-6, 8e-6])
    seen = []

    def slope_time(run_k, k1, k2, **kw):
        assert 1 <= k1 < k2 and kw["device"].type == "cpu"
        seen.append(run_k(k1).shape)
        return next(slopes)

    monkeypatch.setattr(autotune, "slope_time", slope_time)
    res = autotune.enumerate_strategies(
        from_arrays(dataclasses.asdict(spec)), data, device="cpu",
        strategies=(Strategy.SPLIT_FOREST, Strategy.HBM_DIRECT), warmup=2,
        epochs=3, verbose=False)
    n = data.shape[0]
    assert len(seen) == 2 * autotune.ROUNDS and set(seen) == {(n,)}
    # the rounds take the engines in turn
    split, gather = res[Strategy.SPLIT_FOREST], res[Strategy.HBM_DIRECT]
    assert split.us_per_sample == pytest.approx(3e-6 * 1e6 / n)
    assert split.us_band == pytest.approx([2e-6 * 1e6 / n, 7e-6 * 1e6 / n])
    assert gather.us_per_sample == pytest.approx(8e-6 * 1e6 / n)
    assert gather.us_band == pytest.approx([1e-6 * 1e6 / n, 9e-6 * 1e6 / n])
    for r in (split, gather):
        assert r.correct and r.event_us_per_sample > 0


def _result(s, us, correct=True, **kw):
    return autotune.StrategyResult(strategy=s, us_per_sample=us, correct=correct,
                                   **kw)


def test_best_strategy_hand_built():
    res = {
        Strategy.HBM_DIRECT: _result(Strategy.HBM_DIRECT, 0.3),
        Strategy.SPLIT_FOREST: _result(Strategy.SPLIT_FOREST, 0.004),
        # fastest, but wrong: never the best
        Strategy.RANK_MXU: _result(Strategy.RANK_MXU, 0.001, correct=False),
        Strategy.SPARSE: _result(Strategy.SPARSE, 0.0001, error="boom"),
        Strategy.TENSOR: _result(Strategy.TENSOR, 0.0, skipped_reason="too deep"),
    }
    assert autotune.best_strategy(res) == Strategy.SPLIT_FOREST
    del res[Strategy.SPLIT_FOREST], res[Strategy.HBM_DIRECT]
    assert autotune.best_strategy(res) is None
    assert autotune.best_strategy({}) is None


def test_variant_candidates():
    fusable = port_synthetic.generate_forest(60, 6, 12, seed=91)
    small = port_synthetic.generate_forest(20, 4, 10, leaf_prob=0.15, seed=91)
    wide = port_synthetic.generate_forest(10, 4, 600, seed=3)
    assert autotune.variant_candidates(Strategy.RANK_MXU, fusable) == [None, "fused"]
    # at most 256 thresholds in the widest feature: the fused gate refuses
    assert autotune.variant_candidates(Strategy.RANK_MXU, small) == [None]
    # past the rank planes: no variant, and RANK_MXU itself is skipped
    assert autotune.variant_candidates(Strategy.RANK_MXU, wide) == [None]
    for s in Strategy:
        if s != Strategy.RANK_MXU:
            assert autotune.variant_candidates(s, fusable) == [None]


def test_tuned_enumeration_keeps_a_correct_variant():
    spec = port_synthetic.generate_forest(60, 6, 12, seed=91)
    data = port_synthetic.generate_data(24, 12, missing_prob=0.1, seed=92)
    res = autotune.enumerate_strategies(
        spec, data, device="cpu", strategies=(Strategy.RANK_MXU,), warmup=0,
        epochs=1, verbose=False, tune_tiles=True)
    r = res[Strategy.RANK_MXU]
    assert r.ran and r.correct
    assert r.variant in autotune.variant_candidates(Strategy.RANK_MXU, spec)


def test_engine_error_is_reported_not_replaced(monkeypatch, facade):
    """An engine that fails has its strategy's error set; no other engine
    takes its place and the enumeration goes on."""
    from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine

    def broken(self, rows):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(FoldKernelEngine, "predict", broken)
    spec, data = facade
    res = autotune.enumerate_strategies(
        from_arrays(dataclasses.asdict(spec)), data, device="cpu",
        strategies=(Strategy.SPLIT_FOREST, Strategy.HBM_DIRECT), warmup=0,
        epochs=1, verbose=False)
    assert res[Strategy.SPLIT_FOREST].error == "RuntimeError: launch failed"
    assert not res[Strategy.SPLIT_FOREST].ran
    assert res[Strategy.HBM_DIRECT].ran and res[Strategy.HBM_DIRECT].correct


class _Fixed:
    """An engine whose predictions are given."""

    def __init__(self, preds):
        self.preds = preds

    def predict(self, data):
        return self.preds


@pytest.mark.parametrize("corrupt", [False, True])
def test_check_engine_matches_jax(corrupt):
    forest = synthetic.generate_forest(7, 4, 6, leaf_prob=0.1, seed=171)
    data = synthetic.generate_data(30, 6, missing_prob=0.1, seed=172)
    from tahoe_tpu.ops import oracle

    preds = oracle.predict(forest, data).copy()
    if corrupt:
        rng = np.random.default_rng(5)
        rows = rng.choice(30, size=14, replace=False)
        # distinct errors, the smallest inside the tolerance
        preds[rows] += np.linspace(5e-4, 2.0, rows.size).astype(np.float32)
    want = jax_debug.check_engine(_Fixed(preds), forest, data)
    port = from_arrays(dataclasses.asdict(forest))
    for engine in (_Fixed(preds), _Fixed(torch.as_tensor(preds))):
        for kw in ({}, {"want": oracle.predict(forest, data)}):
            got = debug.check_engine(engine, port, data, **kw)
            assert (got.correct, got.max_err, got.num_bad, got.worst_rows) == (
                want.correct, want.max_err, want.num_bad, want.worst_rows)
            assert str(got) == str(want)
    assert want.correct is not corrupt
    if corrupt:
        assert want.num_bad == 13 and len(want.worst_rows) == 10
