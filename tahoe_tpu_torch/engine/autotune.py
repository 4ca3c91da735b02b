"""Exhaustive strategy enumeration: measure everything, pick the winner.

The port of tahoe_tpu/engine/autotune.py:26-122, 172-190, the reference's
benchmarking loop (BaseTahoeTest.h:633-710): build the forest once, run
every strategy with warm-up and timed epochs and a correctness verdict each,
skip the infeasible ones with their reason, return the argmin.

Every strategy is timed as the JAX package times it
(engine/bench_worker.py ``timed_epoch_seconds``, which its enumeration
runs in process too): by the chained slope (utils/profiling.slope_time)
over the engine's ``predict_k``, k serialized predicts replayed from CUDA
graphs (ops/graphed.py), so that one predict's time has the host's issue,
the event tail and the clone of the result cancelled. At the sweep's rows
(1,000-20,000) the host's issue of a graphed call is most of the call and
its spread moved the verdicts of event pairs (ROADMAP Queue 3 fault 5).
Everything runs in this process: no subprocess a strategy, which the JAX
package needs for its remote TPU runtime. ``us_per_sample`` is the median
of ROUNDS slopes and ``us_band`` their [min, max], as the JAX worker
records three slope measurements; the rounds take the engines in turn.
Beside it ``event_us_per_sample`` keeps one round of event pairs around
each call (utils/profiling.median_ms, the host's issue included), the
reading of earlier sweeps. A predict's capture, and each chain length's,
fall in the warm-up, as a jit's compile does; ``build_s`` is the engine's
build alone. The oracle runs once per data set, not once per strategy,
and every engine is dropped once the rounds are done.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tahoe_tpu_torch.config import ORACLE_ATOL, Strategy, resolve_device
from tahoe_tpu_torch.engine.forest import Forest
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops.rank_kernel import fuse_admits, rank_quantize
from tahoe_tpu_torch.utils.debug import check_engine
from tahoe_tpu_torch.utils.profiling import (
    SLOPE_MIN_DELTA_S, median_ms, slope_time)

# reference epoch counts: 5 warmup, 50 timed for the adaptive strategies
# (BaseTahoeTest.h:43, 684-698)
WARMUP_EPOCHS = 5
TIMED_EPOCHS = 50
# slopes a strategy takes; its time is their median
ROUNDS = 3
# a slope's chains: k1 = max(1, warmup) predicts, k2 = k1 + steps, the
# steps sized from a call's time so that t(k2) - t(k1) comes near
# SLOPE_DELTA_S (past the noise guard's least delta), at least
# max(epochs, SLOPE_MIN_STEPS), and at most SLOPE_BUDGET_S of predicts
SLOPE_DELTA_S = 4 * SLOPE_MIN_DELTA_S
SLOPE_MIN_STEPS = 4
SLOPE_BUDGET_S = 0.25
# the round of event pairs a strategy keeps beside its slope takes at least
# ROUND_S of calls (at most MAX_ROUND_CALLS)
ROUND_S = 0.2
MAX_ROUND_CALLS = 10000
# untimed calls after the warm-up that size the chains and the event round
PROBE_CALLS = 3

# the run-time choices a variant stands for, as Forest.engine arguments
VARIANTS = {"fused": {"fuse_transform": True}}


@dataclasses.dataclass
class StrategyResult:
    strategy: Strategy
    us_per_sample: float = float("inf")
    max_err: float = float("nan")
    correct: bool = False
    skipped_reason: Optional[str] = None
    error: Optional[str] = None
    # the run-time choice (a VARIANTS key) that produced us_per_sample;
    # None = the engine's default
    variant: Optional[str] = None
    # [min, max] of the ROUNDS slopes
    us_band: Optional[list] = None
    # one round of event pairs around each call (the host's issue included)
    event_us_per_sample: Optional[float] = None
    # seconds to build the engine's tables on the device
    build_s: Optional[float] = None

    @property
    def ran(self) -> bool:
        return self.skipped_reason is None and self.error is None


def variant_candidates(strategy: Strategy, spec: ForestSpec) -> list:
    """The variants to try when tuning is on, the default (None) first:
    RANK_MXU fused where the fused gate admits the forest; every other
    strategy has one variant. SPLIT_FOREST's kernel is fold_plan's choice,
    fit to measurements, not a variant."""
    if strategy == Strategy.RANK_MXU:
        try:
            q, _ = rank_quantize(spec)
        except NotImplementedError:  # past the rank planes: RANK_MXU skips
            return [None]
        if fuse_admits(q):
            return [None, "fused"]
    return [None]


def enumerate_strategies(
    spec: ForestSpec,
    data: np.ndarray,
    *,
    device,
    strategies=tuple(Strategy),
    warmup: int = WARMUP_EPOCHS,
    epochs: int = TIMED_EPOCHS,
    verbose: bool = True,
    tune_tiles: bool = False,
) -> Dict[Strategy, StrategyResult]:
    """Time and check each of ``strategies`` on ``data`` on ``device``:
    ``warmup`` untimed calls, then ROUNDS chained slopes over at least
    ``epochs`` predicts; with ``tune_tiles`` also each variant_candidates
    variant, keeping the fastest correct one. The rounds take the engines
    in turn, so that a slow spell of a shared host or of the card's clock
    falls on all of them alike."""
    dev = resolve_device(device)
    forest = Forest(spec, device=dev)
    data = np.asarray(data, np.float32)
    want = forest.predict_oracle(data)
    rows = torch.as_tensor(data, device=dev)
    cands: Dict[Strategy, list] = {}
    timings = []
    try:
        for s in strategies:
            reason = forest.feasible(s)
            if reason is not None:
                cands[s] = [StrategyResult(strategy=s, skipped_reason=reason)]
                continue
            cands[s] = [StrategyResult(strategy=s, variant=v) for v in
                        (variant_candidates(s, forest.spec) if tune_tiles
                         else [None])]
            timings += [t for r in cands[s]
                        if (t := _prepare(forest, r, rows, warmup, epochs))]
        for _ in range(ROUNDS):
            for t in timings:
                t.time_round(dev)
        for t in timings:
            t.finish(forest.spec, rows, want)
    finally:
        del timings
        _release(forest)
    results: Dict[Strategy, StrategyResult] = {}
    for s, rs in cands.items():
        r = rs[0]
        for cand in rs[1:]:
            if cand.ran and cand.correct and cand.us_per_sample < r.us_per_sample:
                r = cand
        results[s] = r
        if verbose:
            _print_result(r)
    return results


@dataclasses.dataclass
class _Timing:
    """One built engine under measurement; errors land in ``result``."""

    result: StrategyResult
    call: Callable[[], object]
    run_k: Callable[[int], object]
    engine: object
    k1: int
    k2: int
    iters: int
    rounds: list = dataclasses.field(default_factory=list)
    event_ms: Optional[float] = None

    def time_round(self, dev: torch.device) -> None:
        if self.result.error is None:
            try:
                if self.event_ms is None:
                    self.event_ms = median_ms(self.call, dev, warmup=0,
                                              iters=self.iters)
                self.rounds.append(slope_time(self.run_k, self.k1, self.k2,
                                              device=dev))
            except Exception as e:  # reported as data, as the JAX worker does
                self.result.error = f"{type(e).__name__}: {e}"

    def finish(self, spec: ForestSpec, rows: torch.Tensor,
               want: np.ndarray) -> None:
        r = self.result
        if r.error is not None:
            return
        n = rows.shape[0]
        r.us_per_sample = statistics.median(self.rounds) * 1e6 / n
        r.us_band = [min(self.rounds) * 1e6 / n, max(self.rounds) * 1e6 / n]
        r.event_us_per_sample = self.event_ms * 1e3 / n
        try:
            rep = check_engine(self.engine, spec, rows, want=want)
            r.max_err, r.correct = rep.max_err, rep.correct
        except Exception as e:
            r.error = f"{type(e).__name__}: {e}"


def _prepare(forest: Forest, r: StrategyResult, rows: torch.Tensor,
             warmup: int, epochs: int) -> Optional[_Timing]:
    """Build ``r``'s engine (timed) and warm it up; an error in either is
    the result's ``error``, and no other engine takes its place."""
    dev = forest.device
    try:
        t0 = time.perf_counter()
        eng = forest.engine(r.strategy, **VARIANTS.get(r.variant, {}))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        r.build_s = time.perf_counter() - t0

        def call():
            return eng.predict(rows)

        def run_k(k):
            return eng.predict_k(rows, k)

        return _Timing(r, call, run_k, eng,
                       *plan_timing(call, run_k, dev, warmup, epochs))
    except Exception as e:
        r.error = f"{type(e).__name__}: {e}"
        return None


def plan_timing(call, run_k, dev: torch.device, warmup: int,
                epochs: int) -> tuple[int, int, int]:
    """Warm up one engine and size its timing: run the ``warmup`` calls
    (the first captures the predict's graph), time PROBE_CALLS more by the
    host's clock (a call's seconds, the host's issue included), run a chain
    of each length once (their captures). Returns (k1, k2, the calls of the
    event round)."""
    for _ in range(warmup):
        call()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    for _ in range(PROBE_CALLS):
        call()
    sync()
    per_call = max((time.perf_counter() - t0) / PROBE_CALLS, 1e-6)
    k1 = max(1, warmup)
    steps = max(SLOPE_MIN_STEPS, epochs, math.ceil(SLOPE_DELTA_S / per_call))
    steps = min(steps, max(SLOPE_MIN_STEPS, int(SLOPE_BUDGET_S / per_call)))
    for k in (k1, k1 + steps):
        run_k(k)
    iters = max(epochs, min(MAX_ROUND_CALLS, math.ceil(ROUND_S / per_call)))
    return k1, k1 + steps, iters


def _release(forest: Forest) -> None:
    """Drop the forest's engines and free what they held: no table and no
    CUDA graph outlives the enumeration in device memory."""
    forest.drop_engines()
    gc.collect()
    if forest.device.type == "cuda":
        torch.cuda.synchronize(forest.device)
        torch.cuda.empty_cache()


def best_strategy(results: Dict[Strategy, StrategyResult]) -> Optional[Strategy]:
    ran = [r for r in results.values() if r.ran and r.correct]
    if not ran:
        return None
    return min(ran, key=lambda r: r.us_per_sample).strategy


def _print_result(r: StrategyResult) -> None:
    """Per-strategy report in the spirit of the reference's output contract
    (strategy banner + µs/sample + correctness verdict, BaseTahoeTest.h:682-704)."""
    n = r.strategy.strategy_number
    if r.skipped_reason:
        print(f"Using the #{n} strategy ({r.strategy.name}): skipped — {r.skipped_reason}")
        return
    if r.error:
        print(f"Using the #{n} strategy ({r.strategy.name}): FAILED — {r.error}")
        return
    verdict = "correct" if r.correct else "INCORRECT"
    variant = f" [variant {r.variant}]" if r.variant else ""
    print(
        f"Using the #{n} strategy ({r.strategy.name}): "
        f"{r.us_per_sample:.6f} us/sample — results are {verdict} "
        f"(max err {r.max_err:.2e}, tol {ORACLE_ATOL}){variant}"
    )
