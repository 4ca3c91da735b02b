"""Exhaustive strategy enumeration: measure everything, pick the winner.

The port of tahoe_tpu/engine/autotune.py:26-122, 172-190, the reference's
benchmarking loop (BaseTahoeTest.h:633-710): build the forest once, run
every strategy with warm-up and timed epochs and a correctness verdict each,
skip the infeasible ones with their reason, return the argmin.

Everything runs in this process. The JAX package gives each strategy a
subprocess and times it by a chained slope because its remote TPU runtime
acknowledged a call before running it; on a local GPU an event pair around
each call times it (utils/profiling.median_ms), the host's issue time
included, as a user's call sees it. The rounds take the engines in turn
(PERF.md section 6: on a shared host a slow spell of the host lasts
seconds). The oracle runs once per data set, not once per strategy, and
every engine is dropped once the rounds are done. A predict is one CUDA
graph replay (ops/graphed.py): its capture falls in the warm-up calls, as
a jit's compile does, and the timed rounds time replays; ``build_s`` is the
engine's build alone.
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
from tahoe_tpu_torch.utils.profiling import median_ms

# reference epoch counts: 5 warmup, 50 timed for the adaptive strategies
# (BaseTahoeTest.h:43, 684-698)
WARMUP_EPOCHS = 5
TIMED_EPOCHS = 50
# rounds of timed epochs; a strategy's time is the median of their medians.
# A round takes at least ROUND_S of calls (at most MAX_ROUND_CALLS):
# PERF.md section 6
ROUNDS = 3
ROUND_S = 0.2
MAX_ROUND_CALLS = 10000
# untimed calls after the warm-up that size a round
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
    # [min, max] of the ROUNDS round medians
    us_band: Optional[list] = None
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
    ``warmup`` untimed calls, then ROUNDS rounds of at least ``epochs``
    calls; with ``tune_tiles`` also each variant_candidates variant,
    keeping the fastest correct one. The rounds take the engines in turn,
    so that a slow spell of a shared host falls on all of them alike."""
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
    engine: object
    iters: int
    rounds: list = dataclasses.field(default_factory=list)

    def time_round(self, dev: torch.device) -> None:
        if self.result.error is None:
            try:
                self.rounds.append(median_ms(self.call, dev, warmup=0,
                                             iters=self.iters))
            except Exception as e:  # reported as data, as the JAX worker does
                self.result.error = f"{type(e).__name__}: {e}"

    def finish(self, spec: ForestSpec, rows: torch.Tensor,
               want: np.ndarray) -> None:
        r = self.result
        if r.error is not None:
            return
        n = rows.shape[0]
        r.us_per_sample = statistics.median(self.rounds) * 1e3 / n
        r.us_band = [min(self.rounds) * 1e3 / n, max(self.rounds) * 1e3 / n]
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

        return _Timing(r, call, eng, _round_calls(call, dev, warmup, epochs))
    except Exception as e:
        r.error = f"{type(e).__name__}: {e}"
        return None


def _round_calls(call, dev: torch.device, warmup: int, epochs: int) -> int:
    """Run the ``warmup`` calls, time PROBE_CALLS more and return the calls
    a round takes: ``epochs``, or as many as fill ROUND_S. On a shared host
    the time to issue a short call drifts over tens of milliseconds, so a
    round of a few short calls would time one state of the host."""
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
    per_call = (time.perf_counter() - t0) / PROBE_CALLS
    return max(epochs, min(MAX_ROUND_CALLS, math.ceil(ROUND_S / max(per_call, 1e-6))))


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
