"""Timing on the card: the chained slope, CUDA events, and the program's
spans.

- ``slope_time`` and ``us_per_sample``, the port of the JAX package's
  chained-slope timing (tahoe_tpu/utils/profiling.py:20-48 and its noise
  guard, engine/bench_worker.py:98-113): ``run_k(k)`` runs k serialized
  predicts (an engine's ``predict_k``: ops/graphed.py, one CUDA graph of m
  predicts replayed back to back), each chain is timed whole, and the
  slope (t(k2) - t(k1)) / (k2 - k1) is one predict's time with the issue
  of the chain, its copy in and its clone out, and the wait for its end
  cancelled. This is the enumeration's µs/sample, as it is the JAX
  package's. One chain is timed by the host's clock around it followed by
  a synchronize of the device (the JAX harness's fence), on ``cuda`` and on
  ``cpu`` alike;
- ``median_ms``: an event pair around each call on ``cuda`` (the host's
  issue time included where the card waits on it), the host's clock on
  ``cpu``; ``cuda_median_ms`` the event pairs alone; ``cuda_device_ms`` the
  device time of one call, captured in a CUDA graph;
- ``span(name)``: a host span of the program while a profiler records,
  a shared null context otherwise (the test of the gate: 0.3-0.9 us a span
  on an H100 machine's host). The span is PyTorch's C++ record-function
  scope (``torch._C._profiler._RecordFunctionFast``), a ``cpu_op`` event
  of the trace: 1.2-2.7 us a span there under the profiler, where the
  Python ``torch.profiler.record_function`` (a ``user_annotation``) costs
  8-15 us and set the host behind the card in half the traced slices
  measured (PERF.md §6). The spans land in the same trace as the device
  operations, on its clock, and each kernel, copy or set names the runtime
  call that launched it by its correlation id: so a span holds the device
  work its calls launched. Spans nest on the one host thread. The
  program's spans are named ``tahoe_*`` (engine/forest.py, ops/graphed.py).
"""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Optional

import torch

from tahoe_tpu_torch.config import resolve_device

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the host span ``name`` while a profiler
    records, a shared null context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def cuda_median_ms(fn: Callable[[], object], *, warmup: int = 3,
                   iters: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream: ``warmup``
    untimed calls, then ``iters`` calls each between two events."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_median_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def median_ms(fn: Callable[[], object], device, *, warmup: int = 3,
              iters: int = 20) -> float:
    """Median wall milliseconds of ``fn()`` a call on ``device``: on
    ``cuda`` ``cuda_median_ms``, whose event pair around each call also
    counts the host's time to issue it once the card waits on the host, as
    an end-to-end time must; on ``cpu`` ``time.perf_counter`` around each
    call. A ``cuda`` device without a card raises (resolve_device)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return cuda_median_ms(fn, warmup=warmup, iters=iters)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cuda_device_ms(fn: Callable[[], object], *, warmup: int = 3,
                   calls: int = 20) -> float:
    """Device milliseconds of one ``fn()``: ``calls`` calls captured in one
    CUDA graph after ``warmup``, its replay timed between two events. Unlike
    an event pair around a call, it excludes the host's time to issue the
    call, which exceeds the device time of a kernel of a few tens of
    microseconds. ``fn`` must be capturable: no host synchronisation."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_device_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()  # the first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def alternating(fns: dict, *, rounds: int = 5, calls: int = 20) -> dict:
    """Device ms a call of each fn (``cuda_device_ms`` over ``calls``
    calls), in ``rounds`` rounds that take the fns in turn, so that a drift
    of the card's clock falls on all of them alike; name -> (median of the
    rounds, the rounds)."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_device_ms(fn, calls=calls))
    return {name: (statistics.median(v), v) for name, v in times.items()}


# The noise guard: the least t(k2) - t(k1) a slope is read from. One chain's
# time at a fixed k spreads over its runs: the host's issue of the chain
# and its wait for the end. chip_smoke.py phase 19 measures that spread,
# the max - min of ten runs of a chain of k1 = 2 predicts: 2.8-305 us on
# the 40 paths of csrc's kernels on an H100 (80GB HBM3, 700 W), at most
# 101 us on all but two; SLOPE_SPREAD_S is that 101 us, rounded. A delta
# of SLOPE_NOISE_FACTOR spreads holds the spread's share of a slope near
# 1 / SLOPE_NOISE_FACTOR. k2 is stretched (at most SLOPE_TRIES times, and
# no chain past SLOPE_MAX_CHAIN_S) until the delta passes it.
SLOPE_SPREAD_S = 100e-6
SLOPE_NOISE_FACTOR = 100
SLOPE_MIN_DELTA_S = SLOPE_NOISE_FACTOR * SLOPE_SPREAD_S
SLOPE_TRIES = 4
SLOPE_MAX_CHAIN_S = 2.0


def chain_seconds(run_k: Callable[[int], object], k: int, device, *, n: int = 3,
                  clock: Callable[[], float] = time.perf_counter) -> float:
    """Median seconds of one ``run_k(k)`` over ``n`` runs, after an untimed
    one (a chain's first run at a k captures its graphs): ``clock`` around
    the run and a synchronize of ``device``."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run_k(k)
    sync()
    times = []
    for _ in range(n):
        t0 = clock()
        run_k(k)
        sync()
        times.append(clock() - t0)
    return statistics.median(times)


def slope_time(run_k: Callable[[int], object], k1: int = 3, k2: int = 27,
               n: int = 3, *, device="cpu",
               clock: Callable[[], float] = time.perf_counter,
               min_delta_s: float = SLOPE_MIN_DELTA_S) -> float:
    """Seconds an iteration by the chained slope: ``run_k(k)`` runs k
    serialized iterations (an engine's ``predict_k``); each chain length is
    timed by ``chain_seconds`` and (t(k2) - t(k1)) / (k2 - k1) cancels what
    every chain pays once. Where the delta falls below ``min_delta_s``, k2
    grows (the JAX noise guard) until it passes, for SLOPE_TRIES tries or
    until a chain would outlast SLOPE_MAX_CHAIN_S."""
    if not 1 <= k1 < k2:
        raise ValueError(f"slope_time needs 1 <= k1 < k2; got {k1}, {k2}")

    def timed(k):
        return chain_seconds(run_k, k, device, n=n, clock=clock)

    t1, t2 = timed(k1), timed(k2)
    for _ in range(SLOPE_TRIES):
        delta = t2 - t1
        if delta >= min_delta_s:
            break
        grow = max(2, int(2 * min_delta_s / max(delta, min_delta_s / 20)))
        k_next = k1 + (k2 - k1) * grow
        # t(k2) / k2, the fixed cost included, bounds a chain's time a step
        if t2 / k2 * k_next > SLOPE_MAX_CHAIN_S:
            break
        k2 = k_next
        t2 = timed(k2)
    return max((t2 - t1) / (k2 - k1), 1e-12)


def us_per_sample(engine, rows, k1: int = 3, k2: int = 27, *,
                  device: Optional[object] = None, **kw) -> float:
    """Slope-timed µs a row of ``engine.predict_k`` on ``rows`` (on the
    engine's device unless ``device`` is given)."""
    dev = device if device is not None else getattr(engine, "device", "cpu")
    return slope_time(lambda k: engine.predict_k(rows, k), k1, k2,
                      device=dev, **kw) * 1e6 / len(rows)
