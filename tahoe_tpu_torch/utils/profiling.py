"""Timing on the card with CUDA events.

Replaces the JAX package's chained-slope timing (utils/profiling.py,
bench.py:68-86), which existed because the remote TPU runtime acknowledged a
call before running it. On a local GPU an event pair around each call,
read after one synchronize, gives the time of that call on the card, the
host's issue time included where the card waits on it; ``median_ms`` is
that on ``cuda`` and the host's clock on ``cpu``, and ``cuda_device_ms``
the device time alone.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

from tahoe_tpu_torch.config import resolve_device


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
