"""The traced slice: torch.profiler over a short stretch of a cell's
traffic, read from its Chrome trace.

The benchmark marks its own spans on the host with
``torch.profiler.record_function``: ``slice`` around the whole stretch,
and around each step those its load names (``SPANS``: a batch load's
``predict`` and ``copy_out``); a span of any other name, such as the
program's own, is not one of them. Each device operation (a kernel, a
copy or a set) is given to the span whose host call launched it: the CUDA runtime call with the same correlation id
(a graph's kernels carry the id of its ``cudaGraphLaunch``) lies inside
that span. A profile that records no device operation at all is taken
again, up to PROFILE_TRIES times (the profiler has come back empty after
tens of profiles in one process: PERF.md).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, NamedTuple

PROFILE_TRIES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
SLICE = "slice"
# entries of each list of the breakdown
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 120


class TraceSummary(NamedTuple):
    """What a traced slice showed. Seconds throughout.

    window_s: the slice's length on the host; busy_s: the time in it in
    which some device operation ran; device_s: device seconds by the span
    that launched them (``other`` where none did); spans: host spans by
    name, with their count; device_ops: (name, seconds) of the device
    operations that took most time; idle_gaps: (span open on the host, its
    seconds) of the longest gaps in which no device operation ran."""

    window_s: float
    busy_s: float
    device_s: dict
    spans: dict
    device_ops: list
    idle_gaps: list


def _span_at(spans: list, starts: list, t: float):
    """The name of the span of ``spans`` (sorted, not overlapping) that
    holds ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        return spans[i][2]
    return None


def read(events: list, host_spans) -> TraceSummary:
    """A TraceSummary of the ``traceEvents`` of a Chrome trace that holds
    one ``slice`` span, the benchmark's spans named by ``host_spans``."""
    slices, spans, calls, ops = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"] == SLICE:
            slices.append((ts, ts + dur))
        elif cat == "user_annotation" and e["name"] in host_spans:
            spans.append((ts, ts + dur, e["name"]))
        elif cat in HOST_CALL_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls[corr] = ts
        elif cat in DEVICE_CATS:
            ops.append((ts, ts + dur, e["name"], e.get("args", {}).get("correlation")))
    if len(slices) != 1:
        raise ValueError(f"a trace holds one {SLICE!r} span, not {len(slices)}")
    lo, hi = slices[0][0], slices[0][1]
    spans.sort()
    starts = [s[0] for s in spans]
    counts: dict = defaultdict(int)
    for _, _, name in spans:
        counts[name] += 1
    device_s: dict = defaultdict(float)
    by_name: dict = defaultdict(float)
    for ts, end, name, corr in ops:
        t = calls.get(corr)
        owner = _span_at(spans, starts, t) if t is not None else None
        device_s[owner or "other"] += (end - ts) * 1e-6
        by_name[name[:NAME_CHARS]] += (end - ts) * 1e-6
    # the union of the device's busy intervals, clipped to the slice
    busy, gaps, cursor = 0.0, [], lo
    for ts, end, _, _ in sorted(ops):
        ts, end = max(ts, lo), min(end, hi)
        if end <= cursor:
            continue
        if ts > cursor:
            gaps.append((cursor, ts))
            busy += end - ts
        else:
            busy += end - cursor
        cursor = end
    if cursor < hi:
        gaps.append((cursor, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_span_at(spans, starts, (a + b) / 2) or "none", (b - a) * 1e-6]
            for a, b in gaps[:BREAKDOWN_ENTRIES]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return TraceSummary((hi - lo) * 1e-6, busy * 1e-6, dict(device_s),
                        dict(counts), [[n, s] for n, s in top], idle)


def _take(run: Callable[[Callable], None], device) -> list:
    """The Chrome trace events of ``run(span)`` under the profiler, inside
    one ``slice`` span that ends when the device has finished."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            run(record_function)
            torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def profile(run: Callable[[Callable], None], device, host_spans,
            take=_take) -> TraceSummary:
    """Run ``run(span)`` under the profiler, ``span(name)`` giving a context
    manager that marks a host span, and read the trace, the benchmark's
    spans named by ``host_spans``; taken again, up to PROFILE_TRIES times,
    where it records no device operation."""
    for _ in range(PROFILE_TRIES):
        summary = read(take(run, device), host_spans)
        if summary.busy_s > 0.0:
            return summary
    raise RuntimeError(f"the profiler recorded no device operation in "
                       f"{PROFILE_TRIES} profiles")
