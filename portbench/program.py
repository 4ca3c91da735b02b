"""The program's own spans in a traced slice: the device work of each step
of a predict, and what each idle gap waited for.

While a profiler records, ``tahoe_tpu_torch`` marks host spans named
``tahoe_*`` (its utils/profiling.py ``span``): ``tahoe_predict`` around
``Forest.predict``, and inside it, on a graphed engine's call,
``tahoe_stage`` (the staging of the raw rows into the graph's static
input: a copy, or the column gather), ``tahoe_replay`` (the graph's
launch), ``tahoe_clone`` (the copy of its output) and ``tahoe_capture``
(a shape's warm-up and capture). ``read`` gives each device operation of
a traced slice to the innermost program span that holds the runtime call
that launched it (``other`` where none does), and classes each idle gap
that follows the slice's first device operation by the operation that
ends it:

- ``host``: its runtime call began after the gap opened, so the card
  waited for the host; named after the innermost span, the program's or
  the benchmark's, that holds that call;
- ``in_graph``: it shares its correlation id with the operation before the
  gap, so the gap lies inside one graph's launch;
- ``queued``: it was launched before the gap opened, by another call: a
  submission boundary; named after the program span that launched it.

The three readings of the facade and its kernels: ``stage_share_pct``,
``replay_roofline_pct`` and ``launch_gap_pct``. The benchmark's traced run
(run.py) does not read the program's spans; this module's command runs a
cell as run.py does and reads them:

    python3 -m portbench.program --workload <cell> --seed <n> --seconds <s>

It prints the ``traced slice:`` line, then ``program spans:`` (device
seconds by step, the span counts, the gaps by class and the ten longest)
and ``program counters (window):`` and ``(slice):`` (``graphed.counters()``
across each) on standard error, and one JSON line on standard output: the
three readings beside run.py's per-layer metrics, the slice's batches a
second against the window's, the host's microseconds a span with the
profiler off and on, and the comparison with the reference.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import sys
import time
from collections import defaultdict
from typing import NamedTuple

from portbench.trace import BREAKDOWN_ENTRIES, DEVICE_CATS, HOST_CALL_CATS, SLICE, _span_at

PREFIX = "tahoe_"
# the program marks its spans as C++ record-function scopes: cpu_op events
PROGRAM_CAT = "cpu_op"
PREDICT = "tahoe_predict"
STAGE, REPLAY, CLONE = "tahoe_stage", "tahoe_replay", "tahoe_clone"
GAP_CLASSES = ("host", "in_graph", "queued")
# spans a run of the command times, with the profiler off and on
SPAN_COST_CALLS = 20000


class ProgramSummary(NamedTuple):
    """The program's spans in a traced slice. Seconds throughout.

    window_s: the slice's length; device_s: device seconds by the innermost
    program span that launched them (``other`` where none did); predict_s:
    device seconds launched inside a ``tahoe_predict``; spans: program
    spans by name, with their count; gaps: class -> [count, seconds] of the
    idle gaps after the slice's first device operation; longest: [class,
    name, seconds] of the longest of them; late: device operations that
    started before the program span they were given to opened;
    least_lead_us: the least time from a runtime call's start to the start
    of the device operation it launched. The profiler puts the host's calls
    and the device's operations on one clock only as far as it aligns the
    two: a lead below zero (and with it a late operation) shows them apart
    by at least that much, and a gap's class is sure only where its host
    call lies farther than that from the gap's opening."""

    window_s: float
    device_s: dict
    predict_s: float
    spans: dict
    gaps: dict
    longest: list
    late: int
    least_lead_us: float | None


def innermost(spans: list) -> list:
    """Nested spans (start, end, name) as sorted segments that do not
    overlap, each named by the innermost span open in it (trace._span_at
    reads them)."""
    out, stack, cursor = [], [], None

    def close(upto):
        nonlocal cursor
        while stack and stack[-1][1] <= upto:
            _, end, name = stack.pop()
            if end > cursor:
                out.append((cursor, end, name))
                cursor = end

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close(start)
        if stack and start > cursor:
            out.append((cursor, start, stack[-1][2]))
        stack.append((start, end, name))
        cursor = start
    close(float("inf"))
    return out


def read(events: list, host_spans) -> ProgramSummary | None:
    """The ProgramSummary of the ``traceEvents`` of a Chrome trace that
    holds one ``slice`` span, the benchmark's spans named by
    ``host_spans``; None where the slice holds no ``tahoe_predict``."""
    slices, program, bench, calls, ops = [], [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"] == SLICE:
            slices.append((ts, ts + dur))
        elif cat == PROGRAM_CAT and e["name"].startswith(PREFIX):
            program.append((ts, ts + dur, e["name"]))
        elif cat == "user_annotation" and e["name"] in host_spans:
            bench.append((ts, ts + dur, e["name"]))
        elif cat in HOST_CALL_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls[corr] = ts
        elif cat in DEVICE_CATS:
            ops.append((ts, ts + dur, e.get("args", {}).get("correlation")))
    if len(slices) != 1:
        raise ValueError(f"a trace holds one {SLICE!r} span, not {len(slices)}")
    counts: dict = defaultdict(int)
    for _, _, name in program:
        counts[name] += 1
    if not counts[PREDICT]:
        return None
    lo, hi = slices[0]
    steps = innermost(program)
    step_starts = [s[0] for s in steps]
    every = innermost(program + bench)
    every_starts = [s[0] for s in every]
    predicts = sorted(s for s in program if s[2] == PREDICT)
    predict_starts = [s[0] for s in predicts]
    # the openings of each name: spans of one name do not nest
    opened: dict = defaultdict(list)
    for start, _, name in sorted(program):
        opened[name].append(start)

    def step_of(t):
        return (_span_at(steps, step_starts, t) if t is not None else None) or "other"

    device_s: dict = defaultdict(float)
    predict_s, late, lead = 0.0, 0, None
    for ts, end, corr in ops:
        t = calls.get(corr)
        if t is not None:
            lead = ts - t if lead is None else min(lead, ts - t)
        owner = step_of(t)
        device_s[owner] += (end - ts) * 1e-6
        if t is not None and _span_at(predicts, predict_starts, t):
            predict_s += (end - ts) * 1e-6
        if owner != "other":
            # the owner opened last of its name at or before the call
            i = bisect.bisect_right(opened[owner], t) - 1
            if i < 0 or opened[owner][i] > ts:
                late += 1
    gaps = {c: [0, 0.0] for c in GAP_CLASSES}
    listed, cursor, last = [], lo, None
    for op in sorted(ops):
        ts, end, corr = max(op[0], lo), min(op[1], hi), op[2]
        if end <= cursor:
            continue
        if ts > cursor and last is not None:
            t = calls.get(corr)
            if corr is not None and corr == last[2]:
                kind, name = "in_graph", step_of(t)
            elif t is not None and t > cursor:
                kind, name = "host", _span_at(every, every_starts, t) or "none"
            else:
                kind, name = "queued", step_of(t)
            gaps[kind][0] += 1
            gaps[kind][1] += (ts - cursor) * 1e-6
            listed.append([kind, name, (ts - cursor) * 1e-6])
        cursor, last = end, op
    listed.sort(key=lambda g: -g[2])
    return ProgramSummary((hi - lo) * 1e-6, dict(device_s), predict_s,
                          dict(counts), gaps, listed[:BREAKDOWN_ENTRIES], late,
                          lead)


def stage_share_pct(p: ProgramSummary | None):
    """Device seconds launched from ``tahoe_stage`` over those launched
    inside ``tahoe_predict``: the staging step's share of a predict."""
    if p is None or p.predict_s <= 0.0:
        return None
    return 100.0 * p.device_s.get(STAGE, 0.0) / p.predict_s


def replay_roofline_pct(p: ProgramSummary | None, slice_least_s: float):
    """The least time of the traced predicts' work (``Judged.slice_least_s``,
    the count ``predict_roofline_pct`` reads) over the device seconds
    launched from ``tahoe_replay``: the graph's own share of the roofline.
    It counts the whole predict's work, so it reads the kernels' share for
    as long as the staging step does no part of the walk. None where no
    replay launched device work."""
    if p is None or p.device_s.get(REPLAY, 0.0) <= 0.0:
        return None
    return 100.0 * slice_least_s / p.device_s[REPLAY]


def launch_gap_pct(p: ProgramSummary | None):
    """The slice's idle time in ``in_graph`` and ``queued`` gaps (launch
    and submission boundaries, not waits for the host) over the slice."""
    if p is None or p.window_s <= 0.0:
        return None
    return 100.0 * (p.gaps["in_graph"][1] + p.gaps["queued"][1]) / p.window_s


def program_counters() -> dict | None:
    """``graphed.counters()``; None for a program without them."""
    from tahoe_tpu_torch.ops import graphed

    counters = getattr(graphed, "counters", None)
    return counters() if counters is not None else None


def span_cost_us(calls: int = SPAN_COST_CALLS) -> dict | None:
    """The host's microseconds a program span (``span``, entered and left)
    adds with no profiler and under a CPU profiler, less an empty loop's;
    None for a program without spans."""
    from torch.profiler import ProfilerActivity, profile

    from tahoe_tpu_torch.utils import profiling

    span = getattr(profiling, "span", None)
    if span is None:
        return None

    def per_call(body):
        t0 = time.perf_counter()
        for _ in range(calls):
            body()
        return (time.perf_counter() - t0) * 1e6 / calls

    def empty():
        pass

    def marked():
        with span("tahoe_cost"):
            pass

    base = per_call(empty)
    off = per_call(marked) - base
    with profile(activities=[ProfilerActivity.CPU]):
        on = per_call(marked) - base
    return {"off": off, "on": on}


def _delta(after: dict | None, before: dict | None) -> dict | None:
    return None if after is None else {k: after[k] - before[k] for k in after}


def measure(root, workload: str, seed: int, seconds: float, device="cuda",
            take=None) -> dict:
    """A run of ``workload`` as run.py's traced run, read with the
    program's spans: the JSON line as a dict (the module docstring).
    ``take`` stands in for trace._take in the tests."""
    import torch

    from portbench import readers, run, trace, work
    from portbench.readers import Readings

    take = take or trace._take
    bench = run.load_benchmark(root)
    cell = run.cell_of(bench, workload)
    dev = torch.device(device)
    run.check_device(cell, dev)
    p = run.prepare(root, cell, seed, dev)
    load, strategy, config = p.load, p.strategy, p.config
    gc.collect()
    gc.freeze()
    before = program_counters()
    load.window(strategy, seconds)
    window = _delta(program_counters(), before)
    for _ in range(trace.PROFILE_TRIES):
        before = program_counters()
        events = take(lambda span: load.traced(strategy, run.SLICE_S, span), dev)
        sliced = _delta(program_counters(), before)
        summary = trace.read(events, load.SPANS)
        if summary.busy_s > 0.0:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device operation in "
                           f"{trace.PROFILE_TRIES} profiles")
    prog = read(events, load.SPANS)
    slice_batches = load.next - load.slice_from
    cost = span_cost_us()
    p.prog.drop_engines()
    load.prog = None
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judged = load.judge(work.forest_shape(load.forest))
    r = Readings(0.0, load, judged, summary)
    print(f"traced slice: {summary.window_s!r} s, device busy "
          f"{summary.busy_s!r} s; device seconds by host span "
          f"{summary.device_s!r}; host spans {summary.spans!r}", file=sys.stderr)
    if prog is not None:
        print(f"program spans: device seconds by step {prog.device_s!r}; spans "
              f"{prog.spans!r}; gaps {prog.gaps!r}; longest {prog.longest!r}",
              file=sys.stderr)
    print(f"program counters (window): {window!r}", file=sys.stderr)
    print(f"program counters (slice): {sliced!r}", file=sys.stderr)
    values = {
        "stage_share_pct.batch": stage_share_pct(prog),
        "replay_roofline_pct.batch": replay_roofline_pct(prog, judged.slice_least_s),
        "launch_gap_pct.batch": launch_gap_pct(prog),
        "predict_roofline_pct.batch": readers.predict_roofline_pct(r),
        "mfu_pct.batch": readers.mfu_pct(r),
        "device_idle_pct.batch": readers.device_idle_pct(r),
    }
    steps_s = sum(prog.device_s.get(k, 0.0) for k in (STAGE, REPLAY, CLONE)) if prog else 0.0
    limit = float(config["max_abs_gap"])
    return {
        "workload": workload, "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "metrics": {k: v for k, v in values.items() if v is not None},
        "rows_per_s": readers.rows_per_s(r),
        "window_batches_per_s": load.window_batches / load.window_s,
        "slice_batches_per_s": slice_batches / summary.window_s,
        "steps_over_predict": (steps_s / summary.device_s["predict"]
                               if summary.device_s.get("predict") else None),
        "late_ops": prog.late if prog else None,
        "least_lead_us": prog.least_lead_us if prog else None,
        "span_us": cost,
        "counters": {"window": window, "slice": sliced},
        "program": prog._asdict() if prog else None,
        "max_abs_gap": judged.gap, "limit": limit, "correct": judged.gap <= limit,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench.run import ROOT

    print(json.dumps(measure(ROOT, args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
