"""The program's own spans and counters: utils/profiling.py ``span``, the
``tahoe_*`` spans of ``Forest.predict`` and ops/graphed.py, and
``graphed.counters()``.

On the CPU: with no profiler recording a span is one shared null context
and no record-function scope is made; under ``torch.profiler`` a predict
marks exactly one ``tahoe_predict`` and nothing of the graph's steps; the
counters do not move on the CPU path and only grow. The ``cuda`` tests
skip here and run on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tahoe_tpu_torch import Forest, Strategy
from tahoe_tpu_torch.forest import synthetic
from tahoe_tpu_torch.ops import _build, graphed
from tahoe_tpu_torch.utils import profiling

STEPS = ("tahoe_stage", "tahoe_replay", "tahoe_clone")


class _Counting:
    """A stand-in for the record-function scope that counts what is made."""

    made = 0

    def __init__(self, name):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _forest():
    return synthetic.generate_mixed_depth_forest(12, 6, 9, missing=-999.0,
                                                 seed=1)


def _rows(n, cols=9, seed=2):
    return synthetic.generate_data(n, cols, missing=-999.0, missing_prob=0.1,
                                   seed=seed)


def test_a_span_is_the_shared_null_context_while_nothing_records(monkeypatch):
    monkeypatch.setattr(_Counting, "made", 0)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Counting)
    assert not torch.autograd._profiler_enabled()
    for name in ("tahoe_predict", *STEPS):
        s = profiling.span(name)
        assert s is profiling.span("another")
        with s:
            pass
    assert _Counting.made == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("tahoe_predict"):
            pass
    assert _Counting.made == 1


@pytest.mark.parametrize("strategy", list(Strategy), ids=lambda s: s.name)
def test_a_cpu_predict_marks_one_tahoe_predict(strategy):
    f = Forest(_forest(), device="cpu")
    rows = _rows(6)
    f.predict(rows, strategy)  # builds the engine outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f.predict(rows, strategy)
    names = [e.name for e in prof.events() if e.name.startswith("tahoe_")]
    assert names == ["tahoe_predict"]


def test_counters_grow_only_and_the_cpu_path_moves_none(monkeypatch):
    before = graphed.counters()
    assert set(before) == {"captures", "capture_s", "replays", "staged_bytes",
                           "direct_calls", "launches"}
    f = Forest(_forest(), device="cpu")
    for strategy in (Strategy.SPLIT_FOREST, Strategy.RANK_MXU, Strategy.TENSOR):
        f.predict(_rows(5), strategy)
        f.engine(strategy).predict_k(_rows(5), 3)
    assert graphed.counters() == before
    # a capture's bookkeeping and a kernel's launch only add
    monkeypatch.setattr(_build, "KERNELS", list(_build.KERNELS))
    kernel = _build.CudaKernel("stand_in", [], source="none", replaces="none")
    kernel.launches += 2
    graphed._captured(graphed._Graph(None, None, None, [(kernel, 2)], 0.25))
    after = graphed.counters()
    assert after["captures"] == before["captures"] + 1
    assert after["capture_s"] == pytest.approx(before["capture_s"] + 0.25)
    assert after["launches"] == before["launches"] + 2
    assert ((after["replays"], after["staged_bytes"], after["direct_calls"])
            == (before["replays"], before["staged_bytes"], before["direct_calls"]))


# -- on the card ----------------------------------------------------------

def _trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _read(events):
    """The host spans (name, start, end), the start of each runtime call
    by correlation id, and the device operations (start, correlation)."""
    spans, calls, ops = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e["ts"])
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation" or (cat == "cpu_op"
                                        and e["name"].startswith("tahoe_")):
            spans.append((e["name"], ts, ts + float(e.get("dur", 0.0))))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            calls[corr] = ts
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append((ts, corr))
    return spans, calls, ops


def _queue_ahead():
    """20 ms of work on the card ahead of the calls that follow, so that
    their operations start milliseconds after the host issued them. The
    profiler aligns the host's clock and the card's only so far (PERF.md
    §6: they have read up to 1.5 ms apart); without work queued, an idle
    card starts an operation microseconds after its call."""
    with torch.profiler.record_function("queue_ahead"):
        torch.cuda._sleep(int(4e7))


def _innermost(spans, t):
    held = [s for s in spans if s[1] <= t <= s[2]]
    return max(held, key=lambda s: s[1]) if held else None


def _profiled_predicts(strategy, tmp_path):
    """Four predicts of ``strategy`` under the profiler, with 20 ms queued
    ahead of the first two; every device operation held to the step that
    launched it. A staging engine's first call captures and the three after
    it replay, each through STEPS; on the in-place route every call is one
    direct launch in ``tahoe_replay``. The engine, the counters' change and
    a call's launches."""
    dev = torch.device("cuda", 0)
    forest = synthetic.generate_mixed_depth_forest(60, 8, 18, missing=-999.0,
                                                   seed=3)
    x = torch.as_tensor(_rows(777, cols=18, seed=10), device=dev)
    # the profiler has come back empty on the card: a fresh engine, up to 3 times
    for _ in range(3):
        f = Forest(forest, device=dev)
        f.engine(strategy)  # its tables go up outside the profile
        torch.cuda.synchronize(dev)
        before = graphed.counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(4):
                if i < 2:
                    _queue_ahead()
                f.predict(x, strategy)
            torch.cuda.synchronize(dev)
        after = graphed.counters()
        spans, calls, ops = _read(_trace(prof, tmp_path))
        if ops:
            break
    assert ops, "the profiler recorded no device operation in 3 profiles"
    eng = f.engine(strategy)
    direct = eng._predict.in_place is not None
    steps, captured = (("tahoe_replay",), 0) if direct else (STEPS, 1)
    names = [s[0] for s in spans]
    assert names.count("tahoe_predict") == 4
    assert names.count("tahoe_capture") == captured
    ahead = [s for s in spans if s[0] == "queue_ahead"]
    spans = [s for s in spans if s[0].startswith("tahoe_")]
    predicts = sorted(s for s in spans if s[0] == "tahoe_predict")
    if captured:
        capture = next(s for s in spans if s[0] == "tahoe_capture")
        assert predicts[0][1] <= capture[1] and capture[2] <= predicts[0][2]
    for p in predicts[captured:]:
        inside = sorted((s[1], s[0]) for s in spans
                        if s[0] in STEPS and p[1] <= s[1] and s[2] <= p[2])
        assert [n for _, n in inside] == list(steps), p
    # every device operation goes to the step that launched it, and starts
    # after that step's span opened: the spans and the device share a clock
    launched = {}
    for ts, corr in ops:
        assert calls.get(corr) is not None, (ts, corr)
        if _innermost(ahead, calls[corr]) is not None:
            continue
        owner = _innermost(spans, calls[corr])
        assert owner is not None and owner[0] in ("tahoe_capture", *steps), (ts, owner)
        assert ts >= owner[1], (ts, owner)
        launched[owner[0]] = launched.get(owner[0], 0) + 1
    assert set(launched) == set(steps) | ({"tahoe_capture"} if captured else set())
    if direct:
        per_call = (after["launches"] - before["launches"]) // 4
    else:
        g = eng._predict.graphs[tuple(x.shape)]
        per_call = sum(n for _, n in g.launches)
        assert after["capture_s"] - before["capture_s"] == pytest.approx(g.seconds)
    assert per_call >= 1
    assert after["captures"] - before["captures"] == captured
    assert after["launches"] - before["launches"] == 4 * per_call
    np.testing.assert_array_equal(f.predict(x, strategy).cpu().numpy(),
                                  eng._predict_impl(x).cpu().numpy())
    return eng, {k: after[k] - before[k] for k in after}, per_call


@pytest.mark.cuda
def test_on_the_card_spans_hold_the_work_they_launch(tmp_path):
    """Kernel C's SPLIT_FOREST reads the rows in place: no capture and no
    staging; each call served by one direct launch of kernel C."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    eng, moved, per_call = _profiled_predicts(Strategy.SPLIT_FOREST, tmp_path)
    assert eng._predict.graphs == {} and per_call == 1
    assert moved["replays"] == 4 and moved["staged_bytes"] == 0
    assert moved["direct_calls"] == 4


@pytest.mark.cuda
def test_on_the_card_a_staging_engine_counts_its_staged_bytes(tmp_path):
    """An engine that stages (the rank engine) copies its rows into the
    static input at every replay and makes no direct call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    eng, moved, _ = _profiled_predicts(Strategy.RANK_MXU, tmp_path)
    g = eng._predict.graphs[(777, 18)]
    assert moved["replays"] == 3
    assert moved["staged_bytes"] == 3 * g.static_in.nbytes
    assert moved["direct_calls"] == 0
