"""Reading a Chrome trace: device operations given to the host span that
launched them, the busy share, the idle gaps, and the empty-trace retry."""
from __future__ import annotations

import pytest

from portbench import trace


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events():
    """A slice of 100 us: two predicts (a graph launch and a copy each)
    and a copy out; the device runs 10-30, 40-60 (two kernels of one
    graph), 62-64 and 70-75."""
    return [
        X("user_annotation", "slice", 0, 100),
        X("user_annotation", "predict", 5, 10),
        X("cuda_runtime", "cudaMemcpyAsync", 6, 1, corr=1),
        X("cuda_runtime", "cudaGraphLaunch", 8, 2, corr=2),
        X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 10, 20, corr=1),
        X("kernel", "fold_kernel<0, false>", 40, 12, corr=2),
        X("kernel", "neg_kernel", 52, 8, corr=2),
        X("user_annotation", "copy_out", 20, 5),
        X("cuda_runtime", "cudaMemcpyAsync", 21, 1, corr=3),
        X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 62, 2, corr=3),
        X("user_annotation", "tahoe_stage", 6, 2),  # the program's own span
        X("cpu_op", "aten::copy_", 6, 1),
        X("kernel", "stray", 70, 5, corr=99),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 8, "id": 2},
    ]


SPANS = ("predict", "copy_out")


def test_device_time_goes_to_the_launching_span():
    s = trace.read(events(), SPANS)
    assert s.window_s == pytest.approx(100e-6)
    assert s.device_s["predict"] == pytest.approx(40e-6)
    assert s.device_s["copy_out"] == pytest.approx(2e-6)
    assert s.device_s["other"] == pytest.approx(5e-6)
    assert s.spans == {"predict": 1, "copy_out": 1}


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    s = trace.read(events(), SPANS)
    assert s.busy_s == pytest.approx((20 + 20 + 2 + 5) * 1e-6)
    # 75-100 and 30-40 with no host span open, 0-10 in the predict
    assert [[n, round(sec * 1e6, 6)] for n, sec in s.idle_gaps] == [
        ["none", 25.0], ["predict", 10.0], ["none", 10.0], ["none", 6.0],
        ["none", 2.0]]
    assert s.device_ops[0] == ["Memcpy DtoD (Device -> Device)", pytest.approx(22e-6)]


def test_a_trace_without_one_slice_is_refused():
    with pytest.raises(ValueError):
        trace.read([e for e in events() if e["name"] != "slice"], SPANS)


def test_an_empty_profile_is_taken_again():
    taken = []

    def take(run, device):
        taken.append(1)
        if len(taken) < 3:
            return [X("user_annotation", "slice", 0, 100)]
        return events()

    s = trace.profile(lambda span: None, None, SPANS, take=take)
    assert len(taken) == 3 and s.busy_s > 0


def test_profiles_that_stay_empty_fail():
    with pytest.raises(RuntimeError):
        trace.profile(lambda span: None, None, SPANS,
                      take=lambda run, device: [X("user_annotation", "slice", 0, 1)])
