"""The program's spans in a traced slice (program.py): device seconds by
the innermost program span, the idle gaps by what ends them, the three
readings, and a run of the command on the CPU with a stand-in trace."""
from __future__ import annotations

import json

import pytest

from portbench import program, trace
from portbench.tests.test_portbench_trace import SPANS, X
from portbench.tests.test_portbench_trace import events as bench_events


def with_program_spans():
    """The trace reader's test slice, its two predicts marked inside by the
    program as it marks them: the stage holds the copy's call (6), the
    replay the graph's launch (8)."""
    base = [e for e in bench_events() if not e["name"].startswith("tahoe_")]
    return base + [
        X("cpu_op", "tahoe_predict", 5.5, 9),
        X("cpu_op", "tahoe_stage", 5.8, 1.5),
        X("cpu_op", "tahoe_replay", 7.5, 2.5),
    ]


def two_batches():
    """A slice of 200 us. Batch 1: stage (call 13), replay (call 22: two
    kernels, 60-80 and 85-100), clone (call 32: 102-104); its copy runs
    50-60. Batch 2's stage is issued at 153, after the card went idle at
    104: its copy runs 155-165. A stray kernel with no call, 170-172."""
    return [
        X("user_annotation", "slice", 0, 200),
        X("user_annotation", "predict", 10, 50),
        X("cpu_op", "tahoe_predict", 11, 48),
        X("cpu_op", "tahoe_stage", 12, 8),
        X("cuda_runtime", "cudaMemcpyAsync", 13, 1, corr=1),
        X("cpu_op", "tahoe_replay", 21, 9),
        X("cuda_runtime", "cudaGraphLaunch", 22, 2, corr=2),
        X("cpu_op", "tahoe_clone", 31, 9),
        X("cuda_runtime", "cudaMemcpyAsync", 32, 1, corr=3),
        X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 50, 10, corr=1),
        X("kernel", "cat", 60, 20, corr=2),
        X("kernel", "fold_kernel<0, false>", 85, 15, corr=2),
        X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 102, 2, corr=3),
        X("user_annotation", "predict", 150, 40),
        X("cpu_op", "tahoe_predict", 151, 38),
        X("cpu_op", "tahoe_stage", 152, 8),
        X("cuda_runtime", "cudaMemcpyAsync", 153, 1, corr=4),
        X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 155, 10, corr=4),
        X("kernel", "stray", 170, 2, corr=99),
    ]


def test_program_spans_leave_the_benchmarks_reading_as_it_was():
    base = [e for e in bench_events() if not e["name"].startswith("tahoe_")]
    assert trace.read(with_program_spans(), SPANS) == trace.read(base, SPANS)


def test_innermost_names_each_stretch_by_the_span_open_in_it():
    segments = program.innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"),
                                  (8, 10, "d"), (12, 13, "e")])
    assert segments == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 8, "a"),
                        (8, 10, "d"), (12, 13, "e")]


def test_device_time_goes_to_the_innermost_program_span():
    p = program.read(with_program_spans(), SPANS)
    assert p.device_s["tahoe_stage"] == pytest.approx(20e-6)
    assert p.device_s["tahoe_replay"] == pytest.approx(20e-6)
    # the copy out and the stray kernel: launched outside every program span
    assert p.device_s["other"] == pytest.approx(7e-6)
    assert p.predict_s == pytest.approx(40e-6)
    assert p.spans == {"tahoe_predict": 1, "tahoe_stage": 1, "tahoe_replay": 1}
    assert p.late == 0
    # the copy out: called at 21, run at 62; the stage's copy: 6, 10
    assert p.least_lead_us == pytest.approx(4.0)


def test_gaps_are_classed_by_the_operation_that_ends_them():
    p = program.read(two_batches(), SPANS)
    # 80-85 inside the graph's launch; 100-102 the clone's copy, queued at
    # 32; 165-170 the stray kernel, with no call; 104-155 the host's late
    # issue of batch 2's stage; the slice's opening 0-50 and its end are
    # no gap after a device operation
    assert p.gaps["in_graph"] == [1, pytest.approx(5e-6)]
    assert p.gaps["queued"] == [2, pytest.approx(7e-6)]
    assert p.gaps["host"] == [1, pytest.approx(51e-6)]
    assert [[k, n, round(s * 1e6, 6)] for k, n, s in p.longest] == [
        ["host", "tahoe_stage", 51.0], ["in_graph", "tahoe_replay", 5.0],
        ["queued", "other", 5.0], ["queued", "tahoe_clone", 2.0]]


def test_a_host_gap_is_named_by_the_benchmarks_span_where_the_program_has_none():
    ev = two_batches() + [
        X("user_annotation", "copy_out", 120, 10),
        X("cuda_runtime", "cudaMemcpyAsync", 121, 1, corr=5),
        X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 125, 2, corr=5),
    ]
    p = program.read(ev, SPANS)
    assert ["host", "copy_out", pytest.approx(21e-6)] in p.longest
    assert ["host", "tahoe_stage", pytest.approx(28e-6)] in p.longest


def test_an_operation_before_its_span_opened_is_late():
    ev = two_batches() + [
        X("cpu_op", "tahoe_replay", 180, 5),
        X("cuda_runtime", "cudaLaunchKernel", 181, 1, corr=6),
        X("kernel", "early", 175, 1, corr=6),
    ]
    p = program.read(ev, SPANS)
    assert p.late == 1 and p.least_lead_us == pytest.approx(-6.0)


def test_the_readings_by_hand():
    p = program.read(two_batches(), SPANS)
    # stage 20 us (10 + 10) of the predicts' 57 (+ replay 35, clone 2)
    assert program.stage_share_pct(p) == pytest.approx(100 * 20 / 57)
    assert program.replay_roofline_pct(p, 7e-6) == pytest.approx(20.0)
    # in_graph 5 + queued 7 of the slice's 200
    assert program.launch_gap_pct(p) == pytest.approx(6.0)


def test_no_program_spans_no_readings():
    base = [e for e in bench_events() if not e["name"].startswith("tahoe_")]
    p = program.read(base, SPANS)
    assert p is None
    assert program.stage_share_pct(p) is None
    assert program.replay_roofline_pct(p, 1e-6) is None
    assert program.launch_gap_pct(p) is None


def test_a_trace_without_one_slice_is_refused():
    with pytest.raises(ValueError):
        program.read([e for e in two_batches() if e["name"] != "slice"], SPANS)


def test_the_command_runs_a_cell_on_the_cpu(tiny_root, capsys):
    """The window, the slice and the judgement on the CPU, the profile a
    stand-in that drives the slice and returns the hand-built trace."""
    from portbench import drive

    def take(run, device):
        run(drive.no_span)
        return two_batches()

    r = program.measure(tiny_root, "tiny_susy.batch", 2**31 + 7, 0.2,
                        device="cpu", take=take)
    assert r["correct"] and r["device"] == "cpu"
    assert r["metrics"]["stage_share_pct.batch"] == pytest.approx(100 * 20 / 57)
    assert r["metrics"]["launch_gap_pct.batch"] == pytest.approx(6.0)
    # no graph runs on the CPU
    assert r["counters"]["window"] == {k: 0 for k in r["counters"]["window"]}
    assert r["window_batches_per_s"] > 0 and r["slice_batches_per_s"] > 0
    assert set(r["span_us"]) == {"off", "on"}
    json.dumps(r)
    err = capsys.readouterr().err
    for line in ("traced slice:", "program spans:", "program counters (window):"):
        assert line in err


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_susy.batch", "tiny_cup98.batch"])
def test_on_the_card_the_steps_hold_the_predicts_device_time(tiny_root,
                                                              cuda_device, cell):
    r = program.measure(tiny_root, cell, 12345, 1.0)
    assert r["correct"]
    assert set(r["metrics"]) >= {"stage_share_pct.batch", "replay_roofline_pct.batch",
                                 "launch_gap_pct.batch"}
    assert r["steps_over_predict"] == pytest.approx(1.0, rel=0.01)
    # a small cell keeps the card idle: its operations start microseconds
    # after their calls, within the profiler's misalignment of its two
    # clocks, so a late operation here shows a lead below zero
    assert (r["late_ops"] == 0) or r["least_lead_us"] < 0
    assert r["counters"]["window"]["captures"] == 0
    assert r["counters"]["window"]["replays"] > 0
