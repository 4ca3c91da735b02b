"""What the metric readers (``metrics/<name>.py``) read, and the readings
they share. A reader is ``read(r: Readings) -> float | None``; None where
the run holds nothing it reads, and the metric is then left out of the
result line.
"""
from __future__ import annotations

from typing import NamedTuple


class Readings(NamedTuple):
    """One run, as the readers see it. Seconds throughout.

    setup_s: from the harness's start to the first timed call; load: the
    cell's load after its window (drive.py: ``window_s``, and what its
    kind counts, such as a batch load's ``rows_done()``); judged: what the
    comparison with the reference found, with the least time of the
    window's work and of the traced slice's (drive.Judged); trace: the
    traced slice (trace.TraceSummary), with --trace 1, else None."""

    setup_s: float
    load: object
    judged: object
    trace: object


def setup_s(r: Readings):
    return r.setup_s


def rows_per_s(r: Readings):
    return r.load.rows_done() / r.load.window_s


def predict_roofline_pct(r: Readings):
    """The least time of the traced predicts' work over the device time of
    every operation those predicts launched."""
    if r.trace is None:
        return None
    spent = r.trace.device_s.get("predict", 0.0)
    if spent <= 0.0 or r.judged.slice_least_s <= 0.0:
        return None
    return 100.0 * r.judged.slice_least_s / spent


def mfu_pct(r: Readings):
    """The least time of the window's work over the window's length."""
    if r.judged.window_least_s <= 0.0:
        return None
    return 100.0 * r.judged.window_least_s / r.load.window_s


def device_idle_pct(r: Readings):
    """The share of the traced slice in which no device operation ran."""
    if r.trace is None or r.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
