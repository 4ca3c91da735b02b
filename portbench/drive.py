"""What every kind of load shares. A traffic mix's ``kind`` names the
load that drives the program, ``portbench/kinds/<kind>.py``, found by name
(run.load_kind). Such a file defines:

- ``Load(config, mix, seed, device, prog, forest)``: the rows and the
  schedule drawn from ``seed``, with ``pick_rows()`` (the request size the
  program's pick is made at), ``warm(strategy)`` (every shape the traffic
  uses), ``window(strategy, seconds)`` (the measured window, which sets
  ``window_s``, ``attempted`` and ``failed``), ``traced(strategy, seconds,
  span)`` (the traced slice that continues the traffic after the window)
  and, once the program's state is freed, ``judge(shape)`` (a ``Judged``);
  its attribute ``prog`` is dropped before the reference runs, and
  ``SPANS`` names the host spans it marks;
- ``compared_rows(config, mix, seed)``: the rows a run of the cell
  compares with the reference, for the control (control.py).

A host span is marked with ``span(name)``: a shared null context in the
window, ``torch.profiler.record_function`` in the traced slice.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np

# seed streams of a run (rng): the forest, the rows, the batches a batch
# cell judges besides its output table
FOREST_STREAM, ROWS_STREAM, SAMPLE_STREAM = 100, 101, 102
_NULL = contextlib.nullcontext()


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use (``stream``) of a run's seed;
    any whole number is a seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def no_span(name: str):
    return _NULL


def max_gap(pred: np.ndarray, want: np.ndarray) -> float:
    """The largest |pred - want|; a prediction that is NaN or infinite
    counts as the largest finite float away, so that the result line stays
    JSON."""
    d = np.abs(np.asarray(pred, np.float64) - np.asarray(want, np.float64))
    far = np.finfo(np.float64).max
    return float(np.nan_to_num(d, nan=far, posinf=far).max(initial=0.0))


class Judged(NamedTuple):
    """What ``judge`` found: the widest gap to the reference (an answer
    that never came reads as NaN, the widest), and the least time of the
    window's work and of the traced slice's predicts (work.py)."""

    gap: float
    window_least_s: float
    slice_least_s: float


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
