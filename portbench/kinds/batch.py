"""The batch kind of traffic: a closed loop over a table on the device,
back to back, ``rows`` rows a batch (the mix file's one parameter).

Each batch is the next contiguous slice of the table; where fewer than
``rows`` remain, the next slice starts that many rows on from the table's
first row (``batch_start``), so that a table that holds one batch or a few
still gives every batch other rows. Every seed gets the same slices; the
seed draws the forest, the table and which batches are kept besides the
output table.
"""
from __future__ import annotations

import time

import numpy as np

from portbench import drive, reference, work
from portbench.generators import rows_of

# a run keeps the predictions of one batch in this many, at an offset
# drawn from the seed, besides its output table: 100-120 MB of the card's
# memory in a 51 s window
SAMPLE_EVERY = 512


def batch_start(k, table_rows: int, rows: int):
    """The first row of batch ``k`` (a number or an array of them): k times
    ``rows``, modulo the table_rows - rows + 1 places a batch can start."""
    if rows > table_rows:
        raise ValueError(f"a batch of {rows} rows exceeds the table's {table_rows}")
    return (np.asarray(k, np.int64) * rows) % (table_rows - rows + 1)


def compared_rows(config: dict, mix: dict, seed: int) -> np.ndarray:
    """A window's batches cover the table: every row of it."""
    return rows_of(config, int(config["table_rows"]), [seed, drive.ROWS_STREAM])


class Load:
    """``Forest.predict`` on each batch, the predictions copied into a
    device output table. The window ends at a synchronize after the last
    batch. The table holds each slice's last predictions; one batch in
    SAMPLE_EVERY, from an offset drawn from the seed, is kept besides, so
    that batches whose slices are predicted again later are judged too."""

    SPANS = ("predict", "copy_out")

    def __init__(self, config: dict, mix: dict, seed: int, device, prog,
                 forest: dict):
        import torch

        self.torch, self.device, self.prog, self.forest = torch, device, prog, forest
        self.batch = int(mix["rows"])
        self.table_rows = table_rows = int(config["table_rows"])
        batch_start(0, table_rows, self.batch)  # raises where no batch fits
        self.table = torch.from_numpy(
            rows_of(config, table_rows, [seed, drive.ROWS_STREAM])).to(device)
        self.out = torch.full((table_rows,), float("nan"), device=device)
        self.sample_at = int(drive.rng(seed, drive.SAMPLE_STREAM).integers(SAMPLE_EVERY))
        self.samples: list = []
        self.next = 0
        self.window_batches = self.slice_from = 0
        self.attempted = self.failed = 0
        self.window_s = 0.0

    def pick_rows(self) -> int:
        return self.batch

    def _step(self, strategy, span) -> None:
        s = int(batch_start(self.next, self.table_rows, self.batch))
        with span("predict"):
            pred = self.prog.predict(self.table[s:s + self.batch], strategy)
        with span("copy_out"):
            self.out[s:s + self.batch].copy_(pred)
        if self.next % SAMPLE_EVERY == self.sample_at:
            self.samples.append((s, pred))
        self.next += 1

    def warm(self, strategy) -> None:
        """The one shape's capture, its first replays, and the copy out;
        they write the table's first slices, which the window writes
        again."""
        for _ in range(3):
            self._step(strategy, drive.no_span)
        self.next = 0
        self.samples.clear()
        drive.sync(self.torch, self.device)

    def window(self, strategy, seconds: float) -> None:
        drive.sync(self.torch, self.device)
        t0 = time.perf_counter()
        while True:
            self._step(strategy, drive.no_span)
            if time.perf_counter() - t0 >= seconds:
                break
        drive.sync(self.torch, self.device)
        self.window_s = time.perf_counter() - t0
        self.window_batches = self.attempted = self.next

    def rows_done(self) -> int:
        return self.window_batches * self.batch

    def traced(self, strategy, seconds: float, span) -> None:
        """The traced slice; where the profile is taken again, the last
        one's batches are those its work counts."""
        t0 = time.perf_counter()
        self.slice_from = self.next
        while time.perf_counter() - t0 < seconds:
            self._step(strategy, span)

    def judge(self, shape: work.ForestShape) -> drive.Judged:
        torch = self.torch
        ref, visits = reference.predict(self.forest, self.table)
        want = ref.cpu().numpy()
        # the rows some batch of the window or the slice predicted
        starts = batch_start(np.arange(self.next), self.table_rows, self.batch)
        edges = np.zeros(self.table_rows + 1, np.int64)
        np.add.at(edges, starts, 1)
        np.add.at(edges, starts + self.batch, -1)
        covered = np.cumsum(edges)[:-1] > 0
        gap = drive.max_gap(self.out.cpu().numpy()[covered], want[covered])
        for s, pred in self.samples:
            gap = max(gap, drive.max_gap(pred.cpu().numpy(), want[s:s + self.batch]))
        # the least time of each batch, from the visits of its rows
        cum = np.concatenate([[0], torch.cumsum(visits, 0).cpu().numpy()])
        least = work.least_time(*work.call_work(
            shape, self.batch, cum[starts + self.batch] - cum[starts]))
        window_least = least[:self.window_batches].sum()
        slice_least = least[max(self.slice_from, self.window_batches):].sum()
        return drive.Judged(gap, float(window_least), float(slice_least))
