"""The oracle-parity gate as a library call.

The port of tahoe_tpu/utils/debug.py:25-53. The reference has no
sanitizers (SURVEY.md section 5); its one gate is the on-device oracle
compare (compare_GPU, cuda_base.h:98-111). :func:`check_engine` is that
gate with a per-row report instead of a printf. The JAX module's
``nan_guard`` (jax_debug_nans) has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tahoe_tpu_torch.config import ORACLE_ATOL
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops import oracle


@dataclasses.dataclass
class ParityReport:
    correct: bool
    max_err: float
    num_bad: int
    worst_rows: list

    def __str__(self):
        verdict = "correct" if self.correct else "INCORRECT"
        return (
            f"Results are {verdict}: max |err| = {self.max_err:.3e} "
            f"(tol {ORACLE_ATOL}), {self.num_bad} rows out of tolerance"
        )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def check_engine(engine, forest: ForestSpec, data, atol: float = ORACLE_ATOL,
                 *, want=None) -> ParityReport:
    """Compare an engine's predictions on ``data`` (numpy or a tensor on the
    engine's device) against the CPU oracle. ``want``, the oracle's
    predictions for ``data`` computed once, saves recomputing them for
    every engine that runs the same rows."""
    got = _host(engine.predict(data))
    if want is None:
        want = oracle.predict(forest, _host(data).astype(np.float32))
    err = np.abs(got - np.asarray(want))
    bad = np.flatnonzero(err > atol)
    worst = bad[np.argsort(err[bad])[::-1]][:10].tolist() if bad.size else []
    return ParityReport(
        correct=bool(bad.size == 0),
        max_err=float(err.max(initial=0.0)),
        num_bad=int(bad.size),
        worst_rows=worst,
    )
