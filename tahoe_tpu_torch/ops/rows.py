"""Row canonicalization: raw f32 rows -> the rows the kernels read.

One function for what the JAX package does in four places
(rank_kernel.py:1063, rank_transform.py:596, fold_kernel.py:464 and :918):

- missing -> NaN: ``isnan(x)`` for a NaN sentinel, ``|x - sentinel| <=
  MISSING_EPS`` for a finite one (the reference's rule, Struct.h:380-383);
- the column gather (``col_index``: used-feature compaction and, for the rank
  engine, the banded virtual features' source columns);
- the fold's dual ``[x, -x]`` lanes (compiler.ge_normalize).

It runs in two steps: ``stage_rows`` reads the raw rows once (the column
gather, or a copy into a given buffer), outside an engine's CUDA graph;
``finish_rows`` tests for missing values and adds the dual lanes, inside
it. A value's missing test does not depend on its column, so testing after
the gather gives the same rows.

The CUDA kernels need no lane padding, so none is added. ``missing_mask``
is the missing test on its own, for the plain torch engines that test rows
as they gather them, and ``map_row_chunks`` runs those engines over a batch
in row chunks bounded by bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from tahoe_tpu_torch.config import MISSING_EPS

# the plain torch engines (gather, sparse gather, tensor) take a batch in row
# chunks; this bounds the bytes of one chunk's working tensors
ROW_CHUNK_BYTES = 256 << 20


def map_row_chunks(fn, x: torch.Tensor, bytes_per_row: int) -> torch.Tensor:
    """``fn`` over consecutive row chunks of ``x``, each of at most
    ``ROW_CHUNK_BYTES`` worth of ``bytes_per_row`` (and at least one row),
    concatenated; an empty ``x`` is one empty chunk."""
    step = max(1, ROW_CHUNK_BYTES // max(1, bytes_per_row))
    return torch.cat([fn(x[r:r + step])
                      for r in range(0, max(x.shape[0], 1), step)])


def missing_mask(x: torch.Tensor, missing: float) -> torch.Tensor:
    """The reference's missing test on f32 values: ``isnan(x)`` for a NaN
    sentinel, ``|x - sentinel| <= MISSING_EPS`` for a finite one."""
    if np.isnan(np.float32(missing)):
        return torch.isnan(x)
    # Python scalars keep the arithmetic in f32 (both are exact f32 values)
    # and cost no host-to-device copy
    sentinel = float(np.float32(missing))
    return torch.abs(x - sentinel) <= float(np.float32(MISSING_EPS))


def stage_rows(rows, *, device: torch.device,
               col_index: torch.Tensor | None = None,
               dtype: torch.dtype = torch.float32,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """rows [R, C] (numpy or tensor) -> [R, C'] of ``dtype`` on ``device``:
    the columns ``col_index`` (or all), written into ``out`` when it is
    given (ops/graphed.py: a graph's static input). The step of a predict
    that reads the raw rows: rows on the host reach the device here."""
    if out is not None and col_index is None:
        return out.copy_(_two_dim(torch.as_tensor(rows)))
    x = _two_dim(torch.as_tensor(rows, dtype=dtype, device=device))
    if col_index is None:
        return x
    return torch.index_select(x, 1, col_index, out=out)


def _two_dim(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"rows must be [R, C]; got shape {tuple(x.shape)}")
    return x


def finish_rows(x: torch.Tensor, missing: float, *,
                dual: bool = False) -> torch.Tensor:
    """Staged f32 rows (``stage_rows``) -> the kernels' rows: missing as
    NaN, ``[x, -x]`` lanes when ``dual``, contiguous."""
    if not np.isnan(np.float32(missing)):
        x = x.masked_fill(missing_mask(x, missing), float("nan"))
    if dual:
        x = torch.cat([x, -x], dim=1)
    return x.contiguous()


def canonicalize_rows(rows, missing: float, *, device: torch.device,
                      col_index: torch.Tensor | None = None,
                      dual: bool = False) -> torch.Tensor:
    """rows [R, C] (numpy or tensor) -> contiguous f32 [R, C'] on ``device``.

    C' is ``len(col_index)`` (or C), doubled when ``dual``."""
    return finish_rows(stage_rows(rows, device=device, col_index=col_index),
                       missing, dual=dual)
