"""Row canonicalization: raw f32 rows -> the rows the kernels read.

One function for what the JAX package does in four places
(rank_kernel.py:1063, rank_transform.py:596, fold_kernel.py:464 and :918):

- missing -> NaN: ``isnan(x)`` for a NaN sentinel, ``|x - sentinel| <=
  MISSING_EPS`` for a finite one (the reference's rule, Struct.h:380-383);
- the column gather (``col_index``: used-feature compaction and, for the rank
  engine, the banded virtual features' source columns);
- the fold's dual ``[x, -x]`` lanes (compiler.ge_normalize).

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


def canonicalize_rows(rows, missing: float, *, device: torch.device,
                      col_index: torch.Tensor | None = None,
                      dual: bool = False) -> torch.Tensor:
    """rows [R, C] (numpy or tensor) -> contiguous f32 [R, C'] on ``device``.

    C' is ``len(col_index)`` (or C), doubled when ``dual``."""
    x = torch.as_tensor(rows, dtype=torch.float32, device=device)
    if x.dim() != 2:
        raise ValueError(f"rows must be [R, C]; got shape {tuple(x.shape)}")
    if not np.isnan(np.float32(missing)):
        x = x.masked_fill(missing_mask(x, missing), float("nan"))
    if col_index is not None:
        x = x.index_select(1, col_index)
    if dual:
        x = torch.cat([x, -x], dim=1)
    return x.contiguous()
