"""Rank transform: canonicalized f32 rows -> int8 rank planes (kernel A).

The port of tahoe_tpu/ops/rank_transform.py. Per (row, virtual feature f)
it computes the exact rank ``q = #{u in U_f : u <= x}`` of the row's value
among the feature's sorted thresholds (quantize.transform_rows_np) and
writes the base-127 plane lanes of compiler.rank_normalize
(quantize.encode_rank_planes_np), per 30-feature group of 128 lanes:

    [0,30) qh | [30,60) ql | [60,90) -qh | [90,120) -ql | 120: 127 | 121: 1

with qh = q // 127, ql = q - 127*qh, and -128 in all four segments for a
missing (NaN) value. The TPU kernels found the rank with one-hot digit
matmuls because Mosaic has no vector gather; here the CUDA kernel
(csrc/rank_transform.cu) searches a coarse index of each feature's table in
shared memory, then counts within one 16-threshold window, and the plain
version below uses ``torch.searchsorted``. Both give the same rank.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from tahoe_tpu_torch.forest.compiler import RANK_BASE, RANK_GROUP_COLS, rank_groups
from tahoe_tpu_torch.ops._build import CudaKernel, check_operand, ptr

LANE = 128
TABLE_ALIGN = 16  # csrc/rank_transform.cu kWindow

RANK_PLANES = CudaKernel(
    "tahoe_rank_planes",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/rank_transform.cu",
    replaces="tahoe_tpu/ops/rank_transform.py:428",
)


def threshold_table(tables, *, device: torch.device):
    """Per-feature sorted thresholds -> (thresholds [F, K] f32 padded with
    +inf past each feature's count, counts [F] int32), K a multiple of
    TABLE_ALIGN.

    The counts bound every search, so a +inf pad never counts toward a rank
    (an x of +inf included). K rounds up to TABLE_ALIGN thresholds so that
    each of kernel A's 16-threshold windows is an aligned 64 bytes."""
    k = max((len(t) for t in tables), default=0)
    k = max(1, -(-k // TABLE_ALIGN)) * TABLE_ALIGN
    thr = np.full((len(tables), k), np.inf, np.float32)
    for f, t in enumerate(tables):
        thr[f, : len(t)] = t
    counts = np.asarray([len(t) for t in tables], np.int32)
    return (torch.as_tensor(thr, device=device),
            torch.as_tensor(counts, device=device))


def assemble_planes(q: torch.Tensor, miss: torch.Tensor) -> torch.Tensor:
    """Ranks [R, F] (int) + missing mask [R, F] -> int8 planes [R, 128*G].

    Lanes of a group past the last feature stay 0, as in
    quantize.encode_rank_planes_np."""
    R, nf = q.shape
    G = rank_groups(nf)
    pad = G * RANK_GROUP_COLS - nf
    q = F.pad(q.to(torch.int32), (0, pad)).view(R, G, RANK_GROUP_COLS)
    miss = F.pad(miss, (0, pad)).view(R, G, RANK_GROUP_COLS)
    qh = torch.div(q, RANK_BASE, rounding_mode="floor")
    ql = q - RANK_BASE * qh
    segs = [torch.where(miss, -128, v) for v in (qh, ql, -qh, -ql)]
    tail = torch.zeros(R, G, LANE - 4 * RANK_GROUP_COLS, dtype=torch.int32,
                       device=q.device)
    tail[:, :, 0] = 127
    tail[:, :, 1] = 1
    return torch.cat(segs + [tail], dim=2).to(torch.int8).reshape(R, LANE * G)


def rank_planes_plain(x: torch.Tensor, thresholds: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A: x [R, F] f32 (NaN = missing) ->
    int8 planes [R, 128*G]."""
    q = torch.searchsorted(thresholds, x.t().contiguous(), right=True).t()
    q = torch.minimum(q, counts.to(q.dtype))
    return assemble_planes(q, torch.isnan(x))


def aligned_table(thresholds: torch.Tensor) -> torch.Tensor:
    """``thresholds`` as kernel A takes it: K a multiple of TABLE_ALIGN and
    16-byte-aligned storage. A table from :func:`threshold_table` already is;
    any other is copied with +inf appended, which the counts keep out of
    every rank."""
    nf, k = thresholds.shape
    pad = -k % TABLE_ALIGN
    if pad == 0 and thresholds.data_ptr() % 16 == 0:
        return thresholds
    out = thresholds.new_full((nf, k + pad), float("inf"))
    out[:, :k] = thresholds
    return out


def rank_planes_cuda(x: torch.Tensor, thresholds: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """Kernel A on the card (csrc/rank_transform.cu)."""
    dev = x.device
    check_operand(x, "x", torch.float32, dev, 2)
    check_operand(thresholds, "thresholds", torch.float32, dev, 2)
    check_operand(counts, "counts", torch.int32, dev, 1)
    R, nf = x.shape
    if thresholds.shape[0] != nf or counts.shape[0] != nf:
        raise ValueError(f"tables cover {thresholds.shape[0]} features, x has {nf}")
    thresholds = aligned_table(thresholds)
    G = rank_groups(nf)
    out = torch.empty(R, LANE * G, dtype=torch.int8, device=dev)
    RANK_PLANES.launch(dev, ptr(x), R, nf, G, ptr(thresholds),
                       thresholds.shape[1], ptr(counts), ptr(out))
    return out


def rank_planes(x: torch.Tensor, thresholds: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return rank_planes_plain(x, thresholds, counts)
    return rank_planes_cuda(x, thresholds, counts)
