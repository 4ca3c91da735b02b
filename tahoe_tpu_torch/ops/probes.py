"""Probe kernels (csrc/probes.cu) and their plain PyTorch versions.

They measure in parts, on the card, the record walk that kernel B
(csrc/rank_fold.cu) runs, on kernel B's own launch and inputs, and whether
in-kernel int8 products are exact, for tahoe_tpu_torch/scripts/
{int8_cast_probe,overhead_bench,unit_bench}.py. Each entry point has a plain
version that computes the same integers, and the card's results are held to
it exactly. The port's engines never call them.

The walk's four modes (``walk_probe``; csrc/probes.cu states the arithmetic)
each write one int32 a row, all sums mod 2^32: S, the sum of the row's
staged words (kernel B's staging: int16 pair values at one plane group, the
bytes past it), plus per tree a part and the f32 bits of one leaf j.

- ``noop`` (tahoe_probe_overhead mode 0): S alone;
- ``stream`` (mode 1): part = the XOR of the D records on the path to the
  leaf j given for each (row, tree) (``paths``, ``rank_kernel.walk_paths``:
  the real walk's, so that the loads are kernel B's own);
- ``paths`` (mode 2): S plus each given j, with no record and no leaf read:
  what reading the path words costs ``stream`` and ``dot``, which kernel B
  does not pay;
- ``dot`` (tahoe_probe_rank_parts mode 0): part = sum of cond_d << d, kernel
  B's visit body (``rank_kernel.record_conds``) at the same path's nodes;
  on the real walk that is j again;
- ``descent`` (mode 1): kernel B's dependent walk n += (1 + cond) << d with
  node n of tree t read from no record: g = (key_t ^ n) * C3 mod 2^32,
  key_t = mix32(t * C1 + C2), lane = (g * (128G + 1)) >> 32,
  k = ((g >> 8) & 0x7FFF) - 16384; part = j, the leaf it reaches.
"""
from __future__ import annotations

import ctypes

import torch

from tahoe_tpu_torch.ops._build import CudaKernel, check_operand, ptr
from tahoe_tpu_torch.ops.rank_kernel import (
    RANK_PAIR_GROUPS,
    _int32_matmul,
    pair_values,
    record_conds,
)
from tahoe_tpu_torch.ops.rank_transform import LANE

PROBE_INT8 = CudaKernel(
    "tahoe_probe_int8",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/probes.cu",
    replaces="scripts/int8_cast_probe.py:52",
)
# both walk probes take kernel B's arguments, the paths and a mode
_WALK_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p]
PROBE_OVERHEAD = CudaKernel(
    "tahoe_probe_overhead", _WALK_ARGS,
    source="tahoe_tpu_torch/csrc/probes.cu",
    replaces="scripts/overhead_bench.py:138",
)
PROBE_RANK_PARTS = CudaKernel(
    "tahoe_probe_rank_parts", _WALK_ARGS,
    source="tahoe_tpu_torch/csrc/probes.cu",
    replaces="scripts/unit_bench.py:203",
)

INT8_MODES = ("store", "dot_lhs_dp4a", "dot_lhs_mma", "scratch_dot_dp4a",
              "scratch_dot_mma")
OVERHEAD_MODES = ("noop", "stream", "paths")
RANK_PARTS_MODES = ("dot", "descent")
WALK_MODES = OVERHEAD_MODES + RANK_PARTS_MODES
PATH_MODES = ("stream", "paths", "dot")  # the modes that read ``paths``
# the descent's hash constants (csrc/probes.cu)
C1, C2, C3 = 0x9E3779B1, 0x85EBCA6B, 0x2C1B3C6D
INT8_WIDTH = 128  # the probe's contraction and output widths

MASK32 = 0xFFFFFFFF


def _mode(mode: str, modes: tuple) -> int:
    if mode not in modes:
        raise ValueError(f"mode {mode!r} is not one of {modes}")
    return modes.index(mode)


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> int32 with the same low 32 bits."""
    v = v & MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def mix32(v: torch.Tensor) -> torch.Tensor:
    """csrc/probes.cu mix32 on int64 tensors holding values < 2^32 (both
    multipliers are < 2^31, so no product leaves int64)."""
    v = v ^ (v >> 16)
    v = (v * 0x2C1B3C6D) & MASK32
    v = v ^ (v >> 12)
    v = (v * 0x297A2D39) & MASK32
    return v ^ (v >> 15)


# ------------------------------------------------------------------ int8 --
def int8_probe_plain(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of tahoe_probe_int8: ``store`` is x wrapped to int8 (as
    numpy's astype), ``dot_lhs_*`` is (x > 0) @ W and ``scratch_dot_*`` is
    int8(x) @ W, exact in int32."""
    m = _mode(mode, INT8_MODES)
    if m == 0:
        return x.to(torch.int8)
    lhs = (x > 0).to(torch.int8) if mode.startswith("dot_lhs") else x.to(torch.int8)
    return _int32_matmul(lhs.contiguous(), w)


def int8_probe_cuda(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    dev = x.device
    check_operand(x, "x", torch.int32, dev, 2)
    check_operand(w, "w", torch.int8, dev, 2)
    m = _mode(mode, INT8_MODES)
    M = x.shape[0]
    if x.shape[1] != INT8_WIDTH or w.shape != (INT8_WIDTH, INT8_WIDTH) or M % 16:
        raise ValueError(f"the int8 probe takes x [16k, {INT8_WIDTH}] and w "
                         f"[{INT8_WIDTH}, {INT8_WIDTH}]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    out = torch.empty(M, INT8_WIDTH, dtype=torch.int8 if m == 0 else torch.int32,
                      device=dev)
    PROBE_INT8.launch(dev, ptr(x), M, ptr(w), m, ptr(out))
    return out


def int8_probe(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """The probe kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return int8_probe_plain(x, w, mode)
    return int8_probe_cuda(x, w, mode)


# ------------------------------------------------------- kernel B parts --
def staged_sum(planes: torch.Tensor) -> torch.Tensor:
    """S per row, [R] int64 mod 2^32: the sum of the row's words as kernel B
    stages them. At <= RANK_PAIR_GROUPS groups word w is v[2w] | v[2w + 1]
    << 16 (``pair_values``, int16 each); past them the plane words, then
    zeros."""
    if planes.shape[1] // LANE > RANK_PAIR_GROUPS:
        words = planes.contiguous().view(torch.int32).to(torch.int64)
        return words.sum(dim=1) & MASK32
    v = pair_values(planes).to(torch.int64) & 0xFFFF   # lanes [0, 128G]
    v = torch.nn.functional.pad(v, (0, 1))             # word 64G's high half
    return ((v[:, 0::2] | (v[:, 1::2] << 16)).sum(dim=1)) & MASK32


def walk_probe_plain(planes: torch.Tensor, records: torch.Tensor,
                     leaf: torch.Tensor, depth: int, mode: str,
                     paths: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of both walk probes (the module docstring), [R] int32;
    ``stream``, ``paths`` and ``dot`` take ``paths``
    (``rank_kernel.walk_paths``)."""
    _mode(mode, WALK_MODES)
    if mode in PATH_MODES and paths is None:
        raise ValueError(f"mode {mode} takes the walks' paths")
    R, dev = planes.shape[0], planes.device
    T, N = records.shape[0], (1 << depth) - 1
    acc = staged_sum(planes)
    if mode == "noop":
        return _to_int32(acc)
    tree = torch.arange(T, device=dev)
    v = pair_values(planes)
    bits = leaf.contiguous().view(torch.int32).to(torch.int64) & MASK32
    if mode == "descent":
        key = mix32((tree * C1 + C2) & MASK32)[None, :]
        n = torch.zeros(R, T, dtype=torch.int64, device=dev)
        for d in range(depth):
            g = ((key ^ n) * C3) & MASK32
            lane = (g * v.shape[1]) >> 32
            k = ((g >> 8) & 0x7FFF) - 16384
            n = n + ((1 + (torch.gather(v, 1, lane) + k >= 0).long()) << d)
        part = j = n - N
    else:
        j = paths.transpose(0, 1).reshape(R, -1)[:, :T].long()
        if mode == "paths":
            return _to_int32(acc + j.sum(dim=1))
        part = torch.zeros(R, T, dtype=torch.int64, device=dev)
        for d in range(depth):
            node = (1 << d) - 1 + (j & ((1 << d) - 1))
            if mode == "stream":
                part = part ^ (records[tree, node].to(torch.int64) & MASK32)
            else:
                part = part + (record_conds(v, records, node).long() << d)
    acc = acc + (part + bits[tree, j]).sum(dim=1)
    return _to_int32(acc)


def walk_probe_cuda(planes: torch.Tensor, records: torch.Tensor,
                    leaf: torch.Tensor, depth: int, mode: str,
                    paths: torch.Tensor | None = None) -> torch.Tensor:
    """The walk probe of ``mode`` on the card: ``noop``, ``stream`` and
    ``paths`` are tahoe_probe_overhead's, ``dot`` and ``descent``
    tahoe_probe_rank_parts'."""
    _mode(mode, WALK_MODES)
    dev = planes.device
    check_operand(planes, "planes", torch.int8, dev, 2)
    check_operand(records, "records", torch.int32, dev, 2)
    check_operand(leaf, "leaf", torch.float32, dev, 2)
    R, K = planes.shape
    T = records.shape[0]
    if K % LANE or not 1 <= K // LANE <= 16:
        raise ValueError(f"planes width {K} is not 128 x 1..16 groups")
    if (T < 1 or records.shape[1] != (1 << depth) - 1
            or leaf.shape != (T, 1 << depth)):
        raise ValueError(f"tables {tuple(records.shape)} / {tuple(leaf.shape)} "
                         f"do not match depth {depth}")
    if mode in PATH_MODES:
        if paths is None:
            raise ValueError(f"mode {mode} takes the walks' paths")
        check_operand(paths, "paths", torch.uint8, dev, 3)
        if paths.shape != (-(-T // 8), R, 8) or depth > 8:
            raise ValueError(f"paths {tuple(paths.shape)} do not match {R} rows "
                             f"of {T} trees of depth {depth} <= 8")
    overhead = mode in OVERHEAD_MODES
    kernel = PROBE_OVERHEAD if overhead else PROBE_RANK_PARTS
    index = _mode(mode, OVERHEAD_MODES if overhead else RANK_PARTS_MODES)
    out = torch.empty(R, dtype=torch.int32, device=dev)
    kernel.launch(dev, ptr(planes), R, K // LANE, ptr(records), T, depth,
                  ptr(leaf), None if mode not in PATH_MODES else ptr(paths),
                  index, ptr(out))
    return out


def walk_probe(planes, records, leaf, depth, mode, paths=None):
    """The probe kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if planes.device.type == "cpu":
        return walk_probe_plain(planes, records, leaf, depth, mode, paths)
    return walk_probe_cuda(planes, records, leaf, depth, mode, paths)
