"""Probe kernels (csrc/probes.cu) and their plain PyTorch versions.

They measure in parts, on the card, the column walk that kernel B
(csrc/rank_fold.cu) ran before it read node records, and whether
in-kernel int8 products are exact, for tahoe_tpu_torch/scripts/
{int8_cast_probe,overhead_bench,unit_bench}.py. Each entry point has a plain
version that computes the same integers, and the card's results are held to
it exactly. The port's engines never call them.
"""
from __future__ import annotations

import ctypes

import torch

from tahoe_tpu_torch.ops._build import CudaKernel, check_operand, ptr
from tahoe_tpu_torch.ops.rank_kernel import PLAIN_CHUNK_BYTES, _int32_matmul
from tahoe_tpu_torch.ops.rank_transform import LANE

PROBE_INT8 = CudaKernel(
    "tahoe_probe_int8",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/probes.cu",
    replaces="scripts/int8_cast_probe.py:52",
)
PROBE_OVERHEAD = CudaKernel(
    "tahoe_probe_overhead",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/probes.cu",
    replaces="scripts/overhead_bench.py:138",
)
PROBE_RANK_PARTS = CudaKernel(
    "tahoe_probe_rank_parts",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/probes.cu",
    replaces="scripts/unit_bench.py:203",
)

INT8_MODES = ("store", "dot_lhs_dp4a", "dot_lhs_mma", "scratch_dot_dp4a",
              "scratch_dot_mma")
OVERHEAD_MODES = ("noop", "stream")
RANK_PARTS_MODES = ("dot", "descent")
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
def _check_rank_operands(planes, mats, depth):
    dev = planes.device
    check_operand(planes, "planes", torch.int8, dev, 2)
    check_operand(mats, "mats", torch.int8, dev, 3)
    K = planes.shape[1]
    if K % LANE or not 1 <= K // LANE <= 16:
        raise ValueError(f"planes width {K} is not 128 x 1..16 groups")
    if mats.shape[1:] != ((1 << depth) - 1, K):
        raise ValueError(f"mats {tuple(mats.shape)} do not match depth {depth} "
                         f"and planes width {K}")
    return dev, K // LANE


def _xor_all(words: torch.Tensor) -> int:
    """XOR of every element of an int32 tensor, as a value < 2^32."""
    v = words.reshape(-1).to(torch.int64) & MASK32
    while v.numel() > 1:
        if v.numel() % 2:
            v = torch.cat([v, v.new_zeros(1)])
        v = v[0::2] ^ v[1::2]
    return int(v[0]) if v.numel() else 0


def overhead_probe_plain(planes: torch.Tensor, mats: torch.Tensor, depth: int,
                         mode: str) -> torch.Tensor:
    """Plain version of tahoe_probe_overhead: each row's plane-byte sum
    (``noop``), XOR every word of the columns at node 2^d - 1 of each level
    of each tree (``stream``), as int32."""
    m = _mode(mode, OVERHEAD_MODES)
    s = planes.to(torch.int64).sum(dim=1)
    if m == 1 and depth:
        nodes = [(1 << d) - 1 for d in range(depth)]
        s = (s & MASK32) ^ _xor_all(mats[:, nodes, :].contiguous().view(torch.int32))
    return _to_int32(s)


def overhead_probe_cuda(planes: torch.Tensor, mats: torch.Tensor, depth: int,
                        mode: str) -> torch.Tensor:
    dev, G = _check_rank_operands(planes, mats, depth)
    out = torch.empty(planes.shape[0], dtype=torch.int32, device=dev)
    PROBE_OVERHEAD.launch(dev, ptr(planes), planes.shape[0], G, ptr(mats),
                          mats.shape[0], depth, _mode(mode, OVERHEAD_MODES),
                          ptr(out))
    return out


def overhead_probe(planes, mats, depth, mode):
    """The probe kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if planes.device.type == "cpu":
        return overhead_probe_plain(planes, mats, depth, mode)
    return overhead_probe_cuda(planes, mats, depth, mode)


def probe_paths(rows: torch.Tensor, trees: int) -> torch.Tensor:
    """The ``dot`` probe's path hash h per (row, tree), [R, T] int64: node
    j_d = h & (2^d - 1) of level d."""
    t = torch.arange(trees, dtype=torch.int64, device=rows.device)
    r = (rows.to(torch.int64) * 0x9E3779B1) & MASK32
    return mix32(r[:, None] ^ ((t * 0x85EBCA6B) & MASK32)[None, :])


def rank_parts_probe_plain(planes: torch.Tensor, mats: torch.Tensor,
                           leaf: torch.Tensor, depth: int,
                           mode: str) -> torch.Tensor:
    """Plain version of tahoe_probe_rank_parts, as int32 (sums mod 2^32).

    ``dot``: the sum over trees and levels of planes . column(j_d);
    ``descent``: the sum over trees of the final leaf's f32 bits, after the
    walk j += (mix32(key ^ t*C1 ^ d*C2 ^ j) >> 31) << d with key the sum of
    the row's plane words."""
    m = _mode(mode, RANK_PARTS_MODES)
    R, K = planes.shape
    T = mats.shape[0]
    dev = planes.device
    if m == 0:
        total = torch.zeros(R, dtype=torch.int64, device=dev)
        chunk = max(1, PLAIN_CHUNK_BYTES // max(1, 4 * T * K))
        t = torch.arange(T, device=dev)
        for r0 in range(0, R, chunk):
            p = planes[r0:r0 + chunk].to(torch.int32)[:, None, :]
            h = probe_paths(torch.arange(r0, r0 + p.shape[0], device=dev), T)
            for d in range(depth):
                node = (1 << d) - 1 + (h & ((1 << d) - 1))          # [r, T]
                cols = mats[t[None, :], node].to(torch.int32)        # [r, T, K]
                total[r0:r0 + p.shape[0]] += (p * cols).sum(
                    dim=(1, 2), dtype=torch.int64)
        return _to_int32(total)
    words = planes.contiguous().view(torch.int32).to(torch.int64)
    key = words.sum(dim=1) & MASK32                                  # [R]
    t = torch.arange(T, dtype=torch.int64, device=dev)
    tc = (t * 0x9E3779B1) & MASK32
    j = torch.zeros(R, T, dtype=torch.int64, device=dev)
    for d in range(depth):
        c = mix32(key[:, None] ^ tc[None, :] ^ ((d * 0x85EBCA6B) & MASK32) ^ j) >> 31
        j = j + (c << d)
    bits = leaf.contiguous().view(torch.int32).to(torch.int64)[t[None, :], j]
    return _to_int32(bits.sum(dim=1))


def rank_parts_probe_cuda(planes: torch.Tensor, mats: torch.Tensor,
                          leaf: torch.Tensor, depth: int,
                          mode: str) -> torch.Tensor:
    dev, G = _check_rank_operands(planes, mats, depth)
    check_operand(leaf, "leaf", torch.float32, dev, 2)
    if leaf.shape != (mats.shape[0], 1 << depth):
        raise ValueError(f"leaf {tuple(leaf.shape)} does not match mats")
    out = torch.empty(planes.shape[0], dtype=torch.int32, device=dev)
    PROBE_RANK_PARTS.launch(dev, ptr(planes), planes.shape[0], G, ptr(mats),
                            mats.shape[0], depth, ptr(leaf),
                            _mode(mode, RANK_PARTS_MODES), ptr(out))
    return out


def rank_parts_probe(planes, mats, leaf, depth, mode):
    """The probe kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if planes.device.type == "cpu":
        return rank_parts_probe_plain(planes, mats, leaf, depth, mode)
    return rank_parts_probe_cuda(planes, mats, leaf, depth, mode)
