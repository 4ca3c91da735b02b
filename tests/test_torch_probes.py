"""The probe kernels' plain versions (ops/probes.py) against a short numpy
rendering of the same arithmetic, on the CPU; the probe scripts without a
card. The kernels themselves are held to these plain versions, exactly, in
tests/test_torch_cuda.py and by chip_smoke.py phase 13 on the card."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tahoe_tpu_torch.forest import synthetic
from tahoe_tpu_torch.ops.probes import (
    INT8_MODES,
    int8_probe,
    overhead_probe,
    rank_parts_probe,
)
from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
from tahoe_tpu_torch.scripts import int8_cast_probe

ROOT = Path(__file__).resolve().parents[1]
M32 = 0xFFFFFFFF


def _mix32(v: int) -> int:
    v ^= v >> 16
    v = (v * 0x2C1B3C6D) & M32
    v ^= v >> 12
    v = (v * 0x297A2D39) & M32
    return v ^ (v >> 15)


def _i32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


@pytest.mark.parametrize("mode", INT8_MODES)
def test_int8_plain_is_numpy_wrap_and_int32_product(mode):
    x32, w8 = int8_cast_probe.inputs()
    x32[0, :4] = [127, 128, -129, 255]  # values that wrap
    got = int8_probe(torch.as_tensor(x32), torch.as_tensor(w8), mode).numpy()
    if mode == "store":
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, x32.astype(np.int8))
        assert list(got[0, :4]) == [127, -128, 127, -1]
        return
    lhs = (x32 > 0) if mode.startswith("dot_lhs") else x32.astype(np.int8)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, lhs.astype(np.int64) @ w8.astype(np.int64))
    np.testing.assert_array_equal(
        got, int8_cast_probe.numpy_reference(x32, w8, mode))


def _small(groups=1):
    """A small forest's rank tables and planes (one or two plane groups)."""
    cols = 12 if groups == 1 else 40
    forest = synthetic.generate_forest(9, 4, cols, leaf_prob=0.1, seed=5)
    data = synthetic.generate_data(40, cols, missing_prob=0.1, seed=6)
    eng = RankFoldEngine(forest, device="cpu")
    assert eng.groups == groups
    t = eng.tables
    return eng.transform(data), t.mats, t.leaf, t.depth


@pytest.mark.parametrize("mode", INT8_MODES)
def test_int8_plain_at_other_row_counts(mode):
    """inputs() is the original probe's at 256 rows; at 272 rows (a last
    tile of 16) the plain version is numpy's wrap and int32 product too."""
    x256, w256 = int8_cast_probe.inputs()
    x, w = int8_cast_probe.inputs(256)
    assert np.array_equal(x, x256) and np.array_equal(w, w256)
    x32, w8 = int8_cast_probe.inputs(272)
    assert x32.shape == (272, 128) and w8.shape == (128, 128)
    got = int8_probe(torch.as_tensor(x32), torch.as_tensor(w8), mode).numpy()
    np.testing.assert_array_equal(got, int8_cast_probe.numpy_reference(x32, w8, mode))


@pytest.mark.parametrize("groups", [1, 2])
def test_overhead_plain_matches_numpy(groups):
    planes, mats, _, depth = _small(groups)
    p, m = planes.numpy(), mats.numpy()
    sums = p.astype(np.int64).sum(axis=1)
    x = 0
    for t in range(m.shape[0]):
        for d in range(depth):
            for w in m[t, (1 << d) - 1].view(np.int32):
                x ^= int(w) & M32
    noop = overhead_probe(planes, mats, depth, "noop").numpy()
    stream = overhead_probe(planes, mats, depth, "stream").numpy()
    assert noop.dtype == stream.dtype == np.int32
    np.testing.assert_array_equal(noop, sums)
    np.testing.assert_array_equal(stream, [_i32((int(s) & M32) ^ x) for s in sums])


@pytest.mark.parametrize("groups", [1, 2])
def test_rank_parts_plain_matches_numpy(groups):
    planes, mats, leaf, depth = _small(groups)
    p = planes.numpy().astype(np.int64)
    m = mats.numpy().astype(np.int64)
    bits = leaf.numpy().view(np.int32)
    T = m.shape[0]
    dot, descent = [], []
    for r in range(p.shape[0]):
        acc = 0
        for t in range(T):
            h = _mix32(((r * 0x9E3779B1) & M32) ^ ((t * 0x85EBCA6B) & M32))
            for d in range(depth):
                acc += int(p[r] @ m[t, (1 << d) - 1 + (h & ((1 << d) - 1))])
        dot.append(_i32(acc))
        key = int(planes[r].numpy().view(np.int32).astype(np.int64).sum()) & M32
        acc = 0
        for t in range(T):
            j = 0
            for d in range(depth):
                c = _mix32(key ^ ((t * 0x9E3779B1) & M32)
                           ^ ((d * 0x85EBCA6B) & M32) ^ j) >> 31
                j += c << d
            acc += int(bits[t, j])
        descent.append(_i32(acc))
    np.testing.assert_array_equal(
        rank_parts_probe(planes, mats, leaf, depth, "dot").numpy(), dot)
    np.testing.assert_array_equal(
        rank_parts_probe(planes, mats, leaf, depth, "descent").numpy(), descent)


def test_probe_modes_are_checked():
    planes, mats, leaf, depth = _small()
    with pytest.raises(ValueError, match="mode"):
        rank_parts_probe(planes, mats, leaf, depth, "fold")
    with pytest.raises(ValueError, match="mode"):
        overhead_probe(planes, mats, depth, "dma")


@pytest.mark.parametrize("name", ["int8_cast_probe", "overhead_bench",
                                  "unit_bench", "path_time"])
def test_probe_script_exits_2_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", f"tahoe_tpu_torch.scripts.{name}"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("mode", ["a", "b", "fused", "int8"])
def test_kernel_ab_exits_2_without_a_card(tmp_path, mode):
    """The kernel A/B probe builds nothing and prints nothing without a card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    other = tmp_path / "rank_transform.cu"
    other.write_text("")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "tahoe_tpu_torch.scripts.kernel_ab", mode,
         *([] if mode == "b" else [str(other)])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr, proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("timer", ["cuda_median_ms", "cuda_device_ms"])
def test_timers_refuse_without_a_card(timer):
    """A device time is never taken on the CPU: both timers raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from tahoe_tpu_torch.utils import profiling

    calls = []
    with pytest.raises(RuntimeError, match="CUDA device"):
        getattr(profiling, timer)(lambda: calls.append(1))
    assert calls == []
