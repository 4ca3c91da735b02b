"""The probe kernels' plain versions (ops/probes.py) against a short numpy
rendering of the same arithmetic, on the CPU; kernel B's visit body, which
the walk probes share, fed the real walk against the JAX package's
RankFoldEngine (interpret mode); kernel B's L1 reckoning on hand-built
walks; the probe scripts without a card. The kernels themselves are held to
these plain versions, exactly, in tests/test_torch_cuda.py and by
chip_smoke.py phase 13 on the card.

The JAX package's own probes (scripts/overhead_bench.py ``noop_margins``,
scripts/unit_bench.py ``variant_margins``, scripts/int8_cast_probe.py) are
defined inside the ``main()`` of scripts that run only on a TPU (they reach
``pltpu`` and ops/mosaic.py), so no test can call them; the numpy renderings
here stand in for them.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tahoe_tpu.forest import compiler as jax_compiler
from tahoe_tpu.forest import synthetic as jax_synthetic
from tahoe_tpu.ops.rank_kernel import RankFoldEngine as JaxRankFoldEngine
from tahoe_tpu_torch.forest import synthetic
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops.probes import (
    INT8_MODES,
    int8_probe,
    walk_probe,
)
from tahoe_tpu_torch.ops.rank_kernel import (
    RankFoldEngine,
    rank_block_rows,
    rank_row_words,
    rank_walk,
    rank_wavefronts,
    walk_paths,
    warp_visit_counts,
)
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
    return eng.transform(data), t.records, t.leaf, t.depth


def _np_staged_sum(p):
    """S of one row ``p`` (int8 [128G]): its words as kernel B stages them,
    the int16 pair values at one group, the bytes and 9 zero words past it."""
    K = p.size
    if K > 128:
        return int(p.view(np.int32).astype(np.int64).sum()) & M32
    q = np.concatenate([p.astype(np.int64), np.zeros(32, np.int64)])
    s = 0
    for w in range(K // 2 + 1):
        v = [127 * q[l] + q[l + 30] if l < K else 0 for l in (2 * w, 2 * w + 1)]
        s += (v[0] & 0xFFFF) | ((v[1] & 0xFFFF) << 16)
    return s & M32


def _np_diff(p, lane, k):
    """127 * p[lane] + p[lane + 30] + k, p zero past the row."""
    q = np.concatenate([p.astype(np.int64), np.zeros(32, np.int64)])
    return 127 * q[lane] + q[lane + 30] + k


def _np_leaf(p, rec, depth):
    """The leaf kernel B's walk reaches on row ``p`` over one tree's records."""
    n = 0
    for d in range(depth):
        x = int(rec[n])
        n += (1 + int(_np_diff(p, x & 0xFFF, x >> 12) >= 0)) << d
    return n - ((1 << depth) - 1)


def _np_walk_probe(planes, records, leaf, depth, mode):
    P = planes.numpy()
    rec = records.numpy().astype(np.int64)
    bits = leaf.numpy().view(np.int32).astype(np.int64) & M32
    T, N = rec.shape[0], (1 << depth) - 1
    out = []
    for r in range(P.shape[0]):
        acc = _np_staged_sum(P[r])
        for t in range(T if mode != "noop" else 0):
            if mode == "descent":
                key = _mix32((t * 0x9E3779B1 + 0x85EBCA6B) & M32)
                n = 0
                for d in range(depth):
                    g = ((key ^ n) * 0x2C1B3C6D) & M32
                    lane = (g * (P.shape[1] + 1)) >> 32
                    c = _np_diff(P[r], lane, ((g >> 8) & 0x7FFF) - 16384) >= 0
                    n += (1 + c) << d
                part = j = n - N
            else:  # the real walk's path
                j, part = _np_leaf(P[r], rec[t], depth), 0
                if mode == "paths":
                    acc += j
                    continue
                for d in range(depth):
                    x = int(rec[t, (1 << d) - 1 + (j & ((1 << d) - 1))])
                    if mode == "stream":
                        part ^= x & M32
                    else:
                        part += int(_np_diff(P[r], x & 0xFFF, x >> 12) >= 0) << d
            acc += part + int(bits[t, j])
        out.append(_i32(acc))
    return out


@pytest.mark.parametrize("groups", [1, 2])
def test_overhead_plain_matches_numpy(groups):
    """noop, stream and paths (tahoe_probe_overhead): S; then the XOR of the
    real walk's records and its leaf's bits; then the given leaves alone,
    against numpy."""
    planes, records, leaf, depth = _small(groups)
    paths = walk_paths(planes, records, depth)
    assert paths.shape == (2, 40, 8) and paths.dtype == torch.uint8
    for mode in ("noop", "stream", "paths"):
        got = walk_probe(planes, records, leaf, depth, mode, paths).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, _np_walk_probe(planes, records, leaf, depth, mode))


@pytest.mark.parametrize("groups", [1, 2])
def test_rank_parts_plain_matches_numpy(groups):
    """dot and descent (tahoe_probe_rank_parts): kernel B's visit body on
    the real walk's given path, and its dependent walk over hashed nodes,
    against numpy."""
    planes, records, leaf, depth = _small(groups)
    paths = walk_paths(planes, records, depth)
    for mode in ("dot", "descent"):
        got = walk_probe(planes, records, leaf, depth, mode, paths).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, _np_walk_probe(planes, records, leaf, depth, mode))


def test_probe_modes_are_checked():
    planes, records, leaf, depth = _small()
    for mode in ("fold", "dma", "matmul"):
        with pytest.raises(ValueError, match="mode"):
            walk_probe(planes, records, leaf, depth, mode)
    with pytest.raises(ValueError, match="depth 8"):
        walk_paths(planes, records, 9)
    for mode in ("stream", "paths", "dot"):
        with pytest.raises(ValueError, match="paths"):
            walk_probe(planes, records, leaf, depth, mode)


# (trees, depth, cols, leaf_prob, hot_swap): early leaves (pass-through
# records), a hot-child-swapped forest (the neg form)
WALK_CASES = {"early_leaves": (30, 6, 12, 0.35, False),
              "hot_swapped": (25, 7, 18, 0.1, True)}


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_visit_body_on_the_real_walk_matches_jax(name):
    """Kernel B's visit body (rank_kernel.record_conds, the plain ``dot``
    probe's body) fed the real walk (rank_walk) gives the JAX engine's
    margins in interpret mode within 1e-5."""
    trees, depth, cols, leaf_prob, swap = WALK_CASES[name]
    forest = jax_synthetic.generate_forest(trees, depth, cols, leaf_prob=leaf_prob,
                                           seed=trees + depth)
    if swap:
        forest = jax_compiler.hot_child_swap(forest)
    data = jax_synthetic.generate_data(48, cols, missing_prob=0.1, seed=depth)
    eng = RankFoldEngine(from_arrays(dataclasses.asdict(forest)), device="cpu")
    t = eng.tables
    planes = eng.transform(data)
    walk = rank_walk(planes, t.records, t.depth)
    assert walk.shape == (t.depth + 1, 48, trees)
    paths = walk_paths(planes, t.records, t.depth)
    assert torch.equal(paths.transpose(0, 1).reshape(48, -1)[:, :trees].long(),
                       walk[-1])
    lanes = t.records[torch.arange(trees), walk[-2]] & 0xFFF
    if name == "early_leaves":
        assert (lanes == 128 * t.groups).any()  # a pass-through visited
    T = t.leaf.shape[0]
    margins = t.leaf[torch.arange(T), walk[-1]].double().sum(dim=1).float()
    jeng = JaxRankFoldEngine(forest, interpret=True, row_tile=16, tree_tile=16)
    np.testing.assert_allclose(eng._finish(margins).numpy(),
                               np.asarray(jeng.predict(data)), atol=1e-5, rtol=0)


def test_rank_wavefronts_on_hand_built_walks():
    """Kernel B's L1 reckoning: 32 rows of a warp at one lane -> 1 shared
    wavefront (the odd stride puts row r in bank r + c); at words 2r of the
    pair staging (banks 3r, 32 distinct) -> 1; at words -r (all in bank 0)
    -> 32; a level of <= 32 records in one 128-byte line -> 1 line; 32
    records 8 words apart -> 8 lines, 32 sectors."""
    assert rank_row_words(1) == 65 and rank_block_rows(1) == 256
    assert rank_row_words(2) == 73 and rank_row_words(16) == 521
    assert rank_block_rows(16) == 32
    rows = torch.arange(64)
    same = torch.full((64,), 7)
    c = warp_visit_counts(same, same, rows, 1)
    assert c["wavefronts"].tolist() == [1, 1]
    assert c["lines"].tolist() == [1, 1] and c["sectors"].tolist() == [1, 1]
    c = warp_visit_counts(rows % 32, 4 * rows % 64, rows, 1)
    assert c["wavefronts"].tolist() == [1, 1]
    assert c["lines"].tolist() == [1, 1] and c["sectors"].tolist() == [4, 4]
    c = warp_visit_counts(rows % 32, 2 * (-rows % 32), rows, 1)
    assert c["wavefronts"].tolist() == [32, 32]
    c = warp_visit_counts(8 * rows, 2 * (rows % 32), rows, 1)
    assert c["lines"].tolist() == [8, 8] and c["sectors"].tolist() == [32, 32]
    # byte staging (two groups): two reads a visit, each a broadcast here
    assert warp_visit_counts(same, same, rows, 2)["wavefronts"].tolist() == [2, 2]
    # the real walks: level 0 is one record (the root) for the whole warp
    planes, records, leaf, depth = _small()
    eng = RankFoldEngine(synthetic.generate_forest(9, 4, 12, leaf_prob=0.1, seed=5),
                         device="cpu")
    w = rank_wavefronts(planes[:32], eng.tables)
    assert w["rows"] == 32 and w["per_level"]["lines"][0] == 1.0
    assert w["per_level"]["sectors"][0] == 1.0


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
