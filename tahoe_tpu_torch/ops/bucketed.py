"""Depth-bucketed execution (DEPTH_BUCKETED) over the port's kernels.

The port of tahoe_tpu/ops/bucketed.py. Trained forests mix shallow and deep
trees but are stored as complete trees of the global maximum depth, so a
dense engine pays the deepest tree's price for every tree. This strategy
partitions the trees by reachable depth (``plan_buckets``), truncates each
bucket to its own depth (exact) and runs one sub-engine per bucket, summing
the margins before one output transform. A bucket of depth-0 trees folds to
a constant margin.

Two variants, no kernel of their own:

- ``DepthBucketedRankEngine``: one quantization of the whole forest, one
  kernel-A plane transform per batch, then kernel B once per bucket;
- ``DepthBucketedFoldEngine``: one row canonicalization in the form chosen
  for the whole forest (dual ge up to 64 columns, non-ge for 65-128), then
  kernel C or the deep kernel once per bucket.

``plan_buckets`` and ``subset_trees`` are numpy, as in the JAX module, but
that module imports jax, so they live here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from tahoe_tpu_torch.config import resolve_device
from tahoe_tpu_torch.forest.compiler import (
    RANK_MAX_COLS,
    rank_groups,
    reachable_depths,
    truncate_depth,
)
from tahoe_tpu_torch.forest.quantize import band_split, quantize
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops.fold_kernel import (
    MAX_DUAL_COLS,
    MAX_NONGE_COLS,
    FoldKernelEngine,
)
from tahoe_tpu_torch.ops.graphed import GraphedEngine
from tahoe_tpu_torch.ops.rank_kernel import (
    RankFoldEngine,
    rank_margins,
    rank_virtual_cols,
)
from tahoe_tpu_torch.ops.rows import stage_rows


def plan_buckets(depths: np.ndarray, max_buckets: int = 4,
                 min_count: int = 8) -> List[np.ndarray]:
    """Partition tree indices into <= max_buckets groups by effective depth
    (bucketed.py:37-77 of the JAX package).

    Exact DP over contiguous ranges of the sorted unique depths, minimizing
    sum_b padded_count_b * 2^maxdepth_b (padded to ``min_count``: a tiny
    bucket still costs a launch)."""
    uniq = np.unique(depths)
    m = len(uniq)
    counts = np.array([(depths == d).sum() for d in uniq], np.int64)

    def cost(i, j):  # bucket covering uniq[i..j]
        return max(int(counts[i:j + 1].sum()), min_count) * (1 << int(uniq[j]))

    K = min(max_buckets, m)
    INF = float("inf")
    best = [[INF] * (K + 1) for _ in range(m + 1)]
    arg = [[-1] * (K + 1) for _ in range(m + 1)]
    best[0][0] = 0
    for j in range(1, m + 1):
        for k in range(1, K + 1):
            for i in range(j):
                if best[i][k - 1] == INF:
                    continue
                c = best[i][k - 1] + cost(i, j - 1)
                if c < best[j][k]:
                    best[j][k] = c
                    arg[j][k] = i
    k = min(range(1, K + 1), key=lambda kk: best[m][kk])
    bounds = []
    j = m
    while j > 0:
        i = arg[j][k]
        bounds.append((i, j - 1))
        j, k = i, k - 1
    bounds.reverse()
    return [np.nonzero(np.isin(depths, uniq[i:j + 1]))[0].astype(np.int64)
            for i, j in bounds]


def subset_trees(spec: ForestSpec, idx: np.ndarray) -> ForestSpec:
    """The forest of trees ``idx`` of ``spec`` (bucketed.py:80-91)."""
    return dataclasses.replace(
        spec,
        values=spec.values[idx],
        weights=spec.weights[idx],
        fids=spec.fids[idx],
        def_left=spec.def_left[idx],
        is_leaf=spec.is_leaf[idx],
        exchange=spec.exchange[idx],
    )


class _Bucketed(GraphedEngine):
    """What both variants share: the sum over buckets, plus the stumps'
    constant margin, and the output transform."""

    def _meta(self, spec: ForestSpec, device) -> None:
        self.device = resolve_device(device)
        self.num_trees = spec.num_trees
        self.output = spec.output
        self.global_bias = spec.global_bias
        self.threshold = spec.threshold
        self.stumps_margin = 0.0
        # one CUDA graph a shape on the card (ops/graphed.py) holds every
        # bucket's launches and their sum, as the JAX engine jits
        # _predict_impl
        self._graph()

    def _sum(self, rows: int, per_bucket) -> torch.Tensor:
        margins = None
        for m in per_bucket:
            margins = m if margins is None else margins + m
        if margins is None:  # a forest of stumps only
            margins = torch.zeros(rows, dtype=torch.float32, device=self.device)
        return margins + float(np.float32(self.stumps_margin))

    def _stage(self, rows, out: torch.Tensor | None = None) -> torch.Tensor:
        """The rows every bucket shares, staged once (the first bucket's
        step; f32 rows as they are for a forest of stumps)."""
        if self.sub:
            return self.sub[0]._stage(rows, out)
        return stage_rows(rows, device=self.device, out=out)

    @property
    def bucket_plan(self) -> List[Tuple[int, int]]:
        """[(num_trees, depth)] per non-stump bucket."""
        return [(e.num_trees, e.tables.depth) for e in self.sub]


class DepthBucketedFoldEngine(_Bucketed):
    """Per-depth-bucket f32 fold sharing one row canonicalization
    (bucketed.py:94-169)."""

    def __init__(self, spec: ForestSpec, *, device):
        if spec.num_cols > MAX_NONGE_COLS:
            raise NotImplementedError(
                f"the fold variant takes <= {MAX_NONGE_COLS} columns; got "
                f"{spec.num_cols}")
        self._meta(spec, device)
        # one form for every bucket, so that all share the canonicalized
        # rows; neither form compacts at these widths (bucketed.py:113)
        self.ge_mode = spec.num_cols <= MAX_DUAL_COLS
        depths = reachable_depths(spec)
        self.buckets = plan_buckets(depths)
        self.sub: List[FoldKernelEngine] = []
        for idx in self.buckets:
            d_b = int(depths[idx].max(initial=0))
            sub = truncate_depth(subset_trees(spec, idx), d_b)
            if d_b == 0:
                self.stumps_margin += float(sub.values[:, 0].sum())
                continue
            self.sub.append(FoldKernelEngine(sub, device=self.device,
                                             ge_mode=self.ge_mode))

    def _margins_staged(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sub:
            return self._sum(x.shape[0], ())
        x = self.sub[0].finish(x)
        return self._sum(x.shape[0], (e.margins_rows(x) for e in self.sub))


class DepthBucketedRankEngine(_Bucketed):
    """Depth buckets over the rank engine: one quantization and one kernel-A
    transform per batch shared by every bucket, kernel B once per bucket
    (bucketed.py:192-259)."""

    def __init__(self, spec: ForestSpec, *, device):
        self._meta(spec, device)
        spec_t = truncate_depth(spec, int(reachable_depths(spec).max(initial=0)))
        q, vf_base = band_split(quantize(spec_t))
        depths = reachable_depths(spec_t)
        self.buckets = plan_buckets(depths)
        self.sub: List[RankFoldEngine] = []
        for idx in self.buckets:
            d_b = int(depths[idx].max(initial=0))
            sub_q = truncate_depth(subset_trees(q.spec, idx), d_b)
            if d_b == 0:
                self.stumps_margin += float(sub_q.values[:, 0].sum())
                continue
            self.sub.append(RankFoldEngine(
                sub_q, device=self.device,
                prequantized=(dataclasses.replace(q, spec=sub_q), vf_base,
                              spec.missing)))
        if not self.sub:
            raise ValueError("rank bucketing needs at least one non-stump bucket")

    def transform(self, rows) -> torch.Tensor:
        """Raw rows -> int8 planes (kernel A), once for every bucket."""
        return self.sub[0].transform(rows)

    def _margins_staged(self, x: torch.Tensor) -> torch.Tensor:
        sub = self.sub[0]
        planes = sub.tables.planes_staged(x, sub.raw_missing)
        return self._sum(planes.shape[0], (rank_margins(planes, e.tables)
                                           for e in self.sub))


def rank_buckets_fit(num_cols: int, vcols: int) -> bool:
    """Whether DEPTH_BUCKETED takes its rank variant for a forest of
    ``num_cols`` columns and ``vcols`` banded virtual live features
    (rank_virtual_cols): one or two plane groups (bucketed.py:292-295 of
    the JAX package)."""
    return (num_cols <= RANK_MAX_COLS and vcols <= RANK_MAX_COLS
            and rank_groups(vcols) <= 2)


def make_depth_bucketed_engine(spec: ForestSpec, *, device):
    """DEPTH_BUCKETED's chooser (bucketed.py:282-307): the rank variant when
    the forest takes one or two plane groups, else the fold variant.

    It stops at the first variant whose tables can be built for the forest:
    a constructor compiles tables and launches no kernel, so the only errors
    passed over are the rank variant's refusals of the forest."""
    if rank_buckets_fit(spec.num_cols, rank_virtual_cols(spec)):
        try:
            return DepthBucketedRankEngine(spec, device=device)
        except (ValueError, NotImplementedError):
            pass  # the fold variant below
    return DepthBucketedFoldEngine(spec, device=device)
