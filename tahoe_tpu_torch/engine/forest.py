"""User-facing runtime of the port: one Forest handle, one predict.

The counterpart of tahoe_tpu/engine/forest.py, serving all eight strategies:

  SPLIT_FOREST   -> FoldKernelEngine (f32 fold: kernel C in the dual or sign
                    form, or the deep kernel from depth 12, every depth
                    past 14; its tables capped at 2 GiB)
  VMEM_FOREST    -> FoldKernelEngine(whole_forest=True) (kernel C, the whole
                    forest in one shared-memory tile)
  DEPTH_BUCKETED -> make_depth_bucketed_engine (kernels A + B per bucket, or
                    the fold per bucket, non-ge for 65-128 columns)
  RANK_MXU       -> RankFoldEngine   (rank transform + traversal, kernels A, B)
  SPARSE         -> SparseRankEngine (kernel A + the sparse kernel) where
                    ``sparse_rank_reason`` admits the forest, else
                    SparseGatherEngine (plain torch)
  HBM_DIRECT     -> GatherEngine on the hot-swapped, clustered forest
  ROW_TILED      -> TensorEngine("take") on the leveled forest
  TENSOR         -> TensorEngine("onehot") on the leveled forest

The last three are plain torch, as they are plain XLA in the JAX package.
Every engine's predict is one CUDA graph replay a shape on ``cuda``
(ops/graphed.py), as a JAX engine's is one jit executable: the first call
at a row count captures it, every later one replays it.
The compiled and leveled layouts are built on first use, only for the
strategies that read them: at depth 18 a complete-tree layout holds 10^8
nodes. The device is an explicit argument: on ``cpu`` the engines run the
kernels' plain PyTorch versions, on ``cuda`` the kernels; no strategy falls
back to another engine when a build or a launch fails.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import numpy as np

from tahoe_tpu_torch.config import GpuLimits, Output, Strategy, resolve_device
from tahoe_tpu_torch.engine import feasibility
from tahoe_tpu_torch.forest import compiler, io
from tahoe_tpu_torch.forest.sparse import SparseGatherEngine, from_dense
from tahoe_tpu_torch.forest.spec import ForestSpec, LeveledForest
from tahoe_tpu_torch.ops.bucketed import make_depth_bucketed_engine
from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine
from tahoe_tpu_torch.ops import graphed, oracle
from tahoe_tpu_torch.ops.gather_engine import GatherEngine
from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine
from tahoe_tpu_torch.ops.sparse_kernel import (
    SparseRankEngine,
    sparse_rank_reason,
)
from tahoe_tpu_torch.ops.tensor_engine import TensorEngine
from tahoe_tpu_torch.utils.profiling import span


class Forest:
    """A loaded forest plus lazily built per-strategy engines on ``device``."""

    def __init__(self, spec: ForestSpec, *, device):
        self.device = resolve_device(device)
        self.limits = GpuLimits.for_device(self.device)
        # drop unreachable filler levels once, up front: the facts that
        # feasibility and the engines' choices read are the cut forest's
        self.stored_depth = spec.depth
        self.facts = feasibility.ForestFacts.cut(spec)
        self.spec = self.facts.spec
        self._engines: Dict = {}

    @classmethod
    def from_files(cls, model_path: str, data_path: Optional[str] = None, *,
                   device, output: int = int(Output.RAW),
                   global_bias: float = 0.0, threshold: float = 0.5) -> "Forest":
        """Load the reference text model format. With an existing data file,
        its num_cols and missing sentinel are adopted (the reference reads
        the sentinel from the data file header); without one, the model's
        own num_cols and NaN missing, as the JAX package does. The model
        format carries no output transform, so it is given here, as
        io.load_model takes it."""
        num_cols = None
        missing = float("nan")
        if data_path is not None and os.path.exists(data_path):
            _, num_cols, missing = peek_data_header(data_path)
        spec = io.load_model(model_path, output=output, global_bias=global_bias,
                             threshold=threshold, missing=missing,
                             num_cols=num_cols)
        return cls(spec, device=device)

    @functools.cached_property
    def compiled(self) -> ForestSpec:
        """The hot-swapped, clustered forest (compiler.compile_forest's
        first two passes) that HBM_DIRECT reads."""
        swapped = compiler.hot_child_swap(self.spec)
        return compiler.cluster_trees(swapped)[0]

    @functools.cached_property
    def leveled(self) -> LeveledForest:
        """The unswapped leveled form that ROW_TILED and TENSOR read."""
        return compiler.levelize(self.spec)

    def feasible(self, strategy: Strategy) -> Optional[str]:
        return feasibility.check(strategy, self.facts, self.limits)

    def engine(self, strategy: Strategy, *, fuse_transform: bool = False):
        """Build (or fetch) the engine realizing a strategy.
        ``fuse_transform`` is RankFoldEngine's (RANK_MXU only)."""
        key = (strategy, fuse_transform)
        if key in self._engines:
            return self._engines[key]
        reason = self.feasible(strategy)
        if reason is not None:
            raise ValueError(f"strategy {strategy.name} infeasible: {reason}")
        if fuse_transform and strategy != Strategy.RANK_MXU:
            raise ValueError(f"fuse_transform is RANK_MXU's; not {strategy.name}'s")
        if strategy == Strategy.RANK_MXU:
            eng = RankFoldEngine(self.spec, device=self.device,
                                 fuse_transform=fuse_transform)
        elif strategy == Strategy.DEPTH_BUCKETED:
            eng = make_depth_bucketed_engine(self.spec, device=self.device)
        elif strategy == Strategy.SPARSE:
            if sparse_rank_reason(self.facts.vcols) is None:
                eng = SparseRankEngine(self.spec, device=self.device)
            else:
                eng = SparseGatherEngine(from_dense(self.spec), device=self.device)
        elif strategy == Strategy.HBM_DIRECT:
            eng = GatherEngine(self.compiled, device=self.device)
        elif strategy in (Strategy.ROW_TILED, Strategy.TENSOR):
            eng = TensorEngine(
                self.leveled, device=self.device,
                select_mode="take" if strategy == Strategy.ROW_TILED else "onehot")
        else:
            eng = FoldKernelEngine(
                self.spec, device=self.device,
                whole_forest=strategy == Strategy.VMEM_FOREST)
        self._engines[key] = eng
        return eng

    def drop_engines(self) -> None:
        """Forget every built engine and free its CUDA graphs, so that its
        tables and the graphs' pools can be freed."""
        for eng in self._engines.values():
            graphed.release(eng)
        self._engines.clear()

    def predict(self, rows, strategy: Strategy = Strategy.SPLIT_FOREST):
        """Predictions [R] f32 on ``device``."""
        with span("tahoe_predict"):
            return self.engine(strategy).predict(rows)

    def predict_oracle(self, rows) -> np.ndarray:
        """The numpy CPU golden model (ops/oracle.py, the port's copy of the
        JAX package's)."""
        return oracle.predict(self.spec, np.asarray(rows, np.float32))


def peek_data_header(path: str) -> tuple[int, int, float]:
    """(rows, num_cols, missing sentinel) from the header of a data file in
    the reference text format (tahoe_tpu/engine/forest.py:176)."""
    with open(path, "r") as f:
        rows = int(f.readline())
        cols = int(f.readline())
        missing = float(f.readline())
    return rows, cols, missing
