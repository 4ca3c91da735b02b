"""User-facing runtime of the port: one Forest handle, one predict.

The counterpart of tahoe_tpu/engine/forest.py for the strategies ported so
far:

  SPLIT_FOREST   -> FoldKernelEngine (f32 fold: kernel C in the dual or sign
                    form, or the deep kernel at depth 12-15)
  VMEM_FOREST    -> FoldKernelEngine(whole_forest=True) (kernel C, the whole
                    forest in one shared-memory tile)
  DEPTH_BUCKETED -> make_depth_bucketed_engine (kernels A + B per bucket, or
                    the fold per bucket, non-ge for 65-128 columns)
  RANK_MXU       -> RankFoldEngine   (rank transform + traversal, kernels A, B)

Every other strategy raises NotImplementedError naming its ROADMAP item; none
is routed to another engine. The device is an explicit argument: on ``cpu``
the engines run the kernels' plain PyTorch versions, on ``cuda`` the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tahoe_tpu.forest import compiler, io
from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.ops import oracle
from tahoe_tpu_torch.config import GpuLimits, Output, Strategy, resolve_device
from tahoe_tpu_torch.engine import feasibility
from tahoe_tpu_torch.ops.bucketed import make_depth_bucketed_engine
from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine
from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine

NOT_PORTED = {
    Strategy.HBM_DIRECT: "ROADMAP Queue 1 item 6",
    Strategy.ROW_TILED: "ROADMAP Queue 1 item 6",
    Strategy.TENSOR: "ROADMAP Queue 1 item 6",
    Strategy.SPARSE: "ROADMAP Queue 1 item 7",
}


class Forest:
    """A loaded forest plus lazily built per-strategy engines on ``device``."""

    def __init__(self, spec: ForestSpec, *, device):
        self.device = resolve_device(device)
        self.limits = GpuLimits.for_device(self.device)
        # drop unreachable filler levels once, up front (forest.py:40-43 of
        # the JAX package): exact, and engines size against the real depth
        self.stored_depth = spec.depth
        d_eff = int(compiler.reachable_depths(spec).max(initial=0))
        if d_eff < spec.depth:
            spec = compiler.truncate_depth(spec, d_eff)
        self.spec = spec
        self._engines: Dict = {}

    @classmethod
    def from_files(cls, model_path: str, data_path: Optional[str] = None, *,
                   device, output: int = int(Output.RAW),
                   global_bias: float = 0.0, threshold: float = 0.5) -> "Forest":
        """Load the reference text model format. With a data file, its
        num_cols and missing sentinel are adopted (the reference reads the
        sentinel from the data file header). The model format carries no
        output transform, so it is given here, as io.load_model takes it."""
        num_cols = None
        missing = float("nan")
        if data_path is not None:
            with open(data_path) as f:
                f.readline()
                num_cols = int(f.readline())
                missing = float(f.readline())
        spec = io.load_model(model_path, output=output, global_bias=global_bias,
                             threshold=threshold, missing=missing,
                             num_cols=num_cols)
        return cls(spec, device=device)

    def feasible(self, strategy: Strategy) -> Optional[str]:
        return feasibility.check(strategy, self.spec, self.limits)

    def engine(self, strategy: Strategy):
        """Build (or fetch) the engine realizing a strategy."""
        if strategy in NOT_PORTED:
            raise NotImplementedError(
                f"strategy {strategy.name} not ported yet: {NOT_PORTED[strategy]}")
        if strategy in self._engines:
            return self._engines[strategy]
        reason = self.feasible(strategy)
        if reason is not None:
            raise ValueError(f"strategy {strategy.name} infeasible: {reason}")
        if strategy == Strategy.RANK_MXU:
            eng = RankFoldEngine(self.spec, device=self.device)
        elif strategy == Strategy.DEPTH_BUCKETED:
            eng = make_depth_bucketed_engine(self.spec, device=self.device)
        else:
            eng = FoldKernelEngine(
                self.spec, device=self.device,
                whole_forest=strategy == Strategy.VMEM_FOREST)
        self._engines[strategy] = eng
        return eng

    def predict(self, rows, strategy: Strategy = Strategy.SPLIT_FOREST):
        """Predictions [R] f32 on ``device``."""
        return self.engine(strategy).predict(rows)

    def predict_oracle(self, rows) -> np.ndarray:
        """The numpy CPU golden model (the JAX package's ops/oracle.py)."""
        return oracle.predict(self.spec, np.asarray(rows, np.float32))
