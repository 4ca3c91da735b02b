"""Predicted scaling efficiency of sharded inference (parallel/sharded.py).

The port of tahoe_tpu/perf_model/scaling.py, re-derived on the port's cost
model (model.py ``CostBreakdown``: the card's time, the host's time to
issue a call, and a call's latency). Weak scaling: every rank predicts
``rows_per_device`` rows.

- The ``data`` axis never communicates on ``predict_local``: every rank runs
  the one-card engine on its own rows, so a ``(n, 1)`` mesh scales at
  efficiency 1.
- The ``model`` axis splits the trees ``n_model`` ways: a rank's card time
  is ``device_s / n_model`` (every kernel's work is a sum over trees); the
  host's issue time and the latency stay. After the kernels, one f32
  all-reduce of ``4 * rows`` bytes a rank: the host issues it
  (COLLECTIVE_ISSUE_US, the one-rank NCCL all_reduce timed on the card),
  and a ring moves it in

      T_ring = 2 (n - 1) / n * bytes / link + (n - 1) * hop_latency

  on the slowest link of the ring: NVLink within a node, InfiniBand across
  nodes (``cross_host``). So a rank's call takes

      T(n) = max(device_s / n + T_ring, host_s + issue) + latency_s

  and, against one card running the whole forest on the same rows,
  ``eff = T(1) / (n_model * T(n))`` (throughput n_data * rows / T(n)
  against rows / T(1) a card).

The link rates are data-sheet figures and the hop latencies assumptions,
none measured: the card's machine has one GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from tahoe_tpu_torch.config import GpuLimits
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.perf_model.calibrate import Calibration
from tahoe_tpu_torch.perf_model.model import choose_strategy

# NVLink 4 on an H100 SXM: 900 GB/s a card, 450 GB/s a direction (NVIDIA's
# data sheet); unmeasured
NVLINK_GBPS = 450.0
# NDR InfiniBand, 400 Gb/s a NIC: 50 GB/s a direction (data sheet);
# unmeasured
INFINIBAND_GBPS = 50.0
# a ring step's latency on each: assumed, unmeasured
NVLINK_HOP_LATENCY_S = 2e-6
INFINIBAND_HOP_LATENCY_S = 5e-6
# the host's time to issue one all_reduce of 65,536 f32 on a one-rank NCCL
# group: chip_smoke.py phase 16 on an NVIDIA H100 80GB HBM3, 700.00 W
# (median of 50; its event time read 55.47 us; another run read 23.98 and
# 39.22: the host's time drifts as a call's does)
COLLECTIVE_ISSUE_US = 37.23


@dataclasses.dataclass(frozen=True)
class ScalingPrediction:
    n_devices: int
    n_data: int
    n_model: int
    cross_host: bool
    compute_s: float   # one card, the whole forest, rows_per_device rows
    device_s: float    # a rank's card time: its tree shard and the ring
    host_s: float      # a rank's host time: the call and the collective's issue
    psum_bytes: int    # a rank's all-reduce payload
    psum_s: float      # the ring's transfer
    total_s: float     # a rank's call
    efficiency: float  # throughput against n_devices cards alone

    def explain(self) -> str:
        link = "InfiniBand" if self.cross_host else "NVLink"
        return (f"mesh=({self.n_data} data x {self.n_model} model), "
                f"T(1)={self.compute_s * 1e6:.1f} us, T(n)={self.total_s * 1e6:.1f} "
                f"us, all-reduce {self.psum_bytes} B -> {self.psum_s * 1e6:.2f} us "
                f"({link}), eff={self.efficiency:.1%}")


def predict_scaling(forest: ForestSpec, rows_per_device: int,
                    n_data: int = 1, n_model: int = 1,
                    cross_host: bool = False,
                    cal: Optional[Calibration] = None,
                    limits: GpuLimits = GpuLimits(),
                    link_gbps: float | None = None,
                    collective_us: float = COLLECTIVE_ISSUE_US) -> ScalingPrediction:
    """Weak-scaling efficiency of a ``(n_data, n_model)`` mesh, each rank on
    ``rows_per_device`` rows with the best strategy the model picks for one
    card. ``cross_host``: the model axis spans nodes (its ring crosses
    InfiniBand); ``link_gbps`` overrides the link's rate."""
    cal = cal or Calibration.default()
    _, costs = choose_strategy(forest, rows_per_device, cal, limits)
    best = min((c for c in costs.values() if c is not None), key=lambda c: c.total)
    device_s, host_s = best.device_s, best.host_s
    psum_bytes, psum_s = 0, 0.0
    if n_model > 1:
        bw = (link_gbps or (INFINIBAND_GBPS if cross_host else NVLINK_GBPS)) * 1e9
        hop = INFINIBAND_HOP_LATENCY_S if cross_host else NVLINK_HOP_LATENCY_S
        psum_bytes = 4 * rows_per_device
        psum_s = 2.0 * (n_model - 1) / n_model * psum_bytes / bw + (n_model - 1) * hop
        device_s = device_s / n_model + psum_s
        host_s = host_s + collective_us * 1e-6
    total = max(device_s, host_s) + best.latency_s
    return ScalingPrediction(
        n_devices=n_data * n_model, n_data=n_data, n_model=n_model,
        cross_host=cross_host, compute_s=best.total, device_s=device_s,
        host_s=host_s, psum_bytes=psum_bytes, psum_s=psum_s, total_s=total,
        efficiency=min(1.0, best.total / (n_model * total)))
