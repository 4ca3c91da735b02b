"""tahoe_tpu_torch: the PyTorch/CUDA port of tahoe-tpu for NVIDIA Hopper.

A second package beside ``tahoe_tpu``, the JAX reference. It imports
neither jax nor ``tahoe_tpu``: it keeps its own copy of the numpy host layer
(``forest/``, ``ops/oracle.py``), held to the original bit for bit by the
tests, so the same forests, compiled by the same numpy passes, run through
hand-written CUDA kernels on an H100 or through their plain PyTorch versions
on the CPU. The device is always an explicit argument.
"""
from tahoe_tpu_torch.config import (
    MISSING_EPS,
    ORACLE_ATOL,
    GpuLimits,
    Output,
    Strategy,
)
from tahoe_tpu_torch.engine.forest import Forest

__all__ = ["Forest", "GpuLimits", "MISSING_EPS", "ORACLE_ATOL", "Output",
           "Strategy"]
