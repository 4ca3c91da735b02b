"""Configuration of the PyTorch/CUDA port.

The enums and tolerances are the JAX package's own (re-exported, one source
of truth). ``GpuLimits`` takes the place of ``TpuLimits``: where the TPU
engines budget VMEM, the CUDA kernels budget shared memory per block.
"""
from __future__ import annotations

import dataclasses

import torch

from tahoe_tpu.config import MISSING_EPS, ORACLE_ATOL, Output, Strategy

__all__ = [
    "GpuLimits",
    "MISSING_EPS",
    "ORACLE_ATOL",
    "Output",
    "Strategy",
    "resolve_device",
]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a GPU raises.

    The port never picks a device by itself: every engine takes one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA GPU is present")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev


@dataclasses.dataclass(frozen=True)
class GpuLimits:
    """Hardware budget of one card (the analog of TpuLimits' VMEM budget).

    The defaults are an H100 SXM's (NVIDIA's data sheet): 227 KB of shared
    memory a block can opt into, 228 KB per SM, 132 SMs, a 50 MB L2.
    ``for_device`` reads a real card's values; on the CPU the defaults
    stand."""

    smem_per_block: int = 232_448
    smem_per_sm: int = 233_472
    sm_count: int = 132
    l2_bytes: int = 50 * 1024 * 1024

    # the runtime reserves 1 KB of an SM's shared memory for every resident
    # block (cudaDevAttrReservedSharedMemoryPerBlock on sm_80 and later)
    SMEM_RESERVED_PER_BLOCK = 1024

    @property
    def smem_half_sm(self) -> int:
        """The most dynamic shared memory a block may take so that two
        blocks share an SM."""
        return self.smem_per_sm // 2 - self.SMEM_RESERVED_PER_BLOCK

    @classmethod
    def for_device(cls, device: torch.device) -> "GpuLimits":
        if device.type != "cuda":
            return cls()
        props = torch.cuda.get_device_properties(device)
        return cls(
            smem_per_block=props.shared_memory_per_block_optin,
            smem_per_sm=getattr(props, "shared_memory_per_multiprocessor",
                                cls.smem_per_sm),
            sm_count=props.multi_processor_count,
            l2_bytes=props.L2_cache_size,
        )
