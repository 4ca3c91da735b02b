"""Configuration of the PyTorch/CUDA port.

The enums, node-width masks and tolerances are the port's own copy of
tahoe_tpu/config.py:16-163, with the same names and values (held to the
original by tests/test_torch_host_layer.py). ``GpuLimits`` takes the place
of ``TpuLimits``: where the TPU engines budget VMEM, the CUDA kernels budget
shared memory per block. ``PredictConfig`` is not copied: the port's
engines take their options as arguments.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

__all__ = [
    "GpuLimits",
    "MISSING_EPS",
    "NodeWidth",
    "ORACLE_ATOL",
    "Output",
    "Strategy",
    "forest_num_nodes",
    "resolve_device",
    "tree_num_nodes",
]


class Output(enum.IntFlag):
    """Output transform flags (same numeric values as Struct.h:37-42).

    Applied in fixed order after margin accumulation: AVG (divide by num_trees),
    add global_bias, SIGMOID, THRESHOLD (reference: Struct.h:196-209 transform_k,
    BaseTahoeTest.h:465-472 CPU oracle).
    """

    RAW = 0x0
    AVG = 0x1
    SIGMOID = 0x10
    THRESHOLD = 0x100

    @staticmethod
    def validate(flags: int) -> None:
        all_set = Output.AVG | Output.SIGMOID | Output.THRESHOLD
        if flags & ~int(all_set):
            raise ValueError(
                f"output must be a combination of RAW, AVG, SIGMOID, THRESHOLD; got {flags:#x}"
            )


class Strategy(enum.Enum):
    """TPU memory-placement strategies for forest traversal.

    These are the TPU-native renditions of the reference's five enumerated
    kernels (``selected_algorithm`` 0-4, dispatched at Struct.h:2168-2179,
    printed as "strategy 1-5" at BaseTahoeTest.h:682). The mapping is by
    *memory placement*, not by translation:

    ===============  ==================================  =========================
    This framework   Reference (strategy #, kernel)      Placement
    ===============  ==================================  =========================
    HBM_DIRECT       1  infer_adaptive_reorg_*           node tables stay in HBM,
                                                         XLA-scheduled streaming
    ROW_TILED        2  infer_k_shared_data_wo_adaptive  row tiles VMEM-resident,
                                                         forest streamed by level
    TENSOR           3  infer_k_shared_data_adaptive     rows VMEM-resident,
                                                         vectorized over trees,
                                                         select-fold (MXU/VPU)
    VMEM_FOREST      4  infer_k_shared_forest_adaptive   whole forest pinned in
                                                         VMEM, rows streamed
    SPLIT_FOREST     5  infer_k_split_forest_adaptive    tree chunks in VMEM,
                                                         partial-margin accum
    ===============  ==================================  =========================
    """

    HBM_DIRECT = 1
    ROW_TILED = 2
    TENSOR = 3
    VMEM_FOREST = 4
    SPLIT_FOREST = 5
    # Framework-native sixth strategy with no direct reference counterpart in
    # kernel form, but the spiritual successor of the reference's adaptive
    # compressed node format (Struct.h:1827-1852): node tables rank-quantized
    # to int8 and traversed via MXU matmuls (ops/rank_kernel.py).
    RANK_MXU = 6
    # Framework-native seventh strategy: trees bucketed by per-tree REACHABLE
    # depth, each bucket folded at its own (truncated) depth in one jit,
    # margins summed (ops/bucketed.py). Pays off on trained ensembles stored
    # as complete trees of the global max depth; spiritual successor of the
    # reference's similar-tree clustering (Struct.h:1854-1891).
    DEPTH_BUCKETED = 7
    # CSR sparse descent (forest/sparse.py): pruned node pool in HBM,
    # level-synchronous masked gather advance. The realization of the
    # reference's dormant sparse path (sparse_forest + infer_sparse,
    # Struct.h:2217-2353; dense2sparse commented out at
    # BaseTahoeTest.h:728-846). The only strategy whose storage is the TRUE
    # node count — very deep trained ensembles (depth > 15, mostly-empty
    # complete trees) are infeasible for every dense engine and land here.
    SPARSE = 8

    @property
    def strategy_number(self) -> int:
        """1-based strategy id matching the reference's printed numbering."""
        return self.value


ALL_STRATEGIES = tuple(Strategy)


class NodeWidth(enum.IntEnum):
    """Adaptive node-metadata width in bytes (reference: Struct.h:1827-1852).

    The reference packs {fid, def_left, is_leaf, exchange} into a char/short/int
    chosen by the bits needed for the max feature id (5/13/29 usable fid bits).
    We keep the same three widths for the packed ``bits`` table (int8/int16/int32).
    """

    CHAR = 1   # fid fits in 5 bits  (<= 31 features)
    SHORT = 2  # fid fits in 13 bits (<= 8191 features)
    INT = 4    # fid fits in 29 bits

    @staticmethod
    def for_max_fid(max_fid: int) -> "NodeWidth":
        # Reference computes fid_len = (log2(max_fid) + 3)/8 and buckets it
        # (Struct.h:1836-1852); equivalently: pick the narrowest packing whose
        # fid field holds max_fid.
        if max_fid < (1 << 5):
            return NodeWidth.CHAR
        if max_fid < (1 << 13):
            return NodeWidth.SHORT
        if max_fid < (1 << 29):
            return NodeWidth.INT
        raise ValueError(f"max feature id {max_fid} exceeds 29-bit fid field")

    @property
    def fid_bits(self) -> int:
        return {1: 5, 2: 13, 4: 29}[int(self)]


# Bit layout of the packed adaptive node word, per width W in {8, 16, 32} bits:
#   [fid : W-3 bits][def_left : 1][is_leaf : 1][exchange : 1]
# (reference masks: Struct.h:61-75)
def fid_mask(width: NodeWidth) -> int:
    return (1 << width.fid_bits) - 1


def def_left_mask(width: NodeWidth) -> int:
    return 1 << width.fid_bits


def is_leaf_mask(width: NodeWidth) -> int:
    return 1 << (width.fid_bits + 1)


def exchange_mask(width: NodeWidth) -> int:
    return 1 << (width.fid_bits + 2)


def tree_num_nodes(depth: int) -> int:
    """Nodes in a complete binary tree of the given depth (Struct.h:15-17)."""
    return (1 << (depth + 1)) - 1


def forest_num_nodes(num_trees: int, depth: int) -> int:
    """Total nodes in a forest of complete trees (Struct.h:19-21)."""
    return num_trees * tree_num_nodes(depth)


# Missing-value tolerance: a feature value x is "missing" when
# |x - missing_sentinel| <= MISSING_EPS (reference: Struct.h:380-383,
# BaseTahoeTest.h:452). When the sentinel itself is NaN the check is isnan(x)
# (synthetic-data path, Struct.h:518).
MISSING_EPS = 1.0e-6

# Output tolerance for oracle-parity checks (reference: cuda_base.h:103).
ORACLE_ATOL = 1.0e-3


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
