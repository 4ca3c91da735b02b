"""Sparse rank descent: int8 rank planes -> f32 margins over the pruned CSR
pool (the sparse kernel), and the SPARSE strategy's rank engine around it.

The port of tahoe_tpu/ops/sparse_kernel.py ``SparseRankEngine``. The dense
engines store complete trees, 2^D nodes each; trained forests at depth 16-18
are mostly filler, and only the pruned pool (sparse.from_dense: reachable
nodes, BFS order per tree, children as a stored pair) fits. The host side
is the JAX engine's: ``rank_quantize`` (shared with the dense rank engine)
-> quantized_spec_for_engines -> from_dense. Each pool node becomes one
16-byte record, int32 {lane, k, child, value bits}:

- an internal node carries its rank column in the closed form of its four
  nonzeros (compiler.rank_normalize; sparse_kernel.py:130-144 of the JAX
  package): ``diff = 127 * p[lane] + p[lane + 30] + k``, with ``lane =
  128 * (fid // 30) + (QH | NQH) + fid % 30`` and ``k = 127 * c127 + c1``,
  (c127, c1) = (-rh, -rl) in the pos form and (rh, rl - 1) in the neg form.
  This is exactly ``planes . column``, since every plane group carries 127
  and 1 in its constant lanes 120 and 121. ``cond = diff >= 0`` and the
  next node is ``child + cond``;
- where the missing route is right (``swapped = !def_left ^ exchange``,
  sparse_kernel.py:224-235), the child pair is stored swapped and the
  column takes the neg form (``neg = exchange ^ swapped``), so a missing
  value (planes -128, cond False) walks to the stored-left slot;
- a leaf has ``child = -1`` and its f32 value in the fourth word;
- one root index per tree.

Not ported, because they are TPU workarounds with no counterpart here: the
chunk-packed per-level slot layout, the 128-tree lane tiles and their f32
partials, the macro blocks (plan_macro, _pad_macros, vmem_bytes) and the dead
slot 0. Mosaic has no per-lane gather, so the TPU kernel runs a select chain
over every slot of every level; a GPU thread reads only the nodes it visits.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tahoe_tpu_torch.config import resolve_device
from tahoe_tpu_torch.forest.compiler import (
    RANK_BASE,
    RANK_GROUP_COLS,
    RANK_LANE_C1,
    RANK_LANE_C127,
    RANK_LANE_NQH,
    RANK_LANE_QH,
    RANK_LANE_QL,
    RANK_MAX,
    RANK_MAX_COLS,
    RANK_MAX_GROUPS,
)
from tahoe_tpu_torch.forest.quantize import quantized_spec_for_engines
from tahoe_tpu_torch.forest.sparse import SparseForest, from_dense
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops._build import CudaKernel, check_operand, ptr
from tahoe_tpu_torch.ops.rank_kernel import (
    PLAIN_CHUNK_BYTES,
    RankInput,
    _int32_matmul,
    rank_input,
    rank_quantize,
    rank_virtual_cols,
)
from tahoe_tpu_torch.ops.rank_transform import LANE
from tahoe_tpu_torch.ops.transform import apply_output_transform

SPARSE_RANK = CudaKernel(
    "tahoe_sparse_rank",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/sparse_rank.cu",
    replaces="tahoe_tpu/ops/sparse_kernel.py:251",
)

# int32 words of one node record: lane, k, child, value bits
RECORD_WORDS = 4
RECORD_BYTES = 4 * RECORD_WORDS


def sparse_records(sf: SparseForest) -> tuple[np.ndarray, np.ndarray]:
    """Rank-domain CSR pool -> (records [N, 4] int32, pos [N]): node n of
    ``sf`` is record ``pos[n]``; roots keep their index.

    ``sf`` comes from from_dense of the quantized spec, so internal values
    are integer ranks and def_left/exchange are live."""
    internal = ~sf.is_leaf
    li = sf.left_idx.astype(np.int64)
    swapped = ~sf.def_left ^ sf.exchange  # the missing route is right
    neg = sf.exchange ^ swapped
    pos = np.arange(sf.num_nodes, dtype=np.int64)
    sw = li[internal & swapped]
    pos[sw], pos[sw + 1] = sw + 1, sw

    rank = sf.values[internal]
    if not ((rank >= 0) & (rank <= RANK_MAX)).all():  # NaN fails too
        raise ValueError(f"rank out of the int8 planes' range (max {RANK_MAX})")
    rank = rank.astype(np.int64)
    fid = sf.fids[internal].astype(np.int64)
    ng = neg[internal]
    lane = (LANE * (fid // RANK_GROUP_COLS) + fid % RANK_GROUP_COLS
            + np.where(ng, RANK_LANE_NQH, RANK_LANE_QH))
    records = np.zeros((sf.num_nodes, RECORD_WORDS), np.int32)
    at = pos[internal]
    records[at, 0] = lane
    records[at, 1] = np.where(ng, rank - 1, -rank)
    records[at, 2] = li[internal]
    at = pos[sf.is_leaf]
    records[at, 0] = -1
    records[at, 2] = -1
    records[at, 3] = sf.values[sf.is_leaf].astype(np.float32).view(np.int32)
    return records, pos


def node_columns(records: torch.Tensor, groups: int) -> torch.Tensor:
    """The internal records' rank columns, int8 [128*G, internal nodes] in
    record order: each record's closed form written back as the four
    nonzeros of compiler.rank_normalize's column."""
    r = records[records[:, 2] >= 0].to(torch.int64)
    lane, k = r[:, 0], r[:, 1]
    neg = lane % LANE >= RANK_LANE_NQH
    rank = torch.where(neg, k + 1, -k)
    rh, rl = rank // RANK_BASE, rank % RANK_BASE
    n = r.shape[0]
    j = torch.arange(n, device=records.device)
    cols = torch.zeros(LANE * groups, n, dtype=torch.int8, device=records.device)
    cols[lane, j] = RANK_BASE
    cols[lane + (RANK_LANE_QL - RANK_LANE_QH), j] = 1
    cols[RANK_LANE_C127, j] = torch.where(neg, rh, -rh).to(torch.int8)
    cols[RANK_LANE_C1, j] = torch.where(neg, rl - 1, -rl).to(torch.int8)
    return cols


def sparse_leaves_plain(planes: torch.Tensor, records: torch.Tensor,
                        roots: torch.Tensor, max_depth: int) -> torch.Tensor:
    """The leaf record each row reaches in each tree, int64 [R, T], in the
    TPU kernel's own arithmetic: an int32 matmul of the planes against every
    internal node's column, then a level-synchronous masked descent of
    ``max_depth`` steps by gathers."""
    child = records[:, 2].to(torch.int64)
    internal = child >= 0
    col_of = (torch.cumsum(internal, 0) - 1).clamp(min=0)
    cols = node_columns(records, planes.shape[1] // LANE)
    start = roots.to(torch.int64)
    T, n = start.shape[0], cols.shape[1]
    # per row: the int32 diffs and bool conds of every internal node, and the
    # [T] descent state
    chunk = max(1, PLAIN_CHUNK_BYTES // (5 * n + 32 * T))
    out = [start.expand(0, T)]
    for r0 in range(0, planes.shape[0], chunk):
        p = planes[r0:r0 + chunk]
        idx = start.expand(p.shape[0], T)
        if n:
            cond = _int32_matmul(p, cols) >= 0
            for _ in range(max_depth):
                step = child[idx] + torch.gather(cond, 1, col_of[idx])
                idx = torch.where(internal[idx], step, idx)
        out.append(idx)
    return torch.cat(out)


def sparse_margins_plain(planes: torch.Tensor, records: torch.Tensor,
                         roots: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Plain PyTorch version of the sparse kernel: sparse_leaves_plain's
    leaves, their values summed in f64 in tree order."""
    value = records[:, 3].contiguous().view(torch.float32)
    leaves = sparse_leaves_plain(planes, records, roots, max_depth)
    return value[leaves].double().sum(dim=1).float()


def sparse_margins_cuda(planes: torch.Tensor, records: torch.Tensor,
                        roots: torch.Tensor, max_depth: int) -> torch.Tensor:
    """The sparse kernel on the card (csrc/sparse_rank.cu)."""
    dev = planes.device
    check_operand(planes, "planes", torch.int8, dev, 2)
    check_operand(records, "records", torch.int32, dev, 2)
    check_operand(roots, "roots", torch.int32, dev, 1)
    R, K = planes.shape
    if K % LANE or not 1 <= K // LANE <= RANK_MAX_GROUPS:
        raise ValueError(f"planes width {K} is not 128 x 1..16 groups")
    if records.shape[1] != RECORD_WORDS or records.data_ptr() % 16:
        raise ValueError(f"records {tuple(records.shape)} are not 16-byte "
                         f"aligned [N, {RECORD_WORDS}] int32 records")
    if roots.shape[0] < 1:
        raise ValueError("a forest has at least one tree")
    out = torch.empty(R, dtype=torch.float32, device=dev)
    SPARSE_RANK.launch(dev, ptr(planes), R, K // LANE, ptr(records),
                       ptr(roots), roots.shape[0], max_depth, ptr(out))
    return out


def sparse_margins(planes: torch.Tensor, records: torch.Tensor,
                   roots: torch.Tensor, max_depth: int) -> torch.Tensor:
    """The sparse kernel on a CUDA tensor, its plain version on a CPU
    tensor."""
    if planes.device.type == "cpu":
        return sparse_margins_plain(planes, records, roots, max_depth)
    return sparse_margins_cuda(planes, records, roots, max_depth)


@dataclasses.dataclass(frozen=True)
class SparseTables(RankInput):
    """A forest compiled for the sparse kernel: kernel A's RankInput, plus

    - ``records`` [N, 4] int32: the pruned pool's node records;
    - ``roots`` [T] int32: each tree's root record;
    - ``max_depth``: the deepest leaf's depth (the plain descent's steps).
    """

    records: torch.Tensor
    roots: torch.Tensor
    max_depth: int


def sparse_tables(spec: ForestSpec, band: int | None = None, *,
                  device: torch.device) -> SparseTables:
    """Compile ``spec`` for the sparse kernel (sparse_kernel.py:415-443)."""
    q, gather = rank_quantize(spec, band)
    fields = rank_input(q, gather, device=device)
    sf = from_dense(quantized_spec_for_engines(q))
    records, _ = sparse_records(sf)
    return SparseTables(
        **fields,
        records=torch.as_tensor(records, device=device),
        roots=torch.as_tensor(sf.tree_roots, dtype=torch.int32, device=device),
        max_depth=sf.max_depth,
    )


class SparseRankEngine:
    """Rank-quantize a forest, prune it to its CSR pool and run it through
    kernel A and the sparse kernel (Strategy.SPARSE where the rank planes
    take the forest)."""

    def __init__(self, forest: ForestSpec, *, device, band: int | None = None):
        self.device = resolve_device(device)
        self.raw_missing = forest.missing
        self.tables = sparse_tables(forest, band, device=self.device)
        self.q = self.tables.q
        self.groups = self.tables.groups
        self.num_trees = forest.num_trees
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold

    @staticmethod
    def feasible(forest: ForestSpec) -> str | None:
        """The JAX engine's rule (sparse_kernel.py:528-538): the banded live
        features fit the planes. The pool has no cap of its own here."""
        vcols = rank_virtual_cols(forest)
        if vcols > RANK_MAX_COLS:
            return f"{vcols} virtual features > {RANK_MAX_COLS}"
        return None

    def transform(self, rows) -> torch.Tensor:
        """Raw rows [R, C] -> int8 planes [R, 128*G] (kernel A)."""
        return self.tables.planes(rows, self.raw_missing)

    def margins_planes(self, planes) -> torch.Tensor:
        planes = torch.as_tensor(planes, dtype=torch.int8, device=self.device)
        t = self.tables
        return sparse_margins(planes.contiguous(), t.records, t.roots,
                              t.max_depth)

    def margins(self, rows) -> torch.Tensor:
        return self.margins_planes(self.transform(rows))

    def predict(self, rows) -> torch.Tensor:
        return apply_output_transform(self.margins(rows), self.num_trees,
                                      self.output, self.global_bias,
                                      self.threshold)
