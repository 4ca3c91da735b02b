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

The records are what the plain version (and ``node_columns``) reads. The
sparse kernel reads them repacked into **slots** of 2^b int32 words, one
16-byte load at b = 2 (``SPARSE_LEVELS``, ``sparse_blocks``): a slot is a
block of the b levels below one node, or a leaf.

- A block holds 2^b - 1 node words in heap order (position i has its
  cond-False child at 2i + 1, its cond-True child at 2i + 2), each kernel B's
  record ``(k << 12) | lane`` (rank_kernel.pack_records), then one base word.
  A walk of b steps leaves it by one of 2^b exits.
- A leaf that ends inside a block is padded down with pass-through words,
  ``PASS_WORD`` (k = -2^19, lane 0): its diff is below any planes' sum, so
  the walk goes to the cond-False slot, where a missing value walks too, and
  leaves by the leftmost exit under the leaf. Exits under a pass-through's
  other side are never reached.
- The base word is ``(base << 2^b) | mask``, ``mask`` the reached exits.
  Exit e leads to slot ``base + popcount(mask & (2^e - 1))``: the children of
  a block are consecutive slots, in exit order.
- A leaf slot holds its f32 value in word 0 and -1 in the base word.
- Slot t is tree t's root (a block, or a leaf for a one-leaf tree).

So a descent reads one slot per b levels and one for the leaf, where it
read one 16-byte record per level; the swapped pairs and the neg form are the
records', so missing values route exactly as before.

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
from tahoe_tpu_torch.forest.quantize import (
    RankQuantizedForest,
    quantized_spec_for_engines,
)
from tahoe_tpu_torch.forest.sparse import SparseForest, from_dense
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops._build import CudaKernel, check_operand, ptr
from tahoe_tpu_torch.ops.graphed import GraphedEngine
from tahoe_tpu_torch.ops.rank_kernel import (
    PLAIN_CHUNK_BYTES,
    RankInput,
    _int32_matmul,
    pack_records,
    rank_input,
    rank_quantize,
    rank_virtual_cols,
)
from tahoe_tpu_torch.ops.rank_transform import LANE

SPARSE_RANK = CudaKernel(
    "tahoe_sparse_rank",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/sparse_rank.cu",
    replaces="tahoe_tpu/ops/sparse_kernel.py:251",
)

# int32 words of one node record: lane, k, child, value bits
RECORD_WORDS = 4
RECORD_BYTES = 4 * RECORD_WORDS
# levels of one slot (csrc/sparse_rank.cu TAHOE_SPARSE_LEVELS): 2^2 words,
# one 16-byte load; the kernel refuses slots of another width. Slots of 3
# levels (32 bytes, two loads) ran slower (PERF.md)
SPARSE_LEVELS = 2
# a pass-through node word: k = -2^19 puts its diff below -16,384, the least
# 127 * p[lane] + p[lane + 30] of any planes
PASS_WORD = -(1 << 31)
# a leaf slot's base word
LEAF_BASE = -1


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


def sparse_blocks(records: np.ndarray, roots: np.ndarray,
                  levels: int = SPARSE_LEVELS
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """Records [N, 4] -> (slots [S, 2^levels] int32, the record each slot
    starts at [S]: a block's top node or a leaf, steps): the sparse kernel's
    layout (module docstring), ``steps`` the slots the longest walk reads.

    Slots are laid out in waves: wave 0 holds the roots, slot t tree t's;
    wave w + 1 the entries that wave w's blocks exit to, block by block and
    in exit order, so that a block's children are consecutive."""
    if levels not in (2, 3):
        raise ValueError(f"slots of {levels} levels: the kernel takes 2 or 3")
    W = 1 << levels
    records = np.asarray(records, np.int32)
    child = records[:, 2].astype(np.int64)
    internal = child >= 0
    words = np.full(records.shape[0], PASS_WORD, np.int64)
    words[internal] = pack_records(records[internal, 1], records[internal, 0])
    entries = np.asarray(roots, np.int64)
    waves, starts, start = [], [], 0
    while entries.size:
        n = entries.size
        out = np.zeros((n, W), np.int64)
        block = internal[entries]
        out[~block, 0] = records[entries[~block], 3]
        out[~block, W - 1] = LEAF_BASE
        # the node each position holds (-1: none), positions 0..W-2 the
        # block's, W-1..2W-2 its exits; a leaf walks on to its left child
        pos = np.full((int(block.sum()), 2 * W - 1), -1, np.int64)
        pos[:, 0] = entries[block]
        bw = np.full((pos.shape[0], W), PASS_WORD, np.int64)
        for i in range(W - 1):
            r = pos[:, i]
            inner = (r >= 0) & internal[np.maximum(r, 0)]
            c = child[np.maximum(r, 0)]
            bw[inner, i] = words[r[inner]]
            pos[:, 2 * i + 1] = np.where(inner, c, r)
            pos[:, 2 * i + 2] = np.where(inner, c + 1, -1)
        exits = pos[:, W - 1:]
        reached = exits >= 0
        first = start + n + np.cumsum(reached.sum(axis=1)) - reached.sum(axis=1)
        if first.size and first.max() >= 1 << (31 - W):
            raise ValueError(f"{first.max()} slots: past the base word's "
                             f"{31 - W} bits")
        bw[:, W - 1] = (first << W) | (reached.astype(np.int64)
                                       << np.arange(W)).sum(axis=1)
        out[block] = bw
        waves.append(out.astype(np.int32))
        starts.append(entries)
        start += n
        entries = exits[reached]
    return np.concatenate(waves), np.concatenate(starts), len(waves)


def sparse_block_walk(planes: torch.Tensor, slots: torch.Tensor, trees: int,
                      steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The sparse kernel's walk in torch, the same decode and arithmetic:
    (the leaf slot each row reaches in each tree [R, T], the slots it reads
    [R, T]). The twin the CPU tests hold to the plain version, and the count
    of slots (each one 32-byte sector or less) a run reads."""
    W = slots.shape[1]
    levels = W.bit_length() - 1
    s64 = slots.to(torch.int64)
    out_leaf, out_reads = [], []
    chunk = max(1, PLAIN_CHUNK_BYTES // (trees * (8 * W + 64)))
    for r0 in range(0, planes.shape[0], chunk):
        p = planes[r0:r0 + chunk].to(torch.int32)
        R = p.shape[0]
        slot = torch.arange(trees, device=p.device).expand(R, trees).clone()
        reads = torch.zeros(R, trees, dtype=torch.int64, device=p.device)
        done = torch.zeros(R, trees, dtype=torch.bool, device=p.device)
        for _ in range(steps):
            w = s64[slot]
            base = w[..., W - 1]
            leaf = base < 0
            reads += ~done
            done |= leaf
            w = torch.where(leaf[..., None], PASS_WORD, w)
            i = torch.zeros_like(slot)
            for _ in range(levels):
                word = torch.gather(w, 2, i[..., None])[..., 0]
                lane = (word & 0xFFF).view(R, -1)
                diff = (127 * torch.gather(p, 1, lane) + torch.gather(p, 1, lane + 30)
                        ).view(R, trees) + (word >> 12)
                i = 2 * i + 1 + (diff >= 0).long()
            below = base & (torch.bitwise_left_shift(torch.ones_like(i),
                                                     i - (W - 1)) - 1)
            before = sum((below >> b) & 1 for b in range(W))
            slot = torch.where(leaf, slot, (base >> W) + before)
        out_leaf.append(slot)
        out_reads.append(reads)
    return torch.cat(out_leaf), torch.cat(out_reads)


def record_depths(records: torch.Tensor, max_depth: int) -> torch.Tensor:
    """The depth of every record in its tree, roots at 0: a descent to a
    leaf at depth d reads d + 1 records, and ceil(d / SPARSE_LEVELS) + 1
    slots."""
    rec = records.to(torch.int64)
    internal = rec[:, 2] >= 0
    kids = rec[internal, 2]
    depth = torch.zeros(rec.shape[0], dtype=torch.int64, device=records.device)
    for _ in range(max_depth):
        depth[kids] = depth[kids + 1] = depth[internal] + 1
    return depth


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


def sparse_margins_cuda(planes: torch.Tensor, slots: torch.Tensor, trees: int,
                        steps: int) -> torch.Tensor:
    """The sparse kernel on the card (csrc/sparse_rank.cu), over
    ``sparse_blocks``' slots: tree t starts at slot t, and no walk reads more
    than ``steps`` slots."""
    dev = planes.device
    check_operand(planes, "planes", torch.int8, dev, 2)
    check_operand(slots, "slots", torch.int32, dev, 2)
    R, K = planes.shape
    if K % LANE or not 1 <= K // LANE <= RANK_MAX_GROUPS:
        raise ValueError(f"planes width {K} is not 128 x 1..16 groups")
    if slots.shape[1] % 4 or slots.data_ptr() % 16:
        raise ValueError(f"slots {tuple(slots.shape)} are not 16-byte aligned "
                         f"rows of int32 words")
    if not 1 <= trees <= slots.shape[0]:
        raise ValueError(f"{trees} trees over {slots.shape[0]} slots")
    out = torch.empty(R, dtype=torch.float32, device=dev)
    SPARSE_RANK.launch(dev, ptr(planes), R, K // LANE, ptr(slots),
                       slots.shape[1], trees, steps, ptr(out))
    return out


def sparse_margins(planes: torch.Tensor, t: "SparseTables") -> torch.Tensor:
    """The sparse kernel on a CUDA tensor (over ``t.slots``), its plain
    version on a CPU tensor (over ``t.records``)."""
    if planes.device.type == "cpu":
        return sparse_margins_plain(planes, t.records, t.roots, t.max_depth)
    return sparse_margins_cuda(planes, t.slots, t.roots.shape[0], t.steps)


@dataclasses.dataclass(frozen=True)
class SparseTables(RankInput):
    """A forest compiled for the sparse kernel: kernel A's RankInput, plus

    - ``records`` [N, 4] int32: the pruned pool's node records;
    - ``roots`` [T] int32: each tree's root record;
    - ``max_depth``: the deepest leaf's depth (the plain descent's steps);
    - ``slots`` [S, 2^SPARSE_LEVELS] int32: the kernel's layout of the same
      pool (``sparse_blocks``), slot t tree t's root;
    - ``steps``: the slots the longest walk reads.
    """

    records: torch.Tensor
    roots: torch.Tensor
    max_depth: int
    slots: torch.Tensor
    steps: int


def sparse_tables(spec: ForestSpec, band: int | None = None, *,
                  device: torch.device,
                  prequantized: tuple[RankQuantizedForest, np.ndarray | None]
                  | None = None) -> SparseTables:
    """Compile ``spec`` for the sparse kernel (sparse_kernel.py:415-443).

    ``prequantized`` = (q, gather), as rank_kernel.rank_tables takes it: a
    tree subset of a forest quantized once, so that every subset shares one
    kernel-A transform (parallel/sharded.py's tree shards)."""
    q, gather = (prequantized if prequantized is not None
                 else rank_quantize(spec, band))
    fields = rank_input(q, gather, device=device)
    sf = from_dense(quantized_spec_for_engines(q))
    records, _ = sparse_records(sf)
    slots, _, steps = sparse_blocks(records, sf.tree_roots)
    return SparseTables(
        **fields,
        records=torch.as_tensor(records, device=device),
        roots=torch.as_tensor(sf.tree_roots, dtype=torch.int32, device=device),
        max_depth=sf.max_depth,
        slots=torch.as_tensor(slots, device=device),
        steps=steps,
    )


class SparseRankEngine(GraphedEngine):
    """Rank-quantize a forest, prune it to its CSR pool and run it through
    kernel A and the sparse kernel (Strategy.SPARSE where the rank planes
    take the forest)."""

    def __init__(self, forest: ForestSpec, *, device, band: int | None = None,
                 prequantized: tuple[RankQuantizedForest, np.ndarray | None,
                                     float] | None = None):
        self.device = resolve_device(device)
        # ``prequantized`` = (q, gather, raw sentinel), as RankFoldEngine
        # takes it
        self.raw_missing = forest.missing
        if prequantized is not None:
            q, gather, self.raw_missing = prequantized
            prequantized = (q, gather)
        self.tables = sparse_tables(forest, band, device=self.device,
                                    prequantized=prequantized)
        self.q = self.tables.q
        self.groups = self.tables.groups
        self.num_trees = forest.num_trees
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold
        # one CUDA graph a shape on the card (ops/graphed.py), as the JAX
        # engine jits _predict_impl
        self._graph()

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
        return sparse_margins(planes.contiguous(), self.tables)

    def _stage(self, rows, out: torch.Tensor | None = None) -> torch.Tensor:
        return self.tables.stage(rows, out)

    def _margins_staged(self, x: torch.Tensor) -> torch.Tensor:
        return self.margins_planes(self.tables.planes_staged(x, self.raw_missing))
