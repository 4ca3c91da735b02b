"""Rank traversal: int8 rank planes -> f32 margins (kernel B), the fused
transform + traversal, and the rank-MXU engine around them.

The port of tahoe_tpu/ops/rank_kernel.py ``RankFoldEngine``. The host side
is the JAX engine's, on the port's copy of the numpy compiler:
``rank_quantize`` (truncate_depth -> compact_features -> quantize ->
band_split, shared with the sparse engine, ops/sparse_kernel.py) ->
quantized_spec_for_engines -> levelize -> rank_normalize. Each node's whole
routing rule (missing, def_left, exchange, compare) is one int8 column
R_d[:, node] with

    cond(node) = planes[row] . R_d[:, node] >= 0      (int32 sum)

and in the levelize/rank_normalize layout node j of level d has its children
at j (cond False) and j + 2^d (cond True) of level d + 1. A column has at
most four nonzeros, so kernel B reads each node as one int32 record
(``rank_records``) and computes the dot in closed form, as the fused kernel
does; their plain versions and the probes read the columns (``mats``).

With ``fuse_transform=True`` a forest of one plane group (<= 30 virtual
features) whose widest feature has more than 256 thresholds runs the fused
kernel (csrc/rank_fused.cu): kernel A's search and kernel B's walk in one
launch, each row's pair values kept in shared memory and read through the
records remapped to them (``fused_records``). That is the JAX engine's gate (rank_kernel.py:807-814,
:1043) without its two TPU grid conditions (a split level, no stream-once
chunking), which have no counterpart here; other forests run kernels A and
B, as the JAX engine does.

Not ported, because they are TPU workarounds with no counterpart here: the
row/tree tiling and tree padding with RANK_LANE_C1 = -1 columns, the split
levels and stream-once grid (VMEM budgets), cond_lead/chunk_lead, the
sub-128-lane leaf split-halves layout, and the fused kernel's ``planes0``
seed dispatch (it primes the TPU's ping-pong pipeline).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tahoe_tpu_torch.config import resolve_device
from tahoe_tpu_torch.forest.compiler import (
    RANK_BASE,
    RANK_GROUP_COLS,
    RANK_LANE_C1,
    RANK_LANE_C127,
    RANK_LANE_NQH,
    RANK_LANE_NQL,
    RANK_LANE_QH,
    RANK_LANE_QL,
    RANK_MAX,
    RANK_MAX_COLS,
    RANK_MAX_GROUPS,
    compact_features,
    levelize,
    rank_groups,
    rank_normalize,
    reachable_depths,
    reachable_mask,
    truncate_depth,
)
from tahoe_tpu_torch.forest.quantize import (
    RankQuantizedForest,
    band_split,
    quantize,
    quantized_spec_for_engines,
)
from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops._build import CudaKernel, check_operand, ptr
from tahoe_tpu_torch.ops.graphed import GraphedEngine, graphed
from tahoe_tpu_torch.ops.fold_kernel import _wavefronts
from tahoe_tpu_torch.ops.rank_transform import (
    LANE,
    TABLE_ALIGN,
    rank_planes,
    rank_planes_plain,
    threshold_table,
)
from tahoe_tpu_torch.ops.rows import finish_rows, stage_rows

RANK_FOLD = CudaKernel(
    "tahoe_rank_fold",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/rank_fold.cu",
    replaces="tahoe_tpu/ops/rank_kernel.py:231",
)

# kernel B's node record: (k << RECORD_LANE_BITS) | lane
RECORD_LANE_BITS = 12
RECORD_LANE_MASK = (1 << RECORD_LANE_BITS) - 1

RANK_FUSED = CudaKernel(
    "tahoe_rank_fused",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    source="tahoe_tpu_torch/csrc/rank_fused.cu",
    replaces="tahoe_tpu/ops/rank_kernel.py:560",
)

# the JAX engine runs its fused kernel only on the bucketed (v2) transform,
# which it takes for more than 256 thresholds in the widest feature or more
# than 128 virtual features (rank_kernel.py:1043)
FUSE_MIN_THRESHOLDS = 256

# the plain version folds a chunk of rows at a time; this bounds the bytes of
# one chunk's widest level (int32 diffs + the f32 fold frontier)
PLAIN_CHUNK_BYTES = 256 << 20

# kernel B's block and staging (csrc/common.cuh): int16 pair values up to
# TAHOE_RANK_PAIR_GROUPS plane groups, the bytes past them; rows a block as
# many whole warps as fit kRankSmemTarget, at most kRankMaxRows. The default
# build's values: a rebuild with other -D values (scripts/kernel_ab.py b)
# sizes otherwise; tests/test_torch_cuda.py holds these to the library's
# tahoe_rank_launch_shape.
RANK_PAIR_GROUPS = 1
RANK_SMEM_TARGET = 96 * 1024
RANK_MAX_ROWS = 256


def rank_virtual_cols(forest: ForestSpec) -> int:
    """Virtual feature count after rank band splitting over LIVE features
    (engine/feasibility.py:203 of the JAX package)."""
    internal = ~forest.is_leaf & reachable_mask(forest)
    if not internal.any():
        return 1
    f = forest.fids[internal].ravel()
    v = forest.values[internal].ravel()
    order = np.lexsort((v, f))
    fs, vs = f[order], v[order]
    new = np.ones(fs.size, bool)
    new[1:] = (fs[1:] != fs[:-1]) | (vs[1:] != vs[:-1])
    k = np.bincount(fs[new], minlength=forest.num_cols)
    return int(sum(max(1, -(-int(k[ff]) // RANK_MAX)) for ff in np.unique(fs)))


def rank_quantize(spec: ForestSpec, band: int | None = None
                  ) -> tuple[RankQuantizedForest, np.ndarray | None]:
    """The host quantization both rank engines share (rank_kernel.py:662-668,
    sparse_kernel.py:415-437): truncate_depth -> compact_features ->
    quantize -> band_split. Returns (q, gather): the (banded) rank-quantized
    forest and the data column of each virtual feature, or None when that
    is the identity."""
    forest = truncate_depth(spec, int(reachable_depths(spec).max(initial=0)))
    forest, col_index = compact_features(forest)
    if forest.num_cols > RANK_MAX_COLS:
        raise NotImplementedError(
            f"rank kernels support <= {RANK_MAX_COLS} live features; "
            f"got {forest.num_cols}")
    q, vf_base = band_split(quantize(forest), band)
    if col_index is None:
        return q, vf_base
    if vf_base is None:
        return q, col_index
    return q, col_index[vf_base]


@dataclasses.dataclass(frozen=True)
class RankInput:
    """What kernel A needs, on one device; both rank engines' tables extend
    it.

    - ``q``: the (banded) rank-quantized forest, on the host;
    - ``col_index``: [F_v] int64 data-column gather (compaction composed
      with band expansion), or None;
    - ``thresholds`` [F_v, K] f32 / ``counts`` [F_v] int32: kernel A's
      tables (rank_transform.threshold_table).
    """

    q: RankQuantizedForest
    col_index: torch.Tensor | None
    thresholds: torch.Tensor
    counts: torch.Tensor

    @property
    def groups(self) -> int:
        return rank_groups(self.q.spec.num_cols)

    def stage(self, rows, out: torch.Tensor | None = None) -> torch.Tensor:
        """Raw rows [R, C] -> their source columns [R, F_v] f32 on the
        device (into ``out`` when given): the step that reads them."""
        return stage_rows(rows, device=self.thresholds.device,
                          col_index=self.col_index, out=out)

    def rows(self, rows, raw_missing: float) -> torch.Tensor:
        """Raw rows [R, C] -> kernel A's input [R, F_v] f32, NaN = missing."""
        return finish_rows(self.stage(rows), raw_missing)

    def planes_staged(self, x: torch.Tensor, raw_missing: float) -> torch.Tensor:
        """Staged rows (``stage``) -> int8 planes [R, 128*G] (kernel A)."""
        return rank_planes(finish_rows(x, raw_missing), self.thresholds,
                           self.counts)

    def planes(self, rows, raw_missing: float) -> torch.Tensor:
        """Raw rows [R, C] -> int8 planes [R, 128*G] (kernel A)."""
        return self.planes_staged(self.stage(rows), raw_missing)


def rank_input(q: RankQuantizedForest, gather: np.ndarray | None, *,
               device: torch.device) -> dict:
    """The RankInput fields of a quantized forest, on ``device``."""
    if q.spec.num_cols > RANK_MAX_COLS:
        raise NotImplementedError(
            f"banded forest needs {q.spec.num_cols} virtual features "
            f"> {RANK_MAX_COLS}")
    thresholds, counts = threshold_table(q.tables, device=device)
    return dict(
        q=q,
        col_index=(None if gather is None
                   else torch.as_tensor(gather, dtype=torch.int64, device=device)),
        thresholds=thresholds,
        counts=counts,
    )


@dataclasses.dataclass(frozen=True)
class RankTables(RankInput):
    """A forest compiled for the rank engine: kernel A's RankInput, plus

    - ``mats`` [T, 2^D - 1, 128*G] int8: node n = 2^d - 1 + j of a tree is
      column j of level d's R_d;
    - ``records`` [T, 2^D - 1] int32: the same nodes as kernel B's records
      (``rank_records``);
    - ``leaf`` [T, 2^D] f32, in the mirror-composed rank_normalize order;
    - ``fused_records`` [T, 2^D - 1] int32: the records as the fused kernel
      reads them (``fused_records``), or None past one plane group.
    """

    mats: torch.Tensor
    records: torch.Tensor
    leaf: torch.Tensor
    depth: int
    fused_records: torch.Tensor | None = None


def rank_records(mats: np.ndarray) -> np.ndarray:
    """Node columns [T, N, 128*G] int8 -> kernel B's records [T, N] int32.

    rank_normalize writes at most four nonzeros a column: 127 and 1 at the
    lanes ``lane`` and ``lane + 30`` of the node's feature segment (QH in the
    pos form, NQH in the neg form), and (c127, c1) at lanes 120 and 121 of
    group 0, where the planes carry 127 and 1. So for every row

        planes . column = 127 * p[lane] + p[lane + 30] + k,
        k = 127 * c127 + c1   (k in [-RANK_MAX, RANK_MAX - 1])

    and the record is ``(k << 12) | lane``. A pass-through node (c1 = -1
    alone) gets k = -1 and lane = 128*G, which kernel B points at zeros
    staged past the row. Raises if a column is not of that form."""
    T, N, K = mats.shape
    cols = mats.reshape(T * N, K)
    k = (RANK_BASE * cols[:, RANK_LANE_C127].astype(np.int32)
         + cols[:, RANK_LANE_C1])
    hit = cols.reshape(T * N, K // LANE, LANE) == RANK_BASE
    hit[:, :, RANK_LANE_QL:RANK_LANE_NQH] = False  # only QH and NQH lanes
    hit[:, :, RANK_LANE_NQL:] = False
    node, lane = np.nonzero(hit.reshape(T * N, K))
    lanes = np.full(T * N, K, np.int32)  # pass-through: past the row
    lanes[node] = lane
    if (np.bincount(node, minlength=T * N) > 1).any():
        raise ValueError("a rank column has two feature lanes")
    feature = np.zeros(T * N, bool)
    feature[node] = True
    pair = np.zeros(T * N, bool)
    pair[node] = cols[node, lane + (RANK_LANE_QL - RANK_LANE_QH)] == 1
    nonzeros = np.count_nonzero(cols, axis=1)
    want = (2 * feature + (cols[:, RANK_LANE_C127] != 0)
            + (cols[:, RANK_LANE_C1] != 0))
    if not ((pair == feature).all() and (nonzeros == want).all()
            and (k[~feature] == -1).all()):
        raise ValueError("a rank column is not of rank_normalize's form")
    return pack_records(k, lanes).reshape(T, N)


def fused_records(records: np.ndarray, num_features: int) -> np.ndarray:
    """Kernel B's records [T, N] of one plane group -> the fused kernel's.

    The fused kernel stages a row's pair values compactly, 2F + 1 int16 for
    F features: q of feature i at i, -q at F + i and a zero at 2F. Each
    record keeps its k and points at the same value there: lane i (QH) ->
    i, lane 60 + i (NQH) -> F + i, the pass-through lane 128 -> 2F. Raises on
    any other lane."""
    F = num_features
    if not 1 <= F <= RANK_GROUP_COLS:
        raise ValueError(f"one plane group holds 1..{RANK_GROUP_COLS} features; got {F}")
    r = np.asarray(records, np.int32)
    lane = r & RECORD_LANE_MASK
    pos = lane < F
    neg = (lane >= RANK_LANE_NQH) & (lane < RANK_LANE_NQH + F)
    passing = lane == LANE
    if not (pos | neg | passing).all():
        raise ValueError("a record points at a lane past the forest's features")
    compact = np.where(pos, lane, np.where(neg, lane - RANK_LANE_NQH + F, 2 * F))
    return pack_records(r >> RECORD_LANE_BITS, compact)


def pack_records(k: np.ndarray, lane: np.ndarray) -> np.ndarray:
    """(k, lane) -> int32 records ``(k << 12) | lane``; kernel B decodes
    ``lane = r & 0xFFF`` and ``k = r >> 12`` (arithmetic)."""
    k = np.asarray(k, np.int64)
    lane = np.asarray(lane, np.int64)
    if ((lane < 0) | (lane > RECORD_LANE_MASK)).any() or (np.abs(k) > RANK_MAX).any():
        raise ValueError(f"record fields out of range: |k| <= {RANK_MAX}, "
                         f"0 <= lane <= {RECORD_LANE_MASK}")
    return ((k << RECORD_LANE_BITS) | lane).astype(np.int32)


def rank_tables(spec: ForestSpec, band: int | None = None, *,
                device: torch.device,
                prequantized: tuple[RankQuantizedForest, np.ndarray | None]
                | None = None) -> RankTables:
    """Compile ``spec`` for the rank engine (rank_kernel.py:662-708, :932).

    ``prequantized`` = (q, gather) takes a forest quantized once for a
    larger forest, of which ``q.spec`` is a tree subset, and the final data
    column gather (rank_kernel.py:662-668): every subset then shares one
    threshold table and so one kernel-A transform."""
    q, gather = (prequantized if prequantized is not None
                 else rank_quantize(spec, band))
    fields = rank_input(q, gather, device=device)
    lev = levelize(quantized_spec_for_engines(q))
    mats, leaf = rank_normalize(lev)
    K = LANE * rank_groups(lev.num_cols)
    node_cols = (np.concatenate([m.transpose(1, 2, 0) for m in mats], axis=1)
                 if mats else np.zeros((lev.num_trees, 0, K), np.int8))
    node_cols = np.ascontiguousarray(node_cols)
    records = rank_records(node_cols)
    return RankTables(
        **fields,
        mats=torch.as_tensor(node_cols, device=device),
        records=torch.as_tensor(records, device=device),
        leaf=torch.as_tensor(leaf, device=device),
        depth=lev.depth,
        fused_records=(torch.as_tensor(fused_records(records, q.spec.num_cols),
                                       device=device)
                       if 1 <= q.spec.num_cols <= RANK_GROUP_COLS else None),
    )


def _int32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 [m, k] and int8 [k, n] (``int8 @ int8``
    returns int8 in torch and wraps)."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    # torch._int_mm's CUDA limits: m > 16, k and n multiples of 8
    m, n = a.shape[0], b.shape[1]
    a = F.pad(a, (0, 0, 0, max(32, -(-m // 8) * 8) - m))
    b = F.pad(b, (0, -(-n // 8) * 8 - n))
    return torch._int_mm(a, b)[:m, :n]


def rank_margins_plain(planes: torch.Tensor, mats: torch.Tensor,
                       leaf: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B: per level an int32 matmul of the
    planes against every node column, then the bottom-up where-fold of the
    JAX kernels (lo = w[:n], hi = w[n:2n]); leaves summed in f64."""
    T, _, K = mats.shape
    levels = [mats[:, (1 << d) - 1:(2 << d) - 1, :].reshape(T << d, K)
              .t().contiguous() for d in range(depth)]
    chunk = max(1, PLAIN_CHUNK_BYTES // (8 * T << max(depth - 1, 0)))
    out = []
    for r0 in range(0, planes.shape[0], chunk):
        p = planes[r0:r0 + chunk]
        w = leaf.expand(p.shape[0], T, 1 << depth)
        for d in range(depth - 1, -1, -1):
            n = 1 << d
            cond = (_int32_matmul(p, levels[d]) >= 0).view(-1, T, n)
            w = torch.where(cond, w[..., n:2 * n], w[..., :n])
        out.append(w[..., 0].double().sum(dim=1).float())
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=planes.device)
    return torch.cat(out)


def rank_row_words(groups: int) -> int:
    """Shared-memory words of one row staged by kernel B (csrc/common.cuh
    tahoe_rank_row_words): the int16 pair values over lanes [0, 128G], or
    the bytes and 32 zero bytes past them; both odd."""
    return 64 * groups + 1 if groups <= RANK_PAIR_GROUPS else 32 * groups + 9


def rank_block_rows(groups: int) -> int:
    """Rows (threads) of one kernel-B block (tahoe_rank_block_rows)."""
    fit = RANK_SMEM_TARGET // (4 * rank_row_words(groups)) & ~31
    return max(32, min(RANK_MAX_ROWS, fit))


def pair_values(planes: torch.Tensor) -> torch.Tensor:
    """[R, 128G + 1] int32: v[lane] = 127 * p[lane] + p[lane + 30], p zero
    past the row, so v[128G] (a pass-through node's lane) is 0."""
    p = F.pad(planes.to(torch.int32), (0, RANK_LANE_QL - RANK_LANE_QH + 1))
    K = planes.shape[1]
    return RANK_BASE * p[:, :K + 1] + p[:, RANK_LANE_QL - RANK_LANE_QH:][:, :K + 1]


def record_conds(v: torch.Tensor, records: torch.Tensor,
                 nodes: torch.Tensor) -> torch.Tensor:
    """Kernel B's visit body (csrc/common.cuh tahoe_rank_record_diff) at
    the nodes ``nodes`` [R, T] (node n of tree t) of rows with pair values
    ``v`` (``pair_values``): cond = v[lane] + k >= 0, lane = r & 0xFFF and
    k = r >> 12 of the node's record r. [R, T] bool."""
    r = records[torch.arange(records.shape[0], device=records.device), nodes]
    lane = (r & RECORD_LANE_MASK).long()
    return torch.gather(v, 1, lane) + (r >> RECORD_LANE_BITS) >= 0


def rank_walk(planes: torch.Tensor, records: torch.Tensor,
              depth: int) -> torch.Tensor:
    """The nodes kernel B visits, [D + 1, R, T] int64: level d's node n of
    each (row, tree), n += (1 + cond) << d from the root; the last entry is
    the leaf j each walk reaches."""
    v = pair_values(planes)
    n = torch.zeros(planes.shape[0], records.shape[0], dtype=torch.int64,
                    device=planes.device)
    out = []
    for d in range(depth):
        out.append(n)
        n = n + ((1 + record_conds(v, records, n).long()) << d)
    out.append(n - ((1 << depth) - 1))
    return torch.stack(out)


def walk_paths(planes: torch.Tensor, records: torch.Tensor,
               depth: int) -> torch.Tensor:
    """The leaf j of every (row, tree) walk, as the walk probes take it
    (ops/probes.py): [ceil(T / 8), R, 8] uint8, tree 8g + b at [g, row, b]
    (tail bytes 0); depth <= 8."""
    if depth > 8:
        raise ValueError(f"a walk's leaf takes a byte up to depth 8; got {depth}")
    j = rank_walk(planes, records, depth)[-1]
    j = F.pad(j, (0, -records.shape[0] % 8)).to(torch.uint8)
    return j.view(planes.shape[0], -1, 8).transpose(0, 1).contiguous()


def rank_wavefronts(planes: torch.Tensor, t: RankTables,
                    rows: int = 2048) -> dict:
    """Kernel B's L1 traffic per warp-visit (a warp's 32 rows at one
    (tree, level)), reckoned from the real walks of the first ``rows`` rows
    (whole warps): the 128-byte lines and 32-byte sectors its 32 record
    loads touch, and the shared-memory wavefronts of its reads of the staged
    rows (one read of the pair value, or two of the bytes) at kernel B's
    row stride, in its block. Means over every warp-visit, and per level."""
    R = min(rows, planes.shape[0]) // 32 * 32
    walk = rank_walk(planes[:R], t.records, t.depth)
    T, N = t.records.shape
    dev = planes.device
    tree = torch.arange(T, device=dev)
    slot = torch.arange(R, device=dev) % rank_block_rows(t.groups)
    counts = []
    for d in range(t.depth):
        n = walk[d]
        lane = (t.records[tree, n] & RECORD_LANE_MASK).long()
        counts.append(warp_visit_counts((tree * N)[None, :] + n, lane,
                                        slot[:, None].expand(R, T), t.groups))
    per_level = {k: [float(c[k].double().mean()) for c in counts]
                 for k in ("lines", "sectors", "wavefronts")}
    return {"rows": R, "stride_words": rank_row_words(t.groups),
            "block_rows": rank_block_rows(t.groups),
            "per_warp_visit": {k: sum(v) / max(len(v), 1)
                               for k, v in per_level.items()},
            "per_level": per_level}


def warp_visit_counts(words: torch.Tensor, lanes: torch.Tensor,
                      slots: torch.Tensor, groups: int) -> dict:
    """For visits [R, ...] whose rows go 32 to a warp: the record loads'
    word offsets ``words``, the lanes read, and each row's slot in its
    block -> per warp-visit [R / 32, ...] the distinct 128-byte lines and
    32-byte sectors of the record loads (records 4 bytes each, from an
    aligned base) and the shared-memory wavefronts of the staged-row reads
    (``fold_kernel._wavefronts`` at kernel B's row stride)."""
    def warps(a):  # [R, ...] -> [..., R / 32, 32]
        a = a.reshape(a.shape[0] // 32, 32, -1).permute(2, 0, 1)
        return a.reshape(*words.shape[1:], words.shape[0] // 32, 32)

    w, lane = warps(words), warps(lanes)
    base = warps(slots) * rank_row_words(groups)
    if groups <= RANK_PAIR_GROUPS:
        wave = _wavefronts(base + lane // 2)
    else:
        wave = (_wavefronts(base + lane // 4)
                + _wavefronts(base + (lane + RANK_LANE_QL - RANK_LANE_QH) // 4))
    return {"lines": _distinct(w // 32), "sectors": _distinct(w // 8),
            "wavefronts": wave}


def _distinct(a: torch.Tensor) -> torch.Tensor:
    """Distinct values along the last axis."""
    s = a.sort(dim=-1).values
    return 1 + (s[..., 1:] != s[..., :-1]).sum(dim=-1)


def rank_margins_cuda(planes: torch.Tensor, records: torch.Tensor,
                      leaf: torch.Tensor, depth: int) -> torch.Tensor:
    """Kernel B on the card (csrc/rank_fold.cu): planes [R, 128*G] int8 and
    the records ``rank_records`` built for planes of that width."""
    dev = planes.device
    check_operand(planes, "planes", torch.int8, dev, 2)
    check_operand(records, "records", torch.int32, dev, 2)
    check_operand(leaf, "leaf", torch.float32, dev, 2)
    R, K = planes.shape
    T = leaf.shape[0]
    if K % LANE or not 1 <= K // LANE <= RANK_MAX_GROUPS:
        raise ValueError(f"planes width {K} is not 128 x 1..16 groups")
    if (T < 1 or records.shape != (T, (1 << depth) - 1)
            or leaf.shape[1] != 1 << depth):
        raise ValueError(
            f"tables {tuple(records.shape)} / {tuple(leaf.shape)} do not "
            f"match depth {depth}")
    out = torch.empty(R, dtype=torch.float32, device=dev)
    RANK_FOLD.launch(dev, ptr(planes), R, K // LANE, ptr(records), T, depth,
                     ptr(leaf), ptr(out))
    return out


def rank_margins(planes: torch.Tensor, t: RankTables) -> torch.Tensor:
    """Kernel B on a CUDA tensor, its plain version on a CPU tensor."""
    if planes.device.type == "cpu":
        return rank_margins_plain(planes, t.mats, t.leaf, t.depth)
    return rank_margins_cuda(planes, t.records, t.leaf, t.depth)


def rank_margins_fused_plain(x: torch.Tensor, thresholds: torch.Tensor,
                             counts: torch.Tensor, mats: torch.Tensor,
                             leaf: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: kernel A's plain version,
    then kernel B's."""
    return rank_margins_plain(rank_planes_plain(x, thresholds, counts), mats,
                              leaf, depth)


def rank_margins_fused_cuda(x: torch.Tensor, thresholds: torch.Tensor,
                            counts: torch.Tensor, records: torch.Tensor,
                            leaf: torch.Tensor, depth: int) -> torch.Tensor:
    """The fused kernel on the card (csrc/rank_fused.cu): rows [R, F_v] f32
    (NaN = missing, F_v <= 30, one plane group), kernel A's aligned table
    (K % 16 == 0, 16-byte aligned; rank_transform.aligned_table) and the
    records ``fused_records`` built for F_v features -> margins [R] f32."""
    dev = x.device
    check_operand(x, "x", torch.float32, dev, 2)
    check_operand(thresholds, "thresholds", torch.float32, dev, 2)
    check_operand(counts, "counts", torch.int32, dev, 1)
    check_operand(records, "records", torch.int32, dev, 2)
    check_operand(leaf, "leaf", torch.float32, dev, 2)
    R, nf = x.shape
    T = leaf.shape[0]
    if not 1 <= nf <= RANK_GROUP_COLS:
        raise ValueError(f"the fused kernel takes 1..{RANK_GROUP_COLS} "
                         f"features (one plane group); x has {nf}")
    if thresholds.shape[0] != nf or counts.shape[0] != nf:
        raise ValueError(f"tables cover {thresholds.shape[0]} features, x has {nf}")
    if thresholds.shape[1] % TABLE_ALIGN or thresholds.data_ptr() % 16:
        raise ValueError(f"the fused kernel takes kernel A's aligned table "
                         f"(K % {TABLE_ALIGN} == 0, 16-byte aligned; "
                         f"rank_transform.aligned_table); got K = "
                         f"{thresholds.shape[1]} at {thresholds.data_ptr() % 16} "
                         f"bytes past 16")
    if (T < 1 or records.shape != (T, (1 << depth) - 1)
            or leaf.shape[1] != 1 << depth):
        raise ValueError(
            f"tables {tuple(records.shape)} / {tuple(leaf.shape)} do not "
            f"match depth {depth}")
    out = torch.empty(R, dtype=torch.float32, device=dev)
    RANK_FUSED.launch(dev, ptr(x), R, nf, ptr(thresholds), thresholds.shape[1],
                      ptr(counts), ptr(records), T, depth, ptr(leaf), ptr(out))
    return out


def rank_margins_fused(x: torch.Tensor, t: RankTables) -> torch.Tensor:
    """The fused kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return rank_margins_fused_plain(x, t.thresholds, t.counts, t.mats, t.leaf,
                                        t.depth)
    if t.fused_records is None:
        raise ValueError("the fused kernel takes one plane group; these tables "
                         f"have {t.groups}")
    return rank_margins_fused_cuda(x, t.thresholds, t.counts, t.fused_records,
                                   t.leaf, t.depth)


def fuse_admits(q: RankQuantizedForest) -> bool:
    """Whether ``fuse_transform`` fuses on a quantized forest: the JAX gate
    (rank_kernel.py:807-814) less its TPU grid conditions. One plane group
    (<= 30 virtual features) already rules out the v2 transform's other
    arm, more than 128 virtual features (:1043)."""
    return (rank_groups(q.spec.num_cols) == 1
            and q.max_ranks > FUSE_MIN_THRESHOLDS)


class RankFoldEngine(GraphedEngine):
    """Rank-quantize a forest and run it through kernels A and B, or the
    fused kernel.

    ``predict(rows)`` takes raw f32 rows (transform, then traversal; one
    fused launch when ``fused``); ``predict_planes`` takes planes encoded
    once per batch (the serving path of bench.py's ``rank_mxu_planes_us``).
    """

    def __init__(self, forest: ForestSpec, *, device, band: int | None = None,
                 prequantized: tuple[RankQuantizedForest, np.ndarray | None,
                                     float] | None = None,
                 fuse_transform: bool = False):
        self.device = resolve_device(device)
        # the rank-domain spec's sentinel is NaN (quantized_spec_for_engines);
        # raw rows still carry the forest's own. ``prequantized`` = (q,
        # gather, raw sentinel) for a tree subset of a forest quantized once
        # (rank_tables; rank_kernel.py:647-668)
        self.raw_missing = forest.missing
        if prequantized is not None:
            q, gather, self.raw_missing = prequantized
            prequantized = (q, gather)
        self.tables = rank_tables(forest, band, device=self.device,
                                  prequantized=prequantized)
        self.q = self.tables.q
        self.groups = self.tables.groups
        self.fused = bool(fuse_transform and fuse_admits(self.q))
        self.num_trees = forest.num_trees
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold
        # one CUDA graph a shape on the card (ops/graphed.py), as the JAX
        # engine jits _predict_impl
        self._graph()
        self._predict_planes = graphed(self._predict_planes_impl, self.device,
                                       self._stage_planes)

    def transform(self, rows) -> torch.Tensor:
        """Raw rows [R, C] -> int8 planes [R, 128*G] (kernel A)."""
        return self.tables.planes(rows, self.raw_missing)

    def margins_planes(self, planes) -> torch.Tensor:
        planes = torch.as_tensor(planes, dtype=torch.int8, device=self.device)
        return rank_margins(planes.contiguous(), self.tables)

    def _stage(self, rows, out: torch.Tensor | None = None) -> torch.Tensor:
        return self.tables.stage(rows, out)

    def _stage_planes(self, planes, out: torch.Tensor | None = None) -> torch.Tensor:
        return stage_rows(planes, device=self.device, dtype=torch.int8, out=out)

    def _margins_staged(self, x: torch.Tensor) -> torch.Tensor:
        t = self.tables
        if not self.fused:
            return self.margins_planes(t.planes_staged(x, self.raw_missing))
        return rank_margins_fused(finish_rows(x, self.raw_missing), t)

    def _predict_planes_impl(self, planes) -> torch.Tensor:
        return self._finish(self.margins_planes(planes))

    def predict_planes(self, planes) -> torch.Tensor:
        return self._predict_planes(planes)
