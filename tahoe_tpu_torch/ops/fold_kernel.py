"""f32 fold traversal: rows -> f32 margins (kernel C and the deep kernel).

The port of tahoe_tpu/ops/fold_kernel.py ``FoldKernelEngine``. The host side
is the JAX engine's, on the port's copy of the numpy compiler: levelize ->
used-feature compaction -> one of three node forms, chosen as the JAX engine chooses them
(fold_kernel.py:135-165):

- **dual** (ge, <= 64 live features): ge_normalize folds missing routing,
  def_left and exchange into one compare per node on rows carried as
  ``[x, -x]`` lanes, ``cond = x2[fid'] >= t'``; fid' >= F picks the negated
  lane;
- **sign** (ge, 65-512 live features): the same compare with rows kept at
  width F and the negation applied on read, ``cond = (neg ? -x[f] : x[f])
  >= t'``; the node code is f, or ~f (< 0) for a negated node;
- **non-ge** (only when asked, ``ge_mode=False``; <= 128 features, compacted
  only above 128 columns): levelize's own thresholds with ``cond = (sel_lt ?
  x[f] < t : x[f] >= t) XOR flip``, sel_lt = def_right ^ invert and flip =
  def_right (fold_kernel.py:420-438), packed as f | sel_lt << 29 | flip << 30.

Pass-through nodes hold a NaN threshold (always False); ge_normalize's
negated thresholds are ``nextafter(-t, +inf)``, denormal near 0. Node j of
level d has its children at j and j + 2^d of level d + 1, exactly as in the
rank engine.

Two kernels run these tables, each with one entry point and one launch
counter per form, and both read a tree's nodes as the same 16-byte blocks of
two levels (``deep_blocks``): three thresholds and one word of three 10-bit
codes, one load a block. Kernel C (csrc/fold.cu) stages tiles of whole trees
in shared memory (``fold_c_table``: each tree's blocks, then its leaves),
which arrive by TMA into a ring of two buffers while the last tile
descends, beside the block's rows at an odd stride; the deep kernel
(csrc/fold_deep.cu, the counterpart of the subtree-split fold) stages only
the rows and reads the blocks through the read-only cache. ``fold_plan``
picks the one measured faster, in every form (PERF.md section 6). The TPU
tiling, VMEM estimates, split grid and compile walls have no counterpart
here.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tahoe_tpu_torch.config import GpuLimits, resolve_device
from tahoe_tpu_torch.forest.compiler import compact_leveled, ge_normalize, levelize
from tahoe_tpu_torch.forest.spec import ForestSpec, LeveledForest
from tahoe_tpu_torch.ops._build import CudaKernel, check_operand, ptr
from tahoe_tpu_torch.ops.graphed import GraphedEngine
from tahoe_tpu_torch.ops.rows import finish_rows, stage_rows

# the dual-lane form's feature cap: [x, -x] within the fold's 128 lanes
MAX_DUAL_COLS = 64
# the sign form's cap, the JAX package's (fold_kernel.py:54), so that both
# sides agree on what is feasible
MAX_SIGN_COLS = 512
# the JAX non-ge kernel gathers from one 128-lane feature vreg
MAX_NONGE_COLS = 128
# deeper forests are the SPARSE strategy's (ops/sparse_kernel.py)
MAX_DENSE_DEPTH = 15
# bits of one node code in a block (csrc/common.cuh kCodeBits): the sign
# form's codes lie in [-512, 511], the dual form's in [0, 128), the non-ge
# form's in [0, 512) (BLOCK_NONGE_*)
DEEP_CODE_BITS = 10
# fold_plan's route, fit to scripts/kernel_ab.py route (kernel C against
# the deep kernel on the same tables, 22 shapes, 65,536 rows on an H100;
# PERF.md section 6): kernel C was the faster on every shape whose block
# restages at most 3.73 bytes of tables per node visit, tree_bytes / (rows
# x depth), and on every one whose rows the deep kernel cannot hold 256 a
# block; the deep kernel at 12.44 (deep12-class)
C_MAX_STAGED_PER_VISIT = 8.0
# kernel C's shared memory past its rows and tiles: two 8-byte mbarriers
C_BARRIER_BYTES = 16
# kernel C's trees in flight a thread (csrc/fold.cu TAHOE_FOLD_TREES)
C_TREES_IN_FLIGHT = 8
# non-ge node code bits in the tables (fids)
NONGE_SEL_LT = 1 << 29
NONGE_FLIP = 1 << 30
NONGE_FID = NONGE_SEL_LT - 1
# ... and in a block's 10-bit field (csrc/common.cuh kBlockNonGe*): a 7-bit
# feature (<= MAX_NONGE_COLS), sel_lt and flip
BLOCK_NONGE_SEL_LT = 1 << 7
BLOCK_NONGE_FLIP = 1 << 8
BLOCK_NONGE_FID = BLOCK_NONGE_SEL_LT - 1

_FOLD_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]
FOLD = CudaKernel("tahoe_fold", _FOLD_ARGS,
                  source="tahoe_tpu_torch/csrc/fold.cu",
                  replaces="tahoe_tpu/ops/fold_kernel.py:531")
FOLD_SIGN = CudaKernel("tahoe_fold_sign", _FOLD_ARGS,
                       source="tahoe_tpu_torch/csrc/fold.cu",
                       replaces="tahoe_tpu/ops/fold_kernel.py:594")
FOLD_NONGE = CudaKernel("tahoe_fold_nonge", _FOLD_ARGS,
                        source="tahoe_tpu_torch/csrc/fold.cu",
                        replaces="tahoe_tpu/ops/fold_kernel.py:562")
_DEEP_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
FOLD_DEEP = CudaKernel("tahoe_fold_deep", _DEEP_ARGS,
                       source="tahoe_tpu_torch/csrc/fold_deep.cu",
                       replaces="tahoe_tpu/ops/fold_kernel.py:688")
FOLD_DEEP_SIGN = CudaKernel("tahoe_fold_deep_sign", _DEEP_ARGS,
                            source="tahoe_tpu_torch/csrc/fold_deep.cu",
                            replaces="tahoe_tpu/ops/fold_kernel.py:688")
FOLD_DEEP_NONGE = CudaKernel("tahoe_fold_deep_nonge", _DEEP_ARGS,
                             source="tahoe_tpu_torch/csrc/fold_deep.cu",
                             replaces="tahoe_tpu/ops/fold_kernel.py:562")
FOLD_KERNELS = {"dual": FOLD, "sign": FOLD_SIGN, "nonge": FOLD_NONGE}
DEEP_KERNELS = {"dual": FOLD_DEEP, "sign": FOLD_DEEP_SIGN,
                "nonge": FOLD_DEEP_NONGE}

# the plain version folds a chunk of rows at a time; this bounds the bytes of
# one chunk's widest level (gathered x, its compare and the f32 frontier)
PLAIN_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class FoldTables:
    """A forest compiled for the f32 fold, as tensors on one device.

    - ``form``: "dual", "sign" or "nonge" (the module docstring);
    - ``col_index``: [F] int64 live-feature gather, or None;
    - ``thresholds`` / ``fids`` [T, 2^D - 1] f32 / int32: node
      n = 2^d - 1 + j of a tree is column j of level d; ``fids`` holds the
      form's node code;
    - ``leaf`` [T, 2^D] f32.
    """

    form: str
    col_index: torch.Tensor | None
    num_cols: int
    thresholds: torch.Tensor
    fids: torch.Tensor
    leaf: torch.Tensor
    depth: int

    @property
    def width(self) -> int:
        return row_width(self.form, self.num_cols)


def row_width(form: str, num_cols: int) -> int:
    """Width of the canonicalized rows the kernels read: ``[x, -x]`` in the
    dual form, x in the others."""
    return 2 * num_cols if form == "dual" else num_cols


def fold_leveled(spec: ForestSpec, ge_mode: bool = True
                 ) -> tuple[LeveledForest, np.ndarray | None, str]:
    """levelize + compaction + the form, as the JAX engine chooses them:
    compact when the dual form would not fit (ge) or above 128 columns
    (non-ge); dual up to 64 live features, sign above."""
    lev = levelize(spec)
    col_index = None
    if lev.num_cols > (MAX_DUAL_COLS if ge_mode else MAX_NONGE_COLS):
        lev, col_index = compact_leveled(lev)
    if not ge_mode:
        return lev, col_index, "nonge"
    return lev, col_index, "dual" if lev.num_cols <= MAX_DUAL_COLS else "sign"


def fold_tables(spec: ForestSpec, *, device: torch.device,
                ge_mode: bool = True) -> FoldTables:
    """Compile ``spec`` for the fold (fold_kernel.py:138-165, :383-438)."""
    lev, col_index, form = fold_leveled(spec, ge_mode)
    cap = MAX_NONGE_COLS if form == "nonge" else MAX_SIGN_COLS
    if lev.num_cols > cap:
        raise NotImplementedError(
            f"{form} fold supports <= {cap} live features; got {lev.num_cols}")
    if lev.depth > MAX_DENSE_DEPTH:
        raise NotImplementedError(
            f"dense fold supports depth <= {MAX_DENSE_DEPTH}; got {lev.depth} "
            f"(deeper forests are SPARSE's: ops/sparse_kernel.py)")
    if form == "nonge":
        thr_l = lev.thresh
        code_l = [f.astype(np.int32)
                  | (np.asarray(dr ^ iv, np.int32) * NONGE_SEL_LT)
                  | (np.asarray(dr, np.int32) * NONGE_FLIP)
                  for f, dr, iv in zip(lev.fid, lev.def_right, lev.invert)]
        leaf = lev.leaf_values
    else:
        code_l, thr_l, leaf = ge_normalize(lev)
        if form == "sign":
            F = lev.num_cols
            code_l = [np.where(c >= F, ~(c - F), c).astype(np.int32)
                      for c in code_l]
    T = lev.num_trees
    thr = np.concatenate(thr_l, axis=1) if thr_l else np.zeros((T, 0), np.float32)
    code = np.concatenate(code_l, axis=1) if code_l else np.zeros((T, 0), np.int32)
    return FoldTables(
        form=form,
        col_index=(None if col_index is None
                   else torch.as_tensor(col_index, dtype=torch.int64, device=device)),
        num_cols=lev.num_cols,
        thresholds=torch.as_tensor(np.ascontiguousarray(thr, np.float32),
                                   device=device),
        fids=torch.as_tensor(np.ascontiguousarray(code, np.int32), device=device),
        leaf=torch.as_tensor(np.ascontiguousarray(leaf, np.float32),
                             device=device),
        depth=lev.depth,
    )


class FoldLaunch(NamedTuple):
    """Kernel C's block: rows, trees per staged tile, dynamic shared bytes.
    A tile that holds the whole forest takes one buffer, else two."""

    rows_per_block: int
    tile_trees: int
    smem_bytes: int


class DeepLaunch(NamedTuple):
    """The deep kernel's block: rows, dynamic shared bytes (the rows only),
    and the threads that share a row (``lanes``, 1 or 2), each descending
    half of every group of trees."""

    rows_per_block: int
    smem_bytes: int
    lanes: int = 1


def fold_launch(width: int, depth: int, num_trees: int, limits: GpuLimits, *,
                min_tile: int = 1, budget: int | None = None) -> FoldLaunch | None:
    """Kernel C's block shape: one thread per row; the whole forest in one
    buffer if it fits, else a ring of two buffers of as many trees each as
    fit (``tree_bytes``); then the block's rows at an odd stride and two
    mbarriers. Aims at half an SM so two blocks share one; takes the whole
    opt-in budget, then fewer rows, when ``min_tile`` trees do not fit (only
    ``budget`` when given). None when no block of >= 32 rows holds
    ``min_tile`` trees."""
    T = max(num_trees, 1)
    budgets = ((limits.smem_half_sm, limits.smem_per_block)
               if budget is None else (budget,))
    for rows in (256, 128, 64, 32):
        for b in budgets:
            if fold_smem_bytes(width, depth, T, rows, T) <= b:
                return FoldLaunch(rows, T, fold_smem_bytes(width, depth, T, rows, T))
            tile = (b - fold_smem_bytes(width, depth, T, rows, 0)) // (2 * tree_bytes(depth))
            if tile >= min_tile:
                return FoldLaunch(rows, tile, fold_smem_bytes(width, depth, T, rows, tile))
    return None


def fold_smem_bytes(width: int, depth: int, num_trees: int, rows: int,
                    tile: int) -> int:
    """Kernel C's dynamic shared memory for a block of ``rows`` rows and
    tiles of ``tile`` trees: one buffer if a tile holds every tree, else
    two; then the rows at an odd stride and the mbarriers (the launcher
    checks the same sizes, csrc/fold.cu buffer_bytes, row_bytes)."""
    bufs = (1 if tile >= num_trees else 2) * tile * tree_bytes(depth)
    return bufs + rows * (width | 1) * 4 + C_BARRIER_BYTES


def deep_launch(width: int, limits: GpuLimits) -> DeepLaunch | None:
    """The deep kernel's block: 256 rows in half an SM (two blocks an SM),
    else the most rows, a multiple of 32, in the whole opt-in budget. Where
    fewer than 256 rows fit, two threads share a row, doubling the descents
    in flight that the rows' shared memory leaves. Both were measured
    (scripts/kernel_ab.py deep, PERF.md): on cup98-class, one block of 192
    rows beat two of 64, and two threads a row beat one; on 256-row blocks
    one thread a row was the faster."""
    row_bytes = (width | 1) * 4
    budget = (limits.smem_half_sm if 256 * row_bytes <= limits.smem_half_sm
              else limits.smem_per_block)
    rows = min(256, budget // row_bytes // 32 * 32)
    return DeepLaunch(rows, rows * row_bytes, 2 if rows < 256 else 1) if rows else None


def leaf_slots(depth: int) -> int:
    """A tree's leaf values in kernel C's table: 2^depth, padded to 4 so
    that every tree fills whole 16-byte units, as the bulk copies need."""
    return max(1 << depth, 4)


def tree_bytes(depth: int) -> int:
    """One tree's staged tables in kernel C: its ``deep_blocks``, then its
    leaves."""
    return 16 * deep_block_count(depth) + 4 * leaf_slots(depth)


def fold_plan(form: str, width: int, depth: int, num_trees: int,
              limits: GpuLimits, *, whole_forest: bool = False
              ) -> FoldLaunch | DeepLaunch | None:
    """Which kernel runs a forest, and its block.

    - ``whole_forest`` (VMEM_FOREST): kernel C with every tree in one tile;
    - otherwise, in every form, kernel C in ``fold_launch``'s block (the
      most rows, half an SM before the whole opt-in budget) while that
      block restages at most C_MAX_STAGED_PER_VISIT bytes of tables per
      node visit, or while the deep kernel's rows do not fit 256 a block
      (wide rows, which leave it few threads an SM); else the deep kernel.
      PERF.md section 6 has the shapes and times the rule was fit to.
    None when nothing fits."""
    T = max(num_trees, 1)
    if whole_forest:
        return fold_launch(width, depth, T, limits, min_tile=T)
    launch = fold_launch(width, depth, T, limits)
    deep = deep_launch(width, limits)
    if launch is not None and (
            deep is None or deep.rows_per_block < 256
            or tree_bytes(depth) <= C_MAX_STAGED_PER_VISIT
            * launch.rows_per_block * max(depth, 1)):
        return launch
    return deep


def _node_cond(xv: torch.Tensor, thr: torch.Tensor, codes: torch.Tensor,
               form: str) -> torch.Tensor:
    """One level's branch conditions from the gathered features ``xv``."""
    if form == "dual":
        return xv >= thr
    if form == "sign":
        return torch.where(codes < 0, -xv, xv) >= thr
    c = torch.where((codes & NONGE_SEL_LT) != 0, xv < thr, xv >= thr)
    return c ^ ((codes & NONGE_FLIP) != 0)


def _node_features(codes: torch.Tensor, form: str) -> torch.Tensor:
    if form == "sign":
        codes = torch.where(codes < 0, ~codes, codes)
    elif form == "nonge":
        codes = codes & NONGE_FID
    return codes.to(torch.int64)


def fold_margins_plain(x: torch.Tensor, t: FoldTables) -> torch.Tensor:
    """Plain PyTorch version of kernel C (every form) and of the deep
    kernel: per level a gather of every node's feature, the tables' compare,
    then the bottom-up where-fold of the JAX kernel; leaves summed in f64."""
    thresholds, fids, leaf, depth, form = (t.thresholds, t.fids, t.leaf,
                                           t.depth, t.form)
    T = leaf.shape[0]
    levels = []
    for d in range(depth):
        sl = slice((1 << d) - 1, (2 << d) - 1)
        codes = fids[:, sl].reshape(-1)
        levels.append((_node_features(codes, form), thresholds[:, sl].reshape(-1),
                       codes))
    chunk = max(1, PLAIN_CHUNK_BYTES // (12 * T << max(depth - 1, 0)))
    out = []
    for r0 in range(0, x.shape[0], chunk):
        xc = x[r0:r0 + chunk]
        w = leaf.expand(xc.shape[0], T, 1 << depth)
        for d in range(depth - 1, -1, -1):
            n = 1 << d
            feat, thr, codes = levels[d]
            cond = _node_cond(xc[:, feat], thr, codes, form).view(-1, T, n)
            w = torch.where(cond, w[..., n:2 * n], w[..., :n])
        out.append(w[..., 0].double().sum(dim=1).float())
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=x.device)
    return torch.cat(out)


def _check(x: torch.Tensor, t: FoldTables) -> None:
    """The kernels take raw pointers: rows and tables must be what they
    read."""
    dev = x.device
    check_operand(x, "x", torch.float32, dev, 2)
    check_operand(t.thresholds, "thresholds", torch.float32, dev, 2)
    check_operand(t.fids, "fids", torch.int32, dev, 2)
    check_operand(t.leaf, "leaf", torch.float32, dev, 2)
    T, N = t.leaf.shape[0], (1 << t.depth) - 1
    if (t.thresholds.shape != (T, N) or t.fids.shape != (T, N)
            or t.leaf.shape[1] != 1 << t.depth):
        raise ValueError(
            f"tables {tuple(t.thresholds.shape)} / {tuple(t.fids.shape)} / "
            f"{tuple(t.leaf.shape)} do not match depth {t.depth}")
    if x.shape[1] != t.width:
        raise ValueError(f"rows {tuple(x.shape)} are not {t.width} wide "
                         f"({t.form} form over {t.num_cols} features)")


def fold_margins_cuda(x: torch.Tensor, t: FoldTables, table: torch.Tensor,
                      launch: FoldLaunch) -> torch.Tensor:
    """Kernel C on the card (csrc/fold.cu), in the tables' form; ``table``
    is ``fold_c_table(t)``."""
    _check(x, t)
    dev = x.device
    check_operand(table, "table", torch.int32, dev, 2)
    R, W = x.shape
    T = t.leaf.shape[0]
    if table.shape != (T, tree_bytes(t.depth) // 4):
        raise ValueError(f"table {tuple(table.shape)} does not match the "
                         f"tables' {T} trees of depth {t.depth}")
    if table.data_ptr() % 16:
        raise ValueError("kernel C's table must start on a 16-byte boundary "
                         "(its tiles arrive by bulk copy)")
    out = torch.empty(R, dtype=torch.float32, device=dev)
    FOLD_KERNELS[t.form].launch(
        dev, ptr(x), R, W, ptr(table), T, t.depth, launch.rows_per_block,
        launch.tile_trees, launch.smem_bytes, ptr(out))
    return out


def block_codes(t: FoldTables) -> torch.Tensor:
    """[T, 2^D - 1] int32: the node codes as a block's 10-bit field holds
    them (``DEEP_CODE_BITS``). The dual and sign forms' codes as they are,
    within [-512, 511]; the non-ge form's feature, sel_lt and flip moved to
    bits 0-6, 7 and 8 (``BLOCK_NONGE_*``). Raises on a code that does not
    fit."""
    if t.form == "nonge":
        feature = t.fids & NONGE_FID
        if feature.numel() and int(feature.max()) > BLOCK_NONGE_FID:
            raise ValueError(f"non-ge features past {BLOCK_NONGE_FID} do not "
                             f"fit a block's code")
        return (feature | ((t.fids & NONGE_SEL_LT) != 0).int() * BLOCK_NONGE_SEL_LT
                | ((t.fids & NONGE_FLIP) != 0).int() * BLOCK_NONGE_FLIP)
    lo, hi = -(1 << (DEEP_CODE_BITS - 1)), (1 << (DEEP_CODE_BITS - 1)) - 1
    if t.fids.numel() and not (lo <= int(t.fids.min()) and int(t.fids.max()) <= hi):
        raise ValueError(f"node codes outside the blocks' {DEEP_CODE_BITS} bits")
    return t.fids


def _table_codes(codes: torch.Tensor, form: str) -> torch.Tensor:
    """A block's decoded (sign-extended) codes back in the tables' form."""
    if form != "nonge":
        return codes
    return (codes & BLOCK_NONGE_FID
            | ((codes & BLOCK_NONGE_SEL_LT) != 0).int() * NONGE_SEL_LT
            | ((codes & BLOCK_NONGE_FLIP) != 0).int() * NONGE_FLIP)


def fold_c_table(t: FoldTables) -> torch.Tensor:
    """[T, tree_bytes(D) / 4] int32: kernel C's table, one tree a row, so
    that a tile of trees is one contiguous span (one bulk copy): a tree's
    ``deep_blocks``, then its 2^D leaf values' bits, zero-padded to
    ``leaf_slots``."""
    T, D = t.leaf.shape[0], t.depth
    leaves = torch.zeros(T, leaf_slots(D), dtype=torch.int32, device=t.leaf.device)
    leaves[:, :1 << D] = t.leaf.view(torch.int32)
    return torch.cat([deep_blocks(t).reshape(T, -1), leaves], dim=1).contiguous()


def deep_groups(depth: int) -> list[int]:
    """The level groups of the deep kernel's blocks, root first: two levels
    each, the root group one at an odd depth."""
    return [1] * (depth % 2) + [2] * (depth // 2)


def deep_block_count(depth: int) -> int:
    """Blocks of one tree: 2^d of them for a group that starts at level d."""
    total, d = 0, 0
    for size in deep_groups(depth):
        total += 1 << d
        d += size
    return total


def deep_blocks(t: FoldTables) -> torch.Tensor:
    """[T, B, 4] int32: the node blocks of both fold kernels, 16 bytes each.

    The levels of a tree split into groups (``deep_groups``); a group that
    starts at level d has 2^d blocks, one per path q to level d, laid out
    after the groups above it. Block q holds node q of level d and nodes q
    and q + 2^d of level d + 1 (its cond-False and cond-True children):
    their three threshold bits, then their three codes as 10-bit fields of
    one word (``block_codes``), the top node's lowest. A walk that leaves
    it with the branch bits u goes on to block q + (u << d) of the next
    group, and the last one's path is the leaf index: no pointer is stored.
    A root group of one level leaves its block's two child slots 0."""
    T, D = t.leaf.shape[0], t.depth
    thr = t.thresholds.view(torch.int32)
    codes = block_codes(t) & ((1 << DEEP_CODE_BITS) - 1)
    out = torch.zeros(T, deep_block_count(D), 4, dtype=torch.int32,
                      device=t.leaf.device)
    off, d = 0, 0
    for size in deep_groups(D):
        q = torch.arange(1 << d, device=out.device)
        slots = [(1 << d) - 1 + q]  # node q of level d, then its children
        if size == 2:
            slots += [(2 << d) - 1 + q, (2 << d) - 1 + q + (1 << d)]
        blk = out[:, off:off + (1 << d)]
        for n, node in enumerate(slots):
            blk[..., n] = thr[:, node]
            blk[..., 3] |= codes[:, node] << (DEEP_CODE_BITS * n)
        off += 1 << d
        d += size
    return out


def deep_block_walk(x: torch.Tensor, t: FoldTables,
                    blocks: torch.Tensor) -> torch.Tensor:
    """The fold kernels' walk over ``deep_blocks`` in torch, the same decode,
    arithmetic and compare; leaves summed in f64 in tree order, as the plain
    version sums them."""
    T = blocks.shape[0]
    tree = torch.arange(T, device=x.device)
    j = torch.zeros(x.shape[0], T, dtype=torch.int64, device=x.device)
    shift = 32 - DEEP_CODE_BITS

    def cond(thr_bits, word, n):
        # in int32, as the kernel shifts: the field's top bit is bit 31
        left = torch.as_tensor(shift - DEEP_CODE_BITS * n, dtype=torch.int32,
                               device=word.device)
        codes = _table_codes((word << left) >> shift, t.form)
        xv = torch.gather(x, 1, _node_features(codes, t.form))
        return _node_cond(xv, thr_bits.view(torch.float32), codes, t.form).long()

    off, d = 0, 0
    for size in deep_groups(t.depth):
        b = blocks[tree, off + j]
        u = cond(b[..., 0].contiguous(), b[..., 3], 0)
        if size == 2:
            thr = torch.where(u == 1, b[..., 2], b[..., 1]).contiguous()
            u = u | cond(thr, b[..., 3], 1 + u) << 1
        j = j + (u << d)
        off += 1 << d
        d += size
    return t.leaf[tree, j].double().sum(dim=1).float()


def descent_paths(x: torch.Tensor, t: FoldTables) -> torch.Tensor:
    """[D + 1, R, T] int64: the node a walk of the plain version's compares
    reaches at each level (its index j within the level), the last the
    leaf."""
    T = t.leaf.shape[0]
    tree = torch.arange(T, device=x.device)
    j = torch.zeros(x.shape[0], T, dtype=torch.int64, device=x.device)
    out = [j]
    for d in range(t.depth):
        n = (1 << d) - 1 + j
        codes = t.fids[tree, n]
        xv = torch.gather(x, 1, _node_features(codes, t.form))
        j = j + (_node_cond(xv, t.thresholds[tree, n], codes, t.form).long() << d)
        out.append(j)
    return torch.stack(out)


def _wavefronts(words: torch.Tensor) -> torch.Tensor:
    """Shared-memory wavefronts of warp-wide loads, given [..., n] word
    addresses each: the most distinct words that one bank (word mod 32)
    serves."""
    s = words.sort(dim=-1).values
    new = torch.ones_like(s)
    new[..., 1:] = (s[..., 1:] != s[..., :-1]).long()
    per_bank = torch.zeros(*s.shape[:-1], 32, dtype=torch.int64, device=s.device)
    return per_bank.scatter_add_(-1, s % 32, new).amax(dim=-1)


def fold_wavefronts(x: torch.Tensor, t: FoldTables,
                    rows_per_block: int = 256) -> dict:
    """Kernel C's shared-memory wavefronts per (warp, tree), reckoned from
    the real walks of ``x``'s rows (whole warps of 32): the row gathers at
    an odd stride (``row_major``, csrc/fold.cu) or feature-major, where lane
    r always reads bank r mod 32; the nodes as ``words`` (a threshold and a
    code load per level, the layout kernel C read before its blocks) or ``blocks`` (one 16-byte load
    per two levels, csrc/fold.cu); and the leaf load. Also the shared loads
    per (row, tree) of each node layout."""
    R = x.shape[0] // 32 * 32
    x, D = x[:R], t.depth
    paths = descent_paths(x, t)
    T = paths.shape[2]
    tree = torch.arange(T, device=x.device)
    lane = torch.arange(32, device=x.device)

    def warps(a):  # [R, T] -> [R / 32, T, 32]
        return a.view(R // 32, 32, T).transpose(1, 2)

    zero = torch.zeros(R // 32, T, dtype=torch.int64, device=x.device)
    row_major, feature_major, words, blocks = zero, zero, zero, zero
    for d in range(D):
        n = (1 << d) - 1 + paths[d]
        f = warps(_node_features(t.fids[tree, n], t.form))
        row_major = row_major + _wavefronts(lane * (t.width | 1) + f)
        feature_major = feature_major + _wavefronts(f * rows_per_block + lane)
        words = words + 2 * _wavefronts(warps(n))
    off, d = 0, 0
    for size in deep_groups(D):
        chunk = warps(off + paths[d]).unsqueeze(-1)
        blocks = blocks + _wavefronts((4 * chunk + torch.arange(4, device=x.device))
                                      .flatten(-2))
        off += 1 << d
        d += size
    leaf = _wavefronts(warps(paths[D]))
    mean = {k: float(v.double().mean()) for k, v in (
        ("gather_row_major", row_major), ("gather_feature_major", feature_major),
        ("nodes_words", words), ("nodes_blocks", blocks), ("leaf", leaf))}
    return {
        "rows": R,
        "loads_per_row_tree": {"words": 3 * D + 1,
                               "blocks": D + len(deep_groups(D)) + 1},
        "per_gather": {k: mean[f"gather_{k}"] / max(D, 1)
                       for k in ("row_major", "feature_major")},
        "per_warp_tree": mean,
        "total_per_warp_tree": {
            f"{rows}_{nodes}": mean[f"gather_{rows}"] + mean[f"nodes_{nodes}"]
            + mean["leaf"]
            for rows in ("row_major", "feature_major")
            for nodes in ("words", "blocks")},
    }


def fold_deep_cuda(x: torch.Tensor, t: FoldTables, blocks: torch.Tensor,
                   launch: DeepLaunch) -> torch.Tensor:
    """The deep kernel on the card (csrc/fold_deep.cu) in the tables' form;
    ``blocks`` is ``deep_blocks(t)``."""
    _check(x, t)
    dev = x.device
    check_operand(blocks, "blocks", torch.int32, dev, 3)
    R, W = x.shape
    T = t.leaf.shape[0]
    if blocks.shape != (T, deep_block_count(t.depth), 4):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not match the "
                         f"tables' {T} trees of depth {t.depth}")
    out = torch.empty(R, dtype=torch.float32, device=dev)
    DEEP_KERNELS[t.form].launch(dev, ptr(x), R, W, ptr(blocks), ptr(t.leaf), T,
                                t.depth, launch.rows_per_block, launch.lanes,
                                launch.smem_bytes, ptr(out))
    return out


class FoldKernelEngine(GraphedEngine):
    """Compile a forest into fold tables and run kernel C or the deep kernel.

    ``ge_mode=False`` asks for the non-ge form; ``whole_forest=True`` stages
    every tree in one tile (VMEM_FOREST, the reference's shared-forest
    placement) and raises when the forest does not fit one block."""

    def __init__(self, forest: ForestSpec, *, device, ge_mode: bool = True,
                 whole_forest: bool = False, tables: FoldTables | None = None):
        self.device = resolve_device(device)
        # ``tables``: ``forest``'s, or one tree shard of them
        # (parallel/sharded.py), already on the device
        self.tables = t = (fold_tables(forest, device=self.device, ge_mode=ge_mode)
                           if tables is None else tables)
        self.form = t.form
        self.missing = forest.missing
        self.depth = t.depth
        self.num_trees = forest.num_trees
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold
        limits = GpuLimits.for_device(self.device)
        self.launch = fold_plan(t.form, t.width, t.depth, t.leaf.shape[0],
                                limits, whole_forest=whole_forest)
        if self.launch is None:
            what = "the whole forest's" if whole_forest else "one tree's"
            raise ValueError(
                f"depth {t.depth}, {t.form} form: {what} node tables and a "
                f"32-row block do not fit {limits.smem_per_block} bytes of "
                f"shared memory")
        deep = isinstance(self.launch, DeepLaunch)
        self.kernel = (DEEP_KERNELS if deep else FOLD_KERNELS)[t.form]
        # the table the engine's kernel reads: the deep kernel's blocks, or
        # kernel C's trees of blocks and leaves
        self.blocks = deep_blocks(t) if deep else None
        self.c_table = None if deep else fold_c_table(t)
        # one CUDA graph a shape on the card (ops/graphed.py), as the JAX
        # engine jits _predict_impl
        self._graph()

    def _stage(self, rows, out: torch.Tensor | None = None) -> torch.Tensor:
        """Raw rows [R, C] -> their used columns, f32 on the device (into
        ``out`` when given): the step of ``canonicalize`` that reads them."""
        return stage_rows(rows, device=self.device,
                          col_index=self.tables.col_index, out=out)

    def finish(self, x: torch.Tensor) -> torch.Tensor:
        """Staged rows -> the kernel's rows (ops/rows.py finish_rows)."""
        return finish_rows(x, self.missing, dual=self.form == "dual")

    def canonicalize(self, rows) -> torch.Tensor:
        """Raw rows [R, C] -> [R, width] f32 (``[x, -x]`` lanes in the dual
        form), missing as NaN."""
        return self.finish(self._stage(rows))

    def margins_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Margins of canonicalized rows: the plain version on a CPU tensor,
        the engine's kernel on a CUDA one."""
        if x.device.type == "cpu":
            return fold_margins_plain(x, self.tables)
        if self.blocks is not None:
            return fold_deep_cuda(x, self.tables, self.blocks, self.launch)
        return fold_margins_cuda(x, self.tables, self.c_table, self.launch)

    def _margins_staged(self, x: torch.Tensor) -> torch.Tensor:
        return self.margins_rows(self.finish(x))
