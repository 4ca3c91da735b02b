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
counter per form. Kernel C (csrc/fold.cu) stages tiles of whole trees in
shared memory and restages them for every block of rows; the deep kernel
(csrc/fold_deep.cu, dual and sign forms, the counterpart of the subtree-
split fold) stages only the rows and reads each visited node through the
read-only cache. ``fold_plan`` picks the one measured faster: kernel C while
its block restages at most 1.5 bytes of tables per node visit and holds a
tile of 16 trees (shallow forests in 128-256-row blocks), the deep kernel
otherwise (depth >= 9, wide rows, depth 13-15). The non-ge form has only
kernel C. The TPU tiling, VMEM estimates, split grid and compile walls have
no counterpart here.
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
from tahoe_tpu_torch.ops.rows import canonicalize_rows
from tahoe_tpu_torch.ops.transform import apply_output_transform

# the dual-lane form's feature cap: [x, -x] within the fold's 128 lanes
MAX_DUAL_COLS = 64
# the sign form's cap, the JAX package's (fold_kernel.py:54), so that both
# sides agree on what is feasible
MAX_SIGN_COLS = 512
# the JAX non-ge kernel gathers from one 128-lane feature vreg
MAX_NONGE_COLS = 128
# deeper forests are the SPARSE strategy's (ops/sparse_kernel.py)
MAX_DENSE_DEPTH = 15
# both kernels descend this many trees together (kTreesInFlight,
# csrc/common.cuh)
TREES_IN_FLIGHT = 4
# fold_plan's route, from kernel C against the deep kernel on 24 shapes
# (65,536 rows on an H100; PERF.md section 6): kernel C wins while its block
# restages at most this many bytes of node tables per node visit, per_tree /
# (rows x depth), and holds a tile of this many trees
C_MAX_STAGED_PER_VISIT = 1.5
C_MIN_TILE = 16
# non-ge node code bits (csrc/fold.cu kNonGe*)
NONGE_SEL_LT = 1 << 29
NONGE_FLIP = 1 << 30
NONGE_FID = NONGE_SEL_LT - 1

_FOLD_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
              ctypes.c_int, ctypes.c_void_p]
FOLD_DEEP = CudaKernel("tahoe_fold_deep", _DEEP_ARGS,
                       source="tahoe_tpu_torch/csrc/fold_deep.cu",
                       replaces="tahoe_tpu/ops/fold_kernel.py:688")
FOLD_DEEP_SIGN = CudaKernel("tahoe_fold_deep_sign", _DEEP_ARGS,
                            source="tahoe_tpu_torch/csrc/fold_deep.cu",
                            replaces="tahoe_tpu/ops/fold_kernel.py:688")
FOLD_KERNELS = {"dual": FOLD, "sign": FOLD_SIGN, "nonge": FOLD_NONGE}
DEEP_KERNELS = {"dual": FOLD_DEEP, "sign": FOLD_DEEP_SIGN}

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
            f"(deeper forests are SPARSE's: ROADMAP Queue 1 item 7)")
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
    """Kernel C's block: rows, trees per staged tile, dynamic shared bytes."""

    rows_per_block: int
    tile_trees: int
    smem_bytes: int


class DeepLaunch(NamedTuple):
    """The deep kernel's block: rows and dynamic shared bytes (rows only)."""

    rows_per_block: int
    smem_bytes: int


def fold_launch(width: int, depth: int, num_trees: int, limits: GpuLimits, *,
                min_tile: int = 1, budget: int | None = None
                ) -> FoldLaunch | None:
    """Kernel C's block shape: one thread per row, the block's rows staged
    in shared memory at an odd stride, then as many trees' node tables per
    tile as fit. Aims at half an SM so two blocks share one; takes the whole
    opt-in budget, then fewer rows, when ``min_tile`` trees do not fit (only
    ``budget`` when given). None when no block of >= 32 rows holds
    ``min_tile`` trees."""
    per_tree = tree_bytes(depth)
    budgets = ((limits.smem_half_sm, limits.smem_per_block)
               if budget is None else (budget,))
    for rows in (256, 128, 64, 32):
        xs = rows * (width | 1) * 4
        for b in budgets:
            tile = min(max(num_trees, 1), (b - xs) // per_tree)
            if tile >= min_tile:
                return FoldLaunch(rows, tile, xs + tile * per_tree)
    return None


def deep_launch(width: int, limits: GpuLimits) -> DeepLaunch | None:
    """The deep kernel's block: the most rows (256 down to 32) whose staged
    rows fit half an SM, else the whole opt-in budget."""
    for b in (limits.smem_half_sm, limits.smem_per_block):
        for rows in (256, 128, 64, 32):
            xs = rows * (width | 1) * 4
            if xs <= b:
                return DeepLaunch(rows, xs)
    return None


def tree_bytes(depth: int) -> int:
    """One tree's staged node tables in kernel C: (threshold, code) per node
    and a leaf value per leaf."""
    return ((1 << depth) - 1) * 8 + (1 << depth) * 4


def fold_plan(form: str, width: int, depth: int, num_trees: int,
              limits: GpuLimits, *, whole_forest: bool = False
              ) -> FoldLaunch | DeepLaunch | None:
    """Which kernel runs a forest, and its block.

    - ``whole_forest`` (VMEM_FOREST): kernel C with every tree in one tile;
    - non-ge: kernel C, the only kernel of that form;
    - otherwise kernel C when, in half an SM, a block holds a tile of
      min(T, C_MIN_TILE) trees and restages at most C_MAX_STAGED_PER_VISIT
      bytes of tables per node visit; else the deep kernel. On the sweep's
      shapes that keeps kernel C up to depth 8 at 256-row blocks of narrow
      rows (SUSY-class), up to depth 7 at 256 rows and depth 6 at 128.
    None when nothing fits."""
    T = max(num_trees, 1)
    if whole_forest:
        return fold_launch(width, depth, T, limits, min_tile=T)
    if form == "nonge":
        return fold_launch(width, depth, T, limits)
    launch = fold_launch(width, depth, T, limits, min_tile=min(T, C_MIN_TILE),
                         budget=limits.smem_half_sm)
    if launch is not None and (tree_bytes(depth) <= C_MAX_STAGED_PER_VISIT
                               * launch.rows_per_block * max(depth, 1)):
        return launch
    return deep_launch(width, limits)


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


def fold_margins_cuda(x: torch.Tensor, t: FoldTables,
                      launch: FoldLaunch) -> torch.Tensor:
    """Kernel C on the card (csrc/fold.cu), in the tables' form."""
    _check(x, t)
    dev = x.device
    R, W = x.shape
    out = torch.empty(R, dtype=torch.float32, device=dev)
    FOLD_KERNELS[t.form].launch(
        dev, ptr(x), R, W, ptr(t.thresholds), ptr(t.fids), ptr(t.leaf),
        t.leaf.shape[0], t.depth, launch.rows_per_block, launch.tile_trees,
        launch.smem_bytes, ptr(out))
    return out


def deep_nodes(t: FoldTables) -> torch.Tensor:
    """[T, N, 2] int32: each node's (threshold bits, code), the deep
    kernel's one 8-byte load per visited node."""
    return torch.stack([t.thresholds.view(torch.int32), t.fids],
                       dim=-1).contiguous()


def fold_deep_cuda(x: torch.Tensor, t: FoldTables, nodes: torch.Tensor,
                   launch: DeepLaunch) -> torch.Tensor:
    """The deep kernel on the card (csrc/fold_deep.cu) in the tables' form,
    dual or sign; ``nodes`` is ``deep_nodes(t)``."""
    if t.form not in DEEP_KERNELS:
        raise ValueError(f"the deep kernel takes the dual and sign forms, "
                         f"not {t.form}")
    _check(x, t)
    dev = x.device
    check_operand(nodes, "nodes", torch.int32, dev, 3)
    R, W = x.shape
    T = t.leaf.shape[0]
    if nodes.shape != (T, (1 << t.depth) - 1, 2):
        raise ValueError(f"nodes {tuple(nodes.shape)} do not match the "
                         f"tables' {T} trees of depth {t.depth}")
    out = torch.empty(R, dtype=torch.float32, device=dev)
    DEEP_KERNELS[t.form].launch(dev, ptr(x), R, W, ptr(nodes), ptr(t.leaf), T,
                                t.depth, launch.rows_per_block,
                                launch.smem_bytes, ptr(out))
    return out


class FoldKernelEngine:
    """Compile a forest into fold tables and run kernel C or the deep kernel.

    ``ge_mode=False`` asks for the non-ge form; ``whole_forest=True`` stages
    every tree in one tile (VMEM_FOREST, the reference's shared-forest
    placement) and raises when the forest does not fit one block."""

    def __init__(self, forest: ForestSpec, *, device, ge_mode: bool = True,
                 whole_forest: bool = False):
        self.device = resolve_device(device)
        self.tables = t = fold_tables(forest, device=self.device,
                                      ge_mode=ge_mode)
        self.form = t.form
        self.missing = forest.missing
        self.depth = t.depth
        self.num_trees = forest.num_trees
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold
        limits = GpuLimits.for_device(self.device)
        self.launch = fold_plan(t.form, t.width, t.depth, self.num_trees,
                                limits, whole_forest=whole_forest)
        if self.launch is None:
            what = "the whole forest's" if whole_forest else "one tree's"
            raise ValueError(
                f"depth {t.depth}, {t.form} form: {what} node tables and a "
                f"32-row block do not fit {limits.smem_per_block} bytes of "
                f"shared memory")
        deep = isinstance(self.launch, DeepLaunch)
        self.kernel = (DEEP_KERNELS if deep else FOLD_KERNELS)[t.form]
        self.nodes = deep_nodes(t) if deep else None

    def canonicalize(self, rows) -> torch.Tensor:
        """Raw rows [R, C] -> [R, width] f32 (``[x, -x]`` lanes in the dual
        form), missing as NaN."""
        return canonicalize_rows(rows, self.missing, device=self.device,
                                 col_index=self.tables.col_index,
                                 dual=self.form == "dual")

    def margins_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Margins of canonicalized rows: the plain version on a CPU tensor,
        the engine's kernel on a CUDA one."""
        if x.device.type == "cpu":
            return fold_margins_plain(x, self.tables)
        if self.nodes is not None:
            return fold_deep_cuda(x, self.tables, self.nodes, self.launch)
        return fold_margins_cuda(x, self.tables, self.launch)

    def margins(self, rows) -> torch.Tensor:
        return self.margins_rows(self.canonicalize(rows))

    def predict(self, rows) -> torch.Tensor:
        return apply_output_transform(self.margins(rows), self.num_trees,
                                      self.output, self.global_bias,
                                      self.threshold)
