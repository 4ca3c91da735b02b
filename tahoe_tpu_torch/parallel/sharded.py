"""Sharded inference: rows over the ``data`` axis, trees over ``model``.

The port of tahoe_tpu/parallel/sharded.py, on torch.distributed with one
process and one device a rank (mesh.py), where the JAX package runs
shard_map over a mesh from one process. Each rank builds its own engine,
the port's unsharded one, on its own tree shard, puts only that shard on
its device and runs the kernels the unsharded engine runs:

- ``ShardedForestEngine``: kernel C or the deep kernel (fold_plan's pick
  for the shard) on the forest's fold tables, built once on the host and
  cut along their tree axis, so that every shard shares the forest's
  column compaction and node form;
- ``ShardedRankEngine``: kernel A on this rank's rows with the forest's
  quantization (replicated), then kernel B, or the fused kernel, on the
  shard's records and leaves;
- ``ShardedSparseEngine``: kernel A as above, then the sparse kernel on the
  shard's own CSR pool, the tree being the pool's unit.

The shards' raw f32 margins are joined by one ``all_reduce(SUM)`` over the
model group; the output transform runs once, after it, with the whole
forest's tree count (AVG divides by every tree) and ``global_bias`` added
once. Trees split into ``n_model`` contiguous shards of ceil(T / n_model);
a shorter shard is padded with trees of one zero leaf, which add nothing
to any margin (where the JAX engines raise on a tree count their TPU tiles
do not divide); only a shard with no tree raises. The 128-tree lane tiles
of the JAX split are a TPU layout rule and have no counterpart here.

A shard's margins are its engine's graphed ``margins`` (ops/graphed.py:
one CUDA graph a shape on the card); the ``all_reduce`` and the
``all_gather`` stay outside every graph, because gloo cannot be captured
(capturing NCCL's collectives is not done here either), and so does the
output transform after them.

Rows split into ``n_data`` contiguous slices of ceil(R / n_data).
``predict(rows)`` takes the global batch on every rank and returns every
row's prediction on every rank, gathered over the data axis;
``predict_local(rows)`` takes this rank's slice only and communicates
over the model axis alone. ``shard_margins(rows)`` is this rank's shard's
raw margins, no communication at all. The margins are the shard's leaves
summed in f64 in tree order, as the unsharded engines sum them, so each
shard's margins equal those of an unsharded engine on its trees bit for
bit; their sum over shards differs from the whole forest's by the f32
rounding of the all-reduce, within ORACLE_ATOL.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tahoe_tpu_torch.forest.spec import ForestSpec
from tahoe_tpu_torch.ops.bucketed import subset_trees
from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine, fold_tables
from tahoe_tpu_torch.ops.rank_kernel import RankFoldEngine, rank_quantize
from tahoe_tpu_torch.ops.sparse_kernel import SparseRankEngine
from tahoe_tpu_torch.ops.transform import apply_output_transform
from tahoe_tpu_torch.parallel.mesh import Mesh


def tree_shards(num_trees: int, n_model: int) -> list[np.ndarray]:
    """The trees of each model shard: ``n_model`` contiguous runs whose
    sizes differ by one at most. Raises where a shard would hold none."""
    if num_trees < n_model:
        raise ValueError(f"{num_trees} trees over {n_model} model shards: "
                         f"a shard would be empty")
    return np.array_split(np.arange(num_trees), n_model)


def padded_forest(spec: ForestSpec, shards: list[np.ndarray]) -> ForestSpec:
    """``spec`` with its trees in shard order, each shard padded to the
    largest one's size with trees of one zero leaf: shard m is trees
    ``[m * per, (m + 1) * per)``. ``spec`` itself where no shard needs a
    pad."""
    per = max(len(s) for s in shards)
    if all(len(s) == per for s in shards):
        return spec
    n = spec.nodes_per_tree
    parts = []
    for s in shards:
        sub = subset_trees(spec, s)
        pad = per - len(s)
        parts.append((sub.values, sub.weights, sub.fids, sub.def_left,
                      sub.is_leaf, sub.exchange))
        if pad:
            parts.append((np.zeros((pad, n), np.float32),
                          np.zeros((pad, n), np.float32),
                          np.zeros((pad, n), np.int32),
                          np.ones((pad, n), bool), np.ones((pad, n), bool),
                          np.zeros((pad, n), bool)))
    fields = [np.concatenate(col) for col in zip(*parts)]
    return dataclasses.replace(spec, **dict(zip(
        ("values", "weights", "fids", "def_left", "is_leaf", "exchange"),
        fields)))


def row_slice(rows: int, n_data: int, d: int) -> slice:
    """Data shard ``d``'s rows of a batch of ``rows``: contiguous slices of
    ceil(rows / n_data)."""
    step = -(-rows // n_data)
    return slice(min(d * step, rows), min((d + 1) * step, rows))


def batch_sharded_put(data, mesh: Mesh) -> torch.Tensor:
    """This rank's row slice of ``data`` as f32 on its device: the
    multi-host input path, where a rank reads only its own rows."""
    sl = row_slice(len(data), mesh.data, mesh.d)
    return torch.as_tensor(data[sl], dtype=torch.float32, device=mesh.device)


def _all_reduce(margins: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the model shards' margins (one f32 all-reduce). Both
    NCCL and gloo reduce tensors on the card."""
    if mesh.model > 1:
        dist.all_reduce(margins, op=dist.ReduceOp.SUM, group=mesh.model_group)
    return margins


def _all_gather(preds: torch.Tensor, rows: int, mesh: Mesh) -> torch.Tensor:
    """Every data shard's predictions, in row order: each slice padded to
    ceil(rows / n_data), gathered, trimmed. gloo gathers host tensors only
    (torch.distributed's backend table), so under gloo a card's slice goes
    through the host; NCCL gathers on the card."""
    if mesh.data == 1:
        return preds
    step = -(-rows // mesh.data)
    via_host = mesh.backend == "gloo" and preds.device.type != "cpu"
    src = preds.cpu() if via_host else preds
    src = torch.cat([src, src.new_zeros(step - src.shape[0])])
    parts = [torch.empty_like(src) for _ in range(mesh.data)]
    dist.all_gather(parts, src, group=mesh.data_group)
    sizes = [(lambda sl: sl.stop - sl.start)(row_slice(rows, mesh.data, d))
             for d in range(mesh.data)]
    out = torch.cat([p[:k] for p, k in zip(parts, sizes)])
    return out.to(preds.device) if via_host else out


class _Sharded:
    """What the three engines share: the shards, the all-reduce, the output
    transform and the data axis. ``self.engine`` is the unsharded engine on
    this rank's shard; its ``margins`` add nothing to the leaves' sum."""

    def _shard(self, forest: ForestSpec, mesh: Mesh | None) -> ForestSpec:
        if mesh is None:
            raise ValueError("this rank is past the mesh (make_mesh gave None)")
        self.mesh = mesh
        self.device = mesh.device
        self.n_data, self.n_model = mesh.data, mesh.model
        self.num_trees = forest.num_trees
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold
        shards = tree_shards(forest.num_trees, mesh.model)
        # this rank's own trees of the forest, without its pad
        self.trees = shards[mesh.m]
        self.shard_trees = max(len(s) for s in shards)
        return padded_forest(forest, shards)

    @property
    def shard(self) -> slice:
        """This rank's trees in the padded forest."""
        return slice(self.mesh.m * self.shard_trees,
                     (self.mesh.m + 1) * self.shard_trees)

    def shard_margins(self, rows) -> torch.Tensor:
        """This rank's shard's raw margins of ``rows``: no communication."""
        return self.engine.margins(rows)

    def predict_local(self, rows) -> torch.Tensor:
        """Predictions of this rank's rows: its shard's margins summed over
        the model axis, then the output transform with the whole forest's
        tree count."""
        margins = _all_reduce(self.shard_margins(rows), self.mesh)
        return apply_output_transform(margins, self.num_trees, self.output,
                                      self.global_bias, self.threshold)

    def predict(self, rows) -> torch.Tensor:
        """Predictions of the global batch ``rows`` (the same on every
        rank): this rank's data slice through ``predict_local``, then every
        slice gathered over the data axis."""
        n = len(rows)
        local = self.predict_local(rows[row_slice(n, self.n_data, self.mesh.d)])
        return _all_gather(local, n, self.mesh)


class ShardedForestEngine(_Sharded):
    """The f32 fold over a mesh: kernel C or the deep kernel on this rank's
    tree shard of the forest's fold tables (the JAX engine's sharded.py:39)."""

    def __init__(self, forest: ForestSpec, mesh: Mesh | None):
        padded = self._shard(forest, mesh)
        full = fold_tables(padded, device=torch.device("cpu"))
        sl = self.shard
        tables = dataclasses.replace(
            full, col_index=(None if full.col_index is None
                             else full.col_index.to(self.device)),
            **{k: getattr(full, k)[sl].contiguous().to(self.device)
               for k in ("thresholds", "fids", "leaf")})
        self.engine = FoldKernelEngine(forest, device=self.device, tables=tables)


class ShardedRankEngine(_Sharded):
    """The int8 rank engine over a mesh (sharded.py:161): one quantization
    of the whole forest on every rank, kernel A on this rank's rows, kernel
    B (or, with ``fuse_transform``, the fused kernel) on its shard."""

    def __init__(self, forest: ForestSpec, mesh: Mesh | None, *,
                 fuse_transform: bool = False):
        padded = self._shard(forest, mesh)
        q, gather = rank_quantize(padded)
        sub = dataclasses.replace(q, spec=subset_trees(q.spec, self.shard))
        self.engine = RankFoldEngine(sub.spec, device=self.device,
                                     prequantized=(sub, gather, forest.missing),
                                     fuse_transform=fuse_transform)


class ShardedSparseEngine(_Sharded):
    """The sparse rank descent over a mesh (sharded.py:263): kernel A as
    ShardedRankEngine runs it, then the sparse kernel on the CSR pool of
    this rank's trees."""

    def __init__(self, forest: ForestSpec, mesh: Mesh | None):
        padded = self._shard(forest, mesh)
        q, gather = rank_quantize(padded)
        sub = dataclasses.replace(q, spec=subset_trees(q.spec, self.shard))
        self.engine = SparseRankEngine(sub.spec, device=self.device,
                                       prequantized=(sub, gather, forest.missing))
