"""Text model/data format IO + compiled-forest cache.

Formats are byte-compatible with the reference artifact so its 15 published
datasets load unchanged:

Model file (reference parser: BaseTahoeTest.h:267-352 generate_forest_from_file):
  line 1: num_trees
  line 2: depth + 1          (the reference stores atoi(line2) - 1 as depth)
  then for each tree, for each of tree_num_nodes(depth) nodes in heap order,
  5 lines: fid, value (threshold or leaf value), default (def_left 0/1),
           weight, is_leaf (0/1)

Data file (reference parser: BaseTahoeTest.h:354-402 generate_data_from_file):
  line 1: num_rows
  line 2: num_cols
  line 3: missing sentinel value
  then num_rows * num_cols values, one per line, row-major.

The port's own copy of tahoe_tpu/forest/io.py's numpy parser and writers,
the reference-of-record for the format, held to the original by
tests/test_torch_host_layer.py. The faster C++ parser of the same formats
is forest/native_io.py, held to this one bit for bit.
"""
from __future__ import annotations

import io as _io
from typing import Optional, Tuple

import numpy as np

from tahoe_tpu_torch.config import Output, tree_num_nodes
from tahoe_tpu_torch.forest.spec import ForestSpec


def load_model(path: str, *, output: int = int(Output.RAW), global_bias: float = 0.0,
               threshold: float = 0.5, missing: float = float("nan"),
               num_cols: Optional[int] = None) -> ForestSpec:
    """Parse the reference text model format into a ForestSpec.

    ``num_cols`` defaults to max_fid+1 when a data file is not available; the
    CLI overrides it from the paired data file's num_cols.
    """
    with open(path, "r") as f:
        header = [f.readline(), f.readline()]
        num_trees = int(header[0])
        depth = int(header[1]) - 1
        n = tree_num_nodes(depth)
        body = np.loadtxt(f, dtype=np.float64, max_rows=num_trees * n * 5)
    table = body.reshape(num_trees * n, 5)
    return _model_from_table(num_trees, depth, table, output, global_bias,
                             threshold, missing, num_cols)


def _model_from_table(num_trees: int, depth: int, table: np.ndarray, output: int,
                      global_bias: float, threshold: float, missing: float,
                      num_cols: Optional[int]) -> ForestSpec:
    n = tree_num_nodes(depth)
    if table.shape[0] != num_trees * n:
        raise ValueError(
            f"model file truncated: expected {num_trees * n} nodes, got {table.shape[0]}"
        )
    fids = table[:, 0].astype(np.int32).reshape(num_trees, n)
    values = table[:, 1].astype(np.float32).reshape(num_trees, n)
    def_left = table[:, 2].astype(bool).reshape(num_trees, n)
    weights = table[:, 3].astype(np.float32).reshape(num_trees, n)
    is_leaf = table[:, 4].astype(bool).reshape(num_trees, n)
    if num_cols is None:
        num_cols = int(fids.max(initial=0)) + 1
    return ForestSpec(
        depth=depth,
        num_cols=num_cols,
        values=values,
        weights=weights,
        fids=fids,
        def_left=def_left,
        is_leaf=is_leaf,
        exchange=np.zeros_like(is_leaf),
        output=output,
        global_bias=global_bias,
        threshold=threshold,
        missing=missing,
    )


def load_data(path: str) -> Tuple[np.ndarray, float]:
    """Parse the reference text data format → (rows [R, F] f32, missing sentinel)."""
    with open(path, "r") as f:
        num_rows = int(f.readline())
        num_cols = int(f.readline())
        missing = float(f.readline())
        body = np.loadtxt(f, dtype=np.float64, max_rows=num_rows * num_cols)
    if body.size != num_rows * num_cols:
        raise ValueError(
            f"data file truncated: expected {num_rows * num_cols} values, got {body.size}"
        )
    return body.astype(np.float32).reshape(num_rows, num_cols), missing


def save_model(path: str, forest: ForestSpec) -> None:
    """Write a ForestSpec in the reference text model format (for fixtures)."""
    buf = _io.StringIO()
    buf.write(f"{forest.num_trees}\n{forest.depth + 1}\n")
    n = forest.nodes_per_tree
    fid = forest.fids.reshape(-1)
    val = forest.values.reshape(-1)
    dfl = forest.def_left.reshape(-1).astype(np.int32)
    wgt = forest.weights.reshape(-1)
    lf = forest.is_leaf.reshape(-1).astype(np.int32)
    for i in range(forest.num_trees * n):
        buf.write(f"{fid[i]}\n{val[i]:.9g}\n{dfl[i]}\n{wgt[i]:.9g}\n{lf[i]}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())


def save_data(path: str, data: np.ndarray, missing: float) -> None:
    """Write rows in the reference text data format (for fixtures)."""
    data = np.asarray(data, dtype=np.float32)
    buf = _io.StringIO()
    buf.write(f"{data.shape[0]}\n{data.shape[1]}\n{missing:.9g}\n")
    for v in data.reshape(-1):
        buf.write(f"{v:.9g}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())


# ----------------------------------------------------------------------
# Compiled-forest cache (npz) — the persistence layer the reference lacks
# (its only persistence is the text formats, SURVEY.md §5).
# ----------------------------------------------------------------------

def save_forest_npz(path: str, forest: ForestSpec) -> None:
    np.savez_compressed(
        path,
        depth=forest.depth,
        num_cols=forest.num_cols,
        values=forest.values,
        weights=forest.weights,
        fids=forest.fids,
        def_left=forest.def_left,
        is_leaf=forest.is_leaf,
        exchange=forest.exchange,
        output=forest.output,
        global_bias=forest.global_bias,
        threshold=forest.threshold,
        missing=forest.missing,
    )


def load_forest_npz(path: str) -> ForestSpec:
    z = np.load(path)
    return ForestSpec(
        depth=int(z["depth"]),
        num_cols=int(z["num_cols"]),
        values=z["values"],
        weights=z["weights"],
        fids=z["fids"],
        def_left=z["def_left"],
        is_leaf=z["is_leaf"],
        exchange=z["exchange"],
        output=int(z["output"]),
        global_bias=float(z["global_bias"]),
        threshold=float(z["threshold"]),
        missing=float(z["missing"]),
    )

