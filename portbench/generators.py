"""Seeded forest and row generators: a frozen copy of the port's
``tahoe_tpu_torch/forest/synthetic.py`` ``generate_forest`` and
``generate_data``, bit for bit (``tests/test_portbench_generators.py``).

They return plain numpy arrays (a forest as a dict of the fields that
``tahoe_tpu_torch.forest.spec.from_arrays`` takes), so that the benchmark's
reference reads the same arrays the program is built from and imports
nothing of the program.
"""
from __future__ import annotations

import numpy as np

# the port's Output flags (tahoe_tpu_torch/config.py), by name
OUTPUT_FLAGS = {"RAW": 0x0, "AVG": 0x1, "SIGMOID": 0x10, "THRESHOLD": 0x100}


def tree_num_nodes(depth: int) -> int:
    """Nodes of a complete binary tree of ``depth``."""
    return (1 << (depth + 1)) - 1


def generate_forest(num_trees: int, depth: int, num_cols: int, *,
                    leaf_prob: float = 0.0, output: int = 0,
                    global_bias: float = 0.0, threshold: float = 0.5,
                    missing: float = float("nan"),
                    active_cols: int | None = None, seed: int = 42) -> dict:
    """A random complete forest in heap order, [num_trees, 2^(depth+1) - 1]
    arrays: thresholds and leaf values in [-1, 1), feature ids from all
    columns or from a random subset of ``active_cols``, random default
    directions, early leaves at ``leaf_prob`` (the root never, the last
    level always)."""
    rng = np.random.default_rng(seed)
    shape = (num_trees, tree_num_nodes(depth))
    values = rng.uniform(-1.0, 1.0, size=shape).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    if active_cols is not None and active_cols < num_cols:
        pool = np.sort(rng.choice(num_cols, size=active_cols, replace=False))
        fids = pool[rng.integers(0, active_cols, size=shape)].astype(np.int32)
    else:
        fids = rng.integers(0, num_cols, size=shape, dtype=np.int32)
    def_left = rng.random(shape) < 0.5
    is_leaf = rng.random(shape) < leaf_prob
    is_leaf[:, (1 << depth) - 1:] = True
    if depth > 0:
        is_leaf[:, 0] = False
    return {
        "depth": depth, "num_cols": num_cols, "values": values,
        "weights": weights, "fids": fids, "def_left": def_left,
        "is_leaf": is_leaf, "exchange": np.zeros(shape, dtype=bool),
        "output": output, "global_bias": global_bias,
        "threshold": threshold, "missing": missing,
    }


def generate_data(num_rows: int, num_cols: int, *,
                  missing: float = float("nan"), missing_prob: float = 0.0,
                  seed: int = 42) -> np.ndarray:
    """Rows [num_rows, num_cols] f32 in [-1, 1), each value replaced by
    ``missing`` with probability ``missing_prob``."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(-1.0, 1.0, size=(num_rows, num_cols)).astype(np.float32)
    if missing_prob > 0.0:
        mask = rng.random((num_rows, num_cols)) < missing_prob
        data[mask] = np.float32(missing)
    return data


def forest_of(config: dict, seed: int) -> dict:
    """The forest a configuration file describes, drawn from ``seed``."""
    return generate_forest(
        config["trees"], config["depth"], config["num_cols"],
        leaf_prob=config.get("leaf_prob", 0.0),
        output=OUTPUT_FLAGS[config.get("output", "RAW")],
        global_bias=config.get("global_bias", 0.0),
        threshold=config.get("threshold", 0.5),
        missing=float(config.get("missing", "nan")),
        active_cols=config.get("active_cols"), seed=seed)


def rows_of(config: dict, num_rows: int, seed: int) -> np.ndarray:
    """``num_rows`` rows of a configuration, drawn from ``seed``."""
    return generate_data(num_rows, config["num_cols"],
                         missing=float(config.get("missing", "nan")),
                         missing_prob=config.get("missing_prob", 0.0),
                         seed=seed)
