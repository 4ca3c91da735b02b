"""Forest data model: structure-of-arrays node tables.

The port's own copy of tahoe_tpu/forest/spec.py (the numpy host
layer), held to the original bit for bit by
tests/test_torch_host_layer.py.

The reference stores forests as arrays of 12-byte ``dense_node_t`` structs with
fid/def_left/is_leaf packed into an int (Struct.h:44-59, 103-117). A TPU-native
design wants *columnar* (SoA) tables instead — separate dense arrays per field,
shaped ``[num_trees, nodes_per_tree]`` in heap order — because every engine
reads whole levels of whole trees at once (vectorized level-synchronous
descent), never one struct at a time.

Heap order: node 0 is the root; children of node i are 2i+1 / 2i+2
(the reference's ``curr = 2*curr + 1 + cond`` step, Struct.h:384).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from tahoe_tpu_torch.config import Output, tree_num_nodes


@dataclasses.dataclass
class ForestSpec:
    """A decision-tree ensemble as SoA numpy node tables (host-side).

    Arrays are all ``[num_trees, tree_num_nodes(depth)]`` in heap order:

    - ``values``   f32 — split threshold for internal nodes, leaf value for leaves
    - ``weights``  f32 — training weight (used only by hot-child swapping)
    - ``fids``     i32 — feature id for internal nodes
    - ``def_left`` bool — route left when the feature is missing
    - ``is_leaf``  bool
    - ``exchange`` bool — set by the hot-child-swap compiler pass: the node's
      children were swapped, so the branch condition must be inverted at
      traversal time (reference: Struct.h:896-898 ``if(n_is_exchange) cond=!cond``)

    Scalar metadata mirrors forest_params_t (Struct.h:166-189).
    """

    depth: int
    num_cols: int
    values: np.ndarray
    weights: np.ndarray
    fids: np.ndarray
    def_left: np.ndarray
    is_leaf: np.ndarray
    exchange: np.ndarray
    output: int = int(Output.RAW)
    global_bias: float = 0.0
    threshold: float = 0.5
    missing: float = float("nan")

    # ------------------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return int(self.values.shape[0])

    @property
    def nodes_per_tree(self) -> int:
        return int(self.values.shape[1])

    @property
    def num_leaves(self) -> int:
        return 1 << self.depth

    @property
    def num_nodes(self) -> int:
        return self.num_trees * self.nodes_per_tree

    @property
    def max_fid(self) -> int:
        return int(self.fids.max(initial=0))

    # ------------------------------------------------------------------
    def __post_init__(self):
        expect = tree_num_nodes(self.depth)
        for name in ("values", "weights", "fids", "def_left", "is_leaf", "exchange"):
            arr = getattr(self, name)
            if arr.ndim != 2 or arr.shape[1] != expect:
                raise ValueError(
                    f"{name} must be [num_trees, {expect}] for depth {self.depth}; "
                    f"got {arr.shape}"
                )
        self.values = np.ascontiguousarray(self.values, dtype=np.float32)
        self.weights = np.ascontiguousarray(self.weights, dtype=np.float32)
        self.fids = np.ascontiguousarray(self.fids, dtype=np.int32)
        self.def_left = np.ascontiguousarray(self.def_left, dtype=bool)
        self.is_leaf = np.ascontiguousarray(self.is_leaf, dtype=bool)
        self.exchange = np.ascontiguousarray(self.exchange, dtype=bool)
        Output.validate(self.output)
        if self.depth < 0:
            raise ValueError("depth must be non-negative")
        if self.num_cols <= 0:
            raise ValueError("num_cols must be positive")
        if self.max_fid >= self.num_cols:
            raise ValueError(
                f"max feature id {self.max_fid} out of range for num_cols {self.num_cols}"
            )
        # Leaves at max depth must be marked leaves (complete-tree invariant).
        if self.depth >= 0 and not self.is_leaf[:, self.num_leaves - 1 :].all():
            raise ValueError("all nodes at max depth must be leaves")

    # ------------------------------------------------------------------
    def level_slice(self, d: int) -> slice:
        """Heap-index slice of level d (2^d nodes starting at 2^d - 1)."""
        return slice((1 << d) - 1, (1 << (d + 1)) - 1)

    def copy(self) -> "ForestSpec":
        return ForestSpec(
            depth=self.depth,
            num_cols=self.num_cols,
            values=self.values.copy(),
            weights=self.weights.copy(),
            fids=self.fids.copy(),
            def_left=self.def_left.copy(),
            is_leaf=self.is_leaf.copy(),
            exchange=self.exchange.copy(),
            output=self.output,
            global_bias=self.global_bias,
            threshold=self.threshold,
            missing=self.missing,
        )

    def missing_is_nan(self) -> bool:
        return bool(np.isnan(np.float32(self.missing)))


@dataclasses.dataclass
class LeveledForest:
    """Level-major derived form consumed by the tensorized engines.

    Produced by :func:`tahoe_tpu_torch.forest.compiler.levelize`. All paths have been
    normalized to length exactly ``depth`` (early leaves padded down with
    always-left pass-through nodes), and exchange bits folded in, so engines
    need no is_leaf masking at all — they run ``depth`` unconditional select
    steps. Per level d in 0..depth-1:

    - ``thresh[d]``   f32  [num_trees, 2^d]
    - ``fid[d]``      i32  [num_trees, 2^d]
    - ``def_right[d]`` bool [num_trees, 2^d] — effective routing for missing
      values *after* folding exchange: True means a missing feature routes to
      the right child. (Reference semantics: missing → !def_left, then
      exchange inverts; folding both gives def_right = def_left XOR exchange
      ... see compiler.levelize for the derivation.)
    - ``leaf_values`` f32 [num_trees, 2^depth]

    ``sign`` convention: the effective branch condition at a node is
      cond = missing(x) ? def_right : ((x >= thresh) XOR invert)
    where ``invert[d]`` bool is the folded exchange bit; cond=1 routes right.
    """

    depth: int
    num_cols: int
    thresh: list
    fid: list
    def_right: list
    invert: list
    leaf_values: np.ndarray
    output: int = int(Output.RAW)
    global_bias: float = 0.0
    threshold: float = 0.5
    missing: float = float("nan")

    @property
    def num_trees(self) -> int:
        return int(self.leaf_values.shape[0])

    @property
    def num_leaves(self) -> int:
        return int(self.leaf_values.shape[1])


@dataclasses.dataclass
class PackedForest:
    """Adaptive-width packed node tables — the compiled artifact.

    The TPU rendition of ``dense_adaptive_forest``'s device arrays
    (Struct.h:1928-1960): a parallel f32 ``values`` table plus a packed integer
    ``bits`` table of adaptive width (int8/int16/int32, chosen from max fid;
    Struct.h:1827-1852), in both tree-major ``[T, N]`` and node-major
    (transposed, ``[N, T]``) layouts. Node-major puts the same heap index of
    all trees contiguously — the layout that made reference "reorg" kernels
    coalesce (Struct.h:1911-1923) and that keeps TPU lane dimension dense when
    vectorizing over trees.
    """

    depth: int
    num_cols: int
    width_bytes: int
    values: np.ndarray       # f32 [T, N] tree-major
    bits: np.ndarray         # i8/i16/i32 [T, N] tree-major
    values_reorg: np.ndarray  # f32 [N, T] node-major
    bits_reorg: np.ndarray    # [N, T] node-major
    tree_order: np.ndarray    # i32 [T] — simhash clustering permutation applied
    output: int = int(Output.RAW)
    global_bias: float = 0.0
    threshold: float = 0.5
    missing: float = float("nan")

    @property
    def num_trees(self) -> int:
        return int(self.values.shape[0])

    @property
    def nodes_per_tree(self) -> int:
        return int(self.values.shape[1])

    def nbytes(self) -> int:
        return int(self.values.nbytes + self.bits.nbytes)


# ----------------------------------------------------------------------
# Carrying a forest across from the JAX package. A forest's node tables are
# its weights; they cross as plain numpy arrays and scalars, so neither
# package imports the other.
# ----------------------------------------------------------------------
SPEC_FIELDS = tuple(f.name for f in dataclasses.fields(ForestSpec))


def from_arrays(fields) -> ForestSpec:
    """A ForestSpec from the fields of another package's ForestSpec, as
    ``dataclasses.asdict`` gives them (numpy arrays and scalars). The arrays
    are copied; ``__post_init__`` checks their shapes and types."""
    missing = [n for n in SPEC_FIELDS if n not in fields]
    if missing:
        raise ValueError(f"forest fields missing: {missing}")
    kw = {n: fields[n] for n in SPEC_FIELDS}
    for n in ("values", "weights", "fids", "def_left", "is_leaf", "exchange"):
        kw[n] = np.array(kw[n], copy=True)
    for n in ("depth", "num_cols", "output"):
        kw[n] = int(kw[n])
    for n in ("global_bias", "threshold", "missing"):
        kw[n] = float(kw[n])
    return ForestSpec(**kw)


def to_arrays(spec: ForestSpec) -> dict:
    """The fields of ``spec`` as a dict of numpy arrays and scalars, the form
    ``from_arrays`` (and the JAX package's ForestSpec constructor) takes."""
    out = {}
    for n in SPEC_FIELDS:
        v = getattr(spec, n)
        out[n] = v.copy() if isinstance(v, np.ndarray) else v
    return out
