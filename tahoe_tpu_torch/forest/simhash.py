"""Similar-tree clustering via simhash over tree content.

The port's own copy of tahoe_tpu/forest/simhash.py (the numpy host
layer), held to the original bit for bit by
tests/test_torch_host_layer.py.

The reference's intent (Struct.h:1854-1891 + simhash.h): compute a 64-bit
simhash per tree and sort trees by it, so structurally similar trees sit on
adjacent GPU threads. Its implementation hashes uninitialized buffers (the
tree content is never written into the token arrays — see SURVEY.md §2.6), so
the published pass sorts garbage. This module implements the *intended*
capability: tokens are the per-node (feature id, quantized threshold) pairs of
each tree's internal nodes, hashed with a 64-bit mix, combined by the classic
simhash bit-voting scheme (simhash.h:42-72's structure, real inputs).

Adjacent-lane similarity matters on TPU for the same reason it did on GPU
warps: vectorized descent over the tree axis touches similar node columns when
neighboring trees split on similar features.
"""
from __future__ import annotations

import numpy as np

from tahoe_tpu_torch.forest.spec import ForestSpec


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — a statistically strong stand-in for the
    reference's times-33 string hash (simhash.h:14-40), vectorized."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def tree_simhashes(forest: ForestSpec) -> np.ndarray:
    """64-bit simhash per tree, uint64 [num_trees]."""
    # Token per internal node: (fid, threshold quantized to 1e-3 buckets).
    # Leaves contribute nothing (their values don't affect traversal paths).
    internal = ~forest.is_leaf
    q = np.round(forest.values * 1000.0).astype(np.int64)
    tok = (
        forest.fids.astype(np.int64) * np.int64(1_000_003)
        + q
        # include heap position so the same split at different tree positions
        # hashes differently (structure-awareness)
        + np.arange(forest.nodes_per_tree, dtype=np.int64)[None, :] * np.int64(0x9E3779B9)
    )
    h = _mix64(tok.view(np.uint64) if tok.dtype == np.uint64 else tok.astype(np.uint64))

    # simhash bit voting: for each of 64 bits, +1 if set else -1, summed over
    # the tree's tokens; final bit = sign of the vote.
    votes = np.zeros((forest.num_trees, 64), dtype=np.int64)
    for b in range(64):
        bit = ((h >> np.uint64(b)) & np.uint64(1)).astype(np.int64)
        votes[:, b] = np.where(internal, 2 * bit - 1, 0).sum(axis=1)
    bits = (votes > 0).astype(np.uint64)
    out = np.zeros(forest.num_trees, dtype=np.uint64)
    for b in range(64):
        out |= bits[:, b] << np.uint64(b)
    return out


def tree_simhash_order(forest: ForestSpec) -> np.ndarray:
    """Stable tree permutation sorted by (simhash, original index) —
    the reference's sort of (hash, index) pairs (Struct.h:1881)."""
    hashes = tree_simhashes(forest)
    return np.argsort(hashes, kind="stable").astype(np.int64)
