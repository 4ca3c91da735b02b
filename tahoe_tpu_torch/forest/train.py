"""Tiny numpy forest trainer — realistic fixtures without sklearn.

The port's own copy of tahoe_tpu/forest/train.py (the numpy host
layer), held to the original bit for bit by
tests/test_torch_host_layer.py.

The reference benchmarks forests trained on real datasets (SUSY, HIGGS, ...;
run_all_15_examples.sh downloads them). Those fixtures are unreachable from
this environment, so this module grows genuinely *trained* ensembles on
synthetic regression/classification tasks instead: greedy axis-aligned CART
with bootstrap rows and feature subsampling (random-forest style). Trained
trees have what random node soups lack — early leaves, depth skew across
trees, correlated split structure, and feature-dependent threshold counts —
exactly the properties the adaptive paths (unreachable-depth truncation,
DEPTH_BUCKETED, hot-child swap weights) exist to exploit.

Output is a complete-tree ``ForestSpec`` in the reference's storage
convention (BaseTahoeTest.h:267-352: every tree stored dense to the forest
depth; unreachable filler nodes repeat the parent leaf), with node ``weight``
= training-sample count (the hot-child swap key, Struct.h:1775-1825).
"""
from __future__ import annotations

import numpy as np

from tahoe_tpu_torch.config import Output
from tahoe_tpu_torch.forest.spec import ForestSpec


def _grow_tree(X, y, w_rows, depth_budget, min_leaf, rng, feat_frac):
    """Greedy variance-reduction CART. Returns dict arrays for a complete
    tree of depth ``depth_budget`` (heap order, filler = parent leaf)."""
    n_nodes = (1 << (depth_budget + 1)) - 1
    fid = np.zeros(n_nodes, np.int64)
    thr = np.zeros(n_nodes, np.float64)
    leaf = np.ones(n_nodes, bool)
    val = np.zeros(n_nodes, np.float64)
    wgt = np.zeros(n_nodes, np.float64)
    F = X.shape[1]

    def grow(node, idx, d):
        yv = y[idx]
        wgt[node] = idx.size
        val[node] = float(yv.mean()) if idx.size else 0.0
        if (d >= depth_budget or idx.size < 2 * min_leaf
                or float(yv.max() - yv.min()) == 0.0):
            return
        best = None  # (score, f, t, mask)
        feats = rng.choice(F, max(1, int(F * feat_frac)), replace=False)
        for f in feats:
            xv = X[idx, f]
            order = np.argsort(xv, kind="stable")
            xs, ys = xv[order], yv[order]
            # candidate cuts between distinct neighbors
            cuts = np.nonzero(xs[1:] > xs[:-1])[0]
            if cuts.size == 0:
                continue
            if cuts.size > 32:  # subsample cut positions for speed
                cuts = cuts[rng.choice(cuts.size, 32, replace=False)]
            csum = np.cumsum(ys)
            tot = csum[-1]
            n = ys.size
            for c in cuts:
                nl = c + 1
                nr = n - nl
                if nl < min_leaf or nr < min_leaf:
                    continue
                sl = csum[c]
                # maximize between-group variance = weighted split gain
                score = sl * sl / nl + (tot - sl) * (tot - sl) / nr
                if best is None or score > best[0]:
                    # reference compare is x >= t → right; threshold at the
                    # first element of the right half
                    best = (score, f, float(xs[nl]), None)
        if best is None:
            return
        _, f, t, _ = best
        right = X[idx, f] >= t
        leaf[node] = False
        fid[node] = f
        thr[node] = t
        grow(2 * node + 1, idx[~right], d + 1)
        grow(2 * node + 2, idx[right], d + 1)

    grow(0, np.arange(X.shape[0]), 0)

    # complete-tree filler: unreachable children repeat the parent leaf value
    for node in range(n_nodes):
        if node and leaf[(node - 1) // 2] and wgt[node] == 0:
            p = (node - 1) // 2
            val[node] = val[p]
            wgt[node] = 0.0
            leaf[node] = True
    return fid, thr, leaf, val, wgt


def train_forest(num_trees: int, depth: int, num_cols: int, *,
                 rows: int = 2048, seed: int = 0, min_leaf: int = 4,
                 feat_frac: float = 0.7, missing: float = float("nan"),
                 task_fn=None) -> ForestSpec:
    """Random-forest training on a synthetic nonlinear task. Produces trees
    whose REACHABLE depths vary with the data (typically spanning
    ~depth/2..depth), early leaves throughout, and training-count weights."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((rows, num_cols)).astype(np.float32)
    if task_fn is None:
        # nonlinear target with interactions — forces varied tree shapes
        proj = rng.standard_normal((num_cols, 3))
        z = X @ proj
        y = (np.sin(z[:, 0]) + 0.5 * np.sign(z[:, 1]) * z[:, 1] ** 2
             + 0.3 * z[:, 2] + 0.1 * rng.standard_normal(rows))
    else:
        y = task_fn(X, rng)
    y = y.astype(np.float64)

    fids, vals, leafs, wgts = [], [], [], []
    for t in range(num_trees):
        bidx = rng.integers(0, rows, rows)
        f, th, lf, v, w = _grow_tree(
            X[bidx], y[bidx], None, depth, min_leaf, rng, feat_frac
        )
        # single values array: threshold for internal nodes, value for leaves
        vals.append(np.where(lf, v, th).astype(np.float32))
        fids.append(f.astype(np.int32))
        leafs.append(lf)
        wgts.append(w.astype(np.float32))

    shape = (num_trees, (1 << (depth + 1)) - 1)
    return ForestSpec(
        depth=depth,
        num_cols=num_cols,
        values=np.stack(vals),
        weights=np.stack(wgts),
        fids=np.stack(fids),
        def_left=np.zeros(shape, dtype=bool),
        is_leaf=np.stack(leafs),
        exchange=np.zeros(shape, dtype=bool),
        output=int(Output.AVG),
        missing=missing,
    )
