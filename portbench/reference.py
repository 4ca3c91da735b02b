"""The plain reference: a forest's predictions and the nodes each row
visits, in plain PyTorch, from the generated arrays alone.

It follows the reference binary's golden model (BaseTahoeTest.h:440-487):
at each internal node a row goes right when its value is missing and the
node's default is right, or when it is present and ``x >= threshold``
(inverted where ``exchange`` is set); it stops at a leaf; a row's margin is
the sum of its leaves over the trees, then the output transform (AVG,
+ global bias, SIGMOID, THRESHOLD, in that order). A value is missing when
it is NaN for a NaN sentinel, or within 1e-6 of a finite sentinel.

``predict(..., dtype=torch.float32)`` compares in f32, as the configuration
states, and sums the leaves in float64; ``dtype=torch.bfloat16`` is the
control: rows, thresholds, leaves and their sum all in bfloat16. It runs on
the rows' device, in blocks of rows. It imports nothing of the program.
"""
from __future__ import annotations

import torch

MISSING_EPS = 1.0e-6
AVG, SIGMOID, THRESHOLD = 0x1, 0x10, 0x100
# (row, tree) pairs a block of the walk holds
BLOCK_PAIRS = 1 << 24


def _flat(forest: dict, name: str, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(forest[name]).reshape(-1).to(device)
    return t if dtype is None else t.to(dtype)


def _missing(x: torch.Tensor, missing: float) -> torch.Tensor:
    if missing != missing:  # NaN
        return torch.isnan(x)
    return torch.abs(x.float() - missing) <= MISSING_EPS


def transform(margins: torch.Tensor, forest: dict) -> torch.Tensor:
    """The output transform of ``forest`` on margins, in their dtype."""
    out = margins
    if forest["output"] & AVG:
        out = out / forest["values"].shape[0]
    if forest["global_bias"] != 0.0:
        out = out + float(torch.tensor(forest["global_bias"], dtype=torch.float32))
    if forest["output"] & SIGMOID:
        out = torch.sigmoid(out)
    if forest["output"] & THRESHOLD:
        thr = float(torch.tensor(forest["threshold"], dtype=torch.float32))
        out = (out > thr).to(out.dtype)
    return out


def predict(forest: dict, rows: torch.Tensor, *,
            dtype: torch.dtype = torch.float32,
            block_pairs: int = BLOCK_PAIRS) -> tuple[torch.Tensor, torch.Tensor]:
    """(predictions [R], internal nodes visited [R] int64) of ``rows``
    [R, C]. Predictions are float64 for ``dtype`` float32 (or float64),
    and in ``dtype`` otherwise."""
    device = rows.device
    trees, nodes = forest["values"].shape
    acc = torch.float64 if dtype in (torch.float32, torch.float64) else dtype
    values = _flat(forest, "values", device, dtype)
    fids = _flat(forest, "fids", device, torch.int64)
    def_right = ~_flat(forest, "def_left", device, torch.bool)
    is_leaf = _flat(forest, "is_leaf", device, torch.bool)
    exchange = _flat(forest, "exchange", device, torch.bool)
    base = torch.arange(trees, device=device, dtype=torch.int64) * nodes
    missing = float(forest["missing"])
    n = rows.shape[0]
    preds = torch.empty(n, dtype=acc, device=device)
    visits = torch.empty(n, dtype=torch.int64, device=device)
    step = max(1, block_pairs // trees)
    for a in range(0, n, step):
        x = rows[a:a + step].to(dtype)
        curr = torch.zeros((x.shape[0], trees), dtype=torch.int64, device=device)
        seen = torch.zeros(x.shape[0], dtype=torch.int64, device=device)
        for _ in range(forest["depth"]):
            idx = curr + base
            inner = ~is_leaf[idx]
            xv = torch.gather(x, 1, fids[idx])
            right = torch.where(_missing(xv, missing), def_right[idx],
                                xv >= values[idx])
            right = right ^ exchange[idx]
            curr = torch.where(inner, 2 * curr + 1 + right.to(torch.int64), curr)
            seen += inner.sum(dim=1)
        leaves = values[curr + base].to(acc)
        preds[a:a + step] = transform(leaves.sum(dim=1, dtype=acc), forest)
        visits[a:a + step] = seen
    return preds, visits
