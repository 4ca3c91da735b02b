"""Output transform: margin -> prediction, on torch tensors.

The order is the reference's (Struct.h:196-209, BaseTahoeTest.h:465-472)
and tahoe_tpu/ops/transform.py's: AVG (divide by num_trees) -> + global_bias
-> SIGMOID -> THRESHOLD (strictly greater -> 1.0, else 0.0). Every constant
is rounded to f32 first, as the numpy oracle does, so the arithmetic stays
in f32.
"""
from __future__ import annotations

import numpy as np
import torch

from tahoe_tpu_torch.config import Output

# the flags as plain ints: an IntFlag's ``&`` runs Python's enum code,
# microseconds a test where a fold kernel's direct launch runs the
# transform eagerly
_AVG, _SIGMOID, _THRESHOLD = (int(Output.AVG), int(Output.SIGMOID),
                              int(Output.THRESHOLD))


def apply_output_transform(margins: torch.Tensor, num_trees: int, output: int,
                           global_bias: float,
                           threshold: float) -> torch.Tensor:
    output = int(output)
    preds = margins.to(torch.float32)
    if output & _AVG:
        preds = preds / float(np.float32(num_trees))
    if global_bias != 0.0:
        preds = preds + float(np.float32(global_bias))
    if output & _SIGMOID:
        preds = 1.0 / (1.0 + torch.exp(-preds))
    if output & _THRESHOLD:
        preds = (preds > float(np.float32(threshold))).to(torch.float32)
    return preds
