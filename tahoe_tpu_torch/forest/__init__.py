"""The forest host layer: spec, text IO, compiler passes, rank quantization,
synthetic generators and training. It is numpy, shared with the JAX package
rather than copied, and re-exported here so callers of the port import one
package. ``sparse`` is the port's own module: the shared CSR form plus the
SPARSE strategy's plain torch gather tier.
"""
from tahoe_tpu.forest import compiler, io, quantize, spec, synthetic, train
from tahoe_tpu_torch.forest import sparse

__all__ = ["compiler", "io", "quantize", "sparse", "spec", "synthetic", "train"]
