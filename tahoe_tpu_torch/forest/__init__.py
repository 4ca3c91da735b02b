"""The forest host layer: spec, text IO, compiler passes, rank quantization,
synthetic generators, training and the CSR form. It is numpy, the port's own
copy of the JAX package's host layer (each module names the file it came
from, and tests/test_torch_host_layer.py holds it to the original bit for
bit); ``sparse`` also holds the SPARSE strategy's plain torch gather tier.
"""
from tahoe_tpu_torch.forest import compiler, io, quantize, sparse, spec, synthetic, train

__all__ = ["compiler", "io", "quantize", "sparse", "spec", "synthetic", "train"]
