"""Probe: are int8 products made inside a kernel exact on this card?

    python -m tahoe_tpu_torch.scripts.int8_cast_probe

The H100 counterpart of scripts/int8_cast_probe.py, on its inputs: x [256,
128] int32 in [-100, 100) and W [128, 128] int8 in [-4, 4), both from numpy
seed 0. Three checks (csrc/probes.cu ``tahoe_probe_int8``):

- ``store``: int32 to int8 in the kernel, wrapping as numpy's astype does;
- ``dot_lhs``: (x > 0) made int8 in the kernel, multiplied by W into int32;
- ``scratch_dot``: x cast to int8 through shared memory, then the product.

Each product runs twice, by __dp4a (kernel B's instruction) and by
mma.sync m16n8k32 s8 (the tensor cores), and each must equal the numpy
int32 product exactly: that says whether kernel B's dot could move to the
tensor cores without losing exactness. Prints one JSON line: each check's
verdict, its kernel time and its plain version's, and torch._int_mm on the
scratch_dot operands (int8(x), W) as the library's time, all device times
(utils/profiling.py cuda_device_ms: 20 calls replayed from a CUDA graph,
since each call is shorter than the host's time to issue it).
"""
from __future__ import annotations

import sys

import numpy as np

from tahoe_tpu_torch.scripts import main


def inputs(rows: int = 256):
    """The original probe's x and W (numpy seed 0); at another row count, x
    and W drawn the same way."""
    rng = np.random.default_rng(0)
    x32 = rng.integers(-100, 100, (rows, 128)).astype(np.int32)
    w8 = rng.integers(-4, 4, (128, 128)).astype(np.int8)
    return x32, w8


def numpy_reference(x32: np.ndarray, w8: np.ndarray, mode: str) -> np.ndarray:
    if mode == "store":
        return x32.astype(np.int8)
    lhs = (x32 > 0) if mode.startswith("dot_lhs") else x32.astype(np.int8)
    return lhs.astype(np.int32) @ w8.astype(np.int32)


def run(device) -> dict:
    import torch

    from tahoe_tpu_torch.ops.probes import (
        INT8_MODES, int8_probe_cuda, int8_probe_plain)
    from tahoe_tpu_torch.utils.profiling import cuda_device_ms

    x32, w8 = inputs()
    x = torch.as_tensor(x32, device=device)
    w = torch.as_tensor(w8, device=device)
    out = {"card": torch.cuda.get_device_name(device), "checks": {}}
    for mode in INT8_MODES:
        got = int8_probe_cuda(x, w, mode)
        plain = int8_probe_plain(x, w, mode)
        torch.cuda.synchronize()
        want = numpy_reference(x32, w8, mode)
        exact = (np.array_equal(got.cpu().numpy(), want)
                 and torch.equal(got, plain))
        out["checks"][mode] = {
            "exact": bool(exact),
            "max_abs_err": int((got.long() - plain.long()).abs().max()),
            "ms": cuda_device_ms(lambda: int8_probe_cuda(x, w, mode)),
            "plain_ms": cuda_device_ms(lambda: int8_probe_plain(x, w, mode)),
        }
    lhs = x.to(torch.int8)
    out["library_int_mm_ms"] = cuda_device_ms(lambda: torch._int_mm(lhs, w))
    out["all_exact"] = all(c["exact"] for c in out["checks"].values())
    return out


if __name__ == "__main__":
    sys.exit(main(run))
