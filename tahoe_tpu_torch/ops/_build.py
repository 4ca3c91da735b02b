"""Build and load the port's CUDA kernels (the counterpart of ops/mosaic.py).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
at once, and linked into ONE shared library with a plain C interface,
loaded with ``ctypes``. The build
happens at first use, into ``build/tahoe_tpu_torch/`` under the checkout,
and its file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing here runs when the
module is imported: the CPU tests import every module without a compiler.

Each C launcher returns ``cudaGetLastError()`` (or the first CUDA error it
met); :class:`CudaKernel` raises when that is not 0. A failed build raises
too: no caller turns it into a CPU run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tahoe_tpu_torch"

# Never --use_fast_math, -ftz=true or -prec-*=false: flushing denormals or
# approximating compares changes routing (ge-normalized thresholds near 0
# are denormal, compiler.ge_normalize).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtahoe_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if its hashed file is missing; return it.

    Each source is compiled by its own nvcc, all at once, then the objects
    are linked into one library. The compiler's register/shared-memory
    report (-Xptxas -v) is kept beside the library as ``<lib>.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        try:
            for src in sorted(CSRC.glob("*.cu")):
                cmd = [_nvcc(), *compile_flags, "-c", "-o",
                       os.path.join(objdir, src.stem + ".o"), str(src)]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            log = []
            for cmd, proc in jobs:
                out = proc.communicate()[0]
                log.append(out)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
            objs = sorted(str(p) for p in Path(objdir).glob("*.o"))
            cmd = [_nvcc(), "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
        except BaseException:
            # no compiler outlives the build or writes into objdir as it goes
            for _, job in jobs:
                job.kill()
                job.wait()
                job.stdout.close()
            os.unlink(tmp)
            raise
    Path(str(path) + ".log").write_text("".join(log))
    os.replace(tmp, path)  # atomic: a concurrent process never sees half a file
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


class CudaKernel:
    """One C launcher of the kernel library, with its launch count.

    ``launches`` counts successful launches and nothing else: the plain
    PyTorch versions never touch it, so a run that reads it after driving the
    main path sees whether that path went through the kernel."""

    def __init__(self, symbol: str, argtypes: list, *, source: str,
                 replaces: str):
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, device: torch.device, *args) -> None:
        fn = getattr(library(), self.symbol)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  device: torch.device, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``
    on ``device``: the kernels take raw pointers and trust their layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
