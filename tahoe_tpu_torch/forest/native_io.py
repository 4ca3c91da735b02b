"""ctypes binding of the native text-format parser (forest/loader.cpp).

The port of tahoe_tpu/forest/native_io.py, with its API: ``available()``,
``load_model(path) -> (num_trees, depth, table)`` and ``load_data(path) ->
(rows, missing)``. The reference's loaders are host C++
(BaseTahoeTest.h:267-402); this one scans a file with strtod, about 20x
faster than numpy's loadtxt on the reference's files of millions of lines.
The numpy parser in io.py stays the format of record, and this one gives
the same arrays bit for bit (tests/test_torch_native_io.py).

The library is host code, built by the host's ``c++`` at first use into
build/tahoe_tpu_torch/ under the checkout, its file name keyed by a hash of
the source and flags as ops/_build.py keys the kernels', and never part of
the CUDA kernel library. A build that fails is reported, not hidden:
``available()`` is False, ``build_error()`` says why, and the loaders
raise with that reason.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from tahoe_tpu_torch.config import Output, tree_num_nodes

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tahoe_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra"]

_lib = None
_error: str | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtahoe_io_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent process sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _get_lib():
    """The loaded library, built on first use; None, with ``_error`` set,
    when it cannot be built or loaded."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.tahoe_model_header.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.tahoe_model_load.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
    lib.tahoe_data_header.argtypes = [ctypes.c_char_p, i64p, i64p,
                                      ctypes.POINTER(ctypes.c_double)]
    lib.tahoe_data_load.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_float)]
    for fn in (lib.tahoe_model_header, lib.tahoe_model_load,
               lib.tahoe_data_header, lib.tahoe_data_load):
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native loader could be built and loaded."""
    return _get_lib() is not None


def build_error() -> str | None:
    """Why the native loader is not available, or None."""
    _get_lib()
    return _error


def _lib_or_raise():
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"the native loader is not available: {_error}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_model(path: str) -> tuple[int, int, np.ndarray]:
    """(num_trees, depth, table [nodes, 5] f64): the columns in the file's
    order, fid, value, def_left, weight, is_leaf, as io._model_from_table
    takes them."""
    lib = _lib_or_raise()
    nt, dp = ctypes.c_int64(), ctypes.c_int64()
    if lib.tahoe_model_header(str(path).encode(), ctypes.byref(nt),
                              ctypes.byref(dp)) != 0:
        raise IOError(f"cannot read the model file {path}")
    num_trees, depth = int(nt.value), int(dp.value)
    if num_trees < 0 or depth < 0:
        raise IOError(f"model file {path}: header of {num_trees} trees, depth {depth}")
    n = num_trees * tree_num_nodes(depth)
    fids = np.empty(n, np.int32)
    values = np.empty(n, np.float32)
    def_left = np.empty(n, np.uint8)
    weights = np.empty(n, np.float32)
    is_leaf = np.empty(n, np.uint8)
    rc = lib.tahoe_model_load(
        str(path).encode(), n, _ptr(fids, ctypes.c_int32), _ptr(values, ctypes.c_float),
        _ptr(def_left, ctypes.c_uint8), _ptr(weights, ctypes.c_float),
        _ptr(is_leaf, ctypes.c_uint8))
    if rc != 0:
        raise IOError(f"model file {path} truncated or malformed (rc={rc})")
    table = np.empty((n, 5), np.float64)
    for i, col in enumerate((fids, values, def_left, weights, is_leaf)):
        table[:, i] = col
    return num_trees, depth, table


def load_data(path: str) -> tuple[np.ndarray, float]:
    """(rows [R, C] f32, the missing sentinel), as io.load_data gives them."""
    lib = _lib_or_raise()
    nr, nc, miss = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_double()
    if lib.tahoe_data_header(str(path).encode(), ctypes.byref(nr), ctypes.byref(nc),
                             ctypes.byref(miss)) != 0:
        raise IOError(f"cannot read the data file {path}")
    rows, cols = int(nr.value), int(nc.value)
    if rows < 0 or cols < 0:
        raise IOError(f"data file {path}: header of {rows} x {cols} values")
    out = np.empty(rows * cols, np.float32)
    rc = lib.tahoe_data_load(str(path).encode(), rows * cols, _ptr(out, ctypes.c_float))
    if rc != 0:
        raise IOError(f"data file {path} truncated or malformed (rc={rc})")
    return out.reshape(rows, cols), float(miss.value)


def load_spec(path: str, *, output: int = int(Output.RAW), global_bias: float = 0.0,
              threshold: float = 0.5, missing: float = float("nan"),
              num_cols: int | None = None):
    """io.load_model through the native parser: the same ForestSpec."""
    from tahoe_tpu_torch.forest import io

    return io._model_from_table(*load_model(path), output, global_bias, threshold,
                                missing, num_cols)
