"""One dispatch a predict: an engine's call captured once per input shape
in a CUDA graph and replayed.

The counterpart of the JAX package's ``self._predict =
jax.jit(self._predict_impl)`` (ops/fold_kernel.py:224 and every other
engine): a jit traces an engine's predict once per input shape into one
XLA executable, and each later call is one dispatch. Here
``graphed(fn, device, stage)`` is a callable that does the same with CUDA
graphs, for a call that is ``fn(stage(rows))``. ``stage(rows, out=None)``
is the engine's step that reads the raw rows (ops/rows.py ``stage_rows``:
their column gather, or a copy); given ``out``, it writes into it:

- on ``cuda`` the first call at a key (the input's rows and columns) stages
  its rows into a static input buffer, runs ``fn`` on it once on a side
  stream (the warm-up PyTorch's graph capture asks for; its output is the
  call's result) and then captures ``fn`` on the buffer in a
  ``torch.cuda.CUDAGraph``. Each later call at that key stages its rows
  straight into the buffer, outside the graph, replays the graph and
  returns a clone of the static output: a caller's earlier result is never
  overwritten, as a JAX result is not. So the raw rows are read once, as an
  eager call reads them; where the engine gathers no columns that read is a
  copy the eager call does not make. An empty batch runs ``fn(stage(rows))``
  as it is;
- on ``cpu`` it calls ``fn(stage(rows))``: no graph exists there;
- where the current stream is already capturing
  (``utils/profiling.cuda_device_ms``), it calls ``fn(stage(rows))``
  inline, so that the outer graph records the same launches.

A capture or a replay that fails raises a RuntimeError that names the
engine's method and the key; no caller runs the call eagerly instead.

Launch counts stay true: a ``CudaKernel`` (ops/_build.py) counts the
launches made from Python, and a replay makes none. So a capture records
the counts it added, sets them back (a capture runs nothing on the card),
and every replay adds them again: one replay counts what one eager call
counts.

Memory: every graph of one callable keeps its intermediates in one memory
pool, shared by its shapes: the replays run one at a time on one stream and
each output is cloned at once, so the pool holds about one eager call's
peak working set at the largest shape, not one a shape. The plain torch
engines take their rows in chunks of ``ops/rows.py`` ``ROW_CHUNK_BYTES``
(256 MiB) inside the graph. Besides, each shape keeps its static input and
output. The engine's tables are not copied. The graphs live as long as the
callable (an engine's lifetime); ``release`` frees them at once, and
``Forest.drop_engines`` and the enumeration call it.
"""
from __future__ import annotations

import inspect
import time
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from tahoe_tpu_torch.config import resolve_device
from tahoe_tpu_torch.ops import _build
from tahoe_tpu_torch.ops.transform import apply_output_transform


def launch_counts() -> dict:
    """Every registered kernel's launch count, by kernel."""
    return {k: k.launches for k in _build.KERNELS}


def take_launches(before: dict) -> list:
    """The launches counted since ``before`` (``launch_counts()``), as
    (kernel, count) pairs; the counts are set back to ``before``."""
    delta = []
    for k in _build.KERNELS:
        n = k.launches - before.get(k, 0)
        if n:
            delta.append((k, n))
            k.launches -= n
    return delta


def add_launches(delta: list) -> None:
    """Count ``delta`` (``take_launches``) once more: a replay's launches."""
    for k, n in delta:
        k.launches += n


def _weak(fn: Callable):
    """``fn`` held weakly where it is a bound method: an engine holds its
    graphed callables, and their graphs go with the engine, without a
    reference cycle."""
    return weakref.WeakMethod(fn) if inspect.ismethod(fn) else (lambda: fn)


class _Graph(NamedTuple):
    """One capture: the graph, its static buffers, the launches it holds
    and the seconds its warm-up and capture took."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: list
    seconds: float


class graphed:
    """``fn(stage(rows))`` on ``device``, ``fn`` in one CUDA graph per
    input shape (the module docstring). ``graphs`` maps each key to its
    capture."""

    def __init__(self, fn: Callable, device, stage: Callable):
        self.device = resolve_device(device)
        owner = getattr(fn, "__self__", None)
        # a bound method is named by its engine's class, not by the class
        # that defines it
        self.name = (f"{type(owner).__name__}.{fn.__name__}"
                     if owner is not None else fn.__qualname__)
        self._fn, self._stage = _weak(fn), _weak(stage)
        self.graphs: dict = {}
        self._pool = None

    def _held(self, ref) -> Callable:
        fn = ref()
        if fn is None:
            raise RuntimeError(f"{self.name}: its engine no longer exists")
        return fn

    @property
    def fn(self) -> Callable:
        return self._held(self._fn)

    @property
    def stage(self) -> Callable:
        return self._held(self._stage)

    def release(self) -> None:
        """Drop every graph and their pool."""
        self.graphs.clear()
        self._pool = None

    def __call__(self, rows):
        if self.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return self.fn(self.stage(rows))
        key = tuple(np.shape(rows))
        if not key or key[0] == 0:
            return self.fn(self.stage(rows))
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, rows)
        self.stage(rows, g.static_in)
        try:
            g.graph.replay()
            out = g.static_out.clone()
        except Exception as e:
            raise RuntimeError(f"{self.name}: the replay at rows, columns "
                               f"{key} failed: {e}") from e
        add_launches(g.launches)
        return out

    def _capture(self, key: tuple, rows) -> torch.Tensor:
        """The first call at ``key``: the warm-up's output, and the graph."""
        t0 = time.perf_counter()
        fn = self.fn
        # a buffer of its own: the staged rows may be the caller's tensor
        static_in = self.stage(rows).clone(memory_format=torch.contiguous_format)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn(static_in)
        current.wait_stream(side)
        out.record_stream(current)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                static_out = fn(static_in)
        except Exception as e:
            take_launches(before)
            raise RuntimeError(f"{self.name}: the capture at rows, columns "
                               f"{key} failed: {e}") from e
        self.graphs[key] = _Graph(graph, static_in, static_out,
                                  take_launches(before),
                                  time.perf_counter() - t0)
        return out


class GraphedEngine:
    """An engine whose ``predict`` and ``margins`` are graphed, as a JAX
    engine's are jitted. A subclass gives ``device``, the output
    transform's fields (``num_trees``, ``output``, ``global_bias``,
    ``threshold``), ``_stage(rows, out=None)`` (its step that reads the raw
    rows, ops/rows.py ``stage_rows``) and ``_margins_staged(x)`` (the
    margins of staged rows), and calls ``_graph()`` once it can stage."""

    def _graph(self) -> None:
        self._predict = graphed(self._predict_staged, self.device, self._stage)
        self._margins = graphed(self._margins_staged, self.device, self._stage)

    def _finish(self, margins: torch.Tensor) -> torch.Tensor:
        return apply_output_transform(margins, self.num_trees, self.output,
                                      self.global_bias, self.threshold)

    def _predict_staged(self, x: torch.Tensor) -> torch.Tensor:
        return self._finish(self._margins_staged(x))

    def _margins_impl(self, rows) -> torch.Tensor:
        return self._margins_staged(self._stage(rows))

    def _predict_impl(self, rows) -> torch.Tensor:
        return self._predict_staged(self._stage(rows))

    def margins(self, rows) -> torch.Tensor:
        return self._margins(rows)

    def predict(self, rows) -> torch.Tensor:
        return self._predict(rows)


def release(engine) -> None:
    """Free the graphs of every graphed method of ``engine`` (and of the
    engine it wraps, for a sharded engine)."""
    for value in vars(engine).values():
        if isinstance(value, graphed):
            value.release()
    inner = getattr(engine, "engine", None)
    if inner is not None and inner is not engine:
        release(inner)
