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

**The in-place route** (``graphed(fn, device, stage, in_place)``). An
engine whose kernel reads the raw rows itself gives ``in_place(x)``, its
call on the caller's f32 rows where they lie (``row_stride``: any row
stride, adjacent columns): the kernel applies the column gather and the
engine's own transforms as it stages the rows. On this route a call
captures no graph: it launches ``in_place(rows)`` directly on the current
stream, as an eager op would, and ``stage`` does not run. A graph bakes
the address of its input into the capture, so a graph here would need the
rows copied into a static input, or their address passed through device
memory, and a direct launch needs neither (PERF.md section 6 times the
two against each other). The engine's output transform, where the forest
has one (an average, a bias, a sigmoid), runs as eager elementwise ops
after the kernel. Rows that cannot be read in place
(numpy, host tensors, other dtypes, strided columns) are first made a
contiguous f32 tensor on the device. A chain captures its steps reading
its own device copy of the rows. The fold engine takes the route on both
of its kernels (ops/fold_kernel.py ``FoldKernelEngine``: kernel C or the
deep kernel, whichever ``fold_plan`` picks; ``SPLIT_FOREST`` and
``VMEM_FOREST``): their row staging copies each element anyway, so the
gather, the copy into the static input and the dual lanes were passes of
their own over the same rows. Every other engine, ``DEPTH_BUCKETED``'s
included, stages as above.

Spans and counters. While a profiler records, each call on ``cuda`` marks
host spans (utils/profiling.py ``span``) that the trace ties to the device
work they launch: ``tahoe_stage`` around the staging into the static
input (the copy, or the column gather; on the in-place route only the
conversion of rows that cannot be read in place), ``tahoe_replay`` around
the graph's launch (on the in-place route, the kernel's own launch),
``tahoe_clone`` around the clone of its output, and ``tahoe_capture``
around a shape's warm-up and capture (a predict's, or a chain graph's), so
that a capture in steady state shows in any trace.
The CPU path and a staged call inline in an outer capture mark none; Forest.predict
marks ``tahoe_predict`` around the whole call. With no profiler a span is
one test of a flag. ``counters()`` snapshots monotonic totals over every
graphed callable: ``captures`` and ``capture_s`` (each capture's
``_Graph.seconds``), ``replays`` (each call served without a capture: a
replay of a predict's graph, or on the in-place route the kernel's direct
launch, which takes the graph's place),
``staged_bytes`` (the static input's bytes, each time a call stages into it
outside the graph, or the rows the in-place route converts),
``direct_calls`` (the in-place route's calls whose rows the kernel read
where they lie) and ``launches`` (the kernels' counts above, summed).
They are plain adds on the host. An operator checks the graph cache with
them: in steady state ``captures`` stays flat, ``replays`` counts the calls,
and ``staged_bytes`` a row is what the staging step moves; on the in-place
route, with rows on the card, ``captures`` and ``staged_bytes`` stay flat
and ``direct_calls`` equals ``replays``. On a
chain ``captures`` and ``capture_s`` count its graphs (the one-step graph
and each m-step graph) and ``launches`` k calls' launches; its staging runs
inside its graphs and its replays are the timing's, so ``replays``,
``staged_bytes`` and ``direct_calls`` do not move.

Memory: every graph of one callable keeps its intermediates in one memory
pool, shared by its shapes: the replays run one at a time on one stream and
each output is cloned at once, so the pool holds about one eager call's
peak working set at the largest shape, not one a shape. The plain torch
engines take their rows in chunks of ``ops/rows.py`` ``ROW_CHUNK_BYTES``
(256 MiB) inside the graph. Besides, each shape keeps its static input and
output. The engine's tables are not copied. The graphs live as long as the
callable (an engine's lifetime); ``release`` frees them at once, and
``Forest.drop_engines`` and the enumeration call it.

**A chain of k predicts** (``graphed.chain``, ``GraphedEngine.predict_k``):
the counterpart of the JAX engines' ``jax.jit(self._chain_impl,
static_argnames=("k",))``, k serialized predicts in one dispatch, which
the chained-slope timing (utils/profiling.py ``slope_time``) runs. Each of
the k steps is a whole call: ``stage`` from a device-resident copy of the
rows into the static input (the column gather, or the copy), then ``fn``.
The steps are serialized by the capture's stream order, so no ``data +
acc[0] * 0.0`` op ties one step to the last. k runs into the thousands,
so the chain is not one unrolled graph: m steps are captured in one graph,
keyed by (rows, columns, m), and replayed ⌈k/m⌉ times back to back, a last
graph of the remainder ending the chain. m is chosen once a shape so that
one replay keeps the card busy CHAIN_REPLAY_S, many times the host's issue
of a replay (whose time the one-step graph's replays, back to back, bound
from above), and so that capturing m steps takes at most CHAIN_CAPTURE_S:
m = 1 where a call runs for milliseconds or takes a second to capture
(the plain torch engines at 65,536 rows). The steps share the callable's
memory pool, each freeing the last one's intermediates, so a chain holds
about one step's working set. The result is the last step's output,
cloned once a chain. A chain counts k times one call's launches (the
warm-up before a shape's first capture, and the replays that size m, are
not counted, as a capture is not). On ``cpu``, or inside an outer capture,
it runs k calls of ``fn(stage(rows))`` and returns the last. A capture or a
replay that fails raises a RuntimeError that names the method, the key and
m; nothing runs the chain eagerly instead.
"""
from __future__ import annotations

import inspect
import math
import time
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from tahoe_tpu_torch.config import resolve_device
from tahoe_tpu_torch.ops import _build
from tahoe_tpu_torch.ops.transform import apply_output_transform
from tahoe_tpu_torch.utils.profiling import span

# a chain's replay of m steps keeps the card busy this long (the host
# issues a replay in 10-30 us); capturing m steps takes at most
# CHAIN_CAPTURE_S; m is at most CHAIN_MAX_STEPS
CHAIN_REPLAY_S = 1e-3
CHAIN_CAPTURE_S = 0.5
CHAIN_MAX_STEPS = 256
# replays of the one-step graph, back to back, that size m
CHAIN_PROBE_REPLAYS = 10


# the totals counters() reads, besides the kernels' launch counts
_TOTALS = {"captures": 0, "capture_s": 0.0, "replays": 0, "staged_bytes": 0,
           "direct_calls": 0}


def counters() -> dict:
    """Monotonic totals over every graphed callable (the module docstring,
    "Spans and counters"): captures, capture_s, replays, staged_bytes,
    direct_calls and launches."""
    return {**_TOTALS, "launches": sum(k.launches for k in _build.KERNELS)}


def _captured(g: "_Graph") -> "_Graph":
    _TOTALS["captures"] += 1
    _TOTALS["capture_s"] += g.seconds
    return g


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


def chain_runs(k: int, steps: int) -> list:
    """The graphs a chain of ``k`` calls replays, by their steps: ⌈k/m⌉
    replays of m = ``steps``, the last of the remainder where there is one."""
    full, rest = divmod(k, steps)
    return [steps] * full + ([rest] if rest else [])


def chain_key(key: tuple, steps: int) -> tuple:
    """A chain graph's key: the input's (rows, columns) and its steps."""
    return key + (steps,)


def chain_steps(replay_s: float, capture_s: float) -> int:
    """m, the steps of a chain's graph: enough that one replay keeps the
    card busy CHAIN_REPLAY_S, where one step's graph replays in
    ``replay_s`` back to back (its device time, or the host's issue where
    that is longer), as few as capture in CHAIN_CAPTURE_S where one step
    captures in ``capture_s``; 1 to CHAIN_MAX_STEPS."""
    return max(1, min(CHAIN_MAX_STEPS,
                      math.ceil(CHAIN_REPLAY_S / max(replay_s, 1e-12)),
                      int(CHAIN_CAPTURE_S / max(capture_s, 1e-12))))


def _weak(fn: Callable):
    """``fn`` held weakly where it is a bound method: an engine holds its
    graphed callables, and their graphs go with the engine, without a
    reference cycle."""
    return weakref.WeakMethod(fn) if inspect.ismethod(fn) else (lambda: fn)


def row_stride(rows, device: torch.device) -> int | None:
    """The row stride at which the in-place route reads ``rows`` where
    they lie: a 2-D f32 tensor on ``device`` whose columns are adjacent.
    None for any other rows, which are staged first."""
    if not (isinstance(rows, torch.Tensor) and rows.dtype == torch.float32
            and rows.dim() == 2 and rows.device == device):
        return None
    R, C = rows.shape
    if C > 1 and rows.stride(1) != 1:
        return None
    return rows.stride(0) if R > 1 else C


class _Graph(NamedTuple):
    """One capture: the graph, its static buffers (a chain on the in-place
    route has no static input), the launches it holds and the seconds its
    warm-up and capture took (a chain's graph: its capture's)."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: list
    seconds: float


class _Chain(NamedTuple):
    """A chain's buffers at one input shape: the rows on the device that
    every step stages from (or reads in place), the static input every step
    stages into (None on the in-place route), and m, the steps a
    replay."""

    src: torch.Tensor
    staged: torch.Tensor
    steps: int


class graphed:
    """``fn(stage(rows))`` on ``device``, ``fn`` in one CUDA graph per
    input shape (the module docstring); with ``in_place``, the in-place
    route's ``in_place(rows)`` launched directly in its place on the card.
    ``graphs`` maps each key to its capture; ``chains`` maps (rows, columns,
    steps) to a chain's graph of that many steps."""

    def __init__(self, fn: Callable, device, stage: Callable,
                 in_place: Callable | None = None):
        self.device = resolve_device(device)
        owner = getattr(fn, "__self__", None)
        # a bound method is named by its engine's class, not by the class
        # that defines it
        self.name = (f"{type(owner).__name__}.{fn.__name__}"
                     if owner is not None else fn.__qualname__)
        self._fn, self._stage = _weak(fn), _weak(stage)
        self._in_place = None if in_place is None else _weak(in_place)
        self.graphs: dict = {}
        self.chains: dict = {}
        self._chain_shapes: dict = {}
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

    @property
    def in_place(self) -> Callable | None:
        """The in-place route's call, or None where the callable stages."""
        return None if self._in_place is None else self._held(self._in_place)

    def release(self) -> None:
        """Drop every graph and their pool."""
        self.graphs.clear()
        self.chains.clear()
        self._chain_shapes.clear()
        self._pool = None

    def __call__(self, rows):
        if self.device.type != "cuda":
            return self.fn(self.stage(rows))
        key = tuple(np.shape(rows))
        if not key or key[0] == 0:
            return self.fn(self.stage(rows))
        if self._in_place is not None:
            return self._call_in_place(rows)
        if torch.cuda.is_current_stream_capturing():
            return self.fn(self.stage(rows))
        g = self.graphs.get(key)
        if g is None:
            with span("tahoe_capture"):
                return self._capture(key, rows)
        with span("tahoe_stage"):
            self.stage(rows, g.static_in)
        _TOTALS["staged_bytes"] += g.static_in.nbytes
        try:
            with span("tahoe_replay"):
                g.graph.replay()
            with span("tahoe_clone"):
                out = g.static_out.clone()
        except Exception as e:
            raise RuntimeError(f"{self.name}: the replay at rows, columns "
                               f"{key} failed: {e}") from e
        _TOTALS["replays"] += 1
        add_launches(g.launches)
        return out

    def _call_in_place(self, rows) -> torch.Tensor:
        """A call on the in-place route (the module docstring): no graph,
        the engine's own launch on the rows where they lie."""
        fn = self.in_place
        if row_stride(rows, self.device) is None:
            with span("tahoe_stage"):
                rows = torch.as_tensor(rows, dtype=torch.float32,
                                       device=self.device).contiguous()
            _TOTALS["staged_bytes"] += rows.nbytes
        else:
            _TOTALS["direct_calls"] += 1
        _TOTALS["replays"] += 1
        with span("tahoe_replay"):
            return fn(rows)

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
        self.graphs[key] = _captured(_Graph(graph, static_in, static_out,
                                            take_launches(before),
                                            time.perf_counter() - t0))
        return out

    def chain(self, rows, k: int) -> torch.Tensor:
        """k serialized calls on ``rows`` (the module docstring, "A chain
        of k predicts"): the last one's result."""
        if k < 1:
            raise ValueError(f"{self.name}: a chain takes k >= 1 calls, not {k}")
        key = tuple(np.shape(rows))
        if (self.device.type != "cuda" or torch.cuda.is_current_stream_capturing()
                or not key or key[0] == 0):
            for _ in range(k):  # each call inline
                out = self(rows)
            return out
        c = self._chain_shapes.get(key)
        if c is None:
            c = self._chain_shape(key, rows)
        else:
            c.src.copy_(torch.as_tensor(rows))
        runs = chain_runs(k, c.steps)
        # every capture first: a capture synchronizes the card
        graphs = {n: self._chain_graph(key, c, n) for n in set(runs)}
        for n in runs:
            g = graphs[n]
            try:
                g.graph.replay()
            except Exception as e:
                raise RuntimeError(
                    f"{self.name}: the replay of a chain at rows, columns "
                    f"{key}, m {n} failed: {e}") from e
            add_launches(g.launches)
        return graphs[runs[-1]].static_out.clone()

    def _chain_shape(self, key: tuple, rows) -> _Chain:
        """The first chain at ``key``: its buffers, a warm-up step on a side
        stream (uncounted), the one-step graph, and m from its replays."""
        in_place = self._in_place is not None
        src = torch.as_tensor(rows, dtype=torch.float32 if in_place else None,
                              device=self.device).clone(
            memory_format=torch.contiguous_format)
        staged = (None if in_place else
                  self.stage(src).clone(memory_format=torch.contiguous_format))
        first = _Chain(src, staged, 1)
        step = self._chain_step(first)
        before = launch_counts()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = step()
        current.wait_stream(side)
        out.record_stream(current)
        del out
        take_launches(before)
        one = self._chain_graph(key, first, 1)
        try:
            one.graph.replay()  # the first replay uploads the graph
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CHAIN_PROBE_REPLAYS):
                one.graph.replay()
            end.record()
            end.synchronize()
        except Exception as e:
            raise RuntimeError(f"{self.name}: the replay of a chain at rows, "
                               f"columns {key}, m 1 failed: {e}") from e
        steps = chain_steps(start.elapsed_time(end) * 1e-3 / CHAIN_PROBE_REPLAYS,
                            one.seconds)
        c = self._chain_shapes[key] = _Chain(src, staged, steps)
        return c

    def _chain_step(self, c: _Chain) -> Callable:
        """One step of a chain: the staging from ``c.src`` and ``fn``, or
        the in-place call on ``c.src``."""
        if self._in_place is not None:
            fn, src = self.in_place, c.src
            return lambda: fn(src)
        fn, stage = self.fn, self.stage
        return lambda: fn(stage(c.src, c.staged))

    def _chain_graph(self, key: tuple, c: _Chain, steps: int) -> _Graph:
        """The graph of ``steps`` chained calls at ``key``, captured on
        first use."""
        g = self.chains.get(chain_key(key, steps))
        if g is not None:
            return g
        step = self._chain_step(c)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with span("tahoe_capture"), torch.cuda.graph(graph, pool=self._pool):
                # the capture's own seconds: not those of the collection
                # and the synchronize that open every capture
                t0 = time.perf_counter()
                for _ in range(steps):
                    out = step()
        except Exception as e:
            take_launches(before)
            raise RuntimeError(f"{self.name}: the capture of a chain at rows, "
                               f"columns {key}, m {steps} failed: {e}") from e
        g = self.chains[chain_key(key, steps)] = _captured(_Graph(
            graph, c.staged, out, take_launches(before),
            time.perf_counter() - t0))
        return g


class GraphedEngine:
    """An engine whose ``predict`` and ``margins`` are graphed, as a JAX
    engine's are jitted. A subclass gives ``device``, the output
    transform's fields (``num_trees``, ``output``, ``global_bias``,
    ``threshold``), ``_stage(rows, out=None)`` (its step that reads the raw
    rows, ops/rows.py ``stage_rows``) and ``_margins_staged(x)`` (the
    margins of staged rows), and calls ``_graph()`` once it can stage; one
    whose kernel reads raw rows where they lie also gives
    ``_margins_in_place(x)``, x f32 rows with adjacent columns on the card,
    and takes the module docstring's in-place route."""

    def _graph(self) -> None:
        in_place = getattr(self, "_margins_in_place", None)
        self._predict = graphed(self._predict_staged, self.device, self._stage,
                                self._predict_in_place if in_place else None)
        self._margins = graphed(self._margins_staged, self.device, self._stage,
                                in_place)

    def _predict_in_place(self, x: torch.Tensor) -> torch.Tensor:
        return self._finish(self._margins_in_place(x))

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

    def predict_k(self, rows, k: int) -> torch.Tensor:
        """k serialized predicts on ``rows`` (``graphed.chain``, the JAX
        engines' ``predict_k``): the last one's result."""
        return self._predict.chain(rows, k)


def release(engine) -> None:
    """Free the graphs of every graphed method of ``engine`` (and of the
    engine it wraps, for a sharded engine)."""
    for value in vars(engine).values():
        if isinstance(value, graphed):
            value.release()
    inner = getattr(engine, "engine", None)
    if inner is not None and inner is not engine:
        release(inner)
