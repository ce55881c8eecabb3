"""CUDA graphs for the port's fixed-shape step callables (the role
``jax.jit`` and ``_quiet_donation_jit`` play in repro.core.hetero).

A :class:`StepGraph` owns one callable's static buffers: ``inputs`` (a
dict of tensors the body reads; the caller refreshes them in place, or
hands over buffers that already are them) and ``outputs`` (a dict of
tensors the body's results are copied into).  Both are allocated outside
any capture, so nothing a replay writes lives in a graph's memory pool,
and graphs that run on one stream can share one pool
(:class:`GraphPool`): the S-worker's graphs share one, each R-worker's
graphs share one of their own.

On the card the first call runs the body once on the pool's capture
stream (the warm-up: a real call, its launches counted), captures it
(``capture_error_mode="thread_local"``, so R-worker threads may
synchronise and allocate while another thread captures), and every later
call replays the graph on the caller's current stream.  On the CPU, and
on the card inside :func:`eager`, every call runs the body on the same
buffers.  A capture or replay that fails raises; nothing falls back to
the eager path.

Kernel counters (``kernels.paged_attention.LaunchCounter``) stay true:
a capture tallies the launches it records without applying them, and
every replay applies that tally.  With a span tracer on the pool
(``GraphPool.tracer``, set by ``attach_tracer``) every call counts
``graph.<side>.calls`` and every capture ``graph.<side>.captures`` on it
(``side`` "s" for the S-worker's pool, "r" for an R-worker's): on the
card the calls less the captures are the replays.

Python's cyclic garbage collector is held off while any thread captures
(:func:`_no_gc`): a collection runs in whatever thread allocates, and
collecting an old engine's graphs there calls ``cudaGraphExecDestroy``,
which a capturing thread may not call (the capture is invalidated).
Engines also drop their graphs when they close.

PyTorch registers every graph with the CUDA generator's state in
``capture_begin`` and unregisters it when the graph is destroyed, in a
set with no lock of its own; the S-worker and the R-workers capture
concurrently, so a lost entry makes that graph's destructor abort the
process ("The graph should be registered to the state").  Every
``capture_begin`` / ``capture_end`` here, and every place the port drops
graphs (:func:`dropping`), holds one process-wide lock.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels.paged_attention import tally

Tensors = Dict[str, torch.Tensor]

_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run every StepGraph's body eagerly, in every thread, while active
    (in the spirit of ``jax.disable_jit``): the eager comparison of the
    tests and ``chip_smoke.py``."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


class CaptureStats:
    """Captures made and seconds spent in them (warm-up included), over
    every thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.capture_count = 0
        self.capture_s = 0.0

    def add(self, seconds: float) -> None:
        with self._lock:
            self.capture_count += 1
            self.capture_s += seconds

    def reset(self) -> None:
        with self._lock:
            self.capture_count = 0
            self.capture_s = 0.0


captures = CaptureStats()

_gc_lock = threading.Lock()
_gc_holders = 0
_gc_was_enabled = False

# serialises PyTorch's graph registry (the generator state's set of graphs)
_registry_lock = threading.Lock()


@contextlib.contextmanager
def dropping():
    """Hold the graph registry while the body drops graphs (their
    destructors unregister them)."""
    with _registry_lock:
        yield


@contextlib.contextmanager
def _no_gc():
    """Hold the cyclic GC off while the body runs, in every thread: the
    first holder disables it, the last restores what it found."""
    global _gc_holders, _gc_was_enabled
    with _gc_lock:
        if _gc_holders == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holders += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holders -= 1
            if _gc_holders == 0 and _gc_was_enabled:
                gc.enable()


class GraphPool:
    """The memory pool and capture stream shared by graphs that replay on
    one stream.  ``stream`` None makes a capture stream of its own (the
    S-worker replays on the legacy default stream, on which nothing can
    be captured); an R-worker passes its own stream.  ``side`` names the
    pool's counters; ``tracer`` (an ``obs.SpanTracer`` or None) receives
    them."""

    def __init__(self, device, stream: Optional["torch.cuda.Stream"] = None,
                 side: str = "s"):
        self.device = torch.device(device)
        self.tracer = None
        self.calls_key = f"graph.{side}.calls"
        self.captures_key = f"graph.{side}.captures"
        self.handle = None
        self.stream = None
        if self.device.type == "cuda":
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = stream or torch.cuda.Stream(self.device)


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype
            and a.device == b.device)


class StepGraph:
    """``body(inputs) -> {name: tensor}`` replayed over static buffers.

    The body may also update its inputs and other long-lived tensors in
    place (an R-Part's KV, the drafter's position); every value the
    caller reads after a call is in ``outputs`` or in such a buffer."""

    def __init__(self, body: Callable[[Tensors], Tensors], inputs: Tensors,
                 pool: GraphPool):
        self.body = body
        self.inputs: Tensors = dict(inputs)
        self.outputs: Optional[Tensors] = None
        self.pool = pool
        self.counts: Dict = {}     # counter -> adds of one call
        self._graph = None

    def feed(self, values: Tensors) -> None:
        """Refresh static inputs from ``values``: a value that already is
        the static buffer costs nothing, any other is copied in (the first
        one of a name becomes a buffer of the graph's own)."""
        for k, v in values.items():
            buf = self.inputs.get(k)
            if buf is None:
                self.inputs[k] = v.to(self.pool.device, copy=True)
            elif not _same_buffer(buf, v):
                buf.copy_(v, non_blocking=True)

    def _write(self, out: Tensors) -> None:
        if self.outputs is None:
            self.outputs = {k: torch.empty_like(v) for k, v in out.items()}
        for k, v in out.items():
            self.outputs[k].copy_(v)

    def _apply_counts(self) -> None:
        for counter, n in self.counts.items():
            counter.add(n)

    def _run(self) -> Tensors:
        with tally() as counts:
            self._write(self.body(self.inputs))
        self.counts = counts
        self._apply_counts()
        return self.outputs

    def __call__(self) -> Tensors:
        tracer = self.pool.tracer
        if tracer is not None:
            tracer.count(self.pool.calls_key)
        if self.pool.device.type != "cuda" or _eager_depth:
            return self._run()
        if self._graph is None:
            if tracer is not None:
                tracer.count(self.pool.captures_key)
            self._capture()
        else:
            self._graph.replay()
            self._apply_counts()
        return self.outputs

    def _capture(self) -> None:
        t0 = time.perf_counter()
        side = self.pool.stream
        cur = torch.cuda.current_stream(self.pool.device)
        if side != cur:
            side.wait_stream(cur)
        with torch.cuda.stream(side), _no_gc():
            self._run()                 # the warm-up is this call's work
            graph = torch.cuda.CUDAGraph()
            with tally() as counts:
                with _registry_lock:
                    graph.capture_begin(pool=self.pool.handle,
                                        capture_error_mode="thread_local")
                try:
                    self._write(self.body(self.inputs))
                except BaseException:
                    with contextlib.suppress(RuntimeError), _registry_lock:
                        graph.capture_end()
                    raise
                with _registry_lock:
                    graph.capture_end()
        if side != cur:
            cur.wait_stream(side)
        self.counts = counts
        self._graph = graph
        captures.add(time.perf_counter() - t0)

    def static_bytes(self) -> int:
        """Bytes of the output buffers (inputs may be other graphs')."""
        return sum(t.numel() * t.element_size()
                   for t in (self.outputs or {}).values())
