"""CUDA graphs of the port's hot entries: the counterpart of the JAX
package's ``jax.jit`` dispatch, where each hot entry is one compiled
program per static shape.

On the card an entry runs as one captured graph per static shape: a
warm-up on the cache's own side stream builds every lazy device constant
(resize tables, knot tables, packed-row headers, derivative bands, the
deprojection ticket counter of that stream, cuBLAS workspaces), then
``torch.cuda.graph`` captures one call, and every later call copies its
inputs into the graph's static inputs and replays it: one host launch for
the whole analysis where eager dispatch issues some hundred.

- :class:`GraphCache`: a function captured once per static key under a
  capture guard (``analysis/recompile.py``, the counterpart of
  ``trace_guard``). It owns each graph's static inputs and outputs. All
  graphs of one cache replay on the cache's stream under its lock, and
  share its memory pool: they are never replayed at the same time. A
  call's ``finish`` turns the outputs into its result (copies, a host
  read-back, a copy into the caller's buffer) under the lock, before the
  next call can replay. A key's first call answers with its warm-up's
  outputs and captures right after, so it runs the function once.
- :class:`StepGraph`: a step with no inputs (its state lives in device
  tensors), run eagerly once, then captured and replayed on the caller's
  stream: the trainer's scan epoch.

Each kernel wrapper counts its launches in ``launches`` through
:func:`count_launch`, which also counts the launches onto a stream being
captured for that capture. A capture takes them back from the counts
(nothing ran) and every replay adds them again, so a count means the same
with and without graphs, and launches onto other streams during a capture
(other threads' work) stay counted as run. A capture or replay that fails
raises; nothing falls back to eager dispatch on the card. On a CPU device
the function runs eagerly (the tests), and a new key still counts as one
capture.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.analysis import recompile


def launch_counters() -> tuple:
    """Every kernel wrapper of the port: each counts its launches in
    ``launches``."""
    from robotic_discovery_platform_tpu_torch.ops import (
        conv,
        decode,
        geometry_kernels,
        pack,
    )

    return (conv.conv3x3_bn_relu, conv.conv1x1, conv.conv_transpose2x2,
            conv.conv3x3_grad_weights, geometry_kernels.deproject_edge_stats,
            geometry_kernels.bspline_design,
            geometry_kernels.bspline_curvature, pack.bitpack_mask,
            decode.dequant_idct)


#: capture stream's handle -> the wrappers' launches recorded into it
_recording: dict = {}


def _current_stream_key() -> int:
    """The handle of the current device's current stream."""
    return torch.cuda.current_stream().cuda_stream


def count_launch(wrapper: Callable) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.launches``,
    and, when it goes onto a stream that :func:`recording_launches` is
    recording, in that stream's record."""
    wrapper.launches += 1
    if _recording:
        counts = _recording.get(_current_stream_key())
        if counts is not None:
            counts[wrapper] = counts.get(wrapper, 0) + 1


@contextlib.contextmanager
def recording_launches(stream_key: int):
    """The kernel launches onto the stream ``stream_key`` inside the
    block, by wrapper: a dict that :func:`count_launch` fills. From any
    thread (a captured backward runs on autograd's own thread, on the
    forward's stream); launches onto other streams stay out."""
    counts = _recording[stream_key] = {}
    try:
        yield counts
    finally:
        del _recording[stream_key]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every tensor of a tensor, tuple or NamedTuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        leaves = [tree_map(fn, t) for t in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(
            leaves)
    return tree


def signature(inputs) -> str:
    """The static shapes of ``inputs``, as the guard records them."""
    return "(" + ", ".join(f"{str(getattr(a, 'dtype', '?')).split('.')[-1]}"
                           f"{list(np.shape(a))}" for a in inputs) + ")"


class Capture:
    """One ``torch.cuda.graph`` capture of ``fn()`` on ``stream``, whose
    lazy state ``fn`` has already built (a warm-up ran it on that stream).
    ``outputs`` are the captured call's results; :meth:`replay` reruns
    the graph on the current stream and adds each wrapper's launches of
    one call to its count."""

    def __init__(self, fn: Callable[[], Any], stream: torch.cuda.Stream,
                 pool=None):
        self.graph = torch.cuda.CUDAGraph()
        with recording_launches(stream.cuda_stream) as counts:
            try:
                # thread_local: handler and dispatcher threads may use the
                # card while this thread captures; only this thread's calls
                # are checked, and only launches onto the capture stream
                # are counted in ``counts``
                with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.outputs = fn()
            finally:
                # the wrappers counted launches that were only recorded
                for f, d in counts.items():
                    f.launches -= d
        self.launches = list(counts.items())

    def replay(self) -> Any:
        self.graph.replay()
        for f, d in self.launches:
            f.launches += d
        return self.outputs


def _to_static(static: torch.Tensor, x) -> None:
    """Copy a caller's input into a static input on the current stream: a
    device or pinned tensor directly, host data (numpy, read-only wire
    views included, or a pageable tensor) through a pinned buffer from the
    caching host allocator, so the copy is asynchronous and the buffer is
    reused only once the stream has passed it."""
    if isinstance(x, torch.Tensor) and (x.is_cuda or x.is_pinned()):
        static.copy_(x, non_blocking=True)
        return
    host = torch.empty(static.shape, dtype=static.dtype, pin_memory=True)
    if isinstance(x, torch.Tensor):
        host.copy_(x)
    else:
        np.copyto(host.numpy(), np.asarray(x), casting="no")
    static.copy_(host, non_blocking=True)


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def _spec(x) -> tuple:
    """(shape, torch dtype) of a tensor or numpy input: its static key."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    x = np.asarray(x)
    return x.shape, _TORCH_DTYPES[x.dtype]


def _host_tensor(x) -> torch.Tensor:
    """A caller's input as a CPU tensor (a copy of numpy input: wire views
    are read-only)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def _in_use_on(t: torch.Tensor, stream: torch.cuda.Stream) -> None:
    """Mark a device tensor in use on ``stream`` (the caller's), so the
    allocator keeps its memory until that stream is done with it."""
    if t.is_cuda:
        t.record_stream(stream)


def clone(out: Any) -> Any:
    """A ``finish``: fresh copies of every output tensor."""
    return tree_map(torch.Tensor.clone, out)


def read_back(t: torch.Tensor) -> np.ndarray:
    """A ``finish``: one device-to-host copy of a tensor output into
    pinned memory, waited for, as a host array (the tensor's own numpy
    view on the CPU)."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


class GraphCache:
    """``fn(*inputs)`` captured once per static key on ``device``.

    ``cache(fn, *inputs, static=(), finish=f)`` returns ``f`` of ``fn``'s
    outputs for ``inputs``. On the card the outputs are the key's graph's
    static outputs after a replay (on a key's first call, its warm-up's),
    and ``f`` runs on the cache's stream under its lock, before the next
    call can replay: it copies them or reads them back. Device tensors it
    returns are marked in use on the caller's stream, which waits for the
    cache's. On the CPU ``f`` takes ``fn``'s eager result. ``inputs`` are
    tensors (on the device, pinned or pageable) or numpy arrays; the key
    is their shapes and dtypes and ``static`` (what else ``fn`` bakes
    in). ``fn`` runs only to warm up and capture a new key, whose first
    call counts one capture on ``guard``.
    """

    def __init__(self, name: str, budget: int | None,
                 device: torch.device):
        self.guard = recompile.capture_guard(name, budget)
        self.device = device
        self.graphs: dict = {}  # key -> (static inputs, Capture)
        self._lock = threading.Lock()
        self._stream = None
        self._pool = None

    def __call__(self, fn: Callable, *inputs, static: tuple = (),
                 finish: Callable):
        key = (static, tuple(_spec(x) for x in inputs))
        if self.device.type != "cuda":
            if key not in self.graphs:
                self.guard.count(signature(inputs))
                self.graphs[key] = None
            return finish(fn(*(_host_tensor(x) for x in inputs)))
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            caller = torch.cuda.current_stream(self.device)
            stream = self._stream
            # inputs made on the caller's stream are ready; and a caller
            # reading the outputs on its stream waits for the replay
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                entry = self.graphs.get(key)
                if entry is None:
                    out, self.graphs[key] = self._capture(fn, inputs)
                else:
                    static_in, cap = entry
                    for s, x in zip(static_in, inputs):
                        _to_static(s, x)
                    out = cap.replay()
                out = finish(out)
                tree_map(functools.partial(_in_use_on, stream=caller), out)
            caller.wait_stream(stream)
            return out

    def _capture(self, fn: Callable, inputs) -> tuple:
        """A new key on the cache's stream (the current one): static
        inputs holding the call's inputs, one warm-up call on them (its
        outputs answer the call), then the capture; returns (outputs,
        (static inputs, Capture))."""
        self.guard.count(signature(inputs))
        static = []
        for x in inputs:
            shape, dtype = _spec(x)
            s = torch.empty(shape, dtype=dtype, device=self.device)
            _to_static(s, x)
            static.append(s)
        out = fn(*static)
        return out, (static, Capture(lambda: fn(*static), self._stream,
                                     self._pool))

    def eager(self, fn: Callable, *inputs):
        """``fn`` on ``inputs`` moved to the device, without a graph: the
        reference a replay is held against on the card."""
        return fn(*(_host_tensor(x).to(self.device) for x in inputs))


class StepGraph:
    """A step whose inputs and outputs live in device tensors that it
    reads and updates in place, replayed on the caller's stream.

    The first call runs ``fn`` eagerly on a side stream (a real step: it
    builds the lazy state, the optimizer's moments included), the second
    captures it on that stream and replays it, every later call replays.
    On a CPU device every call runs ``fn`` eagerly. The capture counts one
    on ``guard`` (on the CPU, the first call)."""

    def __init__(self, fn: Callable[[], Any], guard: recompile.CaptureGuard,
                 device: torch.device):
        self.fn = fn
        self.guard = guard
        self.device = device
        self.capture: Capture | None = None
        self._stream = None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            if self._stream is None:
                self.guard.count("()")
                self._stream = "eager"
            self.fn()
            return
        if self.capture is not None:
            self.capture.replay()
            return
        caller = torch.cuda.current_stream(self.device)
        first = self._stream is None
        if first:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(caller)
        if first:
            with torch.cuda.stream(self._stream):
                self.fn()
        else:
            self.guard.count("()")
            self.capture = Capture(self.fn, self._stream)
        caller.wait_stream(self._stream)
        if not first:
            self.capture.replay()
