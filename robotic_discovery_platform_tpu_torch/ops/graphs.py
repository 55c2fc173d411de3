"""CUDA graphs of the port's hot entries: the counterpart of the JAX
package's ``jax.jit`` dispatch, where each hot entry is one compiled
program per static shape.

On the card an entry runs as one captured graph per static shape: a
warm-up on the cache's own side stream builds every lazy device constant
(resize tables, knot tables, packed-row headers, derivative bands, the
deprojection ticket counter of that stream), then
``torch.cuda.graph`` captures one call, and every later call copies its
inputs into the graph's static inputs and replays it: one host launch for
the whole analysis where eager dispatch issues some hundred.

- :class:`GraphCache`: a function captured once per static key under a
  capture guard (``analysis/recompile.py``, the counterpart of
  ``trace_guard``). It owns each graph's static inputs and outputs. All
  graphs of one cache replay on the cache's stream under its lock, and
  share its memory pool: they are never replayed at the same time. The
  stream is the cache's own (:func:`dedicated_stream`), never one of
  PyTorch's pooled side streams, so a cache that warms up and captures
  while other caches replay (a hot reload's new generation under live
  traffic) never captures on a stream that a live cache uses, however
  many caches the process has made. A
  call's ``finish`` turns the outputs into its result (copies, a host
  read-back, a copy into the caller's buffer) under the lock, before the
  next call can replay. A key's first call answers with its warm-up's
  outputs and captures right after, so it runs the function once.
- :class:`StepGraph`: a step with no inputs (its state lives in device
  tensors), run eagerly once, then captured and replayed on the caller's
  stream: the trainer's scan epoch.

Captures run one at a time in the process, each with cuBLAS's cached
workspaces cleared before and after it, so the workspace a graph bakes
in lives in that graph's private memory pool and goes with it; a
profiler starts and stops only while no capture is in progress
(:func:`no_capture`, for ``utils/profiling.capture_profile``).

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
import ctypes
import functools
import gc
import queue
import threading
import time
import weakref
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


# -- streams of their own ------------------------------------------------------

#: CU_STREAM_NON_BLOCKING: no implicit synchronisation with the legacy
#: default stream (PyTorch's pooled side streams are made the same way)
_NON_BLOCKING = 1
_driver_lock = threading.Lock()
_driver = None  # guarded_by: _driver_lock
_free_lock = threading.Lock()
#: device index -> handles of dedicated streams whose owner is gone
_free_streams: dict[int, queue.SimpleQueue] = {}  # guarded_by: _free_lock
#: device index -> how many dedicated streams the port has made there
_made_streams: dict[int, int] = {}  # guarded_by: _free_lock


def _cuda_driver() -> ctypes.CDLL:
    """The CUDA driver library with the argument types of the calls
    used here (PyTorch has loaded and initialised it already)."""
    global _driver
    with _driver_lock:
        if _driver is None:
            lib = ctypes.CDLL("libcuda.so.1")
            ptr = ctypes.POINTER(ctypes.c_void_p)
            for name, args in (
                    ("cuDeviceGet", (ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_int)),
                    ("cuDevicePrimaryCtxRetain", (ptr, ctypes.c_int)),
                    ("cuDevicePrimaryCtxRelease_v2", (ctypes.c_int,)),
                    ("cuCtxPushCurrent_v2", (ctypes.c_void_p,)),
                    ("cuCtxPopCurrent_v2", (ptr,)),
                    ("cuStreamCreate", (ptr, ctypes.c_uint))):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            _driver = lib
        return _driver


def _check(result: int, call: str) -> None:
    if result != 0:
        raise RuntimeError(f"{call} failed with CUDA driver error {result}")


def _new_stream(index: int) -> int:
    """A new non-blocking stream in device ``index``'s primary context
    (the one PyTorch uses), made by the CUDA driver: its handle."""
    cu = _cuda_driver()
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    _check(cu.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
    _check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev.value),
           "cuDevicePrimaryCtxRetain")
    try:
        _check(cu.cuCtxPushCurrent_v2(ctx), "cuCtxPushCurrent")
        try:
            handle = ctypes.c_void_p()
            _check(cu.cuStreamCreate(ctypes.byref(handle), _NON_BLOCKING),
                   "cuStreamCreate")
            return handle.value
        finally:
            _check(cu.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p())),
                   "cuCtxPopCurrent")
    finally:
        cu.cuDevicePrimaryCtxRelease_v2(dev.value)


def dedicated_stream(device: torch.device, owner: Any) -> torch.cuda.Stream:
    """A non-blocking CUDA stream on ``device`` that no other live owner
    has, held until ``owner`` is collected: not one of PyTorch's pooled
    side streams (32 per device and priority, handed out round robin, so
    the 33rd draw shares a stream with the 1st), but one of the port's
    own, made by the CUDA driver. A stream whose owner is gone is handed
    to the next owner (its earlier work is ordered before the new
    owner's on the stream itself), so the port makes as many streams as
    owners were ever alive at once, and the per-stream state others keep
    (the deprojection's ticket counter) stays bounded."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    with _free_lock:
        free = _free_streams.setdefault(index, queue.SimpleQueue())
    try:
        handle = free.get_nowait()
    except queue.Empty:
        handle = _new_stream(index)
        with _free_lock:
            _made_streams[index] = _made_streams.get(index, 0) + 1
    # SimpleQueue.put is safe wherever the collector runs a finalizer
    weakref.finalize(owner, free.put, handle)
    return torch.cuda.ExternalStream(handle, device=torch.device("cuda",
                                                                 index))


def streams_made(index: int) -> int:
    """How many streams :func:`dedicated_stream` has made on device
    ``index`` in this process: each is handed on, never destroyed, so the
    count grows only while more owners are alive at once than ever
    before."""
    with _free_lock:
        return _made_streams.get(index, 0)


#: one capture at a time in the process: each clears cuBLAS's cached
#: workspaces, which must not happen during another capture
_capture_lock = threading.Lock()


def _clear_cublas_workspaces() -> None:
    """Drop cuBLAS's cached per-(handle, stream) workspaces, so the
    capture that follows allocates its own inside its graph's private
    pool (and frees it there) instead of baking in one that outlives it:
    without this every new capture stream keeps a 32 MiB workspace for
    the life of the process (PyTorch's CUDA graph trees do the same). A
    build of PyTorch without CUDA has no workspaces to drop."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def release_workspaces() -> None:
    """Drop cuBLAS's cached per-(handle, stream) workspaces while no
    capture is in progress: an eager run on a stream of its own (a
    candidate's warm-up, a reference analyzer) or on a thread that has
    ended (a training run) keeps one for the life of the process
    otherwise. The next cuBLAS call on a stream allocates its workspace
    again."""
    with _capture_lock:
        _clear_cublas_workspaces()


@contextlib.contextmanager
def _no_collection():
    """No garbage collection while the block runs: a collection during a
    capture could destroy a dead generation's CUDA graph on the capturing
    thread, a call that invalidates the capture. Objects that die by
    reference count on other threads destroy theirs there, which a
    thread-local capture allows; cycles wait for the next collection."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@contextlib.contextmanager
def no_capture():
    """The block runs while no CUDA graph capture is in progress in the
    process: it waits for the capture in progress to end and holds new
    ones back until it exits (a profiler's start and stop)."""
    with _capture_lock:
        yield


#: one entry per GraphCache or captured StepGraph on the card that has
#: died, its graphs destroyed (appended by the finalizer: list.append is
#: safe wherever the collector runs it)
_dead_caches: list = []
_release_lock = threading.Lock()
_released = 0  # guarded_by: _release_lock


def _cache_died(graphs: dict) -> None:
    """A cache's finalizer: destroy its graphs at once, so their private
    memory pool has no user left, and count the death."""
    graphs.clear()
    _dead_caches.append(None)


def release_dead_pools() -> bool:
    """Return the cached memory of the graph pools of caches (and step
    graphs) that died since the last call to the card
    (``torch.cuda.empty_cache``, which
    frees a private pool only once its graphs are gone, and otherwise
    waits for the next capture). A hot reload's poller calls it, so a
    swapped-out generation's graphs do not keep their memory reserved
    once its grace period has ended. Runs while no capture is in
    progress; returns whether it released anything."""
    global _released
    with _release_lock:
        dead = len(_dead_caches)
        if dead == _released:
            return False
        with _capture_lock:
            torch.cuda.empty_cache()
        _released = dead
        return True


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
                # are counted in ``counts``. The caching allocator sends
                # the allocations made on the capture stream (and only
                # those) to ``pool``: other threads allocate on their own
                # streams, outside the capture.
                with _capture_lock, _no_collection():
                    _clear_cublas_workspaces()
                    try:
                        with torch.cuda.graph(
                                self.graph, pool=pool, stream=stream,
                                capture_error_mode="thread_local"):
                            self.outputs = fn()
                    finally:
                        _clear_cublas_workspaces()
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


#: per thread: when its last cache call had its inputs in place
_inputs_ready = threading.local()


def inputs_ready_ns() -> int | None:
    """``time.monotonic_ns()`` when this thread's last :class:`GraphCache`
    call had enqueued the copies of its inputs into the graph's static
    inputs (on the CPU: had its inputs as tensors), None before any call:
    where a batch dispatch's host-to-device stage ends and its launch
    begins, on the host's clock."""
    return getattr(_inputs_ready, "ns", None)


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
    pinned memory, waited for on an event, as a host array (the tensor's
    own numpy view on the CPU). Neither the copy nor the wait is a call
    that ``torch.cuda.set_sync_debug_mode`` reports, so the transfer
    guard (``utils/transferguard``) lets it pass."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    done.synchronize()
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

    On the card the cache's stream is its own (:func:`dedicated_stream`,
    made at its first call): ``stream_handle``. Once the cache is
    collected its graphs go at once and :func:`release_dead_pools` can
    return their pool's memory.
    """

    def __init__(self, name: str, budget: int | None,
                 device: torch.device):
        self.guard = recompile.capture_guard(name, budget)
        self.device = device
        self.graphs: dict = {}  # key -> (static inputs, Capture)
        self._lock = threading.Lock()
        self._stream = None
        self._pool = None

    @property
    def stream_handle(self) -> int | None:
        """The handle of the stream every warm-up, capture and replay of
        this cache runs on (None before the first call on the card)."""
        stream = self._stream
        return None if stream is None else stream.cuda_stream

    def __call__(self, fn: Callable, *inputs, static: tuple = (),
                 finish: Callable):
        key = (static, tuple(_spec(x) for x in inputs))
        if self.device.type != "cuda":
            if key not in self.graphs:
                self.guard.count(signature(inputs))
                self.graphs[key] = None
            tensors = [_host_tensor(x) for x in inputs]
            _inputs_ready.ns = time.monotonic_ns()
            return finish(fn(*tensors))
        with self._lock:
            if self._stream is None:
                self._stream = dedicated_stream(self.device, owner=self)
                self._pool = torch.cuda.graph_pool_handle()
                weakref.finalize(self, _cache_died, self.graphs)
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
                    _inputs_ready.ns = time.monotonic_ns()
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
        _inputs_ready.ns = time.monotonic_ns()
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
    on ``guard`` (on the CPU, the first call). Once the step graph is
    collected its graph goes, and :func:`release_dead_pools` returns its
    pool's memory (a process that trains and then serves keeps no train
    step reserved)."""

    def __init__(self, fn: Callable[[], Any], guard: recompile.CaptureGuard,
                 device: torch.device):
        self.fn = fn
        self.guard = guard
        self.device = device
        # the Capture, held here only: the finalizer clears this dict, so
        # the graph is gone before its death is counted
        self._captured: dict = {}
        self._stream = None

    @property
    def capture(self) -> Capture | None:
        return self._captured.get("step")

    @property
    def stage(self) -> str:
        """What the next call does: ``"warm-up"`` (the eager first step),
        ``"capture"`` or ``"replay"`` (the CPU: ``"eager"`` after the
        first)."""
        if self._stream is None:
            return "warm-up"
        if self.device.type != "cuda":
            return "eager"
        return "replay" if self.capture is not None else "capture"

    def __call__(self) -> None:
        if self.device.type != "cuda":
            if self._stream is None:
                self.guard.count("()")
                self._stream = "eager"
            self.fn()
            return
        capture = self.capture
        if capture is not None:
            capture.replay()
            return
        caller = torch.cuda.current_stream(self.device)
        first = self._stream is None
        if first:
            self._stream = dedicated_stream(self.device, owner=self)
        self._stream.wait_stream(caller)
        if first:
            with torch.cuda.stream(self._stream):
                self.fn()
        else:
            self.guard.count("()")
            self._captured["step"] = Capture(self.fn, self._stream)
            # collected, the step's graph goes at once, and
            # release_dead_pools returns its pool as a dead cache's
            weakref.finalize(self, _cache_died, self._captured)
        caller.wait_stream(self._stream)
        if not first:
            self.capture.replay()
