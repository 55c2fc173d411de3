"""Cross-stream micro-batching for the servicer, pipelined, on one device
(the port of the JAX package's ``serving/batching.py`` ``BatchDispatcher``).

Stream handler threads :meth:`BatchDispatcher.submit` one frame each and
block until its result is back. Three stages keep the card busy while the
host stages and fans out:

1. **Collector** -- drains the deadline-aware backlog
   (``serving/admission.py``), waits at most ``window_ms`` for co-arriving
   frames, groups them by camera geometry, pads each group to the next
   power-of-two bucket in a pooled host staging buffer (pinned, so the
   host-to-device copy is asynchronous), and on a dedicated CUDA stream
   stages the batch (``ops/pipeline.stage_batch``), enqueues the batched
   analyzer (``ops/pipeline.make_batch_analyzer(pack=True)``) and the one
   device-to-host copy of its ``[B, P]`` packed payload into a pooled
   pinned landing buffer, and records an event. It never waits on the
   device.
2. **In-flight window** -- at most ``max_inflight`` dispatches are
   launched but not completed (1 = serial: launch N+1 only after N's
   result reached the host; 2 = batch N+1 stages and computes while N's
   result comes back).
3. **Completer** -- waits on each dispatch's event in launch order, hands
   each frame a :class:`~serving.egress.PackedResult` row view of the
   landing buffer (refcounted: the last ``release`` returns the buffer to
   the pool), and returns the staging buffers, whose copies the event
   covers, to their pool.

Resilience, as in the JAX package: the backlog is bounded
(:class:`~serving.admission.OverloadedError` at ``max_backlog``), every
submit carries a deadline (:class:`DeadlineExceeded`), frames whose
deadline is already unmeetable are shed before staging, a failing
dispatch fails only its own frames, a watchdog restarts a dead collector
or completer after failing the frames either held, and :meth:`stop`
leaves no submitter blocked.

On ``device="cpu"`` (the tests) there is no stream and no event: the
analyzer runs in the collector thread, and the completer copies its
result into the landing buffer.

Not ported (each raises ``NotImplementedError``; ROADMAP queue 1 item 16):
the multi-device ``DeviceRouter``, the zoo's ``bind_model`` and placer,
and the coefficient lane's ``submit_coef`` (queue 1 item 10).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.ops import pipeline as pipeline_lib
from robotic_discovery_platform_tpu_torch.serving.admission import (
    DeadlineQueue,
    OverloadedError,
    ServiceTimeEstimator,
)
from robotic_discovery_platform_tpu_torch.serving.egress import PackedResult
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

__all__ = ["BatchDispatcher", "DeadlineExceeded", "OverloadedError"]


class DeadlineExceeded(TimeoutError):
    """A frame's result was not back within its submit deadline."""


@dataclass(eq=False)
class _Pending:
    frame_rgb: np.ndarray  # [H, W, 3] uint8
    depth: np.ndarray  # [H, W] uint16 (z16)
    intrinsics: np.ndarray  # [3, 3] float32
    depth_scale: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None
    # absolute monotonic deadline; admission orders evictions by the
    # headroom left against it and sheds the frame once it is unmeetable
    deadline_t: float | None = None
    # set by a submitter whose wait timed out: nobody reads the result,
    # so the collector does not stage device work for the frame
    abandoned: bool = False


class _BucketBuffers:
    """One pooled set of host staging tensors for a (bucket, geometry)
    key, filled row by row in place. Pinned on a CUDA device, so the
    host-to-device copies run asynchronously on the dispatch stream; a
    set goes back to the pool only after the dispatch's event has passed,
    so a refill never races a copy still reading it. Depth rides as the
    z16 bit pattern in int16 (the analyzer widens it on the device)."""

    __slots__ = ("key", "frames", "depths", "intr", "scales", "_np")

    def __init__(self, key: tuple, b: int, h: int, w: int, pin: bool):
        self.key = key
        self.frames = torch.empty((b, h, w, 3), dtype=torch.uint8,
                                  pin_memory=pin)
        self.depths = torch.empty((b, h, w), dtype=torch.int16,
                                  pin_memory=pin)
        self.intr = torch.empty((b, 3, 3), dtype=torch.float32,
                                pin_memory=pin)
        self.scales = torch.empty((b,), dtype=torch.float32, pin_memory=pin)
        self._np = tuple(t.numpy() for t in (self.frames, self.depths,
                                             self.intr, self.scales))

    def fill(self, i: int, p: _Pending) -> None:
        """Write frame ``p`` into row ``i`` (the one host copy a frame
        pays between the wire and the device)."""
        frames, depths, intr, scales = self._np
        frames[i] = p.frame_rgb
        depths[i] = np.asarray(p.depth, np.uint16).view(np.int16)
        intr[i] = p.intrinsics
        scales[i] = p.depth_scale

    def pad(self, n: int) -> None:
        """Replicate row 0 into the padding rows past ``n``."""
        if n < self._np[0].shape[0]:
            for a in self._np:
                a[n:] = a[0]


class _EgressStaging:
    """One dispatch's pooled landing buffer, refcounted over its frames:
    the last :meth:`release_one` returns it to the pool."""

    __slots__ = ("buf", "_remaining", "_lock", "_pool_put")

    def __init__(self, buf: torch.Tensor, n: int,
                 pool_put: Callable[[torch.Tensor], None]):
        self.buf = buf
        self._remaining = n  # guarded_by: _lock
        self._lock = threading.Lock()
        self._pool_put = pool_put

    def release_one(self) -> None:
        with self._lock:
            self._remaining -= 1
            last = self._remaining == 0
        if last:
            self._pool_put(self.buf)


@dataclass(eq=False)
class _Dispatch:
    """A launched-but-not-completed batch riding the completion queue."""

    group: list[_Pending]
    out: Any  # the analyzer's result (read by the completer on the CPU)
    host: torch.Tensor | None  # the landing buffer the D2H copy fills
    event: Any  # torch.cuda.Event after the D2H copy (None on the CPU)
    bufs: _BucketBuffers | None
    # the in-flight slot this dispatch holds, released by the completer;
    # carried per dispatch so a watchdog reset never double-frees
    slot: threading.Semaphore
    launch_t: float
    bucket: int
    staged_t: float  # when host staging began (seconds)


def _intrinsics_f32(intrinsics) -> np.ndarray:
    if (isinstance(intrinsics, np.ndarray) and intrinsics.dtype == np.float32
            and intrinsics.shape == (3, 3)):
        return intrinsics
    return np.asarray(intrinsics, np.float32)


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def _group_key(p: _Pending) -> tuple:
    """Frames batch only with co-arrivals of the same camera geometry."""
    return tuple(p.frame_rgb.shape[:2])


class BatchDispatcher:
    """Coalesce concurrent frame analyses into pipelined batched
    dispatches on one device.

    Args:
        analyze_batch: ``(frames [B,H,W,3] u8, depths [B,H,W] int16 z16
            pattern, intrinsics [B,3,3] f32, scales [B] f32) -> [B, P]
            uint8`` packed payload (``ops/pipeline.make_batch_analyzer(
            pack=True)`` around the model), called with staged tensors on
            ``device`` inside the dispatch stream; it must not wait on its
            own result.
        window_ms: how long the first frame of a batch waits for
            co-arriving frames.
        max_batch: frames per dispatch at most.
        max_backlog: queued frames before submits shed
            (:class:`OverloadedError`).
        submit_timeout_s: default per-submit deadline.
        watchdog_interval_s: how often the watchdog checks the collector
            and completer (<= 0: no watchdog).
        max_inflight: dispatches launched but not completed at once.
        admission: "deadline" or "fifo" (``serving/admission.py``).
        device: where the analyzer runs ("cuda" by default).
    """

    def __init__(self, analyze_batch: Callable, window_ms: float = 2.0,
                 max_batch: int = 8, max_backlog: int = 64,
                 submit_timeout_s: float = 30.0,
                 watchdog_interval_s: float = 1.0, max_inflight: int = 2,
                 admission: str = "deadline",
                 device: str | torch.device = "cuda",
                 router=None, placer=None):
        if router is not None:
            raise NotImplementedError(
                "DeviceRouter (multi-device dispatch) is ROADMAP queue 1 "
                "item 16")
        if placer is not None:
            raise NotImplementedError(
                "the zoo's placer is ROADMAP queue 1 item 16")
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # the dispatch stream: staging, the analyzer and the D2H copy of
        # every dispatch run on it, in launch order
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)
        self._analyze = analyze_batch
        self._window_s = window_ms / 1e3
        self._max_batch = max(1, int(max_batch))
        self._submit_timeout_s = submit_timeout_s
        self._max_inflight = max(1, int(max_inflight))
        #: best-case per-frame service time (staging -> result on the host)
        self.service_estimate = ServiceTimeEstimator()
        # consecutive stale sheds with no completion between: after 8 the
        # next frame rides anyway, so the estimate can refresh
        self._sheds_since_complete = 0  # guarded_by: _inflight_lock
        self._q = DeadlineQueue(max_backlog, policy=admission,
                                on_evict=self._on_evicted)
        self._cq: queue.Queue[_Dispatch | None] = queue.Queue()
        self._slots = threading.Semaphore(self._max_inflight)
        self._inflight_lock = threading.Lock()
        self._inflight = 0  # guarded_by: _inflight_lock
        #: most dispatches in flight at once (never above max_inflight)
        self.inflight_high_water = 0  # guarded_by: _inflight_lock
        #: frames per launched dispatch (padding excluded) -> dispatches
        self.dispatch_sizes: collections.Counter = collections.Counter()  # guarded_by: _inflight_lock
        #: seconds completing dispatches overlapped the next launch (0.0
        #: in serial mode); written only by the completer
        self.overlap_s_total = 0.0
        self._last_done_t = 0.0
        # pooled staging and landing buffers, free lists only: at most one
        # set per possible in-flight dispatch plus the one being staged
        self._pool: dict[tuple, list[_BucketBuffers]] = {}  # guarded_by: _pool_lock
        self._egress_pool: dict[tuple, list[torch.Tensor]] = {}  # guarded_by: _pool_lock
        self._pool_cap = self._max_inflight + 1
        self._pool_lock = threading.Lock()
        self._stopped = threading.Event()
        self._submit_lock = threading.Lock()
        # every submitted frame not completed yet, wherever it is: what
        # the watchdog and stop() fail when a stage is gone
        self._pending: set[_Pending] = set()  # guarded_by: _pending_lock
        self._pending_lock = threading.Lock()
        self.collector_restarts = 0
        self.completer_restarts = 0
        self._completer = self._start(self._complete_loop, "batch-completer")
        self._thread = self._start(self._loop, "batch-dispatcher")
        self._watchdog = None
        if watchdog_interval_s > 0:
            self._watchdog = self._start(
                lambda: self._watch(watchdog_interval_s),
                "batch-dispatcher-watchdog")

    @staticmethod
    def _start(target: Callable, name: str) -> threading.Thread:
        t = threading.Thread(target=target, name=name, daemon=True)
        t.start()
        return t

    # -- caller side ----------------------------------------------------------

    def submit(self, frame_rgb, depth, intrinsics, depth_scale,
               timeout_s: float | None = None) -> PackedResult:
        """Block until this frame's result is back; returns its
        :class:`PackedResult` row (call ``release`` when done with it).

        Raises :class:`OverloadedError` at the backlog cap (or when a
        newer frame with more deadline headroom evicted this one) and
        :class:`DeadlineExceeded` when the result misses the deadline
        (``timeout_s`` when given and tighter, else ``submit_timeout_s``).
        """
        frame_rgb = np.asarray(frame_rgb)
        depth = np.asarray(depth)
        if frame_rgb.shape[:2] != depth.shape or frame_rgb.shape[2:] != (3,):
            raise ValueError(
                f"frame {frame_rgb.shape} and depth {depth.shape} disagree")
        timeout = self._submit_timeout_s
        if timeout_s is not None:
            timeout = min(timeout, timeout_s)
        p = _Pending(frame_rgb, depth, _intrinsics_f32(intrinsics),
                     float(depth_scale),
                     deadline_t=time.monotonic() + timeout)
        # enqueue under the lock stop() drains under: a submit lands before
        # the drain (and is failed by it) or sees stopped and raises
        with self._submit_lock:
            if self._stopped.is_set():
                raise RuntimeError("dispatcher stopped")
            with self._pending_lock:
                self._pending.add(p)
            try:
                self._q.put(p, margin_s=self.service_estimate.s_for(""))
            except OverloadedError:
                with self._pending_lock:
                    self._pending.discard(p)
                raise
        try:
            if not p.done.wait(timeout):
                p.abandoned = True
                raise DeadlineExceeded(
                    f"batched analysis not ready within {timeout:.2f}s "
                    "(per-submit deadline)")
        finally:
            with self._pending_lock:
                self._pending.discard(p)
        if p.error is not None:
            raise p.error
        return p.result

    def submit_coef(self, *args, **kwargs):
        raise NotImplementedError(
            "the coefficient lane (submit_coef) is ROADMAP queue 1 item 10")

    def bind_model(self, *args, **kwargs):
        raise NotImplementedError(
            "the zoo's bind_model is ROADMAP queue 1 item 16")

    def _on_evicted(self, p: _Pending) -> None:
        """DeadlineQueue eviction callback (runs under the queue lock)."""
        p.error = OverloadedError(
            "frame evicted at the backlog cap: least remaining deadline "
            "headroom; shedding load")
        p.done.set()
        with self._pending_lock:
            self._pending.discard(p)

    def stop(self) -> None:
        """Idempotent. Dispatches already launched drain with their real
        results; frames still queued get a 'dispatcher stopped' error. No
        submitter is left blocked."""
        with self._submit_lock:
            self._stopped.set()
            self._q.put(None)
        self._thread.join(timeout=5)
        self._cq.put(None)
        self._completer.join(timeout=5)
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.done.is_set():
                item.error = RuntimeError("dispatcher stopped")
                item.done.set()
        self._drain_completions()
        self._fail_pending(RuntimeError("dispatcher stopped"))

    def _drain_completions(self) -> None:
        """Fail what the completion queue still holds; its buffers go back
        once the device has passed their copies."""
        while True:
            try:
                d = self._cq.get_nowait()
            except queue.Empty:
                break
            if d is None:
                continue
            if d.event is not None:
                d.event.synchronize()
            self._pool_put(d.bufs)
            self._fail_group(d.group, RuntimeError("dispatcher stopped"),
                             log_it=False)

    def _fail_pending(self, exc: BaseException) -> None:
        with self._pending_lock:
            stranded = [p for p in self._pending if not p.done.is_set()]
        for p in stranded:
            p.error = exc
            p.done.set()

    @property
    def max_inflight(self) -> int:
        return self._max_inflight

    def backlog(self) -> int:
        """Frames queued for the collector."""
        return self._q.qsize()

    def bucket_for(self, n: int) -> int:
        """The padded bucket a group of ``n`` frames dispatches as."""
        return _bucket(n, self._max_batch)

    # -- watchdog -------------------------------------------------------------

    def _watch(self, interval_s: float) -> None:
        """Fail the pending frames and restart when the collector or the
        completer died outside its per-dispatch guard."""
        while not self._stopped.wait(interval_s):
            collector_dead = not self._thread.is_alive()
            completer_dead = not self._completer.is_alive()
            if not (collector_dead or completer_dead):
                continue
            with self._submit_lock:
                if self._stopped.is_set():
                    return
                dead = "collector" if collector_dead else "completer"
                self.collector_restarts += collector_dead
                self.completer_restarts += completer_dead
                log.error("batch %s thread died; failing %d pending "
                          "frame(s) and restarting", dead, len(self._pending))
                while True:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        break
                while True:
                    try:
                        d = self._cq.get_nowait()
                    except queue.Empty:
                        break
                    if d is not None:
                        if d.event is not None:
                            d.event.synchronize()
                        self._pool_put(d.bufs)
                # a fresh window: slots held by dispatches lost with the
                # dead stage are never released (a dispatch on a live
                # completer releases its own slot object, not this one)
                self._slots = threading.Semaphore(self._max_inflight)
                with self._inflight_lock:
                    self._inflight = 0
                    self._sheds_since_complete = 0
                self._fail_pending(RuntimeError(
                    f"batch {dead} died; frame dropped"))
                if collector_dead:
                    self._thread = self._start(self._loop, "batch-dispatcher")
                if completer_dead:
                    self._completer = self._start(self._complete_loop,
                                                  "batch-completer")

    # -- collector side -------------------------------------------------------

    def _admit(self, p: _Pending) -> bool:
        """Whether a dequeued frame is still worth staging: abandoned frames
        are dropped, and frames whose deadline the best-case service time
        can no longer meet are failed now, before staging."""
        if p.abandoned:
            with self._pending_lock:
                self._pending.discard(p)
            return False
        if p.deadline_t is not None and self._q.policy == "deadline":
            est = self.service_estimate.s_for("")
            slack = p.deadline_t - time.monotonic()
            if est > 0 and slack < est:
                with self._inflight_lock:
                    if self._sheds_since_complete >= 8:
                        return True  # probe: refresh the estimate
                    self._sheds_since_complete += 1
                self._fail_group([p], DeadlineExceeded(
                    f"deadline unmeetable: ~{est * 1e3:.0f}ms estimated "
                    f"service vs {slack * 1e3:.0f}ms headroom; shed before "
                    "staging"), log_it=False)
                with self._pending_lock:
                    self._pending.discard(p)
                return False
        return True

    def _collect(self) -> list[_Pending]:
        while True:
            first = self._q.get()
            if first is None:
                return []
            if self._admit(first):
                break
        batch = [first]
        deadline = time.monotonic() + self._window_s
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            if self._admit(item):
                batch.append(item)
        return batch

    def _loop(self) -> None:
        while not self._stopped.is_set():
            batch = self._collect()
            groups: dict[tuple, list[_Pending]] = {}
            for p in batch:
                groups.setdefault(_group_key(p), []).append(p)
            for group in groups.values():
                self._launch_group(group)

    def _pool_take(self, b: int, h: int, w: int) -> _BucketBuffers:
        key = (b, h, w)
        with self._pool_lock:
            free = self._pool.get(key)
            if free:
                return free.pop()
        return _BucketBuffers(key, b, h, w, pin=self._cuda)

    def _pool_put(self, bufs: _BucketBuffers | None) -> None:
        if bufs is None:
            return
        with self._pool_lock:
            free = self._pool.setdefault(bufs.key, [])
            if len(free) < self._pool_cap:
                free.append(bufs)

    def _egress_take(self, shape: tuple) -> torch.Tensor:
        """A pooled landing buffer for one dispatch's [B, P] payload."""
        with self._pool_lock:
            free = self._egress_pool.get(shape)
            if free:
                return free.pop()
        return torch.empty(shape, dtype=torch.uint8, pin_memory=self._cuda)

    def _egress_put(self, buf: torch.Tensor) -> None:
        """Return a fully released landing buffer (called by the last
        ``PackedResult.release``, usually on a handler thread)."""
        with self._pool_lock:
            free = self._egress_pool.setdefault(tuple(buf.shape), [])
            if len(free) < self._pool_cap:
                free.append(buf)

    def _stage_group(self, group: list[_Pending], b: int) -> _BucketBuffers:
        """The group's rows in a pooled staging set, padded to ``b`` rows
        with replicas of the first frame."""
        h, w = group[0].frame_rgb.shape[:2]
        bufs = self._pool_take(b, h, w)
        for i, p in enumerate(group):
            bufs.fill(i, p)
        bufs.pad(len(group))
        return bufs

    def _enqueue(self, bufs: _BucketBuffers):
        """Stage, analyze and start the D2H copy of one batch; returns
        (out, host, event). Never waits on the device."""
        if not self._cuda:
            return self._analyze(bufs.frames, bufs.depths, bufs.intr,
                                 bufs.scales), None, None
        with torch.cuda.stream(self._stream):
            staged = pipeline_lib.stage_batch(bufs.frames, bufs.depths,
                                              bufs.intr, bufs.scales,
                                              self.device)
            out = self._analyze(*staged)
            host = self._egress_take(tuple(out.shape))
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return None, host, event

    def warm(self, frames, depths, intrinsics, scales) -> None:
        """Run the analyzer once at this batch shape and wait for it, so
        the first live dispatch of the bucket pays no first-use costs."""
        b, h, w = np.shape(depths)
        bufs = self._pool_take(b, h, w)
        try:
            for a, src in zip(bufs._np, (frames, np.asarray(depths, np.uint16)
                                         .view(np.int16), intrinsics, scales)):
                a[...] = src
            out, host, event = self._enqueue(bufs)
            if event is not None:
                event.synchronize()
                self._egress_put(host)
            else:
                np.asarray(out)
        except BaseException:
            self._pool_put_after_failure(bufs)
            raise
        self._pool_put(bufs)

    def _pool_put_after_failure(self, bufs: _BucketBuffers | None) -> None:
        """Pool the staging set of a dispatch that failed, once the
        dispatch stream has finished the host-to-device copies it may have
        queued from it; drop the set if the stream cannot say."""
        if bufs is None:
            return
        if self._stream is not None:
            try:
                self._stream.synchronize()
            except BaseException:  # noqa: BLE001 - the set is dropped
                return
        self._pool_put(bufs)

    def _launch_group(self, group: list[_Pending]) -> None:
        """Stage + async launch of one geometry group, then hand the
        in-flight dispatch to the completer. Never waits on the result."""
        slot = self._slots
        while not slot.acquire(timeout=0.05):
            if self._stopped.is_set():
                self._fail_group(group, RuntimeError("dispatcher stopped"),
                                 log_it=False)
                return
        bufs = None
        launched = False
        try:
            n = len(group)
            b = self.bucket_for(n)
            t0 = time.monotonic()
            bufs = self._stage_group(group, b)
            out, host, event = self._enqueue(bufs)
            t1 = time.monotonic()
            with self._inflight_lock:
                self._inflight += 1
                self.inflight_high_water = max(self.inflight_high_water,
                                               self._inflight)
                self.dispatch_sizes[n] += 1
            self._cq.put(_Dispatch(group, out, host, event, bufs, slot, t1, b,
                                   t0))
            launched = True
        except BaseException as exc:  # deliver, keep the collector alive
            self._fail_group(group, exc)
            self._pool_put_after_failure(bufs)
        finally:
            if not launched:
                slot.release()

    # -- completer side -------------------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            d = self._cq.get()
            if d is None:
                return
            try:
                if d.event is not None:
                    d.event.synchronize()  # waits with the GIL released
                    host = d.host
                else:
                    fetched = np.asarray(d.out)
                    host = self._egress_take(fetched.shape)
                    np.copyto(host.numpy(), fetched)
                rows = host.numpy()
                share = _EgressStaging(host, len(d.group), self._egress_put)
                for i, p in enumerate(d.group):
                    if p.done.is_set() or p.abandoned:
                        share.release_one()  # nobody will read this row
                        continue
                    p.result = PackedResult(rows[i], release=share.release_one)
                    p.done.set()
                self.service_estimate.observe(time.monotonic() - d.staged_t,
                                              key=("", d.bucket))
                with self._inflight_lock:
                    self._sheds_since_complete = 0
            except BaseException as exc:  # deliver, keep draining
                self._fail_group(d.group, exc)
            finally:
                done_t = time.monotonic()
                # how long the previous dispatch was still completing after
                # this one launched (0 in serial mode)
                self.overlap_s_total += max(0.0, self._last_done_t - d.launch_t)
                self._last_done_t = done_t
                self._pool_put(d.bufs)
                with self._inflight_lock:
                    self._inflight = max(0, self._inflight - 1)
                d.slot.release()

    def _fail_group(self, group: list[_Pending], exc: BaseException,
                    log_it: bool = True) -> None:
        if log_it:
            log.error("batched dispatch of %d frame(s) failed: %s: %s",
                      len(group), type(exc).__name__, exc)
        for p in group:
            if not p.done.is_set():
                p.error = exc
                p.done.set()
