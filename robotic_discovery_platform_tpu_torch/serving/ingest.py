"""Request payloads -> frames, off the handler thread (the port of the JAX
package's ``serving/ingest.py``).

Raw payloads (``Image.format = 1``) are numpy views of the wire bytes.
Encoded JPEG/PNG payloads (``format = 0``) decode through ``cv2``, imported
where it is needed. Coefficient payloads (``format = 2``) are views of the
wire bytes too (:func:`serving.entropy.unpack_coefficients`): the frame
stays a :class:`~serving.entropy.CoefficientFrame` and its pixels are
decoded on the device. With on-chip decode on
(:func:`resolve_onchip_decode`), a baseline JPEG sent as ``format = 0`` is
entropy-decoded on the host (:func:`serving.entropy.parse_jpeg`) and takes
the coefficient lane as well.

- :class:`DecodePool`: ``ServerConfig.decode_workers`` (or
  ``RDP_DECODE_WORKERS``) decode threads with per-stream read-ahead of
  ``ingest_prefetch`` requests, so frame k + 1 decodes while frame k rides
  the device. ``workers=0`` decodes inline in the handler thread, byte for
  byte the path without a pool. A frame whose deadline passed in the queue
  is shed before its decode (``rdp_shed_by_deadline_total{point=
  "decode"}``); a watchdog restarts a dead worker and fails the frames it
  held; :meth:`DecodePool.stop` leaves no waiter blocked. The workers
  handle host arrays only and never touch the card.
- :class:`GeometryCache`: a content-keyed LRU (capacity 64) of camera
  geometry: the float32 intrinsics the dispatcher stages per batch, and
  the direct path's copies on the servicer's device, made once per entry
  under the entry's lock (``rdp_geometry_cache_hits_total`` /
  ``_misses_total``).

Fault sites (``resilience/faults.py``): ``serving.ingest.decode`` inside
the per-frame guard (fails that frame only), ``serving.ingest.loop`` in
the worker loop outside it (kills the worker: the watchdog's drill).
Instruments: ``rdp_decode_seconds{format}``, ``rdp_decode_queue_depth``,
``rdp_host_stage_split_seconds{stage="decode"}`` (and ``"entropy"`` for a
coefficient frame's host half), and one ``ingest`` flight-recorder
timeline per decoded frame.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.observability import (
    events,
    instruments as obs,
    journal as journal_lib,
    recorder as recorder_lib,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    DeadlineExceeded,
    inject,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    sites as fault_sites,
)
from robotic_discovery_platform_tpu_torch.serving import entropy
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: ``Image.format`` wire values (protos/vision.proto)
FORMAT_ENCODED = 0
FORMAT_RAW = 1
FORMAT_COEF = 2

_ONCHIP_ENV_VAR = "RDP_ONCHIP_DECODE"
_WORKERS_ENV_VAR = "RDP_DECODE_WORKERS"

#: anything above this is "no deadline": grpc reports a stream without a
#: deadline as about INT64_MAX nanoseconds
_NO_DEADLINE_S = 86400.0 * 365

#: the IJG base quantization tables (ITU-T T.81 Annex K, tables K.1 and
#: K.2), natural (row-major) order: luminance, then chrominance
STANDARD_QUANT_TABLES = (
    np.array([
        16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
        99], np.uint16),
    np.array([
        17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
        *([99] * 32)], np.uint16),
)


def quant_tables(quality: int = 50) -> tuple[np.ndarray, np.ndarray]:
    """(luminance, chrominance) [64] uint16 tables at an IJG quality
    (libjpeg's ``jpeg_quality_scaling``, baseline-limited to 1..255)."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in 1..100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(
        np.clip((t.astype(np.int64) * scale + 50) // 100, 1, 255)
        .astype(np.uint16) for t in STANDARD_QUANT_TABLES)


def blank_coefficient_frame(height: int, width: int,
                            subsampling: str = "420"
                            ) -> entropy.CoefficientFrame:
    """An all-zero coefficient frame with the standard tables: a mid-gray
    (128, 128, 128) image of that geometry, for warming the coefficient
    lane without an encoder."""
    (ybh, ybw), (cbh, cbw) = entropy.block_grids(height, width, subsampling)
    qy, qc = STANDARD_QUANT_TABLES
    return entropy.CoefficientFrame(
        height=height, width=width, subsampling=subsampling,
        y=np.zeros((ybh * ybw, 64), np.int16),
        cb=np.zeros((cbh * cbw, 64), np.int16),
        cr=np.zeros((cbh * cbw, 64), np.int16), qy=qy, qc=qc)


def resolve_onchip_decode(configured: bool) -> bool:
    """The effective on-chip decode mode: ``RDP_ONCHIP_DECODE`` when set
    ("1"/"true"/"yes"/"on"/"strict" enable, anything else disables), else
    ``ServerConfig.onchip_decode``."""
    raw = os.environ.get(_ONCHIP_ENV_VAR)
    if raw is None:
        return bool(configured)
    return raw.strip().lower() in ("1", "true", "yes", "on", "strict")


def normalize_remaining(remaining: float | None) -> float | None:
    """A stream's remaining deadline budget, with grpc's
    INT64_MAX-when-deadline-less sentinel normalized to None."""
    if remaining is None or remaining > _NO_DEADLINE_S:
        return None
    return remaining


def resolve_decode_workers(configured: int) -> int:
    """The effective decode-pool width: ``RDP_DECODE_WORKERS`` when set,
    else ``ServerConfig.decode_workers``. 0 = inline decode in the
    handler thread; negative = one worker per available CPU."""
    raw = os.environ.get(_WORKERS_ENV_VAR)
    value = int(raw) if raw else int(configured)
    if value < 0:
        return max(1, os.cpu_count() or 1)
    return value


def default_intrinsics(w: int, h: int) -> np.ndarray:
    """The focal-length fallback used when no calibration is loaded."""
    f = 0.94 * w
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(
            "encoded (JPEG/PNG) payloads need OpenCV (cv2), which is not "
            "installed; send raw payloads (Image.format = 1)"
        ) from exc
    return cv2


def decode_color(img, *, onchip: bool = False
                 ) -> np.ndarray | entropy.CoefficientFrame:
    """One color payload -> [H, W, 3] uint8 RGB, or the coefficient half of
    a split decode (:class:`~serving.entropy.CoefficientFrame`) when the
    pixels are decoded on the device: always for ``format = 2``, and for a
    baseline JPEG under ``onchip`` (a JPEG that ``parse_jpeg`` calls
    unsupported, e.g. progressive, stays on cv2; a corrupt one raises).
    ``img`` has the ``Image`` fields (a :class:`serving.messages.Image` or
    a protobuf message)."""
    if img.format == FORMAT_COEF:
        frame = entropy.unpack_coefficients(img.data)
        if img.width and img.height and (
                frame.height != img.height or frame.width != img.width):
            raise ValueError(
                f"coefficient payload is {frame.width}x{frame.height}; "
                f"Image says {img.width}x{img.height}"
            )
        return frame
    if img.format == FORMAT_RAW:
        expect = img.height * img.width * 3
        if len(img.data) != expect:
            raise ValueError(
                f"raw color payload is {len(img.data)} bytes; expected "
                f"{expect} for {img.width}x{img.height} RGB8"
            )
        return np.frombuffer(img.data, np.uint8).reshape(
            img.height, img.width, 3)
    if onchip and img.data[:2] == b"\xff\xd8":
        try:
            return entropy.parse_jpeg(img.data)
        except ValueError as exc:
            if not str(exc).startswith("unsupported"):
                raise
    cv2 = _cv2()
    bgr = cv2.imdecode(np.frombuffer(img.data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError("failed to decode color payload")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def decode_depth(img) -> np.ndarray:
    """One depth payload -> [H, W] uint16 (z16)."""
    if img.format == FORMAT_RAW:
        expect = img.height * img.width * 2
        if len(img.data) != expect:
            raise ValueError(
                f"raw depth payload is {len(img.data)} bytes; expected "
                f"{expect} for {img.width}x{img.height} z16"
            )
        return np.frombuffer(img.data, "<u2").reshape(img.height, img.width)
    cv2 = _cv2()
    depth = cv2.imdecode(np.frombuffer(img.data, np.uint8),
                         cv2.IMREAD_UNCHANGED)
    if depth is None:
        raise ValueError("failed to decode depth payload")
    if depth.dtype != np.uint16:
        depth = depth.astype(np.uint16)
    return depth


def request_format(request) -> str:
    """Label of the request's payload encoding: "coef" (the color carries
    coefficient blocks; depth rides raw), "raw" (both raw), "encoded"
    (both encoded) or "mixed"."""
    if request.color_image.format == FORMAT_COEF:
        return "coef"
    c = request.color_image.format == FORMAT_RAW
    d = request.depth_image.format == FORMAT_RAW
    if c and d:
        return "raw"
    if not c and not d:
        return "encoded"
    return "mixed"


def decode_request(request, *, onchip: bool = False) -> tuple:
    """``AnalysisRequest`` -> (rgb [H, W, 3] u8 or a CoefficientFrame,
    depth [H, W] u16, format label); ``onchip`` as in
    :func:`decode_color`. The per-frame decode core; the instruments and
    the fault site ride :meth:`DecodePool.decode`."""
    fmt = request_format(request)
    return (decode_color(request.color_image, onchip=onchip),
            decode_depth(request.depth_image), fmt)


def coef_request(frame: entropy.CoefficientFrame, depth: np.ndarray, *,
                 mask_format: int = 0, model: str = ""):
    """A :class:`serving.messages.AnalysisRequest` whose color image is a
    ``format = 2`` coefficient payload, beside a raw z16 depth image."""
    from robotic_discovery_platform_tpu_torch.serving import messages

    h, w = depth.shape
    return messages.AnalysisRequest(
        color_image=messages.Image(entropy.pack_coefficients(frame),
                                   frame.width, frame.height, FORMAT_COEF),
        depth_image=messages.Image(
            np.ascontiguousarray(depth, "<u2").tobytes(), w, h, FORMAT_RAW),
        model=model, mask_format=mask_format,
    )


def raw_request(rgb: np.ndarray, depth: np.ndarray, *, mask_format: int = 0,
                model: str = ""):
    """A raw-format :class:`serving.messages.AnalysisRequest` for one
    (RGB u8, z16) frame pair."""
    from robotic_discovery_platform_tpu_torch.serving import messages

    h, w = depth.shape
    return messages.AnalysisRequest(
        color_image=messages.Image(
            np.ascontiguousarray(rgb, np.uint8).tobytes(), w, h, FORMAT_RAW),
        depth_image=messages.Image(
            np.ascontiguousarray(depth, "<u2").tobytes(), w, h, FORMAT_RAW),
        model=model, mask_format=mask_format,
    )


# -- geometry cache -------------------------------------------------------------


class GeometryEntry:
    """One camera geometry: the float32 intrinsics the dispatcher stages
    per batch, and (:meth:`staged`) the direct path's copies of intrinsics
    and depth scale on the device, made once per entry."""

    __slots__ = ("k_f32", "depth_scale", "device", "_staged", "_lock")

    def __init__(self, k: np.ndarray, depth_scale: float,
                 device: torch.device):
        self.k_f32 = np.ascontiguousarray(k, np.float32)
        self.depth_scale = float(depth_scale)
        self.device = device
        self._staged: tuple | None = None  # guarded_by: _lock
        self._lock = threading.Lock()

    def staged(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(intrinsics [3, 3], depth_scale [])`` as float32 tensors on the
        device, made at the first call under the entry's lock (two racing
        frames share one copy). Called outside any graph capture."""
        with self._lock:
            if self._staged is None:
                self._staged = (
                    torch.as_tensor(self.k_f32, device=self.device),
                    torch.as_tensor(np.float32(self.depth_scale),
                                    device=self.device),
                )
            return self._staged


class GeometryCache:
    """Content-keyed cache of camera geometry: keyed on the intrinsics'
    bytes, the frame size and the depth scale, so a stream's steady
    intrinsics never convert or stage again, and a stream that changes
    them misses into a fresh entry. A bounded LRU: a client cycling
    intrinsics cannot grow it without bound."""

    def __init__(self, capacity: int = 64,
                 device: str | torch.device = "cpu"):
        self.capacity = max(1, int(capacity))
        self.device = torch.device(device)
        self._lock = checked_lock("ingest.geometry")
        self._entries: OrderedDict[tuple, GeometryEntry] = OrderedDict()  # guarded_by: _lock

    def lookup(self, intrinsics: np.ndarray | None, w: int, h: int,
               depth_scale: float) -> GeometryEntry:
        """The entry of this frame's geometry. ``intrinsics=None`` means
        the focal-length default of (w, h)."""
        key = (w, h, float(depth_scale),
               None if intrinsics is None
               else np.asarray(intrinsics).tobytes())
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is not None:
            obs.GEOMETRY_CACHE_HITS.inc()
            return entry
        obs.GEOMETRY_CACHE_MISSES.inc()
        k = intrinsics if intrinsics is not None else default_intrinsics(w, h)
        entry = GeometryEntry(k, depth_scale, self.device)
        with self._lock:
            # a racing miss may have inserted first: keep the winner, so
            # both callers share one staged copy
            entry = self._entries.setdefault(key, entry)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# -- decode pool ----------------------------------------------------------------


@dataclass(eq=False)  # identity semantics: instances live in _pending sets
class _PendingDecode:
    """One decode job riding the pool queue."""

    request: Any
    #: absolute monotonic deadline; a worker popping a frame past it sheds
    #: the frame before decoding it
    deadline_t: float | None = None
    done: threading.Event = field(default_factory=threading.Event)
    rgb: np.ndarray | entropy.CoefficientFrame | None = None
    depth: np.ndarray | None = None
    fmt: str = "encoded"
    error: BaseException | None = None
    queued_ns: int = field(default_factory=time.monotonic_ns)
    #: seconds the decode itself took (0 when shed or failed before it)
    decode_s: float = 0.0


@dataclass
class IngestFrame:
    """One decoded frame (or its error) as the stream handler takes it,
    with the request's selectors and the handler's wait."""

    rgb: np.ndarray | entropy.CoefficientFrame | None
    depth: np.ndarray | None
    error: BaseException | None
    #: the stream's deadline budget when the request was read
    time_remaining: float | None
    #: seconds the handler thread spent obtaining this frame (inline: the
    #: decode; pooled: the wait, about 0 when read-ahead won)
    wait_s: float
    fmt: str = "encoded"
    model: str = ""
    mask_format: int = 0


class DecodePool:
    """Bounded pool of decode workers with the batch dispatcher's liveness
    guarantees (watchdog restart, stranded frames failed, a ``stop`` that
    leaves no waiter blocked). ``workers=0`` runs no thread: :meth:`submit`
    decodes inline and :meth:`iter_decoded` is the read-check-decode loop
    of a server without a pool."""

    def __init__(self, workers: int, *, watchdog_interval_s: float = 1.0,
                 prefetch: int = 2, onchip: bool = False,
                 flight_recorder: recorder_lib.FlightRecorder | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.workers = max(0, int(workers))
        self.prefetch = max(1, int(prefetch))
        self.onchip = bool(onchip)
        self._clock = clock
        self._recorder = (flight_recorder if flight_recorder is not None
                          else recorder_lib.RECORDER)
        self._q: queue.Queue[_PendingDecode | None] = queue.Queue()
        self._stopped = threading.Event()
        self._submit_lock = checked_lock("ingest.submit")
        self._pending: set[_PendingDecode] = set()  # guarded_by: _pending_lock
        self._pending_lock = checked_lock("ingest.pending")
        self.worker_restarts = 0
        self.sheds = 0
        self._threads: list[threading.Thread] = []
        self._watchdog: threading.Thread | None = None
        if self.workers > 0:
            self._threads = [self._start_worker(i)
                             for i in range(self.workers)]
            if watchdog_interval_s > 0:
                self._watchdog = threading.Thread(
                    target=self._watch, args=(watchdog_interval_s,),
                    name="ingest-watchdog", daemon=True)
                self._watchdog.start()

    def _start_worker(self, i: int) -> threading.Thread:
        t = threading.Thread(target=self._worker_loop,
                             name=f"ingest-decode-{i}", daemon=True)
        t.start()
        return t

    # -- decode core ----------------------------------------------------------

    def decode(self, request) -> tuple:
        """One guarded, timed decode (whichever thread runs it): the
        ``serving.ingest.decode`` fault site, ``rdp_decode_seconds``, the
        host split's ``decode`` stage and one ``ingest`` timeline."""
        t0 = time.monotonic_ns()
        inject(fault_sites.SERVING_INGEST_DECODE)
        rgb, depth, fmt = decode_request(request, onchip=self.onchip)
        t1 = time.monotonic_ns()
        dt = (t1 - t0) / 1e9
        obs.DECODE_SECONDS.labels(format=fmt).observe(dt)
        obs.HOST_STAGE_SPLIT.labels(stage="decode").observe(dt)
        split = isinstance(rgb, entropy.CoefficientFrame)
        if split:
            # the host's half of a split decode: views of a format-2
            # payload, or the entropy decode of a JPEG (on-chip mode)
            obs.HOST_STAGE_SPLIT.labels(stage="entropy").observe(dt)
        tl = recorder_lib.Timeline("ingest", labels={
            "format": fmt, "mode": "pool" if self.workers else "inline"})
        root = tl.span("ingest", start_ns=t0, end_ns=t1)
        tl.span("entropy" if split else "decode", start_ns=t0, end_ns=t1,
                parent=root)
        self._recorder.record(tl)
        return rgb, depth, fmt

    # -- caller side ----------------------------------------------------------

    def submit(self, request, deadline_t: float | None = None
               ) -> _PendingDecode:
        """Enqueue one decode job (inline mode decodes at once); claim the
        result with :meth:`wait`."""
        p = _PendingDecode(request, deadline_t=deadline_t)
        if self.workers == 0:
            self._run_one(p, shed_check=False)
            return p
        with self._submit_lock:
            if self._stopped.is_set():
                p.error = RuntimeError("decode pool stopped")
                p.done.set()
                return p
            with self._pending_lock:
                self._pending.add(p)
            self._q.put(p)
        obs.DECODE_QUEUE_DEPTH.set(self._q.qsize())
        return p

    def wait(self, p: _PendingDecode, timeout_s: float | None = None) -> None:
        """Block until ``p`` has an outcome; on timeout the frame is
        marked failed, so a late decode is dropped."""
        if not p.done.wait(timeout_s):
            p.error = DeadlineExceeded(
                f"decode not ready within {timeout_s:.2f}s")
        with self._pending_lock:
            self._pending.discard(p)

    # -- worker side ----------------------------------------------------------

    def _run_one(self, p: _PendingDecode, shed_check: bool = True) -> None:
        try:
            if (shed_check and p.deadline_t is not None
                    and self._clock() > p.deadline_t):
                # the deadline passed while the frame sat in the queue:
                # its decode would be work for a caller that is gone
                self.sheds += 1
                obs.SHED_BY_DEADLINE.labels(point="decode").inc()
                raise DeadlineExceeded(
                    "deadline blown in the decode queue; shed before "
                    "paying decode cost")
            t0 = time.perf_counter()
            p.rgb, p.depth, p.fmt = self.decode(p.request)
            p.decode_s = time.perf_counter() - t0
        except BaseException as exc:  # deliver, keep the worker alive
            p.error = exc
        finally:
            p.done.set()
            with self._pending_lock:
                self._pending.discard(p)

    def _worker_loop(self) -> None:
        while True:
            p = self._q.get()
            obs.DECODE_QUEUE_DEPTH.set(self._q.qsize())
            if p is None:
                return
            # outside the per-frame guard on purpose: a fault here kills
            # the worker itself (the watchdog's drill)
            inject(fault_sites.SERVING_INGEST_LOOP)
            self._run_one(p)

    # -- watchdog -------------------------------------------------------------

    def _watch(self, interval_s: float) -> None:
        """Restart a worker that died outside its per-frame guard, and
        fail every pending frame now (no waiter sits out its deadline
        against a pool without threads)."""
        while not self._stopped.wait(interval_s):
            dead = [i for i, t in enumerate(self._threads)
                    if not t.is_alive()]
            if not dead:
                continue
            with self._submit_lock:
                if self._stopped.is_set():
                    return
                self.worker_restarts += len(dead)
                obs.WATCHDOG_RESTARTS.inc()
                self._recorder.record_event(
                    "watchdog_restart", stage="ingest",
                    error=f"{len(dead)} decode worker(s) died; "
                          f"{len(self._pending)} pending frame(s) failed")
                journal_lib.JOURNAL.append(
                    events.WATCHDOG_RESTART, stage="ingest",
                    workers=len(dead), pending=len(self._pending))
                log.error(
                    "%d decode worker(s) died unexpectedly; failing %d "
                    "pending frame(s) and restarting (restart #%d)",
                    len(dead), len(self._pending), self.worker_restarts)
                _drain(self._q)
                obs.DECODE_QUEUE_DEPTH.set(0)
                self._fail_pending(RuntimeError(
                    "decode worker died; frame dropped"))
                for i in dead:
                    self._threads[i] = self._start_worker(i)

    def _fail_pending(self, exc: BaseException) -> None:
        with self._pending_lock:
            stranded = [p for p in self._pending if not p.done.is_set()]
            self._pending.clear()
        for p in stranded:
            p.error = exc
            p.done.set()

    def stop(self) -> None:
        """Idempotent. Every pending decode gets an outcome."""
        with self._submit_lock:
            self._stopped.set()
            for _ in self._threads:
                self._q.put(None)
        for t in self._threads:
            t.join(timeout=5)
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
        for p in _drain(self._q):
            if p is not None and not p.done.is_set():
                p.error = RuntimeError("decode pool stopped")
                p.done.set()
        self._fail_pending(RuntimeError("decode pool stopped"))

    # -- stream side ----------------------------------------------------------

    def iter_decoded(self, request_iterator: Iterable, *,
                     active: Callable[[], bool] = lambda: True,
                     time_remaining: Callable[[], float | None] = lambda: None,
                     ) -> Iterator[IngestFrame]:
        """One :class:`IngestFrame` per request, in order. Inline
        (``workers=0``): check cancellation and deadline, decode, yield.
        Pooled: a per-stream pump thread reads ahead up to ``prefetch``
        requests into the pool. A frame that fails or is shed yields its
        error in place; the stream goes on."""
        if self.workers == 0:
            for request in request_iterator:
                if not active():
                    return
                remaining = normalize_remaining(time_remaining())
                if remaining is not None and remaining <= 0:
                    return
                t0 = time.perf_counter()
                p = self.submit(request)
                yield IngestFrame(p.rgb, p.depth, p.error, remaining,
                                  time.perf_counter() - t0, p.fmt,
                                  model=request.model,
                                  mask_format=request.mask_format)
            return
        yield from self._iter_pooled(request_iterator, active,
                                     time_remaining)

    def _iter_pooled(self, request_iterator, active, time_remaining
                     ) -> Iterator[IngestFrame]:
        inbox: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stream_done = threading.Event()

        def put_end() -> None:
            while not stream_done.is_set():
                try:
                    inbox.put(None, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def pump() -> None:
            # the one reader of the request iterator; the bounded inbox is
            # the read-ahead, so a slow handler holds the pump back here
            try:
                for request in request_iterator:
                    if stream_done.is_set() or not active():
                        return
                    remaining = normalize_remaining(time_remaining())
                    if remaining is not None and remaining <= 0:
                        return
                    deadline_t = (self._clock() + remaining
                                  if remaining is not None else None)
                    item = (self.submit(request, deadline_t=deadline_t),
                            remaining)
                    while True:
                        try:
                            inbox.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            if stream_done.is_set():
                                return
            except Exception as exc:  # noqa: BLE001 - a reset mid-read
                if not stream_done.is_set():
                    inbox.put(("error", exc))
            finally:
                put_end()

        t = threading.Thread(target=pump, name="ingest-pump", daemon=True)
        t.start()
        try:
            while True:
                item = inbox.get()
                if item is None:
                    return
                if item[0] == "error":
                    raise item[1]
                p, remaining = item
                t0 = time.perf_counter()
                # the caller's budget when it has one, else a generous
                # ceiling (a frame the watchdog fails completes sooner)
                self.wait(p, remaining if remaining is not None else 60.0)
                yield IngestFrame(p.rgb, p.depth, p.error, remaining,
                                  time.perf_counter() - t0, p.fmt,
                                  model=p.request.model,
                                  mask_format=p.request.mask_format)
        finally:
            stream_done.set()
            # a pump blocked in the request iterator's read unblocks when
            # the call ends (right after the handler returns); it holds no
            # lock and touches nothing once the flag is set
            _drain(inbox)
            t.join(timeout=0.5)


def _drain(q: queue.Queue) -> list:
    """Everything ``q`` holds now, taken out."""
    items = []
    while True:
        try:
            items.append(q.get_nowait())
        except queue.Empty:
            return items
