"""Response mask payloads (the port of the JAX package's
``serving/egress.py`` wire codecs), and :class:`PackedResult`, the parser
of one frame's packed analysis row from a batched dispatch.

``AnalysisRequest.mask_format`` selects what rides
``AnalysisResponse.mask``: 0 = a PNG of the 0/255 mask, 1 = packed bits
(:func:`encode_bits_wire`), 2 = run lengths (:func:`encode_rle_wire`). The
bits and RLE payloads are byte-identical to the JAX package's, and both
decode back to the exact mask (:func:`decode_mask_wire`). PNG goes through
``cv2`` where it is installed (the same bytes as the JAX server) and
otherwise through a small ``zlib`` PNG writer (the same pixels).

:class:`EncodePool` encodes response masks: ``ServerConfig.
egress_workers`` (or ``RDP_EGRESS_WORKERS``) worker threads, or inline in
the handler thread with 0 workers, byte for byte the same payloads. As the
decode pool (``serving/ingest.py``): a watchdog restarts a dead worker and
fails the frames it held, a frame that fails fails alone, ``stop`` leaves
no waiter blocked, and the workers handle host arrays only. Fault sites
``serving.egress.encode`` (inside the per-frame guard) and
``serving.egress.loop`` (the worker loop); instruments
``rdp_encode_seconds{format}``, ``rdp_egress_bytes_total{format}``,
``rdp_egress_pool_queue_depth``, the host split's ``encode`` stage and one
``egress`` flight-recorder timeline per encode.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.observability import (
    events,
    instruments as obs,
    journal as journal_lib,
    recorder as recorder_lib,
)
from robotic_discovery_platform_tpu_torch.ops import geometry, pack, pipeline
from robotic_discovery_platform_tpu_torch.resilience import (
    DeadlineExceeded,
    inject,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    sites as fault_sites,
)
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_WORKERS_ENV_VAR = "RDP_EGRESS_WORKERS"

#: ``AnalysisRequest.mask_format`` wire values (protos/vision.proto)
MASK_FORMAT_PNG = 0
MASK_FORMAT_BITS = 1
MASK_FORMAT_RLE = 2

_BITS_HEADER = struct.Struct("<4sHH")   # magic, height, width
_RLE_HEADER = struct.Struct("<4sHHI")   # magic, height, width, runs
WIRE_BITS_MAGIC = b"RDPB"
WIRE_RLE_MAGIC = b"RDPR"

_FORMAT_NAMES = {MASK_FORMAT_PNG: "png", MASK_FORMAT_BITS: "bits",
                 MASK_FORMAT_RLE: "rle"}


def mask_format_name(mask_format: int) -> str:
    """Metric label of a ``mask_format`` wire value."""
    return _FORMAT_NAMES.get(int(mask_format), "unknown")


def resolve_egress_workers(configured: int) -> int:
    """The effective encode-pool width: ``RDP_EGRESS_WORKERS`` when set,
    else ``ServerConfig.egress_workers``. 0 = inline encode in the
    handler thread; negative = one worker per available CPU."""
    raw = os.environ.get(_WORKERS_ENV_VAR)
    value = int(raw) if raw else int(configured)
    if value < 0:
        return max(1, os.cpu_count() or 1)
    return value


def encode_bits_wire(bits: np.ndarray, h: int, w: int) -> bytes:
    """``mask_format=1`` payload: 8-byte header + the bitpacked rows
    (``np.packbits(mask, axis=-1)``, MSB first)."""
    return _BITS_HEADER.pack(WIRE_BITS_MAGIC, h, w) + bits.tobytes()


def mask_runs(mask: np.ndarray) -> np.ndarray:
    """Row-major run lengths of a 0/1 mask, alternating and starting with
    a zero run (a leading zero-length run when pixel (0, 0) is set)."""
    flat = np.asarray(mask, np.uint8).ravel()
    if flat.size == 0:
        return np.zeros(0, "<u4")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).astype("<u4")
    if flat[0]:
        runs = np.concatenate([np.zeros(1, "<u4"), runs])
    return runs


def encode_rle_wire(mask: np.ndarray, h: int, w: int) -> bytes:
    """``mask_format=2`` payload: 12-byte header + little-endian u32 run
    lengths (alternating zero/one runs, zero first)."""
    runs = mask_runs(mask)
    return _RLE_HEADER.pack(WIRE_RLE_MAGIC, h, w, runs.size) + runs.tobytes()


def decode_mask_wire(data: bytes) -> np.ndarray | None:
    """A packed ``AnalysisResponse.mask`` payload -> the exact [H, W] uint8
    0/1 mask; None when it is not a packed format (a PNG)."""
    if len(data) >= _BITS_HEADER.size and data[:4] == WIRE_BITS_MAGIC:
        _, h, w = _BITS_HEADER.unpack_from(data)
        wb = (w + 7) // 8
        bits = np.frombuffer(data, np.uint8, count=h * wb,
                             offset=_BITS_HEADER.size).reshape(h, wb)
        return np.unpackbits(bits, axis=1)[:, :w]
    if len(data) >= _RLE_HEADER.size and data[:4] == WIRE_RLE_MAGIC:
        _, h, w, n_runs = _RLE_HEADER.unpack_from(data)
        runs = np.frombuffer(data, "<u4", count=n_runs,
                             offset=_RLE_HEADER.size)
        if int(runs.sum()) != h * w:
            raise ValueError(
                f"RLE runs cover {int(runs.sum())} pixels; header says {h}x{w}"
            )
        values = np.arange(n_runs, dtype=np.uint8) & 1
        return np.repeat(values, runs).reshape(h, w)
    return None


def decode_spline_wire(data: bytes) -> np.ndarray:
    """``AnalysisResponse.packed_spline`` -> [N, 3] float32 (x, y, z)."""
    return np.frombuffer(data, "<f4").reshape(-1, 3)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def png_gray8(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of ``img`` [H, W] uint8, stdlib only."""
    h, w = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img, np.uint8)],
        axis=1)  # filter type 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def encode_png_mask(mask: np.ndarray) -> bytes:
    """``mask_format=0`` payload: PNG of ``mask * 255``."""
    img = np.asarray(mask, np.uint8) * np.uint8(255)
    try:
        import cv2
    except ImportError:
        return png_gray8(img)
    ok, buf = cv2.imencode(".png", img)
    if not ok:
        raise ValueError("mask encode failed")
    return buf.tobytes()


def encode_mask(mask: np.ndarray, mask_format: int) -> bytes:
    """The response ``mask`` payload for ``mask_format`` (anything but 1
    or 2 is PNG, as the JAX server answers)."""
    h, w = mask.shape
    if mask_format == MASK_FORMAT_BITS:
        return encode_bits_wire(np.packbits(mask, axis=-1), h, w)
    if mask_format == MASK_FORMAT_RLE:
        return encode_rle_wire(mask, h, w)
    return encode_png_mask(mask)


class PackedResult:
    """One frame's packed analysis payload: a zero-copy parser over the
    uint8 row that a batched dispatch's one device-to-host copy landed in
    the dispatcher's pooled host staging (``ops/pack.py``'s layout: the
    16-byte header, the float32 sidecar, the bitpacked mask rows).

    Scalars come off the sidecar as the exact float32 values the direct
    path reads; the full-resolution mask materializes on the host only
    when something needs pixels (:meth:`unpack_mask`). ``release`` hands
    the row back to the pool: call it once, after everything needed was
    read or copied (a second call is ignored).
    """

    __slots__ = ("payload", "h", "w", "n_pts", "_release")

    def __init__(self, payload: np.ndarray,
                 release: Callable[[], None] | None = None):
        payload = np.asarray(payload)
        if payload.ndim != 1 or payload.dtype != np.uint8:
            raise ValueError(
                f"packed payload must be a 1-D uint8 row; got "
                f"{payload.dtype} with shape {payload.shape}"
            )
        magic, h, w, n_pts = struct.unpack_from(
            "<4sIII", memoryview(payload[:pack.HEADER_BYTES]))
        if magic != pack.ROW_MAGIC:
            raise ValueError(
                f"packed payload header magic {magic!r} != {pack.ROW_MAGIC!r}"
            )
        expect = pack.frame_payload_bytes(h, w, n_pts)
        if payload.shape[0] != expect:
            raise ValueError(
                f"packed payload is {payload.shape[0]} bytes; header "
                f"geometry ({h}x{w}, {n_pts} spline samples) needs {expect}"
            )
        self.payload = payload
        self.h, self.w, self.n_pts = int(h), int(w), int(n_pts)
        self._release = release

    def _sidecar(self) -> np.ndarray:
        lo = pack.HEADER_BYTES
        return self.payload[lo:lo + 4 * pack.sidecar_floats(self.n_pts)].view(
            "<f4")

    @property
    def mask_bits(self) -> np.ndarray:
        """[H, ceil(W/8)] uint8 view of the bitpacked mask rows."""
        wb = pack.packed_row_bytes(self.w)
        lo = pack.HEADER_BYTES + 4 * pack.sidecar_floats(self.n_pts)
        return self.payload[lo:lo + self.h * wb].reshape(self.h, wb)

    def scalars(self) -> tuple[float, float, float, bool, float]:
        """(coverage, mean_curvature, max_curvature, valid, margin): the
        sidecar's float32 values (invalid frames read 0.0 curvature)."""
        s = self._sidecar()
        return (float(s[0]), float(s[1]), float(s[2]), bool(s[3] != 0.0),
                float(s[4]))

    def spline(self) -> np.ndarray:
        """[n_pts, 3] float32 spline block, a copy that outlives
        :meth:`release`; [0, 3] when the profile is invalid."""
        s = self._sidecar()
        if s[3] == 0.0:
            return np.zeros((0, 3), np.float32)
        return np.array(s[pack.N_SCALARS:].reshape(self.n_pts, 3),
                        np.float32)

    def spline_wire(self) -> bytes:
        """The ``packed_spline`` payload: little-endian float32 (x, y, z)
        triples, empty when the profile is invalid."""
        s = self._sidecar()
        return b"" if s[3] == 0.0 else s[pack.N_SCALARS:].tobytes()

    def unpack_mask(self) -> np.ndarray:
        """[H, W] uint8 0/1 mask, the exact mask the analyzer emitted."""
        return np.unpackbits(self.mask_bits, axis=1)[:, :self.w]

    def to_analysis(self):
        """The row as an unbatched :class:`ops.pipeline.FrameAnalysis` of
        CPU tensors (the diagnostic profile fields zeroed, the spline zeros
        when invalid): what the warm-up parity gate reads off a packed
        path's result. Mask and scalars are exact through the pack."""
        coverage, mean_k, max_k, valid, margin = self.scalars()
        zero = torch.zeros((), dtype=torch.int32)
        spline = (self.spline() if valid
                  else np.zeros((self.n_pts, 3), np.float32))
        prof = geometry.CurvatureProfile(
            mean_curvature=torch.tensor(mean_k, dtype=torch.float32),
            max_curvature=torch.tensor(max_k, dtype=torch.float32),
            spline_points=torch.from_numpy(spline),
            valid=torch.tensor(valid),
            num_cloud_points=zero,
            num_edge_points=zero,
            truncated=torch.tensor(False),
        )
        return pipeline.FrameAnalysis(
            mask=torch.from_numpy(self.unpack_mask()),
            mask_coverage=torch.tensor(coverage, dtype=torch.float32),
            profile=prof,
            confidence_margin=torch.tensor(margin, dtype=torch.float32),
        )

    def release(self) -> None:
        """Return this row's share of the staging buffer. Idempotent."""
        release, self._release = self._release, None
        if release is not None:
            release()


# -- encode pool ----------------------------------------------------------------


@dataclass(eq=False)  # identity semantics: instances live in _pending sets
class _PendingEncode:
    """One encode job riding the pool queue."""

    fmt: str  # "png" | "bits" | "rle"
    mask: np.ndarray | None = None  # [H, W] uint8 0/1 (png, rle)
    bits: np.ndarray | None = None  # [H, ceil(W/8)] uint8 (bits, rle)
    shape: tuple[int, int] = (0, 0)  # (h, w) of the native mask
    done: threading.Event = field(default_factory=threading.Event)
    result: bytes | None = None
    error: BaseException | None = None
    queued_ns: int = field(default_factory=time.monotonic_ns)


class EncodePool:
    """Bounded pool of response-encode workers with the decode pool's
    liveness guarantees. ``workers=0`` runs no thread: :meth:`encode`
    runs in the caller's thread."""

    def __init__(self, workers: int, *, watchdog_interval_s: float = 1.0,
                 flight_recorder: recorder_lib.FlightRecorder | None = None):
        self.workers = max(0, int(workers))
        self._recorder = (flight_recorder if flight_recorder is not None
                          else recorder_lib.RECORDER)
        self._q: queue.Queue[_PendingEncode | None] = queue.Queue()
        self._stopped = threading.Event()
        self._submit_lock = checked_lock("egress.submit")
        self._pending: set[_PendingEncode] = set()  # guarded_by: _pending_lock
        self._pending_lock = checked_lock("egress.pending")
        self.worker_restarts = 0
        self._threads: list[threading.Thread] = []
        self._watchdog: threading.Thread | None = None
        if self.workers > 0:
            self._threads = [self._start_worker(i)
                             for i in range(self.workers)]
            if watchdog_interval_s > 0:
                self._watchdog = threading.Thread(
                    target=self._watch, args=(watchdog_interval_s,),
                    name="egress-watchdog", daemon=True)
                self._watchdog.start()

    def _start_worker(self, i: int) -> threading.Thread:
        t = threading.Thread(target=self._worker_loop,
                             name=f"egress-encode-{i}", daemon=True)
        t.start()
        return t

    # -- encode core ----------------------------------------------------------

    def _encode_core(self, p: _PendingEncode) -> bytes:
        """One guarded, timed encode (whichever thread runs it): the
        ``serving.egress.encode`` fault site, the encode instruments and
        one ``egress`` timeline."""
        t0 = time.monotonic_ns()
        inject(fault_sites.SERVING_EGRESS_ENCODE)
        h, w = p.shape
        if p.fmt == "png":
            result = encode_png_mask(p.mask)
        elif p.fmt == "bits":
            result = encode_bits_wire(p.bits, h, w)
        elif p.fmt == "rle":
            mask = (p.mask if p.mask is not None
                    else np.unpackbits(p.bits, axis=1)[:, :w])
            result = encode_rle_wire(mask, h, w)
        else:
            raise ValueError(f"unknown egress encode format {p.fmt!r}")
        t1 = time.monotonic_ns()
        dt = (t1 - t0) / 1e9
        obs.ENCODE_SECONDS.labels(format=p.fmt).observe(dt)
        obs.HOST_STAGE_SPLIT.labels(stage="encode").observe(dt)
        obs.EGRESS_BYTES.labels(format=p.fmt).inc(len(result))
        tl = recorder_lib.Timeline("egress", labels={
            "format": p.fmt, "mode": "pool" if self.workers else "inline"})
        root = tl.span("egress", start_ns=t0, end_ns=t1)
        tl.span("encode", start_ns=t0, end_ns=t1, parent=root)
        self._recorder.record(tl)
        return result

    # -- caller side ----------------------------------------------------------

    def encode(self, fmt: str, *, mask: np.ndarray | None = None,
               bits: np.ndarray | None = None,
               shape: tuple[int, int] | None = None,
               timeout_s: float | None = None) -> bytes:
        """Encode one response mask payload, blocking until done: ``fmt``
        "png" (from ``mask``), "bits" (from ``bits``) or "rle" (from
        ``mask`` or ``bits``); ``shape`` the native (h, w), by default
        ``mask.shape``. A frame's failure raises to its caller only."""
        if shape is None:
            shape = tuple(mask.shape[:2])
        p = _PendingEncode(fmt, mask=mask, bits=bits, shape=shape)
        if self.workers == 0:
            self._run_one(p)
        else:
            with self._submit_lock:
                if self._stopped.is_set():
                    p.error = RuntimeError("encode pool stopped")
                    p.done.set()
                else:
                    with self._pending_lock:
                        self._pending.add(p)
                    self._q.put(p)
                    obs.EGRESS_QUEUE_DEPTH.set(self._q.qsize())
            wait_s = timeout_s if timeout_s is not None else 60.0
            if not p.done.wait(wait_s):
                p.error = DeadlineExceeded(
                    f"encode not ready within {wait_s:.2f}s")
            with self._pending_lock:
                self._pending.discard(p)
        if p.error is not None:
            raise p.error
        return p.result

    # -- worker side ----------------------------------------------------------

    def _run_one(self, p: _PendingEncode) -> None:
        try:
            p.result = self._encode_core(p)
        except BaseException as exc:  # deliver, keep the worker alive
            p.error = exc
        finally:
            p.done.set()
            with self._pending_lock:
                self._pending.discard(p)

    def _worker_loop(self) -> None:
        while True:
            p = self._q.get()
            obs.EGRESS_QUEUE_DEPTH.set(self._q.qsize())
            if p is None:
                return
            # outside the per-frame guard on purpose: a fault here kills
            # the worker itself (the watchdog's drill)
            inject(fault_sites.SERVING_EGRESS_LOOP)
            self._run_one(p)

    # -- watchdog -------------------------------------------------------------

    def _watch(self, interval_s: float) -> None:
        """Restart a worker that died outside its per-frame guard, and
        fail every pending frame now."""
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
                    "watchdog_restart", stage="egress",
                    error=f"{len(dead)} encode worker(s) died; "
                          f"{len(self._pending)} pending frame(s) failed")
                journal_lib.JOURNAL.append(
                    events.WATCHDOG_RESTART, stage="egress",
                    workers=len(dead), pending=len(self._pending))
                log.error(
                    "%d encode worker(s) died unexpectedly; failing %d "
                    "pending frame(s) and restarting (restart #%d)",
                    len(dead), len(self._pending), self.worker_restarts)
                _drain(self._q)
                obs.EGRESS_QUEUE_DEPTH.set(0)
                self._fail_pending(RuntimeError(
                    "encode worker died; frame dropped"))
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
        """Idempotent. Every pending encode gets an outcome."""
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
                p.error = RuntimeError("encode pool stopped")
                p.done.set()
        self._fail_pending(RuntimeError("encode pool stopped"))


def _drain(q: queue.Queue) -> list:
    """Everything ``q`` holds now, taken out."""
    items = []
    while True:
        try:
            items.append(q.get_nowait())
        except queue.Empty:
            return items
