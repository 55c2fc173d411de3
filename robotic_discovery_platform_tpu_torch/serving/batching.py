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
   enqueues the batched analyzer (``ops/pipeline.make_batch_analyzer(
   pack=True)``: on the card it copies the batch into the static inputs
   of the bucket's CUDA graph and replays it) and the one device-to-host
   copy of its ``[B, P]`` packed payload into a pooled pinned landing
   buffer, and records an event. It never waits on the device.
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

The coefficient lane (:meth:`BatchDispatcher.submit_coef`): a frame whose
color half is an entropy-decoded :class:`~serving.entropy.CoefficientFrame`
groups only with coefficient frames of the same geometry and subsampling,
stages its quantized planes and quant tables in pooled pinned buffers
(:class:`_CoefBucketBuffers`), and runs the analyzer that the
``coef_analyzer_factory`` builds for that geometry
(``ops/pipeline.make_coef_batch_analyzer(pack=True)``: the decode on the
device ahead of the analyzer), with the same admission, deadlines and one
packed device-to-host copy per dispatch.

An analyzer without the pack stage (``ServerConfig.egress_pack=False``)
returns a :class:`~ops.pipeline.FrameAnalysis` per dispatch: each leaf is
copied back to the host on its own (no landing pool), and each frame gets
its row of every leaf.

On ``device="cpu"`` (the tests) there is no stream and no event: the
analyzer runs in the collector thread, and the completer copies its
result into the landing buffer.

Instruments, where the JAX package sets them: the queue depth, dispatch
sizes, in-flight dispatches and their overlap, the stage split (stage,
launch, complete) and the host split (admit, stage_host, h2d, launch,
device, d2h), the staging and landing pools' free sets, sheds by point,
watchdog restarts, and one flight-recorder timeline per dispatch (a
``submit`` span per frame with its trace ID, ``collect``, ``stage``,
``launch``, ``complete``; failed dispatches pinned). They read the host's
clock only: the completer already waits on the dispatch's event, and
nothing adds a device synchronisation or a read of a device tensor.

The model zoo (``serving/zoo.py``): :meth:`BatchDispatcher.bind_model`
registers another model's batched analyzer, and ``submit(model=name)``
routes a frame to it. Frames group by (model, geometry), so a dispatch
holds one model's frames only and replays that model's bucket graphs on
that model's graph cache stream (``ops/graphs.dedicated_stream``); a
model whose bucket was not captured at warm-up captures it at its first
dispatch, counted on the analyzer's ``capture_guard`` like every capture.
The placer (``ZooPlacer``) gets each submit's arrival; the service-time
estimate, the stale-shed valve and the per-model fault site
(``serving.model.<name>.dispatch``) are per model. ``warmed`` holds the
(model, chip, bucket) keys captured so far.

The reactive SLO controller (``serving/controller.py``) retunes the
dispatcher online: :meth:`~BatchDispatcher.set_max_inflight` (a new
in-flight window; dispatches in flight release the slots of theirs),
:meth:`~BatchDispatcher.set_window_ms` (read once per collect cycle),
:meth:`~BatchDispatcher.set_bucket_floor` (:meth:`~BatchDispatcher.
bucket_for` pads to at least the floor, clamped to ``max_batch`` and to
the buckets captured for the frame's model) and
:meth:`~BatchDispatcher.set_deadline_safety` (the stale shed compares the
model's service estimate times this factor with the headroom).

Chip quarantine (:class:`DeviceRouter`, the JAX package's placement
and quarantine over a ring of devices): ``round_robin`` placement
(``parallel/mesh.least_loaded``), a per-chip
:class:`~resilience.CircuitBreaker` over dispatch outcomes, the
quarantine of a chip whose breaker opens (never the last healthy one),
one half-open probe per quarantined chip, reinstatement on a successful
probe, ``on_health`` and the ``rdp_quarantined_chips`` /
``rdp_chip_quarantines_total`` instruments and ``chip.quarantine`` /
``chip.reinstate`` journal events, as in the JAX package. It does no
device work; ``analysis/explore.py`` drives it over a fake two-chip ring.
Not ported (ROADMAP queue 1 item 14): ``mode="sharded"`` and the mode
switch, and the dispatcher's ``router=`` (both raise
``NotImplementedError``).
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.observability import (
    events,
    instruments as obs,
    journal as journal_lib,
    recorder as recorder_lib,
    trace,
)
from robotic_discovery_platform_tpu_torch.ops import graphs
from robotic_discovery_platform_tpu_torch.parallel import mesh as mesh_lib
from robotic_discovery_platform_tpu_torch.resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    inject,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    sites as fault_sites,
)
from robotic_discovery_platform_tpu_torch.serving.admission import (
    DeadlineQueue,
    OverloadedError,
    ServiceTimeEstimator,
)
from robotic_discovery_platform_tpu_torch.serving.egress import PackedResult
from robotic_discovery_platform_tpu_torch.serving.entropy import (
    CoefficientFrame,
    block_grids,
)
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock

log = logging.getLogger(__name__)

__all__ = ["BatchDispatcher", "DeadlineExceeded", "DeviceRouter",
           "OverloadedError", "resolve_max_inflight"]

_INFLIGHT_ENV_VAR = "RDP_INFLIGHT"

DISPATCH_MODES = ("round_robin", "sharded")


def resolve_max_inflight(configured: int) -> int:
    """The effective in-flight-dispatch cap: ``RDP_INFLIGHT`` when set,
    else the configured value; never below 1 (1 = serial dispatch)."""
    raw = os.environ.get(_INFLIGHT_ENV_VAR)
    value = int(raw) if raw else int(configured)
    return max(1, value)


class DeviceRouter:
    """Placement and chip quarantine over a ring of devices (the JAX
    package's ``serving/batching.DeviceRouter`` in ``round_robin`` mode).

    Args:
        mesh: the devices to route over: a list of ``torch.device``s, or
            anything with a ``.devices`` array (``parallel/mesh.
            device_ring``).
        mode: "round_robin" (whole buckets onto the least-loaded chip).
            "sharded" is ROADMAP queue 1 item 14 and raises.
        breaker_failures / breaker_reset_s: per-chip quarantine circuit
            breakers (0 disables quarantine, the default). Only
            meaningful over more than one chip.
        on_health: ``(chip_index, serving: bool)`` callback invoked on
            quarantine and reinstatement.
        clock: injectable monotonic clock for the breakers.
    """

    def __init__(self, mesh, mode: str = "round_robin", *,
                 breaker_failures: int = 0, breaker_reset_s: float = 30.0,
                 on_health=None, clock=time.monotonic):
        self._check_mode(mode)
        self.mesh = mesh
        self.mode = mode
        self.ring = mesh_lib.device_ring(mesh)
        # -- chip quarantine state ------------------------------------------
        self.quarantine_enabled = (
            breaker_failures > 0 and len(self.ring) > 1
        )
        self.on_health = on_health
        self._qlock = checked_lock("batching.router.quarantine")
        self._quarantined: set[int] = set()  # guarded_by: _qlock
        # distinct models whose dispatches failed on each chip since its
        # last success: only failures spanning >= 2 models (or a
        # single-model dispatcher's failures) feed the chip's breaker, so
        # one broken zoo model never quarantines a healthy chip
        self._fail_models: dict[int, set[str]] = {}  # guarded_by: _qlock
        #: chips quarantined since construction (monotone; the gauge is
        #: the live set size)
        self.quarantines_total = 0  # guarded_by: _qlock
        self.breakers: list[CircuitBreaker] = []
        if self.quarantine_enabled:
            self.breakers = [
                CircuitBreaker(
                    failure_threshold=breaker_failures,
                    reset_timeout_s=breaker_reset_s,
                    name=f"serving.chip.{i}", clock=clock,
                )
                for i in range(len(self.ring))
            ]

    @staticmethod
    def _check_mode(mode: str) -> None:
        if mode not in DISPATCH_MODES:
            raise ValueError(
                f"unknown dispatch mode {mode!r}; expected one of "
                f"{DISPATCH_MODES}"
            )
        if mode == "sharded":
            raise NotImplementedError(
                "the sharded dispatch mode is ROADMAP queue 1 item 14; the "
                "port's router places round_robin only")

    @property
    def chips(self) -> int:
        return len(self.ring)

    def set_mode(self, mode: str) -> None:
        """The controller's mode actuator: round_robin is the only mode
        (the same mode is a no-op, as in the JAX router)."""
        self._check_mode(mode)

    def pick(self, loads, start: int = 0, allowed=None) -> int:
        """The ring position of the next round_robin dispatch, as the JAX
        dispatcher's ``_pick_chip`` chooses it: a quarantined chip whose
        half-open breaker admits a probe (within ``allowed``, the model's
        placement, when given) takes the dispatch, which is its probe;
        else the least-loaded placeable chip, ties walked in ring order
        from ``start``. The caller advances its cursor past the pick."""
        if self.quarantine_enabled:
            probe = self.probe_candidate()
            if probe is not None and (allowed is None or probe in allowed):
                return probe
            healthy = set(self.healthy_chips())
            placeable = (healthy if allowed is None
                         else (healthy & set(allowed)) or healthy)
        else:
            placeable = (set(range(len(self.ring))) if allowed is None
                         else set(allowed))
        return mesh_lib.least_loaded(
            [loads[i] if i in placeable else float("inf")
             for i in range(len(self.ring))], start)

    # -- quarantine ----------------------------------------------------------

    @property
    def quarantined(self) -> frozenset[int]:
        with self._qlock:
            return frozenset(self._quarantined)

    def healthy_chips(self) -> tuple[int, ...]:
        with self._qlock:
            return tuple(i for i in range(len(self.ring))
                         if i not in self._quarantined)

    def probe_candidate(self) -> int | None:
        """A quarantined chip whose half-open breaker admits a probe NOW,
        else None. The breaker holds the probe slot until the dispatch's
        outcome is recorded, so at most one probe rides each chip."""
        if not self.quarantine_enabled:
            return None
        with self._qlock:
            quarantined = sorted(self._quarantined)
        for i in quarantined:
            if self.breakers[i].allow():
                return i
        return None

    def failure_confined(self, chip: int, model: str) -> bool:
        """True when every recorded failure on ``chip`` since its last
        success came from ``model`` alone: a broken model rather than a
        broken chip."""
        with self._qlock:
            fails = self._fail_models.get(chip)
            return fails is not None and fails == {model}

    def record_result(self, chip: int, ok: bool,
                      exc: BaseException | None = None,
                      model: str = "", multi_model: bool = False) -> None:
        """Feed one dispatch outcome on ``chip`` into its breaker and
        apply the quarantine or reinstatement it implies. Under a zoo
        (``multi_model``) a failure counts toward the chip's breaker only
        once failures on that chip span two models."""
        if not self.quarantine_enabled or not (0 <= chip < len(self.ring)):
            return
        breaker = self.breakers[chip]
        if ok:
            with self._qlock:
                self._fail_models.pop(chip, None)
            breaker.record_success()
            with self._qlock:
                reinstated = chip in self._quarantined
                self._quarantined.discard(chip)
                live = len(self._quarantined)
            if reinstated:
                obs.QUARANTINED_CHIPS.set(live)
                journal_lib.JOURNAL.append(
                    events.CHIP_REINSTATE, chip=chip, quarantined=live)
                log.info("chip %d reinstated after successful probe "
                         "dispatch", chip)
                if self.on_health is not None:
                    self.on_health(chip, True)
            return
        with self._qlock:
            fails = self._fail_models.setdefault(chip, set())
            fails.add(model)
            chip_level = not multi_model or len(fails) >= 2
            already = chip in self._quarantined
            last_healthy = (not already
                            and len(self._quarantined) >= len(self.ring) - 1)
        if not chip_level:
            return
        if last_healthy:
            # never quarantine the last chip: a degraded ring still
            # serves; its breaker is left untouched
            log.warning(
                "chip %d dispatch failed (%s) but it is the last healthy "
                "chip; not quarantining", chip,
                exc if exc is not None else "unknown error",
            )
            return
        breaker.record_failure(exc)
        if breaker.state != "open":
            return
        with self._qlock:
            newly = chip not in self._quarantined
            self._quarantined.add(chip)
            if newly:
                self.quarantines_total += 1
            live = len(self._quarantined)
        if newly:
            obs.QUARANTINED_CHIPS.set(live)
            obs.CHIP_QUARANTINES.labels(chip=str(chip)).inc()
            journal_lib.JOURNAL.append(
                events.CHIP_QUARANTINE, chip=chip, quarantined=live,
                error=str(exc) if exc is not None else "unknown",
            )
            log.error(
                "chip %d quarantined after repeated dispatch failures "
                "(%s); failing its in-flight frames over to %d healthy "
                "chip(s)", chip,
                exc if exc is not None else "unknown error",
                len(self.ring) - live,
            )
            if self.on_health is not None:
                self.on_health(chip, False)


@dataclass(eq=False)
class _Pending:
    # [H, W, 3] uint8 pixels, or the coefficient half of a split decode
    # (the coefficient lane: the device decodes)
    frame_rgb: np.ndarray | CoefficientFrame
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
    # the submitting stream's span context, carried to the collector
    # thread so a dispatch's timeline names the traces it carried
    trace_ctx: Any = None
    # when the frame entered the queue (its timeline's "submit" span)
    submit_ns: int = field(default_factory=time.monotonic_ns)
    # the zoo model the frame is for ("" = the default model)
    model: str = ""


class _BucketBuffers:
    """One pooled set of host staging tensors for a (bucket, geometry)
    key, filled row by row in place. Pinned on a CUDA device, so the
    host-to-device copies run asynchronously on the dispatch stream; a
    set goes back to the pool only after the dispatch's event has passed,
    so a refill never races a copy still reading it. Depth rides as the
    z16 bit pattern in int16 (the analyzer widens it on the device)."""

    __slots__ = ("key", "frames", "depths", "intr", "scales", "_np")

    def __init__(self, key: tuple, template: _Pending, b: int, pin: bool):
        h, w = template.frame_rgb.shape[:2]
        self.key = key
        self.frames = torch.empty((b, h, w, 3), dtype=torch.uint8,
                                  pin_memory=pin)
        self.depths = torch.empty((b, h, w), dtype=torch.int16,
                                  pin_memory=pin)
        self.intr = torch.empty((b, 3, 3), dtype=torch.float32,
                                pin_memory=pin)
        self.scales = torch.empty((b,), dtype=torch.float32, pin_memory=pin)
        self._np = tuple(t.numpy() for t in self.tensors)

    @property
    def tensors(self) -> tuple:
        """The host tensors, in the analyzer's argument order."""
        return self.frames, self.depths, self.intr, self.scales

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


class _CoefBucketBuffers(_BucketBuffers):
    """The coefficient lane's pooled host staging for a (bucket, geometry,
    subsampling) key: the three quantized int16 coefficient planes, the
    per-frame quant tables widened to int32 (the device never computes
    in uint16), then depth, intrinsics and depth scale as for pixels.
    Pinned on a CUDA device; the pixels first exist on the device."""

    __slots__ = ("y", "cb", "cr", "qy", "qc")

    def __init__(self, key: tuple, template: _Pending, b: int, pin: bool):
        cf = template.frame_rgb
        (ybh, ybw), (cbh, cbw) = block_grids(cf.height, cf.width,
                                             cf.subsampling)

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self.key = key
        self.y = empty((b, ybh * ybw, 64), torch.int16)
        self.cb = empty((b, cbh * cbw, 64), torch.int16)
        self.cr = empty((b, cbh * cbw, 64), torch.int16)
        self.qy = empty((b, 64), torch.int32)
        self.qc = empty((b, 64), torch.int32)
        self.depths = empty((b, cf.height, cf.width), torch.int16)
        self.intr = empty((b, 3, 3), torch.float32)
        self.scales = empty((b,), torch.float32)
        self._np = tuple(t.numpy() for t in self.tensors)

    @property
    def tensors(self) -> tuple:
        return (self.y, self.cb, self.cr, self.qy, self.qc, self.depths,
                self.intr, self.scales)

    def fill(self, i: int, p: _Pending) -> None:
        cf = p.frame_rgb
        y, cb, cr, qy, qc, depths, intr, scales = self._np
        y[i] = cf.y
        cb[i] = cf.cb
        cr[i] = cf.cr
        qy[i] = cf.qy
        qc[i] = cf.qc
        depths[i] = np.asarray(p.depth, np.uint16).view(np.int16)
        intr[i] = p.intrinsics
        scales[i] = p.depth_scale


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
    # the dispatch's flight-recorder timeline and its root span, closed
    # and recorded by the completer
    timeline: Any = None
    root: Any = None
    model: str = ""  # the zoo model of the dispatch's frames


def _read_leaf(t: torch.Tensor) -> torch.Tensor:
    """One leaf of an unpacked result copied back to pinned host memory,
    started on the current stream (the dispatch's event covers it)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


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


def _shape_key(p: _Pending) -> tuple:
    """The staging layout of a frame: its camera geometry, and for a
    coefficient frame its subsampling."""
    f = p.frame_rgb
    if isinstance(f, CoefficientFrame):
        return ("coef", f.subsampling, f.height, f.width)
    return tuple(f.shape[:2])


def _group_key(p: _Pending) -> tuple:
    """Frames batch only with co-arrivals of the same model and camera
    geometry, and coefficient frames only with coefficient frames of the
    same subsampling: a dispatch is one model's by construction."""
    return (p.model, *_shape_key(p))


class BatchDispatcher:
    """Coalesce concurrent frame analyses into pipelined batched
    dispatches on one device.

    Args:
        analyze_batch: ``(frames [B,H,W,3] u8, depths [B,H,W] int16 z16
            pattern, intrinsics [B,3,3] f32, scales [B] f32) -> [B, P]
            uint8`` packed payload (``ops/pipeline.make_batch_analyzer(
            pack=True)`` around the model), called with the pooled
            staging tensors (pinned on the card) inside the dispatch
            stream; on the card also with ``finish=``, which it applies to
            the payload on the device and whose result it returns (an
            :class:`ops.pipeline.Analyzer`). It must not wait on its own
            result.
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
        model_label: the default model's name: the ``model`` label of its
            dispatch timelines, ``rdp_model_dispatches_total`` and its
            placer key.
        placer: a :class:`~serving.zoo.ZooPlacer` that each submit's
            arrival is recorded into (None: no zoo).
        flight_recorder: where dispatch timelines go (the process's
            recorder by default).
        coef_analyzer_factory: ``(height, width, subsampling) ->
            analyze(y, cb, cr, qy, qc, depths, intrinsics, scales) -> [B,
            P] uint8`` for coefficient-lane frames
            (``ops/pipeline.make_coef_batch_analyzer(pack=True)``, called
            as ``analyze_batch`` is), built on a geometry's first
            coefficient dispatch and kept; None fails coefficient
            frames.
    """

    def __init__(self, analyze_batch: Callable, window_ms: float = 2.0,
                 max_batch: int = 8, max_backlog: int = 64,
                 submit_timeout_s: float = 30.0,
                 watchdog_interval_s: float = 1.0, max_inflight: int = 2,
                 admission: str = "deadline",
                 device: str | torch.device = "cuda",
                 router=None, placer=None,
                 coef_analyzer_factory: Callable | None = None,
                 model_label: str = "default",
                 flight_recorder: recorder_lib.FlightRecorder | None = None):
        if router is not None:
            raise NotImplementedError(
                "routing the dispatcher over a DeviceRouter (multi-device "
                "dispatch) is ROADMAP queue 1 item 14")
        self.device = resolve_device(device)
        self._model_label = model_label or "default"
        self._placer = placer
        # the zoo's other models: name -> batched analyzer (bind_model).
        # Written before the model is served; the collector reads it
        # without a lock
        self._bindings: dict[str, Callable] = {}
        #: (model, chip, bucket) keys whose graph was captured, at warm-up
        #: or at the first dispatch (``("coef", b)`` for the coefficient
        #: lane's buckets)
        self.warmed: set[tuple] = set()  # guarded_by: _warm_lock
        self._warm_lock = threading.Lock()
        self._recorder = (flight_recorder if flight_recorder is not None
                          else recorder_lib.RECORDER)
        self._cuda = self.device.type == "cuda"
        # the dispatch stream: staging, the analyzer and the D2H copy of
        # every dispatch run on it, in launch order
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)
        self._analyze = analyze_batch
        self._coef_factory = coef_analyzer_factory
        # (height, width, subsampling) -> the coefficient lane's analyzer
        self._coef_analyzers: dict[tuple, Callable] = {}  # guarded_by: _coef_lock
        self._coef_lock = threading.Lock()
        self._window_s = window_ms / 1e3
        self._max_batch = max(1, int(max_batch))
        self._submit_timeout_s = submit_timeout_s
        self._max_inflight = max(1, int(max_inflight))
        #: best-case per-frame service time (staging -> result on the host)
        self.service_estimate = ServiceTimeEstimator()
        # consecutive stale sheds with no completion between: after 8 the
        # next frame rides anyway, so the estimate can refresh
        # (per model, as the estimate it refreshes)
        self._sheds_since_complete: dict[str, int] = {}  # guarded_by: _inflight_lock
        #: multiplier on the service estimate when the collector decides a
        #: deadline is unmeetable: the controller's level 2 raises it
        self.deadline_safety = 1.0
        #: controller-tuned floor of the padded bucket (1 = off)
        self.bucket_floor = 1
        # the queue calls back through a weak reference: a bound method
        # would make dispatcher and queue a cycle, and a stopped dispatcher
        # (a hot reload's old one, with its graphs) would then wait for the
        # garbage collector instead of going when its last user lets go
        this = weakref.ref(self)
        self._q = DeadlineQueue(
            max_backlog, policy=admission,
            on_evict=lambda p: this() is not None and this()._on_evicted(p))
        self._cq: queue.Queue[_Dispatch | None] = queue.Queue()
        self._slots = threading.Semaphore(self._max_inflight)  # guarded_by: _inflight_lock
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
        obs.SERVING_CHIPS.set(1)
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
               timeout_s: float | None = None,
               model: str = "") -> PackedResult:
        """Block until this frame's result is back; returns its
        :class:`PackedResult` row (call ``release`` when done with it).
        ``model`` names a bound zoo model ("" = the default); a frame
        batches only with its own model's co-arrivals.

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
        return self._submit_frame(frame_rgb, depth, intrinsics, depth_scale,
                                  timeout_s, model)

    def submit_coef(self, frame: CoefficientFrame, depth, intrinsics,
                    depth_scale, timeout_s: float | None = None,
                    model: str = "") -> PackedResult:
        """:meth:`submit` for the coefficient lane: the color half is an
        entropy-decoded :class:`~serving.entropy.CoefficientFrame` whose
        pixels are decoded on the device ahead of the analyzer. Admission,
        deadlines and the result are :meth:`submit`'s; frames group by
        geometry and subsampling and never mix with pixel frames. The lane
        serves the default model only, as in the JAX package."""
        if not isinstance(frame, CoefficientFrame):
            raise TypeError(
                f"submit_coef wants a CoefficientFrame, got "
                f"{type(frame).__name__}; pixel arrays ride submit()")
        if model:
            raise ValueError(
                "the coefficient lane serves the default model only; "
                f"model {model!r} frames must use pixel formats")
        depth = np.asarray(depth)
        if depth.shape != (frame.height, frame.width):
            raise ValueError(
                f"depth shape {depth.shape} != frame geometry "
                f"({frame.height}, {frame.width})")
        return self._submit_frame(frame, depth, intrinsics, depth_scale,
                                  timeout_s)

    def _submit_frame(self, frame_rgb, depth, intrinsics, depth_scale,
                      timeout_s: float | None,
                      model: str = "") -> PackedResult:
        if model and model not in self._bindings:
            raise ValueError(
                f"unknown model {model!r}; bound: {self.bound_models()}")
        if self._placer is not None:
            self._placer.record_arrival(self._display_model(model))
        timeout = self._submit_timeout_s
        if timeout_s is not None:
            timeout = min(timeout, timeout_s)
        p = _Pending(frame_rgb, depth, _intrinsics_f32(intrinsics),
                     float(depth_scale),
                     deadline_t=time.monotonic() + timeout,
                     trace_ctx=trace.current(), model=model)
        # enqueue under the lock stop() drains under: a submit lands before
        # the drain (and is failed by it) or sees stopped and raises
        with self._submit_lock:
            if self._stopped.is_set():
                raise RuntimeError("dispatcher stopped")
            with self._pending_lock:
                self._pending.add(p)
            try:
                self._q.put(p, margin_s=(self.service_estimate.s_for(model)
                                         * self.deadline_safety))
            except OverloadedError:
                with self._pending_lock:
                    self._pending.discard(p)
                raise
            obs.BATCH_QUEUE_DEPTH.set(self._q.qsize())
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

    def bind_model(self, name: str, analyze_batch: Callable) -> None:
        """Register another zoo model's batched analyzer (called as
        ``analyze_batch`` is) so that ``submit(model=name)`` routes to it.
        Call before that model is served."""
        if not name:
            raise ValueError("the default model is bound at construction")
        self._bindings[name] = analyze_batch

    def bound_models(self) -> tuple[str, ...]:
        """Every model key this dispatcher routes ("" = the default)."""
        return ("", *self._bindings)

    def _display_model(self, model: str) -> str:
        """A model key's name in labels and placer keys."""
        return model or self._model_label

    def _analyze_for(self, model: str) -> Callable:
        return self._bindings[model] if model else self._analyze

    def _on_evicted(self, p: _Pending) -> None:
        """DeadlineQueue eviction callback (runs under the queue lock)."""
        p.error = OverloadedError(
            "frame evicted at the backlog cap: least remaining deadline "
            "headroom; shedding load")
        p.done.set()
        obs.SHED_BY_DEADLINE.labels(point="evicted").inc()
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

    def set_max_inflight(self, n: int) -> None:
        """The controller's AIMD knob: a new in-flight window of ``n``
        slots. Dispatches in flight hold and release the slot object of
        the window they launched in, so a shrink holds from the next
        launch and the old window drains on its own."""
        n = max(1, int(n))
        with self._inflight_lock:
            if n == self._max_inflight:
                return
            old = self._max_inflight
            self._max_inflight = n
            self._pool_cap = n + 1
            # a new epoch: a fresh semaphore, not a resized one
            self._slots = threading.Semaphore(n)
        log.info("max_inflight retuned: %d -> %d", old, n)

    @property
    def window_ms(self) -> float:
        return self._window_s * 1e3

    def set_window_ms(self, window_ms: float) -> None:
        """The batch window, read once per collect cycle."""
        self._window_s = max(0.0, float(window_ms)) / 1e3

    def set_bucket_floor(self, floor: int) -> None:
        """Pad dispatches up to at least this bucket (1 = off); clamped by
        :meth:`bucket_for`."""
        self.bucket_floor = max(1, int(floor))

    def set_deadline_safety(self, factor: float) -> None:
        """How early the collector sheds against the service estimate
        (the brownout's level 2 raises it)."""
        self.deadline_safety = max(1.0, float(factor))

    def backlog(self) -> int:
        """Frames queued for the collector."""
        return self._q.qsize()

    def analyzers(self) -> list:
        """The analyzers dispatches go to: the default model's pixel lane,
        each bound model's, then each coefficient geometry's built so
        far."""
        with self._coef_lock:
            return [self._analyze, *self._bindings.values(),
                    *self._coef_analyzers.values()]

    def bucket_for(self, n: int, model: str = "") -> int:
        """The padded bucket a group of ``n`` frames of ``model``
        dispatches as: the power of two at or above ``n``, capped at
        ``max_batch``, and never below the controller's ``bucket_floor``
        (clamped to ``max_batch``) where the floor's bucket has been
        captured for ``model`` (a raised floor never makes a live frame
        wait on a capture; below that, the largest captured bucket under
        the floor)."""
        b = _bucket(n, self._max_batch)
        floor = _bucket(min(self.bucket_floor, self._max_batch),
                        self._max_batch)
        if floor <= b:
            return b
        with self._warm_lock:
            captured = {k[2] for k in self.warmed
                        if k[0] == model and isinstance(k[2], int)}
        raised = [c for c in captured if b < c <= floor]
        return max(raised) if raised else b

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
                obs.WATCHDOG_RESTARTS.inc()
                # pinned: the evidence outlives the traffic that follows
                self._recorder.record_event(
                    "watchdog_restart", stage=dead,
                    error=f"batch {dead} thread died; "
                          f"{len(self._pending)} pending frame(s) failed")
                journal_lib.JOURNAL.append(
                    events.WATCHDOG_RESTART, stage=dead,
                    pending=len(self._pending))
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
                with self._inflight_lock:
                    self._slots = threading.Semaphore(self._max_inflight)
                    self._inflight = 0
                    self._sheds_since_complete.clear()
                    obs.INFLIGHT_DISPATCHES.set(0)
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
            obs.SHED_BY_DEADLINE.labels(point="abandoned").inc()
            with self._pending_lock:
                self._pending.discard(p)
            return False
        if p.deadline_t is not None and self._q.policy == "deadline":
            # the frame's own model's estimate: one model's rides never
            # set another's sheds
            est = self.service_estimate.s_for(p.model) * self.deadline_safety
            slack = p.deadline_t - time.monotonic()
            if est > 0 and slack < est:
                with self._inflight_lock:
                    if self._sheds_since_complete.get(p.model, 0) >= 8:
                        return True  # probe: refresh the estimate
                    self._sheds_since_complete[p.model] = (
                        self._sheds_since_complete.get(p.model, 0) + 1)
                obs.SHED_BY_DEADLINE.labels(point="stale").inc()
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
            obs.BATCH_QUEUE_DEPTH.set(self._q.qsize())
            if not batch:
                continue
            # outside the launch guard on purpose: a fault here kills the
            # collector itself (the watchdog's drill)
            inject(fault_sites.SERVING_BATCH_COLLECT)
            collected_ns = time.monotonic_ns()
            groups: dict[tuple, list[_Pending]] = {}
            for p in batch:
                groups.setdefault(_group_key(p), []).append(p)
            for group in groups.values():
                self._launch_group(group, collected_ns)

    def _pool_take(self, b: int, template: _Pending) -> _BucketBuffers:
        """A pooled staging set for ``b`` frames like ``template``."""
        key = (b, *_shape_key(template))
        with self._pool_lock:
            free = self._pool.get(key)
            if free:
                bufs = free.pop()
                obs.BATCH_POOL_SIZE.set(
                    sum(len(v) for v in self._pool.values()))
                return bufs
        cls = (_CoefBucketBuffers
               if isinstance(template.frame_rgb, CoefficientFrame)
               else _BucketBuffers)
        return cls(key, template, b, pin=self._cuda)

    def _pool_put(self, bufs: _BucketBuffers | None) -> None:
        if bufs is None:
            return
        with self._pool_lock:
            free = self._pool.setdefault(bufs.key, [])
            if len(free) < self._pool_cap:
                free.append(bufs)
            obs.BATCH_POOL_SIZE.set(sum(len(v) for v in self._pool.values()))

    def _egress_take(self, shape: tuple) -> torch.Tensor:
        """A pooled landing buffer for one dispatch's [B, P] payload."""
        with self._pool_lock:
            free = self._egress_pool.get(shape)
            if free:
                buf = free.pop()
                obs.EGRESS_POOL_SIZE.set(
                    sum(len(v) for v in self._egress_pool.values()))
                return buf
        return torch.empty(shape, dtype=torch.uint8, pin_memory=self._cuda)

    def _egress_put(self, buf: torch.Tensor) -> None:
        """Return a fully released landing buffer (called by the last
        ``PackedResult.release``, usually on a handler thread)."""
        with self._pool_lock:
            free = self._egress_pool.setdefault(tuple(buf.shape), [])
            if len(free) < self._pool_cap:
                free.append(buf)
            obs.EGRESS_POOL_SIZE.set(
                sum(len(v) for v in self._egress_pool.values()))

    def _stage_group(self, group: list[_Pending], b: int) -> _BucketBuffers:
        """The group's rows in a pooled staging set, padded to ``b`` rows
        with replicas of the first frame."""
        bufs = self._pool_take(b, group[0])
        for i, p in enumerate(group):
            bufs.fill(i, p)
        bufs.pad(len(group))
        return bufs

    def _coef_analyze_for(self, frame: CoefficientFrame) -> Callable:
        """The coefficient lane's analyzer for ``frame``'s geometry and
        subsampling, built through ``coef_analyzer_factory`` on first use
        and kept."""
        key = (frame.height, frame.width, frame.subsampling)
        with self._coef_lock:
            analyze = self._coef_analyzers.get(key)
        if analyze is not None:
            return analyze
        if self._coef_factory is None:
            raise ValueError(
                "coefficient-lane frame dispatched but no "
                "coef_analyzer_factory is bound (the servicer binds "
                "ops/pipeline.make_coef_batch_analyzer)")
        analyze = self._coef_factory(*key)
        with self._coef_lock:
            return self._coef_analyzers.setdefault(key, analyze)

    def _enqueue(self, bufs: _BucketBuffers, template: _Pending):
        """Analyze one staged batch of frames like ``template`` and start
        the D2H copy of its payload; returns (out, host, event). Never
        waits on the device.

        On the card the analyzer copies the pinned staging tensors into
        its (bucket, geometry) graph's static inputs, replays the graph
        and runs :meth:`_land`, all on its cache's stream under the
        cache's lock (that stream first waits for the dispatch stream, and
        the dispatch stream then waits for it). So with ``max_inflight >
        1``, dispatch N+1's input copy follows dispatch N's D2H copy of its
        output on that one stream, and the dispatch's event covers the
        copies out of the staging buffers and into the landing buffer."""
        analyze = (self._coef_analyze_for(template.frame_rgb)
                   if isinstance(bufs, _CoefBucketBuffers)
                   else self._analyze_for(template.model))
        if not self._cuda:
            return analyze(*bufs.tensors), None, None
        with torch.cuda.stream(self._stream):
            host = analyze(*bufs.tensors, finish=self._land)
            event = torch.cuda.Event()
            event.record(self._stream)
        return None, host, event

    def _land(self, out):
        """The analyzer's ``finish`` on the card: the D2H copy of a
        dispatch's ``[B, P]`` payload into a pooled pinned landing buffer,
        or of an unpacked result's every leaf into pinned host tensors of
        its own, started on the current stream."""
        if not isinstance(out, torch.Tensor):
            return graphs.tree_map(_read_leaf, out)
        host = self._egress_take(tuple(out.shape))
        host.copy_(out, non_blocking=True)
        return host

    def warm(self, frames, depths, intrinsics, scales,
             model: str = "") -> None:
        """Run ``model``'s analyzer once at this batch shape and wait for
        it, so the first live dispatch of the bucket pays no first-use
        costs: on the card, the bucket's graph is captured here."""
        self._warm([_Pending(f, d, _intrinsics_f32(k), float(s),
                             model=model)
                    for f, d, k, s in zip(frames, depths, intrinsics,
                                          scales)])
        with self._warm_lock:
            self.warmed.add((model, 0, len(frames)))

    def warm_coef(self, frame: CoefficientFrame, depths, intrinsics,
                  scales) -> None:
        """:meth:`warm` for the coefficient lane: ``frame`` replicated over
        the batch of ``len(depths)`` rows, through the analyzer that live
        coefficient dispatches of its geometry use."""
        self._warm([_Pending(frame, d, _intrinsics_f32(k), float(s))
                    for d, k, s in zip(depths, intrinsics, scales)])
        with self._warm_lock:
            self.warmed.add(("", 0, ("coef", len(depths))))

    def _warm(self, group: list[_Pending]) -> None:
        bufs = self._stage_group(group, len(group))
        try:
            out, host, event = self._enqueue(bufs, group[0])
            if event is not None:
                event.synchronize()
                if isinstance(host, torch.Tensor):
                    self._egress_put(host)
            elif isinstance(out, torch.Tensor):
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

    def _launch_group(self, group: list[_Pending],
                      collected_ns: int | None = None) -> None:
        """Stage + async launch of one geometry group, then hand the
        in-flight dispatch to the completer. Never waits on the result."""
        if collected_ns is None:
            collected_ns = time.monotonic_ns()
        slot = self._slots
        while not slot.acquire(timeout=0.05):
            if self._stopped.is_set():
                self._fail_group(group, RuntimeError("dispatcher stopped"),
                                 log_it=False)
                return
        # the dispatch's timeline: the root opens at the earliest frame's
        # submit; a "submit" span per frame (queue and window wait)
        # carries its trace ID
        first_submit_ns = min(p.submit_ns for p in group)
        model = group[0].model
        label = self._display_model(model)
        tl = recorder_lib.Timeline("dispatch", labels={
            "chip": "0", "mode": "single", "model": label})
        root = tl.span("dispatch", start_ns=first_submit_ns)
        tl.span("collect", start_ns=first_submit_ns, end_ns=collected_ns,
                parent=root, frames=len(group))
        for p in group:
            tl.span("submit", start_ns=p.submit_ns, end_ns=collected_ns,
                    parent=root,
                    trace_id=(p.trace_ctx.trace_id
                              if p.trace_ctx is not None else None))
        bufs = None
        launched = False
        try:
            inject(fault_sites.SERVING_BATCH_DISPATCH)
            # the per-model site: a dispatch holds one model's frames, so
            # it fails that model's frames only
            inject(fault_sites.model_dispatch(label))
            n = len(group)
            obs.BATCH_SIZE.observe(n)
            coef = isinstance(group[0].frame_rgb, CoefficientFrame)
            b = self.bucket_for(n, model)
            tl.labels["bucket"] = str(b)
            for p in group:
                obs.HOST_STAGE_SPLIT.labels(stage="admit").observe(
                    max(0, collected_ns - p.submit_ns) / 1e9)
            t0 = time.monotonic_ns()
            bufs = self._stage_group(group, b)
            t_fill = time.monotonic_ns()
            out, host, event = self._enqueue(bufs, group[0])
            t2 = time.monotonic_ns()
            # the analyzer call enqueues the batch's host-to-device copies
            # and then the replay: the graph cache stamps the boundary
            t1 = min(max(graphs.inputs_ready_ns() or t_fill, t_fill), t2)
            tl.span("stage", start_ns=t0, end_ns=t1, parent=root)
            tl.span("launch", start_ns=t1, end_ns=t2, parent=root)
            obs.BATCH_STAGE_LATENCY.labels(stage="stage").observe(
                (t1 - t0) / 1e9)
            obs.BATCH_STAGE_LATENCY.labels(stage="launch").observe(
                (t2 - t1) / 1e9)
            obs.HOST_STAGE_SPLIT.labels(stage="stage_host").observe(
                (t_fill - t0) / 1e9)
            obs.HOST_STAGE_SPLIT.labels(stage="h2d").observe(
                (t1 - t_fill) / 1e9)
            obs.HOST_STAGE_SPLIT.labels(stage="launch").observe(
                (t2 - t1) / 1e9)
            with self._inflight_lock:
                self._inflight += 1
                self.inflight_high_water = max(self.inflight_high_water,
                                               self._inflight)
                self.dispatch_sizes[n] += 1
                obs.INFLIGHT_DISPATCHES.set(self._inflight)
            obs.MODEL_DISPATCHES.labels(model=label).inc()
            self._cq.put(_Dispatch(group, out, host, event, bufs, slot,
                                   t2 / 1e9, b, t0 / 1e9, tl, root, model))
            launched = True
            with self._warm_lock:
                self.warmed.add((model, 0, ("coef", b) if coef else b))
        except BaseException as exc:  # deliver, keep the collector alive
            # the failed dispatch's timeline is evidence: record() pins it
            root.end()
            self._recorder.record(tl.fail(exc))
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
            pop_ns = time.monotonic_ns()
            t_ready = pop_ns / 1e9
            try:
                inject(fault_sites.SERVING_BATCH_COMPLETE)
                if d.event is not None:
                    d.event.synchronize()  # waits with the GIL released
                    t_ready = time.monotonic()
                    host = d.host
                elif isinstance(d.out, tuple):
                    host = d.out  # an unpacked result, on the host already
                else:
                    fetched = np.asarray(d.out)
                    t_ready = time.monotonic()
                    host = self._egress_take(fetched.shape)
                    np.copyto(host.numpy(), fetched)
                if isinstance(host, torch.Tensor):
                    self._fan_out_rows(d.group, host)
                else:
                    # unpacked: each frame its row of every leaf
                    for i, p in enumerate(d.group):
                        p.result = graphs.tree_map(
                            lambda a, _i=i: a[_i], host)
                        p.done.set()
                self.service_estimate.observe(time.monotonic() - d.staged_t,
                                              key=(d.model, d.bucket))
                with self._inflight_lock:
                    self._sheds_since_complete[d.model] = 0
            except BaseException as exc:  # deliver, keep draining
                if d.timeline is not None:
                    d.timeline.fail(exc)
                self._fail_group(d.group, exc)
            finally:
                done_ns = time.monotonic_ns()
                done_t = done_ns / 1e9
                if d.timeline is not None:
                    d.timeline.span("complete", start_ns=pop_ns,
                                    end_ns=done_ns, parent=d.root)
                    d.root.end(done_ns)
                    # record() pins a timeline an error marked
                    self._recorder.record(d.timeline)
                # how long the previous dispatch was still completing after
                # this one launched (0 in serial mode)
                overlap = max(0.0, self._last_done_t - d.launch_t)
                self._last_done_t = done_t
                self.overlap_s_total += overlap
                obs.DISPATCH_OVERLAP.observe(overlap)
                obs.BATCH_STAGE_LATENCY.labels(stage="complete").observe(
                    done_t - pop_ns / 1e9)
                # launch -> result on the host is the device's ride; ready
                # -> done the copy back and the fan-out
                obs.HOST_STAGE_SPLIT.labels(stage="device").observe(
                    max(0.0, t_ready - d.launch_t))
                obs.HOST_STAGE_SPLIT.labels(stage="d2h").observe(
                    max(0.0, done_t - t_ready))
                self._pool_put(d.bufs)
                with self._inflight_lock:
                    self._inflight = max(0, self._inflight - 1)
                    obs.INFLIGHT_DISPATCHES.set(self._inflight)
                d.slot.release()

    def _fan_out_rows(self, group: list[_Pending], host: torch.Tensor) -> None:
        """Each frame its :class:`PackedResult` row of the landing buffer;
        the last release returns the buffer to the pool."""
        rows = host.numpy()
        share = _EgressStaging(host, len(group), self._egress_put)
        for i, p in enumerate(group):
            if p.done.is_set() or p.abandoned:
                share.release_one()  # nobody will read this row
                continue
            p.result = PackedResult(rows[i], release=share.release_one)
            p.done.set()

    def _fail_group(self, group: list[_Pending], exc: BaseException,
                    log_it: bool = True) -> None:
        if log_it:
            log.error("batched dispatch of %d frame(s) failed: %s: %s",
                      len(group), type(exc).__name__, exc)
        for p in group:
            if not p.done.is_set():
                p.error = exc
                p.done.set()
