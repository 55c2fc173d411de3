"""The vision analysis servicer.

The port of the JAX package's ``serving/server.py`` ``_analyze_frame``
and the per-stream loop of ``_stream_frames``: each request is decoded
(``serving/ingest.DecodePool``: inline, or ``decode_workers`` threads
reading ahead ``ingest_prefetch`` requests a stream), analyzed on the
device with its camera geometry from the servicer's ``GeometryCache``,
its mask encoded in the requested wire format (``serving/egress.
EncodePool``: inline, or ``egress_workers`` threads, on either path),
and answered with status ``"OK"``, ``"DEGRADED: insufficient geometry"``
or ``"ERROR: <Type>: <message> [trace=<id>]"``; a failing frame never
ends its stream. Every answered frame appends one row to the metrics CSV.

Two paths, as in the JAX package: with ``ServerConfig.batch_window_ms``
at 0 (the default) each frame runs the single-frame analyzer
(:func:`ops.pipeline.make_frame_analyzer` around the folded U-Net,
``pack=True``) in its handler thread: on the card its camera geometry's
CUDA graph replays under the graph's lock and the frame's packed row comes
back in one device-to-host copy before the lock is released; above 0,
frames of concurrent streams meet in the batch dispatcher
(``serving/batching.py``; ``batch_impl`` "dense" runs one forward over the
batch, "scan" the frame path once per frame) and come back as packed rows,
or with ``egress_pack=False`` as one unpacked
:class:`~ops.pipeline.FrameAnalysis` row per frame. The response fields
are read off either alike.
Coefficient frames (``Image.format = 2``, or baseline JPEGs under
``ServerConfig.onchip_decode``) take the coefficient lane on either path:
the single-frame coefficient analyzer
(``ops/pipeline.make_coef_frame_analyzer``) or the dispatcher's
``submit_coef``; their pixels are decoded on the device. A dispatcher at
its backlog cap ends the stream with
:class:`serving.admission.OverloadedError` (the gRPC adapter answers
RESOURCE_EXHAUSTED).

The core, :meth:`VisionAnalysisService.analyze_stream`, maps an iterator
of :class:`serving.messages.AnalysisRequest` to an iterator of
:class:`serving.messages.AnalysisResponse` and needs neither grpc nor
protobuf; ``serving/grpc_service.py`` puts it behind a gRPC server.

**Generations.** Everything a frame touches -- the served forward, the
untransformed net of the precision tier's gate, the direct analyzers and
the dispatcher -- is one immutable :class:`Engine`. A frame reads
``self._engine`` once and uses only that; a hot reload swaps it under
``_reload_lock``. :func:`build_service` makes a servicer from the
settings alone: with no forward it loads the registered model
(:func:`resolve_serving_model`: the ``model_alias`` version first, else
the latest), transforms it for the precision tier
(``ServerConfig.precision`` or ``RDP_PRECISION``, ``ops/quant.py``) and
folds it onto the kernels. A bf16 or int8 tier must pass its parity gate
at the end of :meth:`VisionAnalysisService.warmup` (golden frames through
the untransformed net against the served path) or the servicer refuses to
come up.

**Hot reload** (:meth:`VisionAnalysisService.start_reloader`,
:meth:`~VisionAnalysisService.maybe_reload`, as in the JAX package): the
registry is polled every ``reload_poll_s`` through a circuit breaker
(``resilience/breaker.py``); when the version moves, the new generation is
loaded, transformed for the tier again and folded, and its graphs are
warmed and captured off the serving path while live traffic replays the
old generation's graphs; then it is swapped in atomically, and the old
dispatcher is stopped ``reload_grace_s`` later. Each graph cache captures
on a stream of its own (``ops/graphs.dedicated_stream``), so a new
generation never captures on a stream that a live cache replays on, and
once the old generation's grace period has passed and its in-flight
frames are done nothing holds its graphs, static buffers or weights; the
poller's next round returns their graph pools' memory to the card. Like
the JAX reload, a reload does not run the tier's parity gate again: only
:meth:`warmup` gates (ROADMAP queue 3). A reload that fails keeps the
current generation. A servicer over a caller's own forward has no
registry version and never reloads.

**Readiness and drain**: a grpc.health.v1 status registry
(``serving/health.py``) reads NOT_SERVING until warm-up (or, with no
warm-up, until :func:`serving.grpc_service.build_server` marks the
service ready) and again once :meth:`VisionAnalysisService.drain` begins;
a draining or closed service refuses new streams
(:class:`StreamRefusedError`; the gRPC adapter answers UNAVAILABLE).

**Instruments** (``observability/instruments.py``): in-flight streams,
frames by status, per-stage latency (decode, device, encode, total) as
histograms and streaming summaries, end-to-end latency, the SLO tracker
when ``slo_ms > 0``, a ``serving.stream`` span per stream whose trace ID
stamps the stream's log lines and error statuses, the serving precision
and the tier gate's report. The "device" stage is the host's clock around
the packed row's read-back, which waits for the device already: no
instrument adds a device synchronisation or a read of a device tensor to
a frame. The dispatcher, the decode and encode pools and the geometry
cache set their own (``serving/batching.py``, ``serving/ingest.py``,
``serving/egress.py``).

**Drift** (``monitoring/profile.py``; ``ServerConfig.drift_*``, on by
default as in the JAX package): every answered frame's five signals --
mask coverage, mean and max curvature, the depth-valid fraction of the
host depth frame and the confidence margin, all read off the packed row
the frame already brought back -- feed a :class:`DriftMonitor` after the
response is built, on the direct and the batched path alike, and the
margin feeds ``rdp_model_confidence_margin``. The reference is the
configured profile (``drift_profile_path`` or ``RDP_DRIFT_PROFILE``),
else the served registry version's ``drift_profile.json``, else a
self-baseline over the first frames; a hot reload adopts the new
version's reference in the same critical section as the engine swap.
Sustained drift fires one recommendation per excursion: counted
(``rdp_drift_recommendations_total``), journaled, pinned in the flight
recorder and logged; ``GET /debug/drift`` serves ``drift_debug``. The
monitor adds no device work, synchronisation or copy to a frame. With a rollout
manager attached (:attr:`VisionAnalysisService.rollout`, ``serving/
rollout.attach_rollout``) the recommendation is handed to it.

**The model zoo** (``serving/zoo.py``, ``models/variants.py``;
``ServerConfig.zoo_*``): ``zoo_models`` names the variants served beside
the default model, each loaded from its own registry entry, transformed
for the tier by :func:`tier_forward` as the default model is (the JAX
package runs its extras on the unfused forward because its fused net binds
one model's weights; the port's :class:`~ops.unet_infer.FoldedUNet` is
built per model, so that reason does not carry over), with its own
analyzers and graph caches, its own parity gate, drift monitor and SLO
tracker, and on the batched path bound onto the shared dispatcher
(:meth:`~serving.batching.BatchDispatcher.bind_model`; a hot reload binds
them again on the new generation's dispatcher). A request's ``model``
field picks the entry per frame: "" and the default's name take the
default path unchanged, an unknown name answers that frame with
``ERROR: UnknownModel`` and the stream goes on, and an ``anomaly`` head
adds `` anomaly=<score>`` to the status. Extras capture the one-frame
bucket at warm-up (``zoo_eager_warm``; negative: every bucket).
``GET /debug/zoo`` serves :meth:`VisionAnalysisService.zoo_debug`.

**The reactive SLO controller** (``serving/controller.py``;
``controller_enabled`` or ``RDP_CONTROLLER``, with ``slo_ms > 0`` and
batching on): it reads the SLO tracker's burn and retunes the live
generation's dispatcher, read through a callable so a hot reload's swap
never leaves it on a stopped dispatcher; its rung 3 makes
:meth:`VisionAnalysisService._enter_stream` refuse every other new stream
(:class:`StreamRefusedError`, UNAVAILABLE over gRPC).

**The rollout's surface** (``serving/rollout.py``):
:meth:`VisionAnalysisService.set_draining` refuses new streams while
health stays SERVING (apart from the shutdown :meth:`~VisionAnalysisService.
drain`), and :meth:`~VisionAnalysisService.set_shadow` installs a tap that
gets each default-model pixel frame's inputs and outputs after its
response is built (a failing tap never fails the frame).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
import time
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import load_calibration
from robotic_discovery_platform_tpu_torch.models import (
    variants as variants_lib,
)
from robotic_discovery_platform_tpu_torch.models.unet import (
    UNet,
    eval_on_kernels,
)
from robotic_discovery_platform_tpu_torch.monitoring import (
    profile as profile_lib,
)
from robotic_discovery_platform_tpu_torch.observability import (
    events,
    instruments as obs,
    journal as journal_lib,
    recorder as recorder_lib,
    slo as slo_lib,
    trace,
)
from robotic_discovery_platform_tpu_torch.ops import graphs, pipeline, quant
from robotic_discovery_platform_tpu_torch.ops.pipeline import Analyzer
from robotic_discovery_platform_tpu_torch.ops.unet_infer import (
    FoldedUNet,
    reference_forward,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceeded,
    inject,
)
from robotic_discovery_platform_tpu_torch.resilience import (
    sites as fault_sites,
)
from robotic_discovery_platform_tpu_torch.serving import (
    controller as controller_lib,
    egress,
    entropy,
    health as health_lib,
    ingest,
    rollout as rollout_lib,
    zoo as zoo_lib,
)
from robotic_discovery_platform_tpu_torch.serving.admission import (
    OverloadedError,
)
from robotic_discovery_platform_tpu_torch.serving.batching import (
    BatchDispatcher,
    resolve_max_inflight,
)
from robotic_discovery_platform_tpu_torch.serving.messages import (
    AnalysisResponse,
    Point3D,
)
from robotic_discovery_platform_tpu_torch.serving.metrics import MetricsWriter
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ServerConfig,
    check_supported,
)
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger
from robotic_discovery_platform_tpu_torch.utils.profiling import StageTimer

log = get_logger(__name__)

STATUS_OK = "OK"
STATUS_DEGRADED = "DEGRADED: insufficient geometry"
#: the service name ``serving/proto/vision_grpc.py`` registers
VISION_SERVICE = "evofab.vision.VisionAnalysisService"
#: the default zoo model's name (``models/variants.DEFAULT_MODEL``): the
#: ``model`` label of the default model's frames
MODEL_LABEL = variants_lib.DEFAULT_MODEL


class StreamRefusedError(RuntimeError):
    """A new stream on a draining, closed or browned-out service: the
    client retries against another replica (the gRPC adapter answers
    UNAVAILABLE)."""


def resolve_serving_version(cfg: ServerConfig,
                            store: tracking.FileStore | None = None) -> int:
    """The registry version a server runs: ``cfg.model_alias``'s when that
    alias is set, else the latest of ``cfg.model_name``. Raises KeyError
    when the model has no version. ``store`` defaults to one scoped to
    ``cfg.tracking_uri`` (the process-global tracking URI is left alone:
    the reload poller calls this from its own thread). The
    ``serving.resolve`` fault site (``RDP_FAULTS``) fires here."""
    inject(fault_sites.SERVING_RESOLVE)
    store = tracking.store_for(cfg.tracking_uri) if store is None else store
    version = store.get_alias(cfg.model_name, cfg.model_alias)
    if version is not None:
        return int(version)
    return int(store.latest_version(cfg.model_name)["version"])


def resolve_serving_model(cfg: ServerConfig,
                          device: str | torch.device = "cuda"):
    """Load the model a server runs (:func:`resolve_serving_version`):
    returns ``(ModelConfig, UNet on device in eval mode, version)``."""
    store = tracking.store_for(cfg.tracking_uri)
    version = resolve_serving_version(cfg, store)
    uri = f"models:/{cfg.model_name}/{version}"
    model_cfg, net = tracking.load_model(uri, store=store, device=device)
    log.info("loaded %s from %s (alias %r first)", uri, cfg.tracking_uri,
             cfg.model_alias)
    return model_cfg, net, version


def tier_forward(net: UNet, precision: str, device: torch.device,
                 model_forward: str = "auto"
                 ) -> tuple[Callable[[torch.Tensor], torch.Tensor],
                            UNet | None]:
    """``net`` transformed for a precision tier (``ops/quant.
    apply_precision``) and made the served forward: ``(forward,
    untransformed net)``, the latter None at f32 (no gate). The forward is
    ``ServerConfig.model_forward``'s, read as the JAX package's
    ``_build_forward``: "auto" and "pallas" fold it onto the kernels
    (:class:`ops.unet_infer.FoldedUNet`), "flax" serves the unfolded
    ``UNet`` in eval mode with its 3x3 convs on the conv kernel
    (:func:`models.unet.eval_on_kernels`); any other value raises
    ``ValueError``. A group-norm net serves only with "flax": the folded
    forward refuses it with the JAX ``PallasUNet``'s ``ValueError``."""
    if model_forward not in ("auto", "pallas", "flax"):
        raise ValueError(f"unknown model_forward {model_forward!r}")
    served, report = quant.apply_precision(net, precision)
    if report is not None:
        log.info("serving precision tier %s: %s", report["tier"], report)
    forward = (eval_on_kernels(served) if model_forward == "flax"
               else FoldedUNet(served, device=device))
    return forward, (None if report is None else net)


class FrameResult(NamedTuple):
    """One analyzed frame's response fields, and the drift signals the
    frame already computed."""

    mean_k: float
    max_k: float
    spline: np.ndarray  # [N, 3]; empty when invalid or packed
    mask_bytes: bytes  # the mask payload in the requested format
    coverage: float
    valid: bool
    spline_wire: bytes = b""  # packed_spline for mask_format 1/2
    confidence_margin: float = 0.0
    #: nonzero pixels of the host depth frame over all of them
    depth_valid_fraction: float = 0.0
    #: an ``anomaly`` head's score (None for "segment" heads)
    anomaly: float | None = None


class Engine(NamedTuple):
    """One served model generation: everything a frame touches, swapped as
    a unit so a hot reload can never mix one generation's forward with
    another's graphs (the JAX package's ``Engine``)."""

    version: int | None
    forward: Callable[[torch.Tensor], torch.Tensor]
    #: the untransformed net the tier's gate runs as its f32 reference
    #: (None at f32)
    pristine: UNet | None
    analyze: Analyzer  # direct pixel frames, packed
    analyze_coef: Analyzer  # direct coefficient frames, packed
    dispatcher: BatchDispatcher | None


def _fields(out, mask_format: int, encode: Callable) -> FrameResult:
    """A frame's response fields off its packed row (a
    :class:`~serving.egress.PackedResult`) or its unpacked
    :class:`~ops.pipeline.FrameAnalysis` row of host tensors;
    ``encode(fmt, mask=, bits=, shape=)`` makes the mask payload (the
    servicer's encode pool; for a frame nobody will read, b"")."""
    if isinstance(out, egress.PackedResult):
        coverage, mean_k, max_k, valid, margin = out.scalars()
        shape, bits, mask = (out.h, out.w), out.mask_bits, None
        spline_wire = out.spline_wire() if mask_format else b""
        spline = (np.zeros((0, 3), np.float32) if mask_format
                  else out.spline())
    else:
        prof = out.profile
        mask = out.mask.numpy()
        shape, bits = mask.shape, None
        coverage, valid = float(out.mask_coverage), bool(prof.valid)
        mean_k = float(prof.mean_curvature) if valid else 0.0
        max_k = float(prof.max_curvature) if valid else 0.0
        margin = float(out.confidence_margin)
        spline = (prof.spline_points.numpy() if valid
                  else np.zeros((0, 3), np.float32))
        spline_wire = (np.ascontiguousarray(spline, "<f4").tobytes()
                       if mask_format else b"")
        if mask_format:
            spline = np.zeros((0, 3), np.float32)
    if mask_format == egress.MASK_FORMAT_BITS:
        # the wire payload is the packed rows behind a header
        mask_bytes = encode("bits", bits=(bits if bits is not None
                                          else np.packbits(mask, axis=-1)),
                            shape=shape)
    elif mask_format == egress.MASK_FORMAT_RLE:
        mask_bytes = encode("rle", mask=mask, bits=bits, shape=shape)
    else:
        # PNG, and any other mask_format, as the JAX server answers
        mask_bytes = encode("png", mask=(out.unpack_mask() if mask is None
                                         else mask), shape=shape)
    return FrameResult(mean_k, max_k, spline, mask_bytes, coverage, valid,
                       spline_wire, margin)


def _device_scope(device: torch.device):
    """``device`` as the current CUDA device for the calls in the block (a
    null context on the CPU). Every kernel wrapper takes tensors on the
    current device only, so the direct path of a servicer on a card other
    than the current one enters its own card first; the batched path
    enters it through its stream (``serving/batching.py``)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


#: (family, label values) -> its child, for the frame path's instruments
_children: dict = {}


def _child(family, *values: str):
    """``family.labels(...)`` for ``values`` in the family's label order,
    looked up once per family and values (a child is never dropped, so
    every frame after the first skips the label check and the family's
    lock)."""
    key = (family, values)
    child = _children.get(key)
    if child is None:
        child = _children[key] = family.labels(
            **dict(zip(family.labelnames, values)))
    return child


def _observe_stage(stage: str, dt: float) -> None:
    """A closed stage of a frame into the stage latency instruments."""
    _child(obs.STAGE_LATENCY, stage).observe(dt)
    _child(obs.STAGE_LATENCY_SUMMARY, stage).observe(dt)


class VisionAnalysisService:
    """Servicer over a model forward, direct or batched (see the module
    docstring).

    Args:
        forward: NHWC float32 -> NHWC float32 logits on ``device`` (a
            :class:`ops.unet_infer.FoldedUNet`).
        intrinsics: [3, 3] camera matrix, or None for the focal-length
            default of each frame's size.
        depth_scale: depth-to-metres factor.
        cfg: server settings (``model_img_size``, metrics CSV, reload,
            drain, SLO).
        geom_cfg: geometry settings (default: ``stride =
            cfg.geometry_stride``).
        metrics: the metrics writer (default: one on ``cfg.metrics_csv``).
        device: where frames are analyzed.
        pristine: the untransformed net that ``forward`` was made from at a
            bf16 or int8 tier (:func:`build_service` passes it): the
            warm-up's parity gate runs it as the f32 reference. A non-f32
            tier without it raises ``ValueError``.
        version: the registry version ``forward`` serves (None for a
            caller's own forward: such a servicer never reloads).
    """

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 intrinsics: np.ndarray | None = None,
                 depth_scale: float | None = None,
                 cfg: ServerConfig = ServerConfig(),
                 geom_cfg: GeometryConfig | None = None,
                 metrics: MetricsWriter | None = None,
                 device: str | torch.device = "cuda",
                 pristine: UNet | None = None,
                 version: int | None = None):
        check_supported(cfg)
        # resolved once (RDP_PRECISION overrides the field); every
        # generation is transformed for it
        self.precision = quant.resolve_precision(cfg.precision)
        if self.precision != "f32" and pristine is None:
            raise ValueError(
                f"precision {self.precision!r} needs the untransformed net "
                "for its warm-up parity gate; a servicer given only a "
                "forward serves 'f32' (build_service transforms the "
                "registered model and keeps it)"
            )
        for p in quant.PRECISIONS:
            obs.SERVING_PRECISION.labels(precision=p).set(
                1.0 if p == self.precision else 0.0)
        #: the warm-up parity gate's report (None at f32 and before warmup)
        self.parity: dict | None = None
        self.cfg = cfg
        self.device = resolve_device(device)
        self.geom_cfg = (geom_cfg if geom_cfg is not None
                         else GeometryConfig(stride=cfg.geometry_stride))
        self.intrinsics = intrinsics
        self.depth_scale = (cfg.default_depth_scale if depth_scale is None
                            else float(depth_scale))
        # the host path: the decode pool (0 workers: inline in the handler
        # thread), the camera geometry cache (the float32 intrinsics, and
        # the direct path's copies on the device, made once per camera;
        # shared by every generation) and the encode pool
        self.ingest = ingest.DecodePool(
            ingest.resolve_decode_workers(cfg.decode_workers),
            prefetch=cfg.ingest_prefetch,
            onchip=ingest.resolve_onchip_decode(cfg.onchip_decode))
        self.onchip = self.ingest.onchip
        self._geom_cache = ingest.GeometryCache(device=self.device)
        self.egress = egress.EncodePool(
            egress.resolve_egress_workers(cfg.egress_workers))
        if self.ingest.workers or self.egress.workers:
            log.info("host pools: %d decode worker(s) (read-ahead %d), %d "
                     "encode worker(s)", self.ingest.workers,
                     self.ingest.prefetch, self.egress.workers)
        self._registry_store = tracking.store_for(cfg.tracking_uri)
        # the zoo roster: the default model first. One name is the single
        # model server, whose frames take exactly the path without a zoo
        self._zoo_names = variants_lib.resolve_zoo_models(cfg.zoo_models)
        self.model_label = self._zoo_names[0]
        obs.ZOO_MODELS.set(len(self._zoo_names))
        self._controller_enabled = controller_lib.resolve_controller_enabled(
            cfg.controller_enabled)
        # the placer, before the first dispatcher, which records each
        # submit's arrival in it; one device: every model's chip is 0
        self.placer: zoo_lib.ZooPlacer | None = None
        if len(self._zoo_names) > 1:
            self.placer = zoo_lib.ZooPlacer(
                self._zoo_names, chips=1,
                mode=zoo_lib.resolve_zoo_placement(cfg.zoo_placement),
                interval_s=cfg.zoo_rate_interval_s,
                window=cfg.zoo_rate_window,
                rebalance_s=cfg.zoo_rebalance_s,
                corr_cap=cfg.zoo_corr_cap)
            log.info("model zoo: %s (%s placement over 1 device)",
                     ",".join(self._zoo_names), self.placer.mode)
        self._engine = self._make_engine(version, forward, pristine)
        self._warm_shape: tuple[int, int] | None = None
        self._reload_stop: threading.Event | None = None
        self._reload_thread: threading.Thread | None = None
        # at most one reload in flight, and the lock held only for a swap
        self._reload_lock = threading.Lock()
        self._reload_busy = False  # guarded_by: _reload_lock
        self._closed = False
        # pending grace-delayed (timer, old dispatcher) stops; close()
        # cancels the timers and stops the dispatchers at once
        self._grace_stops: list[tuple[threading.Timer, BatchDispatcher]] = []  # guarded_by: _reload_lock
        self.registry_breaker = CircuitBreaker(
            failure_threshold=cfg.registry_breaker_failures,
            reset_timeout_s=cfg.registry_breaker_reset_s,
            name=f"registry:{cfg.tracking_uri}",
        )
        # grpc.health.v1 state: NOT_SERVING until warm-up (or mark_ready),
        # NOT_SERVING again once a drain begins
        self.health = health_lib.HealthServicer()
        self.health.set(VISION_SERVICE, health_lib.NOT_SERVING)
        self._streams_cond = threading.Condition()
        self._active_streams = 0  # guarded_by: _streams_cond
        self._draining = False  # guarded_by: _streams_cond
        # brownout rung 3: the controller sets it and _enter_stream then
        # refuses every other new stream
        self._refusing_streams = False  # guarded_by: _streams_cond
        self._brownout_tick = 0  # guarded_by: _streams_cond
        # frames answered per model (every status; /debug/zoo) and in all
        # (the fleet's stats RPC, replica_stats)
        self._model_frames: dict[str, int] = {}  # guarded_by: _streams_cond
        self._frames_total = 0  # guarded_by: _streams_cond
        # a single-model server's arrival rate (a zoo's rates are its
        # placer's): the fleet planner's demand input, which the JAX
        # package's single-model replica reports as 0
        arrivals = zoo_lib.RateWindow(cfg.zoo_rate_interval_s,
                                      cfg.zoo_rate_window)
        self._arrivals = arrivals  # guarded_by: _streams_cond
        # the fleet membership lease (serving/fleet.LeaseClient), started by
        # grpc_service.build_server when registrars are configured; drain()
        # leaves it, close() stops it
        self.lease_client = None
        # the rollout's shadow tap (set_shadow) and the rollout manager
        # drift recommendations are handed to (rollout.attach_rollout)
        self._shadow_hook = None
        self.rollout: rollout_lib.RolloutManager | None = None
        self.metrics = metrics or MetricsWriter(cfg.metrics_csv,
                                                cfg.metrics_flush_every)
        # the /metrics endpoint: grpc_service.build_server starts one when
        # cfg.metrics_port / RDP_METRICS_PORT asks for it; close() stops it
        self.metrics_server = None
        self.bound_port = 0  # set by grpc_service.build_server
        self.slo: slo_lib.SloTracker | None = None
        slo_ms = slo_lib.resolve_slo_ms(cfg.slo_ms)
        if slo_ms is not None:
            self.slo = slo_lib.SloTracker(
                slo_ms / 1e3, budget=cfg.slo_budget, window=cfg.slo_window,
                name="e2e",
                violations=obs.SLO_VIOLATIONS.labels(objective="e2e"),
                burn_gauge=obs.SLO_BURN.labels(objective="e2e", model=""),
                objective_gauge=obs.SLO_OBJECTIVE.labels(objective="e2e"),
            )
            log.info("SLO tracking: %.1f ms objective, %.2f%% budget",
                     slo_ms, 100 * cfg.slo_budget)
        # the online drift monitor: host-side bookkeeping after each
        # response is built (see the module docstring)
        self.drift: profile_lib.DriftMonitor | None = None
        if cfg.drift_enabled:
            reference = self._load_drift_profile(version)
            self.drift = profile_lib.DriftMonitor(
                reference=reference,
                window=cfg.drift_window,
                baseline_frames=cfg.drift_baseline_frames,
                score_every=cfg.drift_score_every,
                psi_threshold=cfg.drift_psi_threshold,
                sustain_s=cfg.drift_sustain_s,
                cooldown_s=cfg.drift_cooldown_s,
                generation=version,
                on_score=self._on_drift_score,
                on_recommendation=self._on_drift_recommendation,
            )
            obs.DRIFT_REFERENCE_AGE.set(
                -1.0 if reference is None else reference.age_s
            )
        # the reactive SLO controller: it needs an objective to hold and a
        # dispatcher to retune, and reads the live generation's dispatcher
        # through a callable, so a hot reload's swap never strands it
        self.controller: controller_lib.ReactiveController | None = None
        if (self._controller_enabled and self.slo is not None
                and cfg.batch_window_ms > 0):
            self.controller = controller_lib.ReactiveController(
                dispatcher=lambda: self._engine.dispatcher,
                burn=lambda: self.slo.burn,
                refuse_streams=self._set_refuse_streams,
                interval_s=cfg.controller_interval_s,
                burn_high=cfg.controller_burn_high,
                burn_low=cfg.controller_burn_low,
                sustain_s=cfg.controller_sustain_s,
                cooldown_s=cfg.controller_cooldown_s,
                inflight_cap=cfg.controller_inflight_cap,
                samples=lambda: self.slo.observed_total,
            )
            self.controller.start()
        elif self._controller_enabled:
            log.warning(
                "controller enabled but idle: it needs slo_ms > 0 (got %s) "
                "and batch_window_ms > 0 (got %s)",
                cfg.slo_ms, cfg.batch_window_ms)
        # the zoo: the default entry reads this servicer's own generation;
        # the extras come from their own registry entries
        self.zoo = zoo_lib.ModelZoo(default=self.model_label)
        self.zoo.add(zoo_lib.ZooEntry(
            name=self.model_label,
            variant=variants_lib.VARIANTS[self.model_label],
            analyze=None, forward=None, version=version,
            precision=self.precision))
        self._model_slo: dict[str, slo_lib.SloTracker] = {}
        self._build_zoo_entries()

    def _set_refuse_streams(self, refusing: bool) -> None:
        """The controller's rung 3: refuse (or accept again) every other
        new stream."""
        with self._streams_cond:
            changed = refusing != self._refusing_streams
            self._refusing_streams = refusing
        if changed:
            log.warning("overload brownout: %s new analysis streams",
                        "refusing" if refusing else "accepting")

    # -- the generation -------------------------------------------------------

    def _make_engine(self, version: int | None, forward: Callable,
                     pristine: UNet | None) -> Engine:
        """One generation around ``forward``: the direct analyzers and,
        with batching, a dispatcher whose threads start here."""
        cfg, geom_cfg, device = self.cfg, self.geom_cfg, self.device
        # the direct path's analyzers end in the packed row and read it
        # back to the host before they release their graph
        analyze = pipeline.make_frame_analyzer(
            forward, img_size=cfg.model_img_size, geom_cfg=geom_cfg,
            device=device, pack=True)
        analyze_coef = pipeline.make_coef_frame_analyzer(
            forward, img_size=cfg.model_img_size, geom_cfg=geom_cfg,
            device=device, pack=True)
        dispatcher = None
        if cfg.batch_window_ms > 0:
            make_batched = (pipeline.make_scan_batch_analyzer
                            if cfg.batch_impl == "scan"
                            else pipeline.make_batch_analyzer)

            def coef_factory(height: int, width: int, subsampling: str):
                return pipeline.make_coef_batch_analyzer(
                    forward, img_size=cfg.model_img_size, geom_cfg=geom_cfg,
                    device=device, height=height, width=width,
                    subsampling=subsampling, pack=cfg.egress_pack)

            # egress_pack: the batch graph ends in the pack stage, one
            # [B, P] device-to-host copy per dispatch; without it each
            # leaf comes back on its own
            dispatcher = BatchDispatcher(
                make_batched(forward, img_size=cfg.model_img_size,
                             geom_cfg=geom_cfg, device=device,
                             pack=cfg.egress_pack),
                coef_analyzer_factory=coef_factory,
                window_ms=cfg.batch_window_ms, max_batch=cfg.max_batch,
                max_backlog=cfg.max_backlog,
                submit_timeout_s=cfg.submit_deadline_s,
                watchdog_interval_s=cfg.watchdog_interval_s,
                max_inflight=resolve_max_inflight(
                    cfg.max_inflight_dispatches),
                admission=cfg.admission_policy, device=device,
                model_label=self.model_label, placer=self.placer,
            )
            # a hot reload's new dispatcher: the zoo's other models, whose
            # generations did not move, are bound on it again
            if hasattr(self, "zoo"):
                old = self._engine.dispatcher
                for entry in self.zoo.extras():
                    dispatcher.bind_model(entry.name, entry.batch_analyze)
                if old is not None:
                    # their graphs are the same caches, captured already
                    with old._warm_lock:
                        carried = {k for k in old.warmed if k[0]}
                    with dispatcher._warm_lock:
                        dispatcher.warmed |= carried
        return Engine(version, forward, pristine, analyze, analyze_coef,
                      dispatcher)

    @property
    def current_version(self) -> int | None:
        return self._engine.version

    @property
    def model_version(self) -> int | None:
        """The registry version served (None for a caller's forward)."""
        return self._engine.version

    @property
    def analyze(self) -> Analyzer:
        return self._engine.analyze

    @property
    def analyze_coef(self) -> Analyzer:
        return self._engine.analyze_coef

    @property
    def dispatcher(self) -> BatchDispatcher | None:
        return self._engine.dispatcher

    @property
    def _pristine(self) -> UNet | None:
        return self._engine.pristine

    def _geometry(self, w: int, h: int) -> ingest.GeometryEntry:
        """The geometry cache's entry of a w x h camera."""
        return self._geom_cache.lookup(self.intrinsics, w, h,
                                       self.depth_scale)

    def _camera(self, w: int, h: int) -> np.ndarray:
        """The float32 intrinsics of a w x h camera."""
        return self._geometry(w, h).k_f32

    # -- the model zoo ---------------------------------------------------------

    def _build_zoo_entries(self) -> None:
        """Load and bind every zoo model after the default: its registry
        entry (the ``model_alias`` version first, else the latest), the
        tier's forward, its own analyzers and graph caches, bound onto the
        shared dispatcher, its drift monitor and SLO tracker. A model whose
        registry entry is missing or fails to build is left out with a
        warning: the zoo serves what exists."""
        cfg = self.cfg
        slo_ms = slo_lib.resolve_slo_ms(cfg.slo_ms)
        if len(self._zoo_names) > 1 and slo_ms is not None:
            # the default model's own burn beside the aggregate (model=""),
            # which the controller reads
            self._model_slo[self.model_label] = slo_lib.SloTracker(
                slo_ms / 1e3, budget=cfg.slo_budget, window=cfg.slo_window,
                name=f"e2e/{self.model_label}",
                burn_gauge=obs.SLO_BURN.labels(objective="e2e",
                                               model=self.model_label))
        for name in self._zoo_names[1:]:
            variant = variants_lib.VARIANTS[name]
            reg_name = variants_lib.registered_name(variant, cfg.model_name)
            try:
                alias = self._registry_store.get_alias(reg_name,
                                                       cfg.model_alias)
                version = (int(alias) if alias is not None else int(
                    self._registry_store.latest_version(reg_name)["version"]))
                _, net = tracking.load_model(
                    f"models:/{reg_name}/{version}",
                    store=self._registry_store, device=self.device)
            except Exception as exc:
                log.warning("zoo model %r (%s) unavailable (%s: %s); serving "
                            "without it", name, reg_name, type(exc).__name__,
                            exc)
                continue
            try:
                entry = self._make_zoo_entry(name, variant, reg_name, net,
                                             version)
            except Exception:
                log.exception("zoo model %r failed to build; serving "
                              "without it", name)
                continue
            self.zoo.add(entry)
            log.info("zoo model %r: %s v%s (%s tier, %s head)", name,
                     reg_name, version, entry.precision, variant.head)

    def _make_zoo_entry(self, name: str, variant, reg_name: str, net: UNet,
                        version: int | None) -> zoo_lib.ZooEntry:
        """One extra zoo model, built as the default model's generation is:
        :func:`tier_forward`, a direct packed analyzer and, with batching, a
        batched analyzer bound on the dispatcher, each with its own graph
        cache."""
        cfg, geom_cfg, device = self.cfg, self.geom_cfg, self.device
        forward, pristine = tier_forward(net, self.precision, device,
                                         cfg.model_forward)
        analyze = pipeline.make_frame_analyzer(
            forward, img_size=cfg.model_img_size, geom_cfg=geom_cfg,
            device=device, pack=True)
        batch_analyze = None
        dispatcher = self._engine.dispatcher
        if dispatcher is not None:
            make_batched = (pipeline.make_scan_batch_analyzer
                            if cfg.batch_impl == "scan"
                            else pipeline.make_batch_analyzer)
            batch_analyze = make_batched(
                forward, img_size=cfg.model_img_size, geom_cfg=geom_cfg,
                device=device, pack=cfg.egress_pack)
            dispatcher.bind_model(name, batch_analyze)
        drift = None
        if cfg.drift_enabled:
            reference = self._load_drift_profile(
                version, model_name=reg_name, allow_explicit=False)
            drift = profile_lib.DriftMonitor(
                reference=reference, window=cfg.drift_window,
                baseline_frames=cfg.drift_baseline_frames,
                score_every=cfg.drift_score_every,
                psi_threshold=cfg.drift_psi_threshold,
                sustain_s=cfg.drift_sustain_s,
                cooldown_s=cfg.drift_cooldown_s, generation=version,
                on_score=functools.partial(self._on_model_drift_score, name),
                on_recommendation=functools.partial(
                    self._on_model_drift_recommendation, name))
        slo_ms = slo_lib.resolve_slo_ms(cfg.slo_ms)
        tracker = None
        if slo_ms is not None:
            tracker = slo_lib.SloTracker(
                slo_ms / 1e3, budget=cfg.slo_budget, window=cfg.slo_window,
                name=f"e2e/{name}",
                burn_gauge=obs.SLO_BURN.labels(objective="e2e", model=name))
            self._model_slo[name] = tracker
        return zoo_lib.ZooEntry(
            name=name, variant=variant, analyze=analyze, forward=forward,
            version=version, precision=self.precision, pristine=pristine,
            drift=drift, slo=tracker, batch_analyze=batch_analyze)

    def _resolve_model(self, name: str) -> tuple[str, zoo_lib.ZooEntry | None]:
        """A request's ``model`` field -> (metric label, zoo entry). "" and
        the default's name give (default label, None): the default path,
        unchanged. An unknown name raises :class:`zoo.UnknownModelError`
        (that frame's error)."""
        if not name or name == self.model_label:
            return self.model_label, None
        entry = self.zoo.get(name)
        if entry is None:
            raise zoo_lib.UnknownModelError(
                f"model {name!r} is not in this server's zoo "
                f"({', '.join(self.zoo.names())})")
        return name, entry

    def zoo_debug(self) -> dict:
        """The ``GET /debug/zoo`` payload: the roster, each model's
        version, head, registry entry, tier, frames and parity report, the
        placer's placement and rate correlations, and the (model, chip,
        bucket) keys the dispatcher has captured."""
        with self._streams_cond:
            frames = dict(self._model_frames)
        models = {}
        for n in self.zoo.names():
            e = self.zoo.get(n)
            default = n == self.model_label
            models[n] = {
                "version": self._engine.version if default else e.version,
                "head": e.variant.head,
                "registered_name": variants_lib.registered_name(
                    e.variant, self.cfg.model_name),
                "precision": e.precision,
                "frames": frames.get(n, 0),
                "parity": self.parity if default else e.parity,
            }
        dispatcher = self._engine.dispatcher
        if dispatcher is not None:
            with dispatcher._warm_lock:
                warmed = sorted([list(map(str, k))
                                 for k in dispatcher.warmed])
        else:
            warmed = []
        return {
            "enabled": len(self._zoo_names) > 1,
            "default": self.model_label,
            "models": models,
            "placement": (self.placer.snapshot()
                          if self.placer is not None else None),
            "warmed": warmed,
        }

    # -- one frame --------------------------------------------------------------

    def analyze_frame(self, rgb, depth: np.ndarray, mask_format: int = 0,
                      timer: StageTimer | None = None,
                      timeout_s: float | None = None,
                      active: Callable[[], bool] | None = None,
                      model: str = "") -> FrameResult:
        """One decoded frame -> its response fields. ``rgb`` is [H, W, 3]
        uint8 pixels or a :class:`~serving.entropy.CoefficientFrame` (the
        coefficient lane). Directly, the frame's graph replays under its
        lock and its packed row comes back in one device-to-host copy;
        batched, the row (or the unpacked result) is the dispatch's. The
        mask is encoded through the encode pool on either path.
        ``timer`` takes the "device" stage (up to the result on the host)
        and the "encode" stage; ``timeout_s`` is the frame's deadline
        budget (the dispatcher's submit and the encode wait), and a frame
        whose stream is gone (``active`` False) or whose budget ran out on
        the device pays no encode. ``model`` picks the zoo entry ("" = the
        default model; an unknown name raises
        :class:`zoo.UnknownModelError` before any device work)."""
        inject(fault_sites.SERVING_ANALYZE)
        timer = timer or StageTimer()
        t_entry = time.monotonic()
        h, w = rgb.shape[:2]
        if depth.shape != (h, w):
            raise ValueError(
                f"depth frame is {depth.shape[1]}x{depth.shape[0]}; color "
                f"frame is {w}x{h}"
            )
        geom = self._geometry(w, h)
        _, entry = self._resolve_model(model)
        # ONE read of the engine per frame: a concurrent reload cannot mix
        # generations
        eng = self._engine
        with timer.stage("device"):
            out = self._packed(eng, rgb, depth, geom, timeout_s, entry)
        try:
            dead = ((active is not None and not active())
                    or (timeout_s is not None
                        and time.monotonic() - t_entry >= timeout_s))

            def encode(fmt: str, **kw) -> bytes:
                if dead:  # nobody will read it
                    return b""
                return self.egress.encode(fmt, timeout_s=timeout_s, **kw)

            with timer.stage("encode"):
                res = _fields(out, mask_format, encode)
            # the drift signal the frame already paid for: one host-side
            # count over the raw depth frame
            res = res._replace(depth_valid_fraction=(
                float(np.count_nonzero(depth)) / max(depth.size, 1)))
            if entry is not None and entry.variant.head == "anomaly":
                # the aux head's product: its score off the confidence
                # margin the frame already computed
                res = res._replace(anomaly=variants_lib.anomaly_score(
                    res.confidence_margin))
                obs.MODEL_ANOMALY_SCORE.observe(res.anomaly)
            if (entry is None and self._shadow_hook is not None
                    and not isinstance(rgb, entropy.CoefficientFrame)):
                # only the default model's pixel frames mirror to a
                # rollout's shadow (the rollout replaces the default
                # generation), and the mask unpacks only when a tap is in
                self._mirror_shadow(rgb, depth, geom.k_f32, out, res)
        finally:
            if isinstance(out, egress.PackedResult):
                out.release()
        return res

    def _packed(self, eng: Engine, rgb, depth: np.ndarray,
                geom: ingest.GeometryEntry, timeout_s: float | None = None,
                entry: zoo_lib.ZooEntry | None = None):
        """One frame's result from ``eng``'s path (or zoo ``entry``'s): the
        direct analyzer's packed row, or the dispatcher's row (a
        :class:`~serving.egress.PackedResult`, or with
        ``egress_pack=False`` the frame's :class:`~ops.pipeline.
        FrameAnalysis` row). The coefficient lane serves the default model
        only, as in the JAX package."""
        coef = isinstance(rgb, entropy.CoefficientFrame)
        if coef and entry is not None:
            raise ValueError(
                "the coefficient lane serves the default model only; "
                f"model {entry.name!r} frames must use pixel formats")
        if eng.dispatcher is not None:
            if coef:
                return eng.dispatcher.submit_coef(
                    rgb, depth, geom.k_f32, self.depth_scale,
                    timeout_s=timeout_s)
            return eng.dispatcher.submit(
                rgb, depth, geom.k_f32, self.depth_scale,
                timeout_s=timeout_s,
                model=entry.name if entry is not None else "")
        with _device_scope(self.device):
            k, scale = geom.staged()
            if entry is not None:
                analyze = entry.analyze
            else:
                analyze = eng.analyze_coef if coef else eng.analyze
            return egress.PackedResult(analyze(rgb, depth, k, scale))

    # -- streams ----------------------------------------------------------------

    def analyze_stream(self, requests: Iterable,
                       active: Callable[[], bool] = lambda: True,
                       parent: trace.SpanContext | None = None,
                       time_remaining: Callable[[], float | None] = (
                           lambda: None),
                       ) -> Iterator[AnalysisResponse]:
        """One response per request, in order, inside a ``serving.stream``
        span (``parent``: the client's trace context, else a new trace).
        Requests are decoded by the decode pool
        (:meth:`serving.ingest.DecodePool.iter_decoded`); ``active``
        returning False (a cancelled stream) or ``time_remaining`` at or
        below 0 (the stream's deadline, seconds) stops the loop before the
        next frame, and each frame's remaining budget bounds its waits. On
        a draining or closed service the first ``next`` raises
        :class:`StreamRefusedError`."""
        if not self._enter_stream():
            raise StreamRefusedError(
                "server is draining or in overload brownout; retry against "
                "another replica")
        try:
            with trace.span("serving.stream", parent=parent):
                log.info("analysis stream opened (%s trace)",
                         "client" if parent is not None else "local")
                timer = StageTimer(observer=_observe_stage)
                for frame in self.ingest.iter_decoded(
                        requests, active=active,
                        time_remaining=time_remaining):
                    yield self._respond(frame, timer, active)
                if timer.totals:
                    log.info("stream stage breakdown: %s", timer.summary())
        finally:
            self.metrics.flush()
            self._exit_stream()

    def _respond(self, frame: ingest.IngestFrame, timer: StageTimer,
                 active: Callable[[], bool]) -> AnalysisResponse:
        t0 = time.perf_counter()
        label, entry = self.model_label, None
        try:
            # the handler's share of the decode (inline: the decode;
            # pooled: the wait); the pool times the decode itself
            timer.observe("decode", frame.wait_s)
            if frame.error is not None:
                raise frame.error
            label, entry = self._resolve_model(frame.model)
            res = self.analyze_frame(frame.rgb, frame.depth,
                                     frame.mask_format, timer,
                                     timeout_s=frame.time_remaining,
                                     active=active, model=frame.model)
            status = STATUS_OK if res.valid else STATUS_DEGRADED
            if res.anomaly is not None:
                # an anomaly head's verdict rides the status text, only on
                # frames that asked for that model
                status += f" anomaly={res.anomaly:.4f}"
            response = AnalysisResponse(
                mean_curvature=res.mean_k,
                max_curvature=res.max_k,
                spline_points=[Point3D(float(p[0]), float(p[1]), float(p[2]))
                               for p in res.spline],
                status=status,
                mask=res.mask_bytes,
                mask_coverage=res.coverage,
                packed_spline=res.spline_wire,
            )
            self.metrics.append(res.mean_k, res.max_k, res.coverage)
            self._observe_drift(res, entry)
            status_label = "ok" if res.valid else "degraded"
        except zoo_lib.UnknownModelError as exc:
            # a mistyped model name is a bad frame: that frame's error,
            # and requested names never become labels
            label = "unknown"
            response = AnalysisResponse(
                status=f"ERROR: UnknownModel: {exc} "
                       f"[trace={trace.current_trace_id() or '-'}]")
            status_label = "error"
        except OverloadedError as exc:
            # load shedding ends the stream (RESOURCE_EXHAUSTED); a shed
            # frame burned SLO budget too
            _child(obs.FRAMES, "shed", label).inc()
            if self.slo is not None:
                self.slo.observe(float("inf"), ok=False)
            mslo = self._model_slo.get(label)
            if mslo is not None:
                mslo.observe(float("inf"), ok=False)
            raise OverloadedError(
                f"{exc} [trace={trace.current_trace_id() or '-'}]") from exc
        except DeadlineExceeded as exc:
            log.warning("frame missed its deadline: %s", exc)
            response = AnalysisResponse(
                status=f"ERROR: DeadlineExceeded: {exc} "
                       f"[trace={trace.current_trace_id() or '-'}]")
            status_label = "deadline"
        except Exception as exc:  # a bad frame answers, the stream lives on
            log.exception("analysis error")
            trace_id = trace.current_trace_id()
            recorder_lib.RECORDER.record_event(
                "serving.frame_error", trace_id=trace_id,
                error=f"{type(exc).__name__}: {exc}")
            response = AnalysisResponse(
                status=f"ERROR: {type(exc).__name__}: {exc} "
                       f"[trace={trace_id or '-'}]")
            status_label = "error"
        total_s = time.perf_counter() - t0 + frame.wait_s
        response.proc_time_ms = total_s * 1e3
        with self._streams_cond:
            self._frames_total += 1
            self._model_frames[label] = self._model_frames.get(label, 0) + 1
            self._arrivals.record()
        _child(obs.FRAMES, status_label, label).inc()
        _observe_stage("total", total_s)
        obs.FRAME_LATENCY_SUMMARY.observe(total_s)
        frame_ok = status_label in ("ok", "degraded")
        if self.slo is not None:
            self.slo.observe(total_s, ok=frame_ok)
        mslo = self._model_slo.get(label)
        if mslo is not None:
            # each model's own burn beside the aggregate
            mslo.observe(total_s, ok=frame_ok)
        return response

    def _observe_drift(self, res: FrameResult,
                       entry: zoo_lib.ZooEntry | None = None) -> None:
        """Feed one answered frame's signals to its model's drift monitor
        and the confidence-margin histogram: host-side Python, after the
        response is built."""
        obs.MODEL_CONFIDENCE_MARGIN.observe(res.confidence_margin)
        monitor = self.drift if entry is None else entry.drift
        if monitor is None:
            return
        monitor.observe_frame({
            "mask_coverage": res.coverage,
            "mean_curvature": res.mean_k if res.valid else math.nan,
            "max_curvature": res.max_k if res.valid else math.nan,
            "depth_valid_fraction": res.depth_valid_fraction,
            "confidence_margin": res.confidence_margin,
        })

    # -- drift observability ----------------------------------------------------

    def _load_drift_profile(self, version: int | None,
                            model_name: str | None = None,
                            allow_explicit: bool = True
                            ) -> profile_lib.FeatureProfile | None:
        """The reference profile: an explicit path (``drift_profile_path``
        or ``RDP_DRIFT_PROFILE``) wins, else the ``drift_profile.json``
        artifact next to the served registry version's weights; None
        means self-baseline. An unusable profile is logged and falls
        back. ``model_name`` picks the registry entry (default: the
        server's model); the explicit path applies to the default model
        only (``allow_explicit``): one path cannot describe M models."""
        model_name = model_name or self.cfg.model_name
        path = (profile_lib.resolve_drift_profile_path(
            self.cfg.drift_profile_path) if allow_explicit else None)
        if path is not None:
            try:
                return profile_lib.FeatureProfile.load(path)
            except Exception as exc:
                log.warning(
                    "drift profile %s unusable (%s: %s); falling back "
                    "to registry artifact / self-baseline",
                    path, type(exc).__name__, exc,
                )
        if version is None:
            return None
        try:
            artifact = (self._registry_store.version_path(
                model_name, version) / profile_lib.DRIFT_PROFILE_FILE)
            if artifact.exists():
                return profile_lib.FeatureProfile.load(artifact)
        except Exception as exc:
            log.warning(
                "no drift profile artifact for %s v%s (%s: %s); "
                "self-baselining", model_name, version,
                type(exc).__name__, exc,
            )
        return None

    def _on_drift_score(self, signal: str,
                        score: profile_lib.DriftScore) -> None:
        _child(obs.DRIFT_SCORE, signal, self.model_label).set(score.psi)
        if self.drift is not None:
            age = self.drift.reference_age_s
            obs.DRIFT_REFERENCE_AGE.set(-1.0 if age is None else age)

    def _on_drift_recommendation(
            self, rec: profile_lib.RetrainRecommendation) -> None:
        """At most one per sustained excursion: counted, pinned in the
        flight recorder, journaled and logged."""
        obs.DRIFT_RECOMMENDATIONS.inc()
        recorder_lib.RECORDER.pin(recorder_lib.RECORDER.record_event(
            "serving.drift_recommendation",
            signals=",".join(rec.signals),
            generation=str(rec.generation),
            reference=rec.reference_source,
            reason=rec.reason,
        ))
        journal_lib.JOURNAL.append(
            events.DRIFT_RECOMMENDATION, rec.reason,
            signals=",".join(rec.signals), generation=str(rec.generation),
        )
        log.warning(
            "DRIFT: %s -- recommend retraining (workflows.retraining)",
            rec.reason,
        )
        manager = self.rollout
        if manager is not None:
            try:
                manager.on_recommendation(rec)
            except Exception:
                log.exception("rollout manager rejected the recommendation")

    def _on_model_drift_score(self, model: str, signal: str,
                              score: profile_lib.DriftScore) -> None:
        """A zoo extra's drift score (the default model's goes through
        :meth:`_on_drift_score`)."""
        _child(obs.DRIFT_SCORE, signal, model).set(score.psi)

    def _on_model_drift_recommendation(
            self, model: str, rec: profile_lib.RetrainRecommendation) -> None:
        """A zoo extra drifted: counted, pinned, journaled and logged, and
        not handed to the rollout manager, whose cycle replaces the
        default model's generation (as in the JAX package)."""
        obs.DRIFT_RECOMMENDATIONS.inc()
        recorder_lib.RECORDER.pin(recorder_lib.RECORDER.record_event(
            "serving.drift_recommendation", model=model,
            signals=",".join(rec.signals), generation=str(rec.generation),
            reference=rec.reference_source, reason=rec.reason))
        journal_lib.JOURNAL.append(
            events.DRIFT_RECOMMENDATION, rec.reason, model=model,
            signals=",".join(rec.signals), generation=str(rec.generation))
        log.warning("DRIFT[%s]: %s -- recommend retraining", model,
                    rec.reason)

    def _apply_drift_reference(
            self, version: int | None,
            reference: profile_lib.FeatureProfile | None) -> None:
        """Adopt the swapped-in generation's drift reference: its profile
        when it shipped one, else a fresh self-baseline stamped with
        ``version``. Called under ``_reload_lock``, in the critical
        section of the engine swap, so no reader pairs new weights with
        the old reference."""
        if self.drift is None:
            return
        if reference is not None:
            self.drift.set_reference(reference)
            obs.DRIFT_REFERENCE_AGE.set(reference.age_s)
        else:
            self.drift.rebaseline(generation=version)
            obs.DRIFT_REFERENCE_AGE.set(-1.0)

    def version_and_reference(self) -> tuple[int | None, object]:
        """The (engine generation, drift reference generation) pair, read
        under the reload lock: both move together in a swap, so this never
        returns a mixed pair."""
        with self._reload_lock:
            version = self._engine.version
            if self.drift is None:
                return version, None
            ref = self.drift.reference
            gen = (ref.generation if ref is not None
                   and ref.generation is not None
                   else self.drift.generation)
            return version, gen

    def replica_stats(self) -> dict:
        """The per-replica payload of the fleet's stats RPC
        (``serving/fleet.add_replica_stats_to_server``), every key of the
        JAX package's: in-flight streams and error-budget burn feed the
        front-end's least-loaded placement and its weighted ring; the rest
        is diagnostics. The port serves on one device with no
        ``DeviceRouter`` (ROADMAP queue 1 item 14): ``chips`` is 1 and
        ``quarantined_chips`` 0. A single-model server reports its
        model's arrival rate (the JAX package's reports 0.0: only a zoo's
        placer measured one), over ``zoo_rate_window`` intervals of
        ``zoo_rate_interval_s``."""
        # version and drift reference generation as one consistent pair
        version, drift_generation = self.version_and_reference()
        host, role = trace.identity()
        with self._streams_cond:
            model_frames = dict(self._model_frames)
            frames_total = self._frames_total
            refusing = self._refusing_streams
            rates = {self.model_label: self._arrivals.mean_rate()}
        if self.placer is not None:
            rates = self.placer.rates()
        models = {
            name: {
                "frames": model_frames.get(name, 0),
                "rate": round(rates.get(name, 0.0), 3),
            }
            for name in self.zoo.names()
        }
        return {
            "inflight_streams": self.active_streams,
            "frames_total": frames_total,
            "models": models,
            "burn": self.slo.burn if self.slo is not None else 0.0,
            "slo_ms": self.cfg.slo_ms,
            "chips": 1,
            "quarantined_chips": 0,
            "version": version,
            "drift_generation": drift_generation,
            "draining": self.is_draining,
            "refusing_streams": refusing,
            "pid": os.getpid(),
            # the front-end's federation and trace stitching scrape this
            # replica's /metrics and /debug/spans at this port (0: none)
            "metrics_port": (self.metrics_server.port
                             if self.metrics_server is not None else 0),
            "host": host,
            "role": role,
        }

    def drift_debug(self) -> dict:
        """The ``GET /debug/drift`` payload: the monitor's snapshot and
        the engine version, read under the reload lock."""
        if self.drift is None:
            return {"enabled": False,
                    "reason": "drift monitoring disabled "
                              "(ServerConfig.drift_enabled)"}
        with self._reload_lock:
            snap = self.drift.snapshot()
            snap["model_version"] = self._engine.version
        return snap

    def _enter_stream(self) -> bool:
        with self._streams_cond:
            if self._draining or self._closed:
                return False
            if self._refusing_streams:
                # brownout rung 3 refuses every other new stream: refusing
                # all would starve the SLO signal and hold the ladder at
                # its top rung
                self._brownout_tick += 1
                if self._brownout_tick % 2:
                    return False
            self._active_streams += 1
        obs.INFLIGHT_STREAMS.inc()
        return True

    def _exit_stream(self) -> None:
        obs.INFLIGHT_STREAMS.dec()
        with self._streams_cond:
            self._active_streams -= 1
            self._streams_cond.notify_all()

    @property
    def active_streams(self) -> int:
        with self._streams_cond:
            return self._active_streams

    @property
    def is_draining(self) -> bool:
        with self._streams_cond:
            return self._draining

    def set_draining(self, draining: bool) -> None:
        """The rollout's drain: set or clear the draining flag only. Unlike
        :meth:`drain` (the shutdown path), health stays SERVING; new
        streams are refused (UNAVAILABLE) while the streams in flight
        finish, and ``set_draining(False)`` accepts them again. A closed
        service cannot be un-drained."""
        draining = bool(draining)
        with self._streams_cond:
            if self._closed and not draining:
                return
            changed = self._draining != draining
            self._draining = draining
            self._streams_cond.notify_all()
        if changed:
            log.info("replica %s: %s new streams (health stays up)",
                     "draining" if draining else "un-draining",
                     "refusing" if draining else "accepting")

    def set_shadow(self, hook) -> None:
        """Install (or clear with None) the rollout's shadow tap: a callable
        that gets one :class:`~serving.rollout.ShadowSample` per analyzed
        default-model pixel frame, on the handler thread after the
        response is built. It must not block (the rollout's
        ``ShadowRunner.hook`` samples and puts without waiting)."""
        self._shadow_hook = hook

    def _mirror_shadow(self, rgb, depth, k, out, res: FrameResult) -> None:
        """Hand one frame's inputs and this generation's outputs to the
        shadow tap. A failing tap never fails the frame."""
        hook = self._shadow_hook
        if hook is None:
            return
        try:
            mask = (out.unpack_mask() if isinstance(out, egress.PackedResult)
                    else out.mask.numpy())
            hook(rollout_lib.ShadowSample(
                rgb=rgb, depth=depth, k=np.asarray(k),
                depth_scale=self.depth_scale, mask=mask,
                coverage=res.coverage, mean_curvature=res.mean_k,
                max_curvature=res.max_k, valid=res.valid,
                confidence_margin=res.confidence_margin,
                depth_valid_fraction=res.depth_valid_fraction))
        except Exception:
            log.exception("shadow mirror hook failed; frame served normally")

    # -- hot reload -------------------------------------------------------------

    def _resolve_version(self) -> int | None:
        """Registry resolution under the per-service circuit breaker.

        Closed: failures log a warning and count toward the threshold.
        Open: the poll is skipped entirely (no registry touch, no log
        line) and serving keeps its current engine; the breaker logs its
        transitions once each."""
        try:
            return self.registry_breaker.call(
                lambda: resolve_serving_version(self.cfg,
                                                self._registry_store))
        except CircuitOpenError:
            return None
        except Exception as exc:
            log.warning(
                "registry %s unreachable/empty (%s: %s); serving keeps "
                "its current model (breaker: %d/%d failures)",
                self.cfg.tracking_uri, type(exc).__name__, exc,
                self.registry_breaker.failure_count,
                self.registry_breaker.failure_threshold,
            )
            return None

    def start_reloader(self) -> None:
        """Poll the registry every ``cfg.reload_poll_s`` seconds on a
        daemon thread (:meth:`maybe_reload`); on the card each poll then
        returns the graph memory of generations gone since the last one
        (``ops/graphs.release_dead_pools``). No poller when the interval
        is <= 0 or the servicer serves a caller's forward."""
        if (self.cfg.reload_poll_s <= 0 or self._reload_thread is not None
                or self.current_version is None):
            return
        self._reload_stop = threading.Event()

        def loop():
            while not self._reload_stop.wait(self.cfg.reload_poll_s):
                try:
                    self.maybe_reload()
                except Exception:
                    log.exception("model hot-reload failed; keeping current")
                if self.device.type == "cuda":
                    # the graph memory of generations gone since the last
                    # poll (a swapped-out one goes after its grace)
                    graphs.release_dead_pools()

        self._reload_thread = threading.Thread(
            target=loop, name="model-reloader", daemon=True)
        self._reload_thread.start()

    def maybe_reload(self) -> bool:
        """One reload check; returns True when a new version was swapped in.

        The expensive phase (resolve, load, fold, warm-up and graph
        captures) runs outside ``_reload_lock`` behind a busy flag, so at
        most one reload is in flight and :meth:`close` and :meth:`warmup`
        wait at most for a swap. The new generation is warmed for the
        camera :meth:`warmup` recorded, re-checked under the lock before
        the swap (a concurrent warmup of another camera warms it again);
        a closed service refuses the swap, and a generation that never
        went live has its dispatcher stopped."""
        with self._reload_lock:
            if self._closed or self._reload_busy:
                return False
            self._reload_busy = True
            current_version = self._engine.version
        engine = None
        try:
            if current_version is None:
                return False  # a caller's forward: nothing to reload
            version = self._resolve_version()
            if version is None or version == current_version:
                return False
            # scoped store: this runs on the poller thread
            _, net = tracking.load_model(
                f"models:/{self.cfg.model_name}/{version}",
                store=self._registry_store, device=self.device)
            forward, pristine = tier_forward(net, self.precision,
                                             self.device,
                                             self.cfg.model_forward)
            del net
            engine = self._make_engine(version, forward, pristine)
            # the new generation's drift reference is read here, off the
            # lock, and adopted in the swap's critical section below
            drift_reference = (self._load_drift_profile(version)
                               if self.drift is not None else None)
            if self._closed:
                return False  # skip the warm; finally cleans up
            old = None
            warmed_shape = object()  # sentinel: warmed for nothing yet
            while True:
                shape = self._warm_shape
                if shape is not None and shape != warmed_shape:
                    self._warm_engine(engine, shape)
                warmed_shape = shape
                with self._reload_lock:
                    if self._closed:
                        return False  # never swap into a closed service
                    if (self._warm_shape is not None
                            and self._warm_shape != warmed_shape):
                        continue  # warmup() raced us; warm the new shape
                    old, self._engine = self._engine, engine
                    engine = None  # went live; finally must not stop it
                    # the new generation's reference goes live with its
                    # weights, never after them
                    self._apply_drift_reference(version, drift_reference)
                    if old.dispatcher is not None:
                        self._schedule_grace_stop(old.dispatcher)
                    break
            log.info("hot-reloaded model: version %s -> %s", old.version,
                     version)
            return True
        finally:
            if engine is not None and engine.dispatcher is not None:
                engine.dispatcher.stop()
            with self._reload_lock:
                self._reload_busy = False

    def _schedule_grace_stop(self, dispatcher: BatchDispatcher) -> None:  # guarded_by: _reload_lock
        """Stop a swapped-out dispatcher ``reload_grace_s`` from now (a
        frame that read the old engine just before the swap may still be
        about to submit; ``stop`` is drain-safe, so a straggler past the
        window gets a per-frame error, not a hang). The fired timer drops
        its own entry, so nothing holds the old generation afterwards.
        Called under ``_reload_lock``."""
        entry: list = []

        def fire():
            dispatcher.stop()
            with self._reload_lock:
                self._grace_stops = [e for e in self._grace_stops
                                     if e is not entry[0]]
            entry.clear()  # no cycle through the timer: freed at once

        timer = threading.Timer(self.cfg.reload_grace_s, fire)
        timer.daemon = True
        entry.append((timer, dispatcher))
        self._grace_stops.append(entry[0])
        timer.start()

    def _buckets(self, dispatcher: BatchDispatcher | None = None
                 ) -> list[int]:
        """Every padded batch size a dispatch can take (``dispatcher``:
        the serving generation's by default)."""
        dispatcher = dispatcher or self.dispatcher
        return sorted({dispatcher.bucket_for(n)
                       for n in range(1, self.cfg.max_batch + 1)})

    def _warm_engine(self, engine: Engine, shape: tuple[int, int]) -> None:
        """Capture the graphs live frames of camera ``shape`` = (w, h)
        dispatch to on ``engine``: the batched per-bucket graphs when it
        has a dispatcher, the single-frame analyzer otherwise (the JAX
        package's ``_warm_engine``). On the card each capture runs on the
        engine's own cache streams while live frames replay another
        generation's."""
        w, h = shape
        with _device_scope(self.device):
            if engine.dispatcher is None:
                k, scale = self._geometry(w, h).staged()
                row = engine.analyze(np.zeros((h, w, 3), np.uint8),
                                     np.zeros((h, w), np.uint16), k, scale)
                # and the response's encode once, on the host: its first
                # use is not a served frame's (the JAX warm-up runs a real
                # frame through the whole path)
                egress.encode_mask(egress.PackedResult(row).unpack_mask(), 0)
                return
            k = self._camera(w, h)
            for b in self._buckets(engine.dispatcher):
                engine.dispatcher.warm(
                    np.zeros((b, h, w, 3), np.uint8),
                    np.zeros((b, h, w), np.uint16),
                    np.repeat(k[None], b, axis=0),
                    np.full((b,), self.depth_scale, np.float32))

    # -- warm-up and readiness -------------------------------------------------

    def warmup(self, width: int, height: int) -> None:
        """Capture the graphs of a camera geometry before traffic, so the
        first served frame pays no kernel build, warm-up or capture: the
        direct analyzer, or with batching every bucket up to
        ``max_batch`` (a capture is checked for this thread's calls only,
        so handler and dispatcher threads may already run). With on-chip
        decode on, the coefficient lane too (:meth:`warmup_coef`). A bf16
        or int8 tier then runs its parity gate (:meth:`_parity_gate`),
        which raises ``RuntimeError`` when the tier fails it. Readiness
        flips to SERVING at the end (:meth:`mark_ready`); a reload warms
        its generation for this camera."""
        self._warm_shape = (width, height)
        # under the reload lock: a poll that read _warm_shape as None could
        # otherwise swap in a never-warmed engine while this warms the old
        with self._reload_lock:
            self._warm_engine(self._engine, self._warm_shape)
        with _device_scope(self.device):
            if self.onchip:
                self.warmup_coef(width, height)
            self._warm_zoo(width, height)
            # after every capture of the warm-up: the gate replays the
            # served graphs and runs its reference without one
            self._parity_gate(width, height)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.mark_ready()
        log.info("warmed up %dx%d analyzer on %s", width, height, self.device)

    def _warm_zoo(self, width: int, height: int) -> None:
        """Capture the zoo extras' graphs for a camera: the direct
        analyzer, or on the batched path the one-frame bucket
        (``zoo_eager_warm`` negative: every bucket); their other buckets
        capture at their first dispatch. Runs inside :meth:`warmup`'s
        device scope."""
        extras = self.zoo.extras()
        if not extras:
            return
        dispatcher = self._engine.dispatcher
        k = self._camera(width, height)
        for entry in extras:
            if dispatcher is None:
                k_dev, scale = self._geometry(width, height).staged()
                entry.analyze(np.zeros((height, width, 3), np.uint8),
                              np.zeros((height, width), np.uint16),
                              k_dev, scale)
                continue
            sizes = (self._buckets(dispatcher) if self.cfg.zoo_eager_warm < 0
                     else [dispatcher.bucket_for(1, entry.name)])
            for b in sizes:
                dispatcher.warm(
                    np.zeros((b, height, width, 3), np.uint8),
                    np.zeros((b, height, width), np.uint16),
                    np.repeat(k[None], b, axis=0),
                    np.full((b,), self.depth_scale, np.float32),
                    model=entry.name)

    def _parity_gate(self, width: int, height: int) -> None:
        """The warm-up parity gate of a bf16 or int8 tier (none at f32),
        for the default model and then each zoo extra against its own
        untransformed net (:meth:`_parity_gate_for`). The default model's
        report of a passing gate is kept in ``self.parity``, an extra's in
        its entry. Runs inside :meth:`warmup`'s device scope."""
        if self.precision == "f32":
            return
        self.parity = self._parity_gate_for(
            self.model_label, self._engine.pristine, None, width, height)
        for entry in self.zoo.extras():
            entry.parity = self._parity_gate_for(
                entry.name, entry.pristine, entry, width, height)

    def _parity_gate_for(self, name: str, pristine: UNet,
                         entry: zoo_lib.ZooEntry | None, width: int,
                         height: int) -> dict:
        """One model's gate: ``quant_parity_frames`` golden frames of the
        camera's size through a reference analyzer of the untransformed
        net, run eagerly (no graph capture, no capture budget, no graph
        memory), and through the path the servicer serves (the direct
        packed analyzer, or the dispatcher), compared by
        ``ops/quant.parity_report``. Publishes the report's
        ``rdp_quant_parity_*`` gauges. Fails closed: raises
        ``RuntimeError`` below ``quant_parity_min_iou`` or above
        ``quant_parity_max_curv_err``."""
        cfg, eng = self.cfg, self._engine
        ref = pipeline.make_frame_analyzer(
            reference_forward(pristine, device=self.device),
            img_size=cfg.model_img_size, geom_cfg=self.geom_cfg,
            device=self.device)
        k = self._camera(width, height)
        scale = np.float32(self.depth_scale)
        refs, gots = [], []
        geom = self._geometry(width, height)
        for rgb, depth in quant.golden_frames(cfg.quant_parity_frames,
                                              height, width):
            refs.append(ref.eager(rgb, depth, k, scale))
            out = self._packed(eng, rgb, depth, geom, entry=entry)
            if isinstance(out, egress.PackedResult):
                try:
                    gots.append(out.to_analysis())
                finally:
                    out.release()
            else:
                gots.append(out)
        report = quant.parity_report(refs, gots)
        obs.QUANT_PARITY_IOU.labels(model=name).set(
            report["mask_iou_mean"])
        obs.QUANT_PARITY_CURV.labels(stat="mean", model=name).set(
            report["curvature_err_mean"])
        obs.QUANT_PARITY_CURV.labels(stat="max", model=name).set(
            report["curvature_err_max"])
        model_name = (cfg.model_name if entry is None
                      else variants_lib.registered_name(entry.variant,
                                                        cfg.model_name))
        if not quant.parity_gates_pass(report, cfg.quant_parity_min_iou,
                                       cfg.quant_parity_max_curv_err):
            raise RuntimeError(
                f"{self.precision} serving of model {model_name!r} "
                f"failed its parity gate vs the f32 goldens: mean IoU "
                f"{report['mask_iou_mean']:.4f} "
                f"(floor {cfg.quant_parity_min_iou}), max |d curvature| "
                f"{report['curvature_err_max']:.4f} (ceiling "
                f"{cfg.quant_parity_max_curv_err}) over "
                f"{report['frames']} frames"
            )
        log.info(
            "%s parity gate passed for %s: mean IoU %.4f, curvature err "
            "mean %.4g / max %.4g over %d goldens", self.precision,
            model_name, report["mask_iou_mean"],
            report["curvature_err_mean"], report["curvature_err_max"],
            report["frames"])
        return report

    def warmup_coef(self, width: int, height: int,
                    subsampling: str = "420") -> None:
        """Warm the coefficient lane for a camera geometry, capturing its
        graphs on the card: a blank (mid-gray, standard tables)
        coefficient frame through the direct coefficient analyzer, or
        with batching through every bucket
        (``BatchDispatcher.warm_coef``). :meth:`warmup` calls it when
        on-chip decode is on; a server whose clients send ``format = 2``
        calls it before load arrives."""
        frame = ingest.blank_coefficient_frame(height, width, subsampling)
        depth = np.zeros((height, width), np.uint16)
        eng = self._engine
        with _device_scope(self.device):
            if eng.dispatcher is None:
                self.analyze_frame(frame, depth)
            else:
                k = self._camera(width, height)
                for b in self._buckets(eng.dispatcher):
                    eng.dispatcher.warm_coef(
                        frame, np.zeros((b, height, width), np.uint16),
                        np.repeat(k[None], b, axis=0),
                        np.full((b,), self.depth_scale, np.float32))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def mark_ready(self) -> None:
        """Readiness up: every health entry SERVING, journaled."""
        self.health.set_all(health_lib.SERVING)
        journal_lib.JOURNAL.append(
            events.SERVER_READY, version=str(self.current_version))

    # -- shutdown ---------------------------------------------------------------

    def drain(self, timeout_s: float | None = None) -> bool:
        """Begin graceful shutdown: readiness to NOT_SERVING, new streams
        refused (UNAVAILABLE, so clients fail over), then wait up to
        ``timeout_s`` (default ``cfg.drain_grace_s``) for the streams in
        flight to finish. Returns True when none is left. Idempotent;
        :meth:`close` calls it first."""
        timeout_s = self.cfg.drain_grace_s if timeout_s is None else timeout_s
        with self._streams_cond:
            already = self._draining
            self._draining = True
        if not already:
            self.health.set_all(health_lib.NOT_SERVING)
            journal_lib.JOURNAL.append(
                events.SERVER_DRAIN, streams=str(self.active_streams))
            # graceful departure beats lease expiry: every registrar marks
            # this member draining (left) now instead of a TTL later
            if self.lease_client is not None:
                self.lease_client.leave()
            log.info("draining: readiness down, waiting for %d in-flight "
                     "stream(s)", self.active_streams)
        deadline = time.monotonic() + timeout_s
        with self._streams_cond:
            while self._active_streams > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log.warning(
                        "drain grace (%.1fs) expired with %d stream(s) "
                        "still in flight", timeout_s, self._active_streams)
                    return False
                self._streams_cond.wait(remaining)
        return True

    def close(self) -> None:
        """Drain, stop the controller and the reloader, stop every
        dispatcher (the live one and those in their grace period; pending
        frames drain or fail), then the decode and encode pools (the JAX
        package's order), stop the metrics endpoint and flush the
        metrics."""
        self.drain()
        if self.lease_client is not None:
            self.lease_client.stop()
            self.lease_client = None
        if self.controller is not None:
            self.controller.stop()
        # flag first: an in-flight reload re-checks it before swapping, so
        # a generation built after this point never goes live
        with self._streams_cond:
            self._closed = True
        if self._reload_stop is not None:
            self._reload_stop.set()
        if self._reload_thread is not None:
            self._reload_thread.join(timeout=5)
            self._reload_thread = None
        with self._reload_lock:
            pending, self._grace_stops = self._grace_stops, []
            engine = self._engine
        for timer, dispatcher in pending:
            timer.cancel()
            dispatcher.stop()
        if engine.dispatcher is not None:
            engine.dispatcher.stop()
        self.ingest.stop()
        self.egress.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        self.metrics.close()


def build_service(cfg: ServerConfig, forward=None, *,
                  geom_cfg: GeometryConfig | None = None,
                  warmup_shape: tuple[int, int] | None = None,
                  device="cuda") -> VisionAnalysisService:
    """A servicer built from the settings.

    ``forward`` defaults to the registered model (``cfg.tracking_uri``,
    ``cfg.model_name``, ``cfg.model_alias``; :func:`resolve_serving_model`)
    made the served forward by :func:`tier_forward` (``cfg.model_forward``:
    folded onto the kernels as a :class:`ops.unet_infer.FoldedUNet`, or
    with "flax" the unfolded net); its version is
    ``service.current_version``. The camera calibration comes
    from ``cfg.calibration_path`` (intrinsics and depth scale) when that
    file exists, else the focal-length default and
    ``cfg.default_depth_scale``. ``warmup_shape`` = (width, height) runs
    blank frames first, then a bf16 or int8 tier's parity gate (a failed
    gate closes the servicer and raises).

    At a bf16 or int8 tier (``cfg.precision``, overridden by
    ``RDP_PRECISION``) the registered net is transformed
    (:func:`tier_forward`) and folded, and the untransformed net is kept
    for the gate. A caller's own ``forward`` serves only at f32 (there is
    no untransformed net to gate it against): another tier raises
    ``ValueError``.
    """
    version = pristine = None
    device = resolve_device(device)
    if forward is None:
        _, net, version = resolve_serving_model(cfg, device=device)
        forward, pristine = tier_forward(net, cfg.precision, device,
                                         cfg.model_forward)
    intrinsics, depth_scale = None, cfg.default_depth_scale
    try:
        mtx, _, scale = load_calibration(cfg.calibration_path)
        intrinsics = np.asarray(mtx)
        if scale is not None:
            depth_scale = scale
        log.info("calibration loaded from %s", cfg.calibration_path)
    except (FileNotFoundError, KeyError) as exc:
        # the message, not the exception: a kept log record would hold its
        # traceback's frames, and with them this generation's forward
        log.warning("no calibration at %s (%s); using focal-length defaults",
                    cfg.calibration_path, str(exc))
    service = VisionAnalysisService(forward, intrinsics, depth_scale, cfg,
                                    geom_cfg, device=device,
                                    pristine=pristine, version=version)
    if warmup_shape is not None:
        try:
            service.warmup(*warmup_shape)
        except BaseException:
            service.close()
            raise
    return service


if __name__ == "__main__":
    from robotic_discovery_platform_tpu_torch.serving.grpc_service import main

    main()
