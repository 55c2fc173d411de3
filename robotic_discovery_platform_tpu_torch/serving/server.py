"""The vision analysis servicer.

The port of the JAX package's ``serving/server.py`` ``_analyze_frame``
and the per-stream loop of ``_stream_frames``: each request is decoded,
analyzed on the device, its mask encoded in the requested wire format,
and answered with status ``"OK"``, ``"DEGRADED: insufficient geometry"``
or ``"ERROR: <Type>: <message>"``; a failing frame never ends its stream.
Every answered frame appends one row to the metrics CSV.

Two paths, as in the JAX package: with ``ServerConfig.batch_window_ms``
at 0 (the default) each frame runs the single-frame analyzer
(:func:`ops.pipeline.make_frame_analyzer` around the folded U-Net,
``pack=True``) in its handler thread: on the card its camera geometry's
CUDA graph replays under the graph's lock and the frame's packed row comes
back in one device-to-host copy before the lock is released; above 0,
frames of concurrent streams meet in the batch dispatcher
(``serving/batching.py``) and come back as packed rows. Both read the
response fields off a :class:`serving.egress.PackedResult` alike.
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

:func:`build_service` makes a servicer from the settings alone: with no
forward it loads the registered model (:func:`resolve_serving_model`: the
``model_alias`` version first, else the latest), transforms it for the
precision tier (``ServerConfig.precision`` or ``RDP_PRECISION``,
``ops/quant.py``) and folds it onto the kernels. A bf16 or int8 tier
must pass its parity gate at the end of :meth:`VisionAnalysisService.
warmup` (golden frames through the untransformed net against the served
path) or the servicer refuses to come up. Hot reload of a newly
registered version, and the re-quantization it brings, are not ported
(ROADMAP queue 1 item 5); neither are the JAX package's
``rdp_quant_parity_*`` gauges (item 23) or its per-zoo-model gates (item
12).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import load_calibration
from robotic_discovery_platform_tpu_torch.models.unet import UNet
from robotic_discovery_platform_tpu_torch.ops import pipeline, quant
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import (
    egress,
    entropy,
    ingest,
)
from robotic_discovery_platform_tpu_torch.serving.admission import (
    OverloadedError,
)
from robotic_discovery_platform_tpu_torch.serving.batching import (
    BatchDispatcher,
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

log = logging.getLogger(__name__)

STATUS_OK = "OK"
STATUS_DEGRADED = "DEGRADED: insufficient geometry"


def resolve_serving_version(cfg: ServerConfig,
                            store: tracking.FileStore | None = None) -> int:
    """The registry version a server runs: ``cfg.model_alias``'s when that
    alias is set, else the latest of ``cfg.model_name``. Raises KeyError
    when the model has no version. ``store`` defaults to one scoped to
    ``cfg.tracking_uri`` (the process-global tracking URI is left
    alone)."""
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


class FrameResult(NamedTuple):
    """One analyzed frame's response fields."""

    mean_k: float
    max_k: float
    spline: np.ndarray  # [N, 3]; empty when invalid or packed
    mask_bytes: bytes  # the mask payload in the requested format
    coverage: float
    valid: bool
    spline_wire: bytes = b""  # packed_spline for mask_format 1/2


def _fields(packed: egress.PackedResult, h: int, w: int,
            mask_format: int) -> FrameResult:
    """A frame's response fields off its packed row."""
    coverage, mean_k, max_k, valid, _ = packed.scalars()
    if mask_format == egress.MASK_FORMAT_BITS:
        # the wire payload is the packed rows behind a header
        mask_bytes = egress.encode_bits_wire(packed.mask_bits, h, w)
    else:
        mask_bytes = egress.encode_mask(packed.unpack_mask(), mask_format)
    spline_wire = packed.spline_wire() if mask_format else b""
    spline = (np.zeros((0, 3), np.float32) if mask_format
              else packed.spline())
    return FrameResult(mean_k, max_k, spline, mask_bytes, coverage, valid,
                       spline_wire)


def _device_scope(device: torch.device):
    """``device`` as the current CUDA device for the calls in the block (a
    null context on the CPU). Every kernel wrapper takes tensors on the
    current device only, so the direct path of a servicer on a card other
    than the current one enters its own card first; the batched path
    enters it through its stream (``serving/batching.py``)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class VisionAnalysisService:
    """Servicer over a model forward, direct or batched (see the module
    docstring).

    Args:
        forward: NHWC float32 -> NHWC float32 logits on ``device`` (a
            :class:`ops.unet_infer.FoldedUNet`).
        intrinsics: [3, 3] camera matrix, or None for the focal-length
            default of each frame's size.
        depth_scale: depth-to-metres factor.
        cfg: server settings (``model_img_size``, metrics CSV).
        geom_cfg: geometry settings (default: ``stride =
            cfg.geometry_stride``).
        metrics: the metrics writer (default: one on ``cfg.metrics_csv``).
        device: where frames are analyzed.
        pristine: the untransformed net that ``forward`` was made from at a
            bf16 or int8 tier (:func:`build_service` passes it): the
            warm-up's parity gate runs it as the f32 reference. A non-f32
            tier without it raises ``ValueError``.
    """

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 intrinsics: np.ndarray | None = None,
                 depth_scale: float | None = None,
                 cfg: ServerConfig = ServerConfig(),
                 geom_cfg: GeometryConfig | None = None,
                 metrics: MetricsWriter | None = None,
                 device: str | torch.device = "cuda",
                 pristine: UNet | None = None):
        check_supported(cfg)
        # resolved once (RDP_PRECISION overrides the field)
        self.precision = quant.resolve_precision(cfg.precision)
        if self.precision != "f32" and pristine is None:
            raise ValueError(
                f"precision {self.precision!r} needs the untransformed net "
                "for its warm-up parity gate; a servicer given only a "
                "forward serves 'f32' (build_service transforms the "
                "registered model and keeps it)"
            )
        self._pristine = pristine
        #: the warm-up parity gate's report (None at f32 and before warmup)
        self.parity: dict | None = None
        self.cfg = cfg
        self.device = resolve_device(device)
        self.geom_cfg = (geom_cfg if geom_cfg is not None
                         else GeometryConfig(stride=cfg.geometry_stride))
        self.intrinsics = intrinsics
        self.depth_scale = (cfg.default_depth_scale if depth_scale is None
                            else float(depth_scale))
        self.onchip = ingest.resolve_onchip_decode(cfg.onchip_decode)
        # the direct path's analyzers end in the packed row and read it
        # back to the host before they release their graph
        self.analyze = pipeline.make_frame_analyzer(
            forward, img_size=cfg.model_img_size, geom_cfg=self.geom_cfg,
            device=self.device, pack=True,
        )
        self.analyze_coef = pipeline.make_coef_frame_analyzer(
            forward, img_size=cfg.model_img_size, geom_cfg=self.geom_cfg,
            device=self.device, pack=True,
        )
        self.dispatcher = None
        if cfg.batch_window_ms > 0:

            def coef_factory(height: int, width: int, subsampling: str):
                return pipeline.make_coef_batch_analyzer(
                    forward, img_size=cfg.model_img_size,
                    geom_cfg=self.geom_cfg, device=self.device,
                    height=height, width=width, subsampling=subsampling,
                    pack=True)

            self.dispatcher = BatchDispatcher(
                pipeline.make_batch_analyzer(
                    forward, img_size=cfg.model_img_size,
                    geom_cfg=self.geom_cfg, device=self.device, pack=True),
                coef_analyzer_factory=coef_factory,
                window_ms=cfg.batch_window_ms, max_batch=cfg.max_batch,
                max_backlog=cfg.max_backlog,
                submit_timeout_s=cfg.submit_deadline_s,
                watchdog_interval_s=cfg.watchdog_interval_s,
                max_inflight=cfg.max_inflight_dispatches,
                admission=cfg.admission_policy, device=self.device,
            )
        # per camera geometry: the float32 intrinsics and depth scale,
        # staged on the device once rather than once per frame
        self._geometry: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self.metrics = metrics or MetricsWriter(cfg.metrics_csv,
                                                cfg.metrics_flush_every)
        self.bound_port = 0  # set by grpc_service.build_server
        self.model_version: int | None = None  # set by build_service

    def _camera(self, w: int, h: int) -> np.ndarray:
        """The float32 intrinsics of a w x h camera."""
        k = (self.intrinsics if self.intrinsics is not None
             else ingest.default_intrinsics(w, h))
        return np.asarray(k, np.float32)

    def _staged_geometry(self, w: int, h: int):
        key = (w, h)
        staged = self._geometry.get(key)
        if staged is None:
            staged = self._geometry[key] = (
                torch.as_tensor(self._camera(w, h), device=self.device),
                torch.as_tensor(np.float32(self.depth_scale),
                                device=self.device),
            )
        return staged

    def analyze_frame(self, rgb, depth: np.ndarray,
                      mask_format: int = 0) -> FrameResult:
        """One decoded frame -> its response fields. ``rgb`` is [H, W, 3]
        uint8 pixels or a :class:`~serving.entropy.CoefficientFrame` (the
        coefficient lane). Directly, the frame's graph replays under its
        lock and its packed row comes back in one device-to-host copy;
        batched, the row is the dispatch's. Both read the fields off the
        row alike."""
        coef = isinstance(rgb, entropy.CoefficientFrame)
        h, w = rgb.shape[:2]
        if depth.shape != (h, w):
            raise ValueError(
                f"depth frame is {depth.shape[1]}x{depth.shape[0]}; color "
                f"frame is {w}x{h}"
            )
        packed = self._packed(rgb, depth)
        try:
            return _fields(packed, h, w, mask_format)
        finally:
            packed.release()

    def _packed(self, rgb, depth: np.ndarray) -> egress.PackedResult:
        """One frame's packed row, from the path the servicer serves
        (:meth:`analyze_frame`)."""
        h, w = rgb.shape[:2]
        coef = isinstance(rgb, entropy.CoefficientFrame)
        if self.dispatcher is not None:
            submit = (self.dispatcher.submit_coef if coef
                      else self.dispatcher.submit)
            return submit(rgb, depth, self._camera(w, h), self.depth_scale)
        with _device_scope(self.device):
            k, scale = self._staged_geometry(w, h)
            analyze = self.analyze_coef if coef else self.analyze
            return egress.PackedResult(analyze(rgb, depth, k, scale))

    def analyze_stream(self, requests: Iterable,
                       active: Callable[[], bool] = lambda: True
                       ) -> Iterator[AnalysisResponse]:
        """One response per request, in order. ``active`` returning False
        (a cancelled stream) stops the loop before the next frame."""
        try:
            for request in requests:
                if not active():
                    return
                yield self._respond(request)
        finally:
            self.metrics.flush()

    def _respond(self, request) -> AnalysisResponse:
        t0 = time.perf_counter()
        try:
            rgb, depth = ingest.decode_request(request, onchip=self.onchip)
            res = self.analyze_frame(rgb, depth, request.mask_format)
            response = AnalysisResponse(
                mean_curvature=res.mean_k,
                max_curvature=res.max_k,
                spline_points=[Point3D(float(p[0]), float(p[1]), float(p[2]))
                               for p in res.spline],
                status=STATUS_OK if res.valid else STATUS_DEGRADED,
                mask=res.mask_bytes,
                mask_coverage=res.coverage,
                packed_spline=res.spline_wire,
            )
            self.metrics.append(res.mean_k, res.max_k, res.coverage)
        except OverloadedError:
            raise  # load shedding ends the stream (RESOURCE_EXHAUSTED)
        except Exception as exc:  # a bad frame answers, the stream lives on
            log.exception("analysis error")
            response = AnalysisResponse(
                status=f"ERROR: {type(exc).__name__}: {exc}")
        response.proc_time_ms = (time.perf_counter() - t0) * 1e3
        return response

    def _buckets(self) -> list[int]:
        """Every padded batch size a dispatch can take."""
        return sorted({self.dispatcher.bucket_for(n)
                       for n in range(1, self.cfg.max_batch + 1)})

    def warmup(self, width: int, height: int) -> None:
        """Run blank frames of the camera's size through the analyzer the
        served frames will take -- with batching, every bucket up to
        ``max_batch`` -- so the first served frame pays no kernel build,
        warm-up or graph capture: on the card this is where each graph of
        the geometry is captured (``ops/graphs.py``; a capture is checked
        for this thread's calls only, so handler and dispatcher threads
        may already run). With on-chip decode on, the coefficient lane
        too (:meth:`warmup_coef`). A bf16 or int8 tier then runs its
        parity gate (:meth:`_parity_gate`), which raises ``RuntimeError``
        when the tier fails it."""
        with _device_scope(self.device):
            if self.dispatcher is None:
                self.analyze_frame(np.zeros((height, width, 3), np.uint8),
                                   np.zeros((height, width), np.uint16))
            else:
                k = self._camera(width, height)
                for b in self._buckets():
                    self.dispatcher.warm(
                        np.zeros((b, height, width, 3), np.uint8),
                        np.zeros((b, height, width), np.uint16),
                        np.repeat(k[None], b, axis=0),
                        np.full((b,), self.depth_scale, np.float32))
            if self.onchip:
                self.warmup_coef(width, height)
            # after every capture of the warm-up: the gate replays the
            # served graphs and runs its reference without one
            self._parity_gate(width, height)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        log.info("warmed up %dx%d analyzer on %s", width, height, self.device)

    def _parity_gate(self, width: int, height: int) -> None:
        """The warm-up parity gate of a bf16 or int8 tier (none at f32):
        ``quant_parity_frames`` golden frames of the camera's size through
        a reference analyzer of the untransformed net, run eagerly (no
        graph capture, no capture budget, no graph memory), and through
        the path the servicer serves (the direct packed analyzer, or the
        dispatcher), compared by ``ops/quant.parity_report``. Fails
        closed: raises ``RuntimeError`` below ``quant_parity_min_iou`` or
        above ``quant_parity_max_curv_err``; the report of a passing gate
        is kept in ``self.parity``. Runs inside :meth:`warmup`'s device
        scope."""
        if self.precision == "f32":
            return
        cfg = self.cfg
        ref = pipeline.make_frame_analyzer(
            FoldedUNet(self._pristine, device=self.device),
            img_size=cfg.model_img_size, geom_cfg=self.geom_cfg,
            device=self.device)
        k = self._camera(width, height)
        scale = np.float32(self.depth_scale)
        refs, gots = [], []
        for rgb, depth in quant.golden_frames(cfg.quant_parity_frames,
                                              height, width):
            refs.append(ref.eager(rgb, depth, k, scale))
            packed = self._packed(rgb, depth)
            try:
                gots.append(packed.to_analysis())
            finally:
                packed.release()
        report = quant.parity_report(refs, gots)
        if not quant.parity_gates_pass(report, cfg.quant_parity_min_iou,
                                       cfg.quant_parity_max_curv_err):
            raise RuntimeError(
                f"{self.precision} serving of model {cfg.model_name!r} "
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
            cfg.model_name, report["mask_iou_mean"],
            report["curvature_err_mean"], report["curvature_err_max"],
            report["frames"])
        self.parity = report

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
        with _device_scope(self.device):
            if self.dispatcher is None:
                self.analyze_frame(frame, depth)
            else:
                k = self._camera(width, height)
                for b in self._buckets():
                    self.dispatcher.warm_coef(
                        frame, np.zeros((b, height, width), np.uint16),
                        np.repeat(k[None], b, axis=0),
                        np.full((b,), self.depth_scale, np.float32))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Stop the dispatcher (its pending frames drain or fail) and
        flush the metrics."""
        if self.dispatcher is not None:
            self.dispatcher.stop()
        self.metrics.close()


def build_service(cfg: ServerConfig, forward=None, *,
                  geom_cfg: GeometryConfig | None = None,
                  warmup_shape: tuple[int, int] | None = None,
                  device="cuda") -> VisionAnalysisService:
    """A servicer built from the settings.

    ``forward`` defaults to the registered model (``cfg.tracking_uri``,
    ``cfg.model_name``, ``cfg.model_alias``; :func:`resolve_serving_model`)
    folded onto the kernels as a :class:`ops.unet_infer.FoldedUNet`; its
    version is ``service.model_version``. The camera calibration comes
    from ``cfg.calibration_path`` (intrinsics and depth scale) when that
    file exists, else the focal-length default and
    ``cfg.default_depth_scale``. ``warmup_shape`` = (width, height) runs
    blank frames first, then a bf16 or int8 tier's parity gate (a failed
    gate closes the servicer and raises).

    At a bf16 or int8 tier (``cfg.precision``, overridden by
    ``RDP_PRECISION``) the registered net is transformed
    (``ops/quant.apply_precision``) and folded, and the untransformed net
    is kept for the gate. A caller's own ``forward`` serves only at f32
    (there is no untransformed net to gate it against): another tier
    raises ``ValueError``.
    """
    version = net = report = None
    if forward is None:
        _, net, version = resolve_serving_model(cfg, device=device)
        served, report = quant.apply_precision(net, cfg.precision)
        if report is not None:
            log.info("serving precision tier %s: %s", report["tier"], report)
        forward = FoldedUNet(served, device=device)
    intrinsics, depth_scale = None, cfg.default_depth_scale
    try:
        mtx, _, scale = load_calibration(cfg.calibration_path)
        intrinsics = np.asarray(mtx)
        if scale is not None:
            depth_scale = scale
        log.info("calibration loaded from %s", cfg.calibration_path)
    except (FileNotFoundError, KeyError) as exc:
        log.warning("no calibration at %s (%s); using focal-length defaults",
                    cfg.calibration_path, exc)
    service = VisionAnalysisService(forward, intrinsics, depth_scale, cfg,
                                    geom_cfg, device=device,
                                    pristine=None if report is None else net)
    service.model_version = version
    if warmup_shape is not None:
        try:
            service.warmup(*warmup_shape)
        except BaseException:
            service.close()
            raise
    return service
