"""The vision analysis servicer.

The port of the JAX package's ``serving/server.py`` ``_analyze_frame``
and the per-stream loop of ``_stream_frames``: each request is decoded,
analyzed on the device, its mask encoded in the requested wire format,
and answered with status ``"OK"``, ``"DEGRADED: insufficient geometry"``
or ``"ERROR: <Type>: <message>"``; a failing frame never ends its stream.
Every answered frame appends one row to the metrics CSV.

Two paths, as in the JAX package: with ``ServerConfig.batch_window_ms``
at 0 (the default) each frame runs the single-frame analyzer
(:func:`ops.pipeline.make_frame_analyzer` around the folded U-Net) in its
handler thread; above 0, frames of concurrent streams meet in the batch
dispatcher (``serving/batching.py``) and come back as packed rows
(:class:`serving.egress.PackedResult`). A dispatcher at its backlog cap
ends the stream with :class:`serving.admission.OverloadedError` (the gRPC
adapter answers RESOURCE_EXHAUSTED).

The core, :meth:`VisionAnalysisService.analyze_stream`, maps an iterator
of :class:`serving.messages.AnalysisRequest` to an iterator of
:class:`serving.messages.AnalysisResponse` and needs neither grpc nor
protobuf; ``serving/grpc_service.py`` puts it behind a gRPC server.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.ops import pipeline
from robotic_discovery_platform_tpu_torch.serving import egress, ingest
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


class FrameResult(NamedTuple):
    """One analyzed frame's response fields."""

    mean_k: float
    max_k: float
    spline: np.ndarray  # [N, 3]; empty when invalid or packed
    mask_bytes: bytes  # the mask payload in the requested format
    coverage: float
    valid: bool
    spline_wire: bytes = b""  # packed_spline for mask_format 1/2


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
    """

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 intrinsics: np.ndarray | None = None,
                 depth_scale: float | None = None,
                 cfg: ServerConfig = ServerConfig(),
                 geom_cfg: GeometryConfig | None = None,
                 metrics: MetricsWriter | None = None,
                 device: str | torch.device = "cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.geom_cfg = (geom_cfg if geom_cfg is not None
                         else GeometryConfig(stride=cfg.geometry_stride))
        self.intrinsics = intrinsics
        self.depth_scale = (cfg.default_depth_scale if depth_scale is None
                            else float(depth_scale))
        self.analyze = pipeline.make_frame_analyzer(
            forward, img_size=cfg.model_img_size, geom_cfg=self.geom_cfg,
            device=self.device,
        )
        self.dispatcher = None
        if cfg.batch_window_ms > 0:
            self.dispatcher = BatchDispatcher(
                pipeline.make_batch_analyzer(
                    forward, img_size=cfg.model_img_size,
                    geom_cfg=self.geom_cfg, device=self.device, pack=True),
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

    def analyze_frame(self, rgb: np.ndarray, depth: np.ndarray,
                      mask_format: int = 0) -> FrameResult:
        """One decoded frame -> its response fields (the device result is
        read back here, once)."""
        h, w = rgb.shape[:2]
        if depth.shape != (h, w):
            raise ValueError(
                f"depth frame is {depth.shape[1]}x{depth.shape[0]}; color "
                f"frame is {w}x{h}"
            )
        if self.dispatcher is not None:
            return self._analyze_batched(rgb, depth, mask_format)
        k, scale = self._staged_geometry(w, h)
        out = self.analyze(rgb, depth, k, scale)
        prof = out.profile
        scalars = torch.stack([
            out.mask_coverage, prof.mean_curvature, prof.max_curvature,
            prof.valid.to(torch.float32),
        ]).cpu().numpy()
        mask = out.mask.cpu().numpy()
        coverage, mean_k, max_k, valid = (float(v) for v in scalars)
        valid = bool(valid)
        spline = (prof.spline_points.cpu().numpy() if valid
                  else np.zeros((0, 3), np.float32))
        if not valid:
            mean_k = max_k = 0.0
        spline_wire = b""
        if mask_format:
            # packed wire formats carry the spline as f32 LE triples
            spline_wire = np.ascontiguousarray(spline, "<f4").tobytes()
            spline = np.zeros((0, 3), np.float32)
        return FrameResult(mean_k, max_k, spline,
                           egress.encode_mask(mask, mask_format), coverage,
                           valid, spline_wire)

    def _analyze_batched(self, rgb: np.ndarray, depth: np.ndarray,
                         mask_format: int) -> FrameResult:
        """One frame through the batch dispatcher: the response fields off
        its packed row (the direct path's values, bit for bit)."""
        h, w = rgb.shape[:2]
        packed = self.dispatcher.submit(rgb, depth, self._camera(w, h),
                                        self.depth_scale)
        try:
            coverage, mean_k, max_k, valid, _ = packed.scalars()
            if mask_format == egress.MASK_FORMAT_BITS:
                # the wire payload is the packed rows behind a header
                mask_bytes = egress.encode_bits_wire(packed.mask_bits, h, w)
            else:
                mask_bytes = egress.encode_mask(packed.unpack_mask(),
                                                mask_format)
            spline_wire = packed.spline_wire() if mask_format else b""
            spline = (np.zeros((0, 3), np.float32) if mask_format
                      else packed.spline())
        finally:
            packed.release()
        return FrameResult(mean_k, max_k, spline, mask_bytes, coverage, valid,
                           spline_wire)

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
            rgb, depth = ingest.decode_request(request)
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

    def warmup(self, width: int, height: int) -> None:
        """Run blank frames of the camera's size through the analyzer the
        served frames will take -- with batching, every bucket up to
        ``max_batch`` -- so the first served frame pays no kernel build or
        first-launch cost."""
        if self.dispatcher is None:
            self.analyze_frame(np.zeros((height, width, 3), np.uint8),
                               np.zeros((height, width), np.uint16))
        else:
            k = self._camera(width, height)
            for b in sorted({self.dispatcher.bucket_for(n)
                             for n in range(1, self.cfg.max_batch + 1)}):
                self.dispatcher.warm(
                    np.zeros((b, height, width, 3), np.uint8),
                    np.zeros((b, height, width), np.uint16),
                    np.repeat(k[None], b, axis=0),
                    np.full((b,), self.depth_scale, np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log.info("warmed up %dx%d analyzer on %s", width, height, self.device)

    def close(self) -> None:
        """Stop the dispatcher (its pending frames drain or fail) and
        flush the metrics."""
        if self.dispatcher is not None:
            self.dispatcher.stop()
        self.metrics.close()
