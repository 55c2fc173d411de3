"""The gRPC face of the servicer: proto messages in and out of
:meth:`serving.server.VisionAnalysisService.analyze_stream`, on the wire
contract of ``protos/vision.proto`` (the same service, method path and
messages as the JAX package's server).

grpc and protobuf are imported inside the functions that need them, so the
servicer core runs where neither is installed.
"""

from __future__ import annotations

import logging

import numpy as np

from robotic_discovery_platform_tpu_torch.serving import messages
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ServerConfig,
)

log = logging.getLogger(__name__)


def request_from_proto(msg) -> messages.AnalysisRequest:
    """``vision_pb2.AnalysisRequest`` -> the dataclass (payload bytes are
    shared, not copied)."""

    def image(img) -> messages.Image:
        return messages.Image(img.data, img.width, img.height, img.format)

    return messages.AnalysisRequest(
        color_image=image(msg.color_image), depth_image=image(msg.depth_image),
        model=msg.model, mask_format=msg.mask_format,
    )


def response_to_proto(resp: messages.AnalysisResponse):
    """The dataclass -> ``vision_pb2.AnalysisResponse``."""
    from robotic_discovery_platform_tpu_torch.serving.proto import vision_pb2

    return vision_pb2.AnalysisResponse(
        mean_curvature=resp.mean_curvature,
        max_curvature=resp.max_curvature,
        spline_points=[vision_pb2.Point3D(x=p.x, y=p.y, z=p.z)
                       for p in resp.spline_points],
        status=resp.status,
        mask=resp.mask,
        mask_coverage=resp.mask_coverage,
        proc_time_ms=resp.proc_time_ms,
        packed_spline=resp.packed_spline,
    )


class GrpcVisionService:
    """``AnalyzeActuatorPerformance`` over a :class:`VisionAnalysisService`."""

    def __init__(self, service: VisionAnalysisService):
        self.service = service

    def AnalyzeActuatorPerformance(self, request_iterator, context):
        requests = (request_from_proto(r) for r in request_iterator)
        for resp in self.service.analyze_stream(requests,
                                                active=context.is_active):
            yield response_to_proto(resp)


def build_server(cfg: ServerConfig, forward, *,
                 geom_cfg: GeometryConfig | None = None,
                 warmup_shape: tuple[int, int] | None = None,
                 device="cuda"):
    """An unstarted (grpc.Server, VisionAnalysisService) pair serving
    ``forward`` (a :class:`ops.unet_infer.FoldedUNet`) on
    ``cfg.address``; the bound port is ``servicer.bound_port``.

    The camera calibration comes from ``cfg.calibration_path`` (intrinsics
    and depth scale) when that file exists, else the focal-length default
    and ``cfg.default_depth_scale``. ``geom_cfg`` defaults to ``stride =
    cfg.geometry_stride``. ``warmup_shape`` = (width, height) runs one
    blank frame first.
    """
    from concurrent import futures

    import grpc

    from robotic_discovery_platform_tpu_torch.io.frames import (
        load_calibration,
    )
    from robotic_discovery_platform_tpu_torch.serving.proto import vision_grpc

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
    servicer = VisionAnalysisService(forward, intrinsics, depth_scale, cfg,
                                     geom_cfg, device=device)
    if warmup_shape is not None:
        servicer.warmup(*warmup_shape)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=cfg.max_workers))
    vision_grpc.add_VisionAnalysisServiceServicer_to_server(
        GrpcVisionService(servicer), server)
    servicer.bound_port = server.add_insecure_port(cfg.address)
    return server, servicer
