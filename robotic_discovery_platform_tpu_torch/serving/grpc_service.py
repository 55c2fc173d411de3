"""The gRPC face of the servicer: proto messages in and out of
:meth:`serving.server.VisionAnalysisService.analyze_stream`, on the wire
contract of ``protos/vision.proto`` (the same service, method path and
messages as the JAX package's server).

grpc and protobuf are imported inside the functions that need them, so the
servicer core runs where neither is installed.
"""

from __future__ import annotations

from robotic_discovery_platform_tpu_torch.serving import messages
from robotic_discovery_platform_tpu_torch.serving.admission import (
    OverloadedError,
)
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
    build_service,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ServerConfig,
)


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
        import grpc

        requests = (request_from_proto(r) for r in request_iterator)
        try:
            for resp in self.service.analyze_stream(requests,
                                                    active=context.is_active):
                yield response_to_proto(resp)
        except OverloadedError as exc:  # shed: retryable by the client
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))


def build_server(cfg: ServerConfig, forward=None, *,
                 geom_cfg: GeometryConfig | None = None,
                 warmup_shape: tuple[int, int] | None = None,
                 device="cuda"):
    """An unstarted (grpc.Server, VisionAnalysisService) pair on
    ``cfg.address``; the bound port is ``servicer.bound_port``. The
    servicer is :func:`serving.server.build_service`'s: with no
    ``forward`` it serves the registered model."""
    from concurrent import futures

    import grpc

    from robotic_discovery_platform_tpu_torch.serving.proto import vision_grpc

    servicer = build_service(cfg, forward, geom_cfg=geom_cfg,
                             warmup_shape=warmup_shape, device=device)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=cfg.max_workers))
    vision_grpc.add_VisionAnalysisServiceServicer_to_server(
        GrpcVisionService(servicer), server)
    servicer.bound_port = server.add_insecure_port(cfg.address)
    return server, servicer
