"""The gRPC face of the servicer: proto messages in and out of
:meth:`serving.server.VisionAnalysisService.analyze_stream`, on the wire
contract of ``protos/vision.proto`` (the same service, method path and
messages as the JAX package's server), beside the standard
``grpc.health.v1`` service (``serving/health.py``).

grpc and protobuf are imported inside the functions that need them, so the
servicer core runs where neither is installed.

Run a server on the card (the counterpart of ``python -m
robotic_discovery_platform_tpu.serving.server``)::

    python -m robotic_discovery_platform_tpu_torch.serving.server \
        [--device cuda] [--server.field value ...]

It serves the registered model (``--server.tracking_uri``,
``--server.model_name``, ``--server.model_alias``), warms a 640x480
camera, marks itself ready, polls the registry for new versions every
``--server.reload_poll_s`` seconds, serves ``/metrics`` and ``/debug/*``
on ``--server.metrics_port`` when that is set, and on SIGINT (or
KeyboardInterrupt) drains before it stops: readiness down, in-flight
streams given ``drain_grace_s``, then the gRPC server stopped and the
servicer closed.
"""

from __future__ import annotations

import argparse

from robotic_discovery_platform_tpu_torch.observability import (
    exposition,
    trace,
)
from robotic_discovery_platform_tpu_torch.serving import health as health_lib
from robotic_discovery_platform_tpu_torch.serving import messages
from robotic_discovery_platform_tpu_torch.serving.admission import (
    OverloadedError,
)
from robotic_discovery_platform_tpu_torch.serving.server import (
    StreamRefusedError,
    VisionAnalysisService,
    build_service,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ServerConfig,
    parse_config,
)
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


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
        # the client's trace (W3C traceparent metadata): its stream's log
        # lines and error statuses carry the same [trace=...] stamp
        remote = trace.from_metadata(context.invocation_metadata())
        try:
            for resp in self.service.analyze_stream(
                    requests, active=context.is_active, parent=remote,
                    time_remaining=context.time_remaining):
                yield response_to_proto(resp)
        except StreamRefusedError as exc:  # draining or browned out
            context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))
        except OverloadedError as exc:  # shed: retryable by the client
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))


def rollout_debug(servicer: VisionAnalysisService) -> dict:
    """The ``GET /debug/rollout`` payload: the attached rollout manager's
    snapshot, or why there is none."""
    if servicer.rollout is not None:
        return servicer.rollout.snapshot()
    return {"enabled": False,
            "reason": "no rollout manager attached (RolloutConfig.enabled "
                      "/ RDP_ROLLOUT)"}


def build_server(cfg: ServerConfig, forward=None, *,
                 geom_cfg: GeometryConfig | None = None,
                 warmup_shape: tuple[int, int] | None = None,
                 device="cuda"):
    """An unstarted (grpc.Server, VisionAnalysisService) pair on
    ``cfg.address``; the bound port is ``servicer.bound_port``. The
    servicer is :func:`serving.server.build_service`'s: with no
    ``forward`` it serves the registered model.

    As the JAX package's ``build_server``: the process's tracing identity
    becomes "replica"; the ``/metrics`` endpoint starts when
    ``cfg.metrics_port`` (or ``RDP_METRICS_PORT``) asks for one (a failed
    start raises), with the servicer's ``drift_debug`` behind
    ``/debug/drift``, its ``zoo_debug`` behind ``/debug/zoo`` and its
    rollout manager's snapshot behind ``/debug/rollout`` (resolved per
    request, so a manager attached later is served at once); readiness
    flips after the warm-up, or at once with
    none; the registry reloader starts; the grpc.health.v1 service and
    the fleet's ``rdp.fleet.ReplicaStats`` service (``Get`` answering
    :meth:`~serving.server.VisionAnalysisService.replica_stats`, ``Drain``
    calling ``set_draining``) are registered beside the analysis service;
    and with registrars configured (``cfg.fleet_registrars`` /
    ``RDP_FLEET_REGISTRARS``) a :class:`~serving.fleet.LeaseClient`
    advertises this server (``localhost:<bound port>`` unless
    ``fleet_advertise`` says otherwise) and renews its lease."""
    from concurrent import futures

    import grpc

    from robotic_discovery_platform_tpu_torch.serving import fleet as fleet_lib
    from robotic_discovery_platform_tpu_torch.serving.proto import vision_grpc

    trace.set_identity(role="replica")
    servicer = build_service(cfg, forward, geom_cfg=geom_cfg, device=device)
    try:
        servicer.metrics_server = exposition.maybe_start_metrics_server(
            cfg.metrics_port)
        if servicer.metrics_server is not None:
            # /debug/drift serves the drift monitor's live state
            servicer.metrics_server.set_drift_provider(servicer.drift_debug)
            servicer.metrics_server.set_zoo_provider(servicer.zoo_debug)
            servicer.metrics_server.set_rollout_provider(
                lambda: rollout_debug(servicer))
        if warmup_shape is not None:
            servicer.warmup(*warmup_shape)  # flips readiness at its end
        else:
            servicer.mark_ready()
        servicer.start_reloader()
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=cfg.max_workers))
        vision_grpc.add_VisionAnalysisServiceServicer_to_server(
            GrpcVisionService(servicer), server)
        health_lib.add_HealthServicer_to_server(servicer.health, server)
        # the fleet front-end scrapes in-flight streams and burn here to
        # place streams, and retires this member through Drain
        fleet_lib.add_replica_stats_to_server(
            server, servicer.replica_stats, drain=servicer.set_draining)
        servicer.bound_port = server.add_insecure_port(cfg.address)
        _start_lease(cfg, servicer)
    except BaseException:
        servicer.close()
        raise
    return server, servicer


def _start_lease(cfg: ServerConfig, servicer: VisionAnalysisService) -> None:
    """Elastic membership: register and renew a lease with every
    configured registrar (front-end), as the JAX package's build_server
    does; a replica respawned on a new port rejoins with no config edit,
    since it advertises the port just bound."""
    from robotic_discovery_platform_tpu_torch.serving import fleet as fleet_lib

    registrars = fleet_lib.resolve_fleet_registrars(cfg.fleet_registrars)
    if not registrars:
        return
    advertise = fleet_lib.resolve_fleet_advertise(
        cfg.fleet_advertise, default=f"localhost:{servicer.bound_port}")
    servicer.lease_client = fleet_lib.LeaseClient(
        registrars, endpoint=advertise,
        metrics_port=(servicer.metrics_server.port
                      if servicer.metrics_server is not None else 0),
        version=str(servicer.current_version), ttl_s=cfg.fleet_lease_ttl_s)
    servicer.lease_client.start()
    log.info("fleet lease: advertising %s to %s (ttl %.1fs)", advertise,
             ",".join(registrars), cfg.fleet_lease_ttl_s)


def shutdown(server, servicer: VisionAnalysisService) -> None:
    """The shutdown order of :func:`serve`: readiness down first so load
    balancers stop routing here, a bounded drain of the streams in flight,
    the gRPC server's stop with ``drain_grace_s`` of grace, then the
    servicer's close."""
    servicer.drain()
    server.stop(grace=servicer.cfg.drain_grace_s).wait()
    servicer.close()


def serve(cfg: ServerConfig = ServerConfig(), warmup_shape=(640, 480),
          device="cuda") -> None:
    """Run a server until interrupted, then :func:`shutdown` it."""
    server, servicer = build_server(cfg, warmup_shape=warmup_shape,
                                    device=device)
    server.start()
    log.info("vision analysis server listening on %s (port %d)",
             cfg.address, servicer.bound_port)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        log.info("interrupt: beginning graceful shutdown")
    finally:
        shutdown(server, servicer)


def main(argv: list[str] | None = None) -> None:
    """``python -m robotic_discovery_platform_tpu_torch.serving.server``:
    ``--device`` (default "cuda"), then the config flags of
    :func:`utils.config.parse_config` (``--config FILE``,
    ``--server.field value``)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    args, rest = parser.parse_known_args(argv)
    serve(parse_config(rest).server, device=args.device)


if __name__ == "__main__":
    main()
