"""Standard ``grpc.health.v1`` health/readiness service.

Wire-compatible with grpc_health_probe and Kubernetes native gRPC probes:
same service name (``grpc.health.v1.Health``), same method paths, same
message bytes (serving/proto/health_pb2.py). Like vision_grpc.py, the stub
and registration glue are handwritten on grpcio's generic APIs because the
image lacks the grpc_tools plugin and the grpcio-health-checking wheel.

The port's copy of the JAX package's ``serving/health.py``. grpc and the
message classes (``serving/proto/health_pb2.py``, which needs protobuf)
are imported inside the functions that need them, so the servicer core
(status registry, ``set_all``) runs where neither is installed; the
status constants are the ``ServingStatus`` enum's values.

Semantics (mirroring the canonical HealthServicer):

- ``Check("")`` answers for the process as a whole; per-service statuses
  are registered under their full service name.
- An unknown service NOT_FOUNDs on Check and streams SERVICE_UNKNOWN on
  Watch (the canonical servicer's documented behavior).
- ``Watch`` pushes the current status immediately and again on every
  change; the serving stack flips readiness to SERVING only after model
  warm-up and back to NOT_SERVING when a drain begins.
"""

from __future__ import annotations

import threading

SERVICE_NAME = "grpc.health.v1.Health"
_CHECK_PATH = f"/{SERVICE_NAME}/Check"
_WATCH_PATH = f"/{SERVICE_NAME}/Watch"

# grpc.health.v1.HealthCheckResponse.ServingStatus
UNKNOWN = 0
SERVING = 1
NOT_SERVING = 2
SERVICE_UNKNOWN = 3

# how often a Watch stream re-checks client liveness while idle (a watch
# with no status changes must still notice a gone client and free its
# handler thread)
_WATCH_POLL_S = 1.0


class HealthServicer:
    """Thread-safe status registry + the two RPCs."""

    def __init__(self):
        self._cond = threading.Condition()
        self._statuses: dict[str, int] = {"": NOT_SERVING}

    # -- server-side state ---------------------------------------------------

    def set(self, service: str, status: int) -> None:
        with self._cond:
            self._statuses[service] = status
            self._cond.notify_all()

    def set_all(self, status: int) -> None:
        """Flip every registered service (including the process-wide "")
        at once -- readiness up after warm-up, down on drain."""
        with self._cond:
            for service in self._statuses:
                self._statuses[service] = status
            self._cond.notify_all()

    def get(self, service: str = "") -> int | None:
        with self._cond:
            return self._statuses.get(service)

    # -- RPCs ----------------------------------------------------------------

    def Check(self, request, context):
        import grpc

        from robotic_discovery_platform_tpu_torch.serving.proto import (
            health_pb2,
        )

        with self._cond:
            status = self._statuses.get(request.service)
        if status is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"unknown service {request.service!r}")
        return health_pb2.HealthCheckResponse(status=status)

    def Watch(self, request, context):
        from robotic_discovery_platform_tpu_torch.serving.proto import (
            health_pb2,
        )

        last = None
        while context.is_active():
            with self._cond:
                status = self._statuses.get(request.service,
                                            SERVICE_UNKNOWN)
                if status == last:
                    # wait for a change (or an idle poll tick, to notice a
                    # gone client), then re-check
                    self._cond.wait(_WATCH_POLL_S)
                    continue
            last = status
            yield health_pb2.HealthCheckResponse(status=status)


class HealthStub:
    """Client stub: ``stub.Check(HealthCheckRequest(service=...))``."""

    def __init__(self, channel):
        from robotic_discovery_platform_tpu_torch.serving.proto import (
            health_pb2,
        )

        self.Check = channel.unary_unary(
            _CHECK_PATH,
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )
        self.Watch = channel.unary_stream(
            _WATCH_PATH,
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )


def add_HealthServicer_to_server(servicer: HealthServicer, server) -> None:
    import grpc

    from robotic_discovery_platform_tpu_torch.serving.proto import health_pb2

    handlers = {
        "Check": grpc.unary_unary_rpc_method_handler(
            servicer.Check,
            request_deserializer=health_pb2.HealthCheckRequest.FromString,
            response_serializer=(
                health_pb2.HealthCheckResponse.SerializeToString),
        ),
        "Watch": grpc.unary_stream_rpc_method_handler(
            servicer.Watch,
            request_deserializer=health_pb2.HealthCheckRequest.FromString,
            response_serializer=(
                health_pb2.HealthCheckResponse.SerializeToString),
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )
