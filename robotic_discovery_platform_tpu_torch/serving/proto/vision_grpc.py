"""Handwritten gRPC glue for the VisionAnalysisService.

The image has protoc but not grpc_tools' protoc plugin, so instead of a
generated ``vision_pb2_grpc.py`` this module builds the client stub and
server registration directly on grpcio's generic APIs -- same call shapes as
generated code (``VisionAnalysisServiceStub``, ``VisionAnalysisServiceServicer``,
``add_VisionAnalysisServiceServicer_to_server``), same method path, same
serializers, so it is wire-identical to the reference's generated stubs
(reference: pkg/protos/vision_pb2_grpc.py).
"""

from __future__ import annotations

import grpc

from robotic_discovery_platform_tpu_torch.serving.proto import vision_pb2

SERVICE_NAME = "evofab.vision.VisionAnalysisService"
_ANALYZE = "AnalyzeActuatorPerformance"
_ANALYZE_PATH = f"/{SERVICE_NAME}/{_ANALYZE}"


class VisionAnalysisServiceStub:
    """Client stub: ``stub.AnalyzeActuatorPerformance(request_iterator)``
    returns a response iterator (bidirectional stream)."""

    def __init__(self, channel: grpc.Channel):
        self.AnalyzeActuatorPerformance = channel.stream_stream(
            _ANALYZE_PATH,
            request_serializer=vision_pb2.AnalysisRequest.SerializeToString,
            response_deserializer=vision_pb2.AnalysisResponse.FromString,
        )


class VisionAnalysisServiceServicer:
    """Subclass and override ``AnalyzeActuatorPerformance``."""

    def AnalyzeActuatorPerformance(self, request_iterator, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")


def add_VisionAnalysisServiceServicer_to_server(servicer, server) -> None:
    handlers = {
        _ANALYZE: grpc.stream_stream_rpc_method_handler(
            servicer.AnalyzeActuatorPerformance,
            request_deserializer=vision_pb2.AnalysisRequest.FromString,
            response_serializer=vision_pb2.AnalysisResponse.SerializeToString,
        )
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )
