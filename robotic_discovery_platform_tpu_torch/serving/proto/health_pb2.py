# Wire-identical stand-in for grpc_health.v1.health_pb2.
#
# The image has neither protoc nor the grpcio-health-checking wheel, so the
# grpc.health.v1 message descriptors (see protos/health.proto) are built
# programmatically from a FileDescriptorProto -- byte-for-byte the same wire
# format (field numbers, types, enum values) as the canonical generated
# module, which is what grpc_health_probe / Kubernetes gRPC probes speak.
# When the real package IS installed we defer to it, both for fidelity and
# to avoid registering duplicate symbols in the default descriptor pool.

try:  # pragma: no cover - absent in this image, present in some deploys
    from grpc_health.v1.health_pb2 import (  # noqa: F401
        DESCRIPTOR,
        HealthCheckRequest,
        HealthCheckResponse,
    )
except ImportError:
    from google.protobuf import descriptor_pb2 as _dpb2
    from google.protobuf import descriptor_pool as _descriptor_pool
    from google.protobuf.internal import builder as _builder

    _fdp = _dpb2.FileDescriptorProto()
    _fdp.name = "rdp_health.proto"  # distinct file name, canonical package
    _fdp.package = "grpc.health.v1"
    _fdp.syntax = "proto3"

    _req = _fdp.message_type.add()
    _req.name = "HealthCheckRequest"
    _f = _req.field.add()
    _f.name = "service"
    _f.number = 1
    _f.type = _dpb2.FieldDescriptorProto.TYPE_STRING
    _f.label = _dpb2.FieldDescriptorProto.LABEL_OPTIONAL

    _resp = _fdp.message_type.add()
    _resp.name = "HealthCheckResponse"
    _enum = _resp.enum_type.add()
    _enum.name = "ServingStatus"
    for _i, _name in enumerate(
        ("UNKNOWN", "SERVING", "NOT_SERVING", "SERVICE_UNKNOWN")
    ):
        _v = _enum.value.add()
        _v.name = _name
        _v.number = _i
    _f = _resp.field.add()
    _f.name = "status"
    _f.number = 1
    _f.type = _dpb2.FieldDescriptorProto.TYPE_ENUM
    _f.type_name = ".grpc.health.v1.HealthCheckResponse.ServingStatus"
    _f.label = _dpb2.FieldDescriptorProto.LABEL_OPTIONAL

    _svc = _fdp.service.add()
    _svc.name = "Health"
    _m = _svc.method.add()
    _m.name = "Check"
    _m.input_type = ".grpc.health.v1.HealthCheckRequest"
    _m.output_type = ".grpc.health.v1.HealthCheckResponse"
    _m = _svc.method.add()
    _m.name = "Watch"
    _m.input_type = ".grpc.health.v1.HealthCheckRequest"
    _m.output_type = ".grpc.health.v1.HealthCheckResponse"
    _m.server_streaming = True

    DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
        _fdp.SerializeToString()
    )
    _builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
    _builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, "health_pb2",
                                            globals())
