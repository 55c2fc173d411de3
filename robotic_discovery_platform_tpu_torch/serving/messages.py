"""The wire messages as plain dataclasses, with the field names of
``protos/vision.proto``: the servicer's core speaks these and needs
neither grpc nor protobuf (``serving/grpc_service.py`` converts)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Point3D:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclass
class Image:
    """One frame: ``format`` 0 = encoded JPEG/PNG, 1 = raw (RGB8 color or
    little-endian z16 depth), 2 = JPEG coefficient blocks."""

    data: bytes = b""
    width: int = 0
    height: int = 0
    format: int = 0


@dataclass
class AnalysisRequest:
    color_image: Image = field(default_factory=Image)
    depth_image: Image = field(default_factory=Image)
    model: str = ""
    # response mask payload: 0 = PNG, 1 = packed bits, 2 = run lengths
    mask_format: int = 0


@dataclass
class AnalysisResponse:
    mean_curvature: float = 0.0
    max_curvature: float = 0.0
    spline_points: list[Point3D] = field(default_factory=list)
    status: str = ""
    mask: bytes = b""
    mask_coverage: float = 0.0
    proc_time_ms: float = 0.0
    packed_spline: bytes = b""
