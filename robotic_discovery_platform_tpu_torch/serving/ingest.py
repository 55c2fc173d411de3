"""Request payloads -> frames (the port of the JAX package's
``serving/ingest.py`` decode core).

Raw payloads (``Image.format = 1``) are numpy views of the wire bytes.
Encoded JPEG/PNG payloads (``format = 0``) decode through ``cv2``, imported
where it is needed. Coefficient payloads (``format = 2``) are views of the
wire bytes too (:func:`serving.entropy.unpack_coefficients`): the frame
stays a :class:`~serving.entropy.CoefficientFrame` and its pixels are
decoded on the device. With on-chip decode on
(:func:`resolve_onchip_decode`), a baseline JPEG sent as ``format = 0`` is
entropy-decoded on the host (:func:`serving.entropy.parse_jpeg`) and takes
the coefficient lane as well.
"""

from __future__ import annotations

import os

import numpy as np

from robotic_discovery_platform_tpu_torch.serving import entropy

#: ``Image.format`` wire values (protos/vision.proto)
FORMAT_ENCODED = 0
FORMAT_RAW = 1
FORMAT_COEF = 2

_ONCHIP_ENV_VAR = "RDP_ONCHIP_DECODE"

#: the IJG base quantization tables (ITU-T T.81 Annex K, tables K.1 and
#: K.2), natural (row-major) order: luminance, then chrominance
STANDARD_QUANT_TABLES = (
    np.array([
        16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
        99], np.uint16),
    np.array([
        17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
        *([99] * 32)], np.uint16),
)


def quant_tables(quality: int = 50) -> tuple[np.ndarray, np.ndarray]:
    """(luminance, chrominance) [64] uint16 tables at an IJG quality
    (libjpeg's ``jpeg_quality_scaling``, baseline-limited to 1..255)."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in 1..100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(
        np.clip((t.astype(np.int64) * scale + 50) // 100, 1, 255)
        .astype(np.uint16) for t in STANDARD_QUANT_TABLES)


def blank_coefficient_frame(height: int, width: int,
                            subsampling: str = "420"
                            ) -> entropy.CoefficientFrame:
    """An all-zero coefficient frame with the standard tables: a mid-gray
    (128, 128, 128) image of that geometry, for warming the coefficient
    lane without an encoder."""
    (ybh, ybw), (cbh, cbw) = entropy.block_grids(height, width, subsampling)
    qy, qc = STANDARD_QUANT_TABLES
    return entropy.CoefficientFrame(
        height=height, width=width, subsampling=subsampling,
        y=np.zeros((ybh * ybw, 64), np.int16),
        cb=np.zeros((cbh * cbw, 64), np.int16),
        cr=np.zeros((cbh * cbw, 64), np.int16), qy=qy, qc=qc)


def resolve_onchip_decode(configured: bool) -> bool:
    """The effective on-chip decode mode: ``RDP_ONCHIP_DECODE`` when set
    ("1"/"true"/"yes"/"on"/"strict" enable, anything else disables), else
    ``ServerConfig.onchip_decode``."""
    raw = os.environ.get(_ONCHIP_ENV_VAR)
    if raw is None:
        return bool(configured)
    return raw.strip().lower() in ("1", "true", "yes", "on", "strict")


def default_intrinsics(w: int, h: int) -> np.ndarray:
    """The focal-length fallback used when no calibration is loaded."""
    f = 0.94 * w
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(
            "encoded (JPEG/PNG) payloads need OpenCV (cv2), which is not "
            "installed; send raw payloads (Image.format = 1)"
        ) from exc
    return cv2


def decode_color(img, *, onchip: bool = False
                 ) -> np.ndarray | entropy.CoefficientFrame:
    """One color payload -> [H, W, 3] uint8 RGB, or the coefficient half of
    a split decode (:class:`~serving.entropy.CoefficientFrame`) when the
    pixels are decoded on the device: always for ``format = 2``, and for a
    baseline JPEG under ``onchip`` (a JPEG that ``parse_jpeg`` calls
    unsupported, e.g. progressive, stays on cv2; a corrupt one raises).
    ``img`` has the ``Image`` fields (a :class:`serving.messages.Image` or
    a protobuf message)."""
    if img.format == FORMAT_COEF:
        frame = entropy.unpack_coefficients(img.data)
        if img.width and img.height and (
                frame.height != img.height or frame.width != img.width):
            raise ValueError(
                f"coefficient payload is {frame.width}x{frame.height}; "
                f"Image says {img.width}x{img.height}"
            )
        return frame
    if img.format == FORMAT_RAW:
        expect = img.height * img.width * 3
        if len(img.data) != expect:
            raise ValueError(
                f"raw color payload is {len(img.data)} bytes; expected "
                f"{expect} for {img.width}x{img.height} RGB8"
            )
        return np.frombuffer(img.data, np.uint8).reshape(
            img.height, img.width, 3)
    if onchip and img.data[:2] == b"\xff\xd8":
        try:
            return entropy.parse_jpeg(img.data)
        except ValueError as exc:
            if not str(exc).startswith("unsupported"):
                raise
    cv2 = _cv2()
    bgr = cv2.imdecode(np.frombuffer(img.data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError("failed to decode color payload")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def decode_depth(img) -> np.ndarray:
    """One depth payload -> [H, W] uint16 (z16)."""
    if img.format == FORMAT_RAW:
        expect = img.height * img.width * 2
        if len(img.data) != expect:
            raise ValueError(
                f"raw depth payload is {len(img.data)} bytes; expected "
                f"{expect} for {img.width}x{img.height} z16"
            )
        return np.frombuffer(img.data, "<u2").reshape(img.height, img.width)
    cv2 = _cv2()
    depth = cv2.imdecode(np.frombuffer(img.data, np.uint8),
                         cv2.IMREAD_UNCHANGED)
    if depth is None:
        raise ValueError("failed to decode depth payload")
    if depth.dtype != np.uint16:
        depth = depth.astype(np.uint16)
    return depth


def decode_request(request, *, onchip: bool = False) -> tuple:
    """``AnalysisRequest`` -> (rgb [H, W, 3] u8 or a CoefficientFrame,
    depth [H, W] u16); ``onchip`` as in :func:`decode_color`."""
    return (decode_color(request.color_image, onchip=onchip),
            decode_depth(request.depth_image))


def coef_request(frame: entropy.CoefficientFrame, depth: np.ndarray, *,
                 mask_format: int = 0, model: str = ""):
    """A :class:`serving.messages.AnalysisRequest` whose color image is a
    ``format = 2`` coefficient payload, beside a raw z16 depth image."""
    from robotic_discovery_platform_tpu_torch.serving import messages

    h, w = depth.shape
    return messages.AnalysisRequest(
        color_image=messages.Image(entropy.pack_coefficients(frame),
                                   frame.width, frame.height, FORMAT_COEF),
        depth_image=messages.Image(
            np.ascontiguousarray(depth, "<u2").tobytes(), w, h, FORMAT_RAW),
        model=model, mask_format=mask_format,
    )


def raw_request(rgb: np.ndarray, depth: np.ndarray, *, mask_format: int = 0,
                model: str = ""):
    """A raw-format :class:`serving.messages.AnalysisRequest` for one
    (RGB u8, z16) frame pair."""
    from robotic_discovery_platform_tpu_torch.serving import messages

    h, w = depth.shape
    return messages.AnalysisRequest(
        color_image=messages.Image(
            np.ascontiguousarray(rgb, np.uint8).tobytes(), w, h, FORMAT_RAW),
        depth_image=messages.Image(
            np.ascontiguousarray(depth, "<u2").tobytes(), w, h, FORMAT_RAW),
        model=model, mask_format=mask_format,
    )
