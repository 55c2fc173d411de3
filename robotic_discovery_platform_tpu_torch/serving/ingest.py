"""Request payloads -> frames (the port of the JAX package's
``serving/ingest.py`` decode core).

Raw payloads (``Image.format = 1``) are numpy views of the wire bytes.
Encoded JPEG/PNG payloads (``format = 0``) decode through ``cv2``, imported
where it is needed; the coefficient lane (``format = 2``) is not in this
slice of the port.
"""

from __future__ import annotations

import numpy as np

#: ``Image.format`` wire values (protos/vision.proto)
FORMAT_ENCODED = 0
FORMAT_RAW = 1
FORMAT_COEF = 2


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


def decode_color(img) -> np.ndarray:
    """One color payload -> [H, W, 3] uint8 RGB. ``img`` has the ``Image``
    fields (a :class:`serving.messages.Image` or a protobuf message)."""
    if img.format == FORMAT_COEF:
        raise NotImplementedError(
            "Image.format = 2 (JPEG coefficient lane) is ROADMAP queue 1 "
            "item 10 of the port; send format 0 or 1"
        )
    if img.format == FORMAT_RAW:
        expect = img.height * img.width * 3
        if len(img.data) != expect:
            raise ValueError(
                f"raw color payload is {len(img.data)} bytes; expected "
                f"{expect} for {img.width}x{img.height} RGB8"
            )
        return np.frombuffer(img.data, np.uint8).reshape(
            img.height, img.width, 3)
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


def decode_request(request) -> tuple[np.ndarray, np.ndarray]:
    """``AnalysisRequest`` -> (rgb [H, W, 3] u8, depth [H, W] u16)."""
    return decode_color(request.color_image), decode_depth(request.depth_image)


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
