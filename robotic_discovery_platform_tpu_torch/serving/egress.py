"""Response mask payloads (the port of the JAX package's
``serving/egress.py`` wire codecs).

``AnalysisRequest.mask_format`` selects what rides
``AnalysisResponse.mask``: 0 = a PNG of the 0/255 mask, 1 = packed bits
(:func:`encode_bits_wire`), 2 = run lengths (:func:`encode_rle_wire`). The
bits and RLE payloads are byte-identical to the JAX package's, and both
decode back to the exact mask (:func:`decode_mask_wire`). PNG goes through
``cv2`` where it is installed (the same bytes as the JAX server) and
otherwise through a small ``zlib`` PNG writer (the same pixels).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

#: ``AnalysisRequest.mask_format`` wire values (protos/vision.proto)
MASK_FORMAT_PNG = 0
MASK_FORMAT_BITS = 1
MASK_FORMAT_RLE = 2

_BITS_HEADER = struct.Struct("<4sHH")   # magic, height, width
_RLE_HEADER = struct.Struct("<4sHHI")   # magic, height, width, runs
WIRE_BITS_MAGIC = b"RDPB"
WIRE_RLE_MAGIC = b"RDPR"


def encode_bits_wire(bits: np.ndarray, h: int, w: int) -> bytes:
    """``mask_format=1`` payload: 8-byte header + the bitpacked rows
    (``np.packbits(mask, axis=-1)``, MSB first)."""
    return _BITS_HEADER.pack(WIRE_BITS_MAGIC, h, w) + bits.tobytes()


def mask_runs(mask: np.ndarray) -> np.ndarray:
    """Row-major run lengths of a 0/1 mask, alternating and starting with
    a zero run (a leading zero-length run when pixel (0, 0) is set)."""
    flat = np.asarray(mask, np.uint8).ravel()
    if flat.size == 0:
        return np.zeros(0, "<u4")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).astype("<u4")
    if flat[0]:
        runs = np.concatenate([np.zeros(1, "<u4"), runs])
    return runs


def encode_rle_wire(mask: np.ndarray, h: int, w: int) -> bytes:
    """``mask_format=2`` payload: 12-byte header + little-endian u32 run
    lengths (alternating zero/one runs, zero first)."""
    runs = mask_runs(mask)
    return _RLE_HEADER.pack(WIRE_RLE_MAGIC, h, w, runs.size) + runs.tobytes()


def decode_mask_wire(data: bytes) -> np.ndarray | None:
    """A packed ``AnalysisResponse.mask`` payload -> the exact [H, W] uint8
    0/1 mask; None when it is not a packed format (a PNG)."""
    if len(data) >= _BITS_HEADER.size and data[:4] == WIRE_BITS_MAGIC:
        _, h, w = _BITS_HEADER.unpack_from(data)
        wb = (w + 7) // 8
        bits = np.frombuffer(data, np.uint8, count=h * wb,
                             offset=_BITS_HEADER.size).reshape(h, wb)
        return np.unpackbits(bits, axis=1)[:, :w]
    if len(data) >= _RLE_HEADER.size and data[:4] == WIRE_RLE_MAGIC:
        _, h, w, n_runs = _RLE_HEADER.unpack_from(data)
        runs = np.frombuffer(data, "<u4", count=n_runs,
                             offset=_RLE_HEADER.size)
        if int(runs.sum()) != h * w:
            raise ValueError(
                f"RLE runs cover {int(runs.sum())} pixels; header says {h}x{w}"
            )
        values = np.arange(n_runs, dtype=np.uint8) & 1
        return np.repeat(values, runs).reshape(h, w)
    return None


def decode_spline_wire(data: bytes) -> np.ndarray:
    """``AnalysisResponse.packed_spline`` -> [N, 3] float32 (x, y, z)."""
    return np.frombuffer(data, "<f4").reshape(-1, 3)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def png_gray8(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of ``img`` [H, W] uint8, stdlib only."""
    h, w = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img, np.uint8)],
        axis=1)  # filter type 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def encode_png_mask(mask: np.ndarray) -> bytes:
    """``mask_format=0`` payload: PNG of ``mask * 255``."""
    img = np.asarray(mask, np.uint8) * np.uint8(255)
    try:
        import cv2
    except ImportError:
        return png_gray8(img)
    ok, buf = cv2.imencode(".png", img)
    if not ok:
        raise ValueError("mask encode failed")
    return buf.tobytes()


def encode_mask(mask: np.ndarray, mask_format: int) -> bytes:
    """The response ``mask`` payload for ``mask_format`` (anything but 1
    or 2 is PNG, as the JAX server answers)."""
    h, w = mask.shape
    if mask_format == MASK_FORMAT_BITS:
        return encode_bits_wire(np.packbits(mask, axis=-1), h, w)
    if mask_format == MASK_FORMAT_RLE:
        return encode_rle_wire(mask, h, w)
    return encode_png_mask(mask)
