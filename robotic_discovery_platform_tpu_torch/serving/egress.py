"""Response mask payloads (the port of the JAX package's
``serving/egress.py`` wire codecs), and :class:`PackedResult`, the parser
of one frame's packed analysis row from a batched dispatch.

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
from typing import Callable

import numpy as np

from robotic_discovery_platform_tpu_torch.ops import pack

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


class PackedResult:
    """One frame's packed analysis payload: a zero-copy parser over the
    uint8 row that a batched dispatch's one device-to-host copy landed in
    the dispatcher's pooled host staging (``ops/pack.py``'s layout: the
    16-byte header, the float32 sidecar, the bitpacked mask rows).

    Scalars come off the sidecar as the exact float32 values the direct
    path reads; the full-resolution mask materializes on the host only
    when something needs pixels (:meth:`unpack_mask`). ``release`` hands
    the row back to the pool: call it once, after everything needed was
    read or copied (a second call is ignored).
    """

    __slots__ = ("payload", "h", "w", "n_pts", "_release")

    def __init__(self, payload: np.ndarray,
                 release: Callable[[], None] | None = None):
        payload = np.asarray(payload)
        if payload.ndim != 1 or payload.dtype != np.uint8:
            raise ValueError(
                f"packed payload must be a 1-D uint8 row; got "
                f"{payload.dtype} with shape {payload.shape}"
            )
        magic, h, w, n_pts = struct.unpack_from(
            "<4sIII", memoryview(payload[:pack.HEADER_BYTES]))
        if magic != pack.ROW_MAGIC:
            raise ValueError(
                f"packed payload header magic {magic!r} != {pack.ROW_MAGIC!r}"
            )
        expect = pack.frame_payload_bytes(h, w, n_pts)
        if payload.shape[0] != expect:
            raise ValueError(
                f"packed payload is {payload.shape[0]} bytes; header "
                f"geometry ({h}x{w}, {n_pts} spline samples) needs {expect}"
            )
        self.payload = payload
        self.h, self.w, self.n_pts = int(h), int(w), int(n_pts)
        self._release = release

    def _sidecar(self) -> np.ndarray:
        lo = pack.HEADER_BYTES
        return self.payload[lo:lo + 4 * pack.sidecar_floats(self.n_pts)].view(
            "<f4")

    @property
    def mask_bits(self) -> np.ndarray:
        """[H, ceil(W/8)] uint8 view of the bitpacked mask rows."""
        wb = pack.packed_row_bytes(self.w)
        lo = pack.HEADER_BYTES + 4 * pack.sidecar_floats(self.n_pts)
        return self.payload[lo:lo + self.h * wb].reshape(self.h, wb)

    def scalars(self) -> tuple[float, float, float, bool, float]:
        """(coverage, mean_curvature, max_curvature, valid, margin): the
        sidecar's float32 values (invalid frames read 0.0 curvature)."""
        s = self._sidecar()
        return (float(s[0]), float(s[1]), float(s[2]), bool(s[3] != 0.0),
                float(s[4]))

    def spline(self) -> np.ndarray:
        """[n_pts, 3] float32 spline block, a copy that outlives
        :meth:`release`; [0, 3] when the profile is invalid."""
        s = self._sidecar()
        if s[3] == 0.0:
            return np.zeros((0, 3), np.float32)
        return np.array(s[pack.N_SCALARS:].reshape(self.n_pts, 3),
                        np.float32)

    def spline_wire(self) -> bytes:
        """The ``packed_spline`` payload: little-endian float32 (x, y, z)
        triples, empty when the profile is invalid."""
        s = self._sidecar()
        return b"" if s[3] == 0.0 else s[pack.N_SCALARS:].tobytes()

    def unpack_mask(self) -> np.ndarray:
        """[H, W] uint8 0/1 mask, the exact mask the analyzer emitted."""
        return np.unpackbits(self.mask_bits, axis=1)[:, :self.w]

    def release(self) -> None:
        """Return this row's share of the staging buffer. Idempotent."""
        release, self._release = self._release, None
        if release is not None:
            release()
