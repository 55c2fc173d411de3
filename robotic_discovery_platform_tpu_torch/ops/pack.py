"""Device-side mask bitpacking for the egress wire, and the packed row
layout (the counterpart of the JAX package's ``ops/pallas/pack.py``).

:func:`bitpack_mask` (``csrc/bitpack_mask.cu``) packs the analyzer's
``[B, H, W]`` uint8 mask to ``[B, H, ceil(W/8)]`` on the device, 8 pixels
per byte, most significant bit first (``np.packbits`` order), so the one
device-to-host copy of a batched dispatch carries an eighth of the mask's
bytes. Integer only: the kernel and its plain version agree bitwise. As in
``ops/conv.py``, the wrapper takes the plain version only for a tensor on
the CPU and counts its launches in ``bitpack_mask.launches``.

The packed payload row that ``ops/pipeline.pack_analysis`` emits and
``serving/egress.PackedResult`` parses, one self-describing uint8 row per
frame, byte for byte the JAX package's:

    [0:16)   header: ``<4sIII`` = (b"RDPP", height, width, n_pts)
    [16:..)  f32 sidecar, little-endian: coverage, mean curvature, max
             curvature, validity (1.0/0.0), confidence margin, then the
             [n_pts, 3] spline block row-major
    [..:..)  the bitpacked mask rows, H * ceil(W/8) bytes
    [..:P)   zero pad up to :func:`frame_payload_bytes` (a multiple of 64)
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch
import torch.nn.functional as F

from robotic_discovery_platform_tpu_torch.ops import build

#: f32 scalars ahead of the spline block in the sidecar: coverage,
#: mean curvature, max curvature, validity, confidence margin.
N_SCALARS = 5

#: bytes of the self-describing row header, ``<4sIII``.
HEADER_BYTES = 16

#: header magic of a packed payload row (wire payloads carry their own
#: magics, serving/egress.py: b"RDPB" / b"RDPR").
ROW_MAGIC = b"RDPP"

#: rows pad to a multiple of this, so the rows of a 64-byte-aligned
#: [B, P] staging buffer stay 64-byte aligned.
ROW_ALIGN = 64


def sidecar_floats(n_pts: int) -> int:
    """f32 slots in the per-frame sidecar: the scalars + the spline."""
    return N_SCALARS + 3 * n_pts


def packed_row_bytes(w: int) -> int:
    """Bytes of one bitpacked mask row: ceil(w / 8)."""
    return (w + 7) // 8


def frame_payload_bytes(h: int, w: int, n_pts: int) -> int:
    """Total bytes of one frame's packed payload row, 64-byte padded."""
    raw = HEADER_BYTES + 4 * sidecar_floats(n_pts) + h * packed_row_bytes(w)
    return -(-raw // ROW_ALIGN) * ROW_ALIGN


@functools.lru_cache(maxsize=None)
def payload_header(h: int, w: int, n_pts: int) -> np.ndarray:
    """The [16] uint8 header constant for one frame geometry."""
    return np.frombuffer(
        struct.pack("<4sIII", ROW_MAGIC, h, w, n_pts), np.uint8
    )


def bitpack_mask_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bitpack_mask`: the JAX package's
    ``_pack_math``, a shift-accumulate over groups of 8 pixels of the
    zero-padded rows."""
    b, h, w = mask.shape
    wb = packed_row_bytes(w)
    bits = (mask != 0).to(torch.int32)
    if w % 8:
        bits = F.pad(bits, (0, wb * 8 - w))
    bits = bits.reshape(b, h, wb, 8)
    packed = bits[..., 0]
    for k in range(1, 8):
        packed = packed * 2 + bits[..., k]
    return packed.to(torch.uint8)


def bitpack_mask(mask: torch.Tensor) -> torch.Tensor:
    """Bitpack a ``[B, H, W]`` uint8 mask to ``[B, H, ceil(W/8)]`` uint8,
    MSB first: ``np.unpackbits(out, axis=-1)[..., :W]`` is the exact
    mask (any nonzero pixel is a set bit; a ragged tail packs as
    zeros)."""
    if mask.device.type == "cpu":
        return bitpack_mask_plain(mask)
    if mask.dim() != 3 or mask.dtype != torch.uint8:
        raise ValueError(
            f"bitpack_mask: want a [B, H, W] uint8 mask; got "
            f"{tuple(mask.shape)} {mask.dtype}"
        )
    if mask.device.index != torch.cuda.current_device():
        raise ValueError(
            f"bitpack_mask: mask is on {mask.device} but the current device "
            f"is cuda:{torch.cuda.current_device()}"
        )
    mask = mask.contiguous()
    b, h, w = mask.shape
    out = torch.empty((b, h, packed_row_bytes(w)), dtype=torch.uint8,
                      device=mask.device)
    fn = build.function("bitpack_mask", "bitpack_mask_launch",
                        [ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    err = fn(mask.data_ptr(), out.data_ptr(), b * h, w,
             torch.cuda.current_stream(mask.device).cuda_stream)
    build.check("bitpack_mask", err)
    bitpack_mask.launches += 1
    return out


bitpack_mask.launches = 0
