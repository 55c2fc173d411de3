"""Fused dequantize + 8x8 islow IDCT for the split JPEG decode: a
hand-written CUDA kernel for Hopper with its plain PyTorch version beside
it (the counterpart of the JAX package's ``ops/pallas/decode.py``).

The host ships quantized coefficient blocks ``[B, N, 64]`` int16 and
per-frame quant tables ``[B, 64]`` (``serving/entropy.py``); the device
dequantizes, runs libjpeg's ``jpeg_idct_islow`` and level-shifts and
clamps, bit for bit. islow is a fixed-point Loeffler factorization that is
linear between its two DESCALE roundings, so each pass is one integer
``[64, 64]`` matrix on the flattened block (:func:`_pass_matrices`): pass 1
``DESCALE(x @ m1, 11)``, pass 2 ``DESCALE(ws @ m2, 18) + 128``, clamped to
0..255, all in int32 with two's-complement wrap, as XLA computes it.

- :func:`dequant_idct` (``csrc/dequant_idct.cu``) replaces the TPU kernel
  ``robotic_discovery_platform_tpu/ops/pallas/decode.py`` ``dequant_idct``
  (bodies ``_idct_kernel`` and ``_idct_math``). It computes the two
  matrices in their separable form: ``m1 = kron(A, I8).T`` is the 8-point
  ``A`` on each column of the block and ``m2 = kron(I8, A).T`` on each
  row, the same nonzero products summed modulo 2^32, so the output is the
  dense products' bit for bit (mirrored in numpy by
  tests/test_torch_port_decode.py, which also reads ``A`` from the
  source).
- :func:`dequant_idct_plain` computes the same map with PyTorch ops that
  run on the CPU and on the card: the two products in float64, where
  every partial sum is an integer below 2^48 and so exact, then an
  explicit wrap to int32 before and after each DESCALE's rounding add
  (torch has no integer matrix product on CUDA).

Dispatch, as in ``ops/conv.py``: the wrapper takes its plain version only
for a tensor that lies on the CPU. For a CUDA tensor it launches its
kernel on the current stream or raises; nothing falls back. It counts its
launches in ``dequant_idct.launches``. Integer only: kernel and plain
version agree bitwise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.ops import build, graphs

# islow fixed-point constants: FIX(x) at CONST_BITS = 13.
_CONST_BITS = 13
_PASS1_SHIFT = _CONST_BITS - 2           # 11: pass 1 DESCALE
_PASS2_SHIFT = _CONST_BITS + 2 + 3       # 18: pass 2 DESCALE
_FIX = {
    "c0298": 2446, "c0390": 3196, "c0541": 4433, "c0765": 6270,
    "c0899": 7373, "c1175": 9633, "c1501": 12299, "c1847": 15137,
    "c1961": 16069, "c2053": 16819, "c2562": 20995, "c3072": 25172,
}


#: kernel name -> (C function, ctypes argument types):
#: coefs, q, out, B, N, stream
_SIGNATURES = {
    "dequant_idct": ("dequant_idct_launch",
                     [ctypes.c_void_p] * 3
                     + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def islow_basis() -> np.ndarray:
    """The exact [8, 8] int32 basis matrix of one ``jpeg_idct_islow`` pass.

    Runs the islow butterfly on unit vectors with Python ints (the pass is
    linear up to its DESCALE, so columns of the result ARE the matrix).
    ``pass_out = DESCALE(A @ x, shift)`` reproduces libjpeg bit for bit.
    """
    f = _FIX
    a = np.zeros((8, 8), np.int64)
    for j in range(8):
        x = [0] * 8
        x[j] = 1
        z2, z3 = x[2], x[6]
        z1 = (z2 + z3) * f["c0541"]
        t2 = z1 - z3 * f["c1847"]
        t3 = z1 + z2 * f["c0765"]
        t0 = (x[0] + x[4]) << _CONST_BITS
        t1 = (x[0] - x[4]) << _CONST_BITS
        t10, t13 = t0 + t3, t0 - t3
        t11, t12 = t1 + t2, t1 - t2
        o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
        z1, z2 = o0 + o3, o1 + o2
        z3, z4 = o0 + o2, o1 + o3
        z5 = (z3 + z4) * f["c1175"]
        o0 *= f["c0298"]
        o1 *= f["c2053"]
        o2 *= f["c3072"]
        o3 *= f["c1501"]
        z1 *= -f["c0899"]
        z2 *= -f["c2562"]
        z3 = z3 * -f["c1961"] + z5
        z4 = z4 * -f["c0390"] + z5
        o0 += z1 + z3
        o1 += z2 + z4
        o2 += z2 + z3
        o3 += z1 + z4
        col = (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
               t13 - o0, t12 - o1, t11 - o2, t10 - o3)
        for i in range(8):
            a[i, j] = col[i]
    return a.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pass_matrices() -> tuple:
    """([64, 64], [64, 64]) int32 right-multiply forms of the two passes.

    With blocks flattened row-major (index = 8*row + col):
    pass 1 contracts block COLUMNS -> ``x @ kron(A, I8).T``;
    pass 2 contracts block ROWS    -> ``ws @ kron(I8, A).T``.
    """
    a = islow_basis().astype(np.int64)
    eye = np.eye(8, dtype=np.int64)
    m1 = np.kron(a, eye).T.astype(np.int32)
    m2 = np.kron(eye, a).T.astype(np.int32)
    return m1, m2


@functools.lru_cache(maxsize=16)
def _pass_matrices_on(device: torch.device) -> tuple:
    """The two pass matrices on ``device`` in float64, copied once (for the
    plain version; the kernel applies ``islow_basis`` separably)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(
        device=device, dtype=torch.float64) for m in _pass_matrices())


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value it wraps to (as int64)."""
    return ((x + 2**31) & (2**32 - 1)) - 2**31


def _descale(x: torch.Tensor, shift: int) -> torch.Tensor:
    """libjpeg DESCALE in int32: the rounding add wraps, then an
    arithmetic shift right (int64 in and out)."""
    return _wrap32(x + (1 << (shift - 1))) >> shift


def dequant_idct_plain(coefs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dequant_idct`, on any device.

    The dequantized block times each pass matrix is taken in float64:
    both passes multiply int32 values by basis entries below 2^14 in
    magnitude, 8 nonzeros per column, so every product and partial sum is
    an integer below 2^48 and exact in any order; each result then wraps
    to int32 as XLA's int32 dot does (wrapping is order-free modulo
    2^32)."""
    b, n, _ = coefs.shape
    m1, m2 = _pass_matrices_on(coefs.device)
    deq = coefs.to(torch.int64) * q.to(torch.int64)[:, None, :]
    deq = _wrap32(deq).reshape(b * n, 64)
    ws = _descale(_wrap32(torch.matmul(deq.double(), m1).to(torch.int64)),
                  _PASS1_SHIFT)
    s = _descale(_wrap32(torch.matmul(ws.double(), m2).to(torch.int64)),
                 _PASS2_SHIFT) + 128
    return torch.clamp(s, 0, 255).to(torch.int32).reshape(b, n, 64)


def dequant_idct(coefs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Fused dequantize + 8x8 islow IDCT over the block axis.

    Args:
        coefs: [B, N, 64] int16 quantized coefficients, natural
            (row-major) order (``serving.entropy.CoefficientFrame``
            planes, batched).
        q: [B, 64] int32 quant tables, one per frame (the wire's uint16
            tables widened before they reach the device).

    Returns [B, N, 64] int32 spatial samples in 0..255 (level-shifted,
    range-limited), bitwise equal to libjpeg's islow output.
    """
    if coefs.device.type == "cpu":
        return dequant_idct_plain(coefs, q)
    if (coefs.dim() != 3 or coefs.shape[2] != 64 or coefs.dtype != torch.int16
            or q.shape != (coefs.shape[0], 64) or q.dtype != torch.int32):
        raise ValueError(
            f"dequant_idct: want coefs [B, N, 64] int16 and q [B, 64] int32; "
            f"got {tuple(coefs.shape)} {coefs.dtype} and {tuple(q.shape)} "
            f"{q.dtype}"
        )
    for label, t in (("coefs", coefs), ("q", q)):
        if t.device != coefs.device or not t.is_contiguous():
            raise ValueError(
                f"dequant_idct: {label} must be contiguous on {coefs.device}")
    if coefs.device.index != torch.cuda.current_device():
        raise ValueError(
            f"dequant_idct: coefs are on {coefs.device} but the current "
            f"device is cuda:{torch.cuda.current_device()}")
    b, n, _ = coefs.shape
    out = torch.empty((b, n, 64), dtype=torch.int32, device=coefs.device)
    if out.numel() == 0:
        return out
    fn = build.function("dequant_idct", *_SIGNATURES["dequant_idct"])
    err = fn(coefs.data_ptr(), q.data_ptr(), out.data_ptr(), b, n,
             torch.cuda.current_stream(coefs.device).cuda_stream)
    build.check("dequant_idct", err)
    graphs.count_launch(dequant_idct)
    return out


dequant_idct.launches = 0
