"""The U-Net's convolution kernels: hand-written CUDA for Hopper, each with
its plain PyTorch version beside it.

- :func:`conv3x3_bn_relu` (``csrc/conv3x3_bn_relu.cu``) replaces the TPU
  kernel ``robotic_discovery_platform_tpu/ops/pallas/conv.py``
  ``conv3x3_bn_relu``: NHWC 3x3 SAME conv + folded-BatchNorm scale/bias
  (+ ReLU), f32 accumulation, one rounding to the output type.
- :func:`conv1x1` (``csrc/conv1x1.cu``) replaces ``conv1x1`` of the same
  file (both its Cout = 1 squeeze body and its general body): a vector
  streaming head for Cout = 1, a register-tiled FMA GEMM for the rest
  (:func:`conv1x1_path`).
- :func:`conv3x3_grad_weights` (``csrc/conv3x3_grad_weights.cu``)
  replaces ``conv3x3_grad_weights`` of the same file: the weight gradient
  of the training conv.
- :func:`conv_transpose2x2` (``csrc/conv_transpose2x2.cu``) replaces
  ``conv_transpose2x2`` of the same file: the non-bilinear U-Net's 2x2
  stride-2 transposed conv + bias; bf16 at widths that tile (every
  ladder shape) on the tensor cores, the rest on the CUDA cores
  (:func:`convt_path`).
- :func:`conv3x3` is the training conv, a ``torch.autograd.Function``
  and the counterpart of that file's custom-VJP ``conv3x3``: its forward
  and dx launch :func:`conv3x3_bn_relu` with a unit epilogue (dx on the
  flipped, in/out-transposed kernel), its dw :func:`conv3x3_grad_weights`.

Layouts are the JAX package's: activations NHWC, 3x3 kernels HWIO
``[3, 3, Cin, Cout]``, 1x1 kernels ``[Cin, Cout]``, transposed-conv
kernels ``[2, 2, Cin, Cout]``, scale/bias ``[Cout]`` float32. The bound of each kernel on an H100 and what its design does
about it are stated at the top of its source.

Dispatch: a wrapper takes its plain version only for a tensor that lies
on the CPU (the test path). For a CUDA tensor it launches its kernel on
the current stream or raises; nothing falls back. Each wrapper counts its
launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from robotic_discovery_platform_tpu_torch.analysis.contracts import shape_contract
from robotic_discovery_platform_tpu_torch.ops import build, graphs
from robotic_discovery_platform_tpu_torch.utils.config import (
    CONV_IMPLS,
    PLAIN_CONV_IMPLS,
)

#: (input dtype, output dtype) -> the dtypes code of the C interface
_DTYPES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.bfloat16, torch.float32): 2,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C function -> (kernel name, ctypes argument types)
_SIGNATURES = {
    # x, w, scale, bias, out, workspace, B, H, W, Cin, Cout, relu, splits,
    # dtypes, stream
    "conv3x3_bn_relu_launch": ("conv3x3_bn_relu", [_P] * 6 + [_I] * 8 + [_P]),
    # x, w, scale, bias, out, P, Cin, Cout, relu, dtypes, stream
    "conv1x1_launch": (
        "conv1x1", [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                    _P]),
    # x, out, Cin, Cout, dtypes -> 1 head, 2 tensor cores, 0 FMA
    "conv1x1_path": ("conv1x1", [_P, _I, _I, _I]),
    # x, g, workspace, dw, B, H, W, Cin, Cout, splits, dtypes, stream
    "conv3x3_grad_weights_launch": (
        "conv3x3_grad_weights", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _P]),
    # x, w, bias, out, B, H, W, Cin, Cout, dtypes, stream
    "conv_transpose2x2_launch": (
        "conv_transpose2x2", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # Cin, Cout, dtypes -> 1 tensor cores, 0 FMA
    "conv_transpose2x2_path": ("conv_transpose2x2", [_I, _I, _I]),
}

#: the bf16 tensor-core kernels' tiles (csrc/conv3x3_bn_relu.cu and
#: csrc/conv3x3_grad_weights.cu): both walk 8x16 pixel tiles and 64 output
#: channels per block. The forward's K is walked in chunks of 16 input
#: channels, or, for Cin not a multiple of 8, of 32 flattened (tap, ci);
#: the weight gradient's block owns 64 input channels for all nine taps,
#: or 32 flattened (tap, ci) rows.
PIXEL_TILE = (8, 16)
COUT_TILE = 64
FWD_CIN_CHUNK, FWD_GATHER_CHUNK = 16, 32
DW_CIN_TILE, DW_GATHER_TILE = 64, 32
#: the card's SMs: the split counts fill one wave of blocks on them
SMS = 132
#: the forward's float32 split partials at the batched path's largest
#: batch (8) stay under this cap
FWD_WORKSPACE_CAP, FWD_CAP_BATCH = 64 * 2**20, 8  # bytes, frames
#: the weight gradient splits its pixel tiles over one wave of blocks:
#: one block of three warpgroups per SM, or, for Cin not a multiple of 8
#: (the gather kernel: small blocks, bound by g's bytes), four; the split
#: partials' workspace is capped
DW_GATHER_BLOCKS_PER_SM = 4
DW_WORKSPACE_CAP = 32 * 2**20  # bytes


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5):
    """Fold inference BatchNorm into per-channel float32 (scale, bias):
    ``(x - mean) / sqrt(var + eps) * gamma + beta = x * scale + bias``."""
    gamma, beta, mean, var = (torch.as_tensor(t, dtype=torch.float32)
                              for t in (gamma, beta, mean, var))
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _kernel(symbol: str):
    name, argtypes = _SIGNATURES[symbol]
    return build.function(name, symbol, argtypes)


def _check_cuda(name: str, x, w, out_dtype, **vectors):
    """Validate what the kernel takes (``vectors``: its float32 per-channel
    operands, by name); returns its dtypes code."""
    code = _DTYPES.get((x.dtype, out_dtype))
    if code is None:
        raise TypeError(
            f"{name}: unsupported dtypes {x.dtype} -> {out_dtype}; the "
            f"kernel takes {sorted((str(a), str(b)) for a, b in _DTYPES)}"
        )
    for label, t in (("x", x), ("w", w), *vectors.items()):
        if t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: x is on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    if any(t.dtype != torch.float32 for t in vectors.values()):
        raise TypeError(f"{name}: {' and '.join(vectors)} must be float32")
    return code


# -- 3x3 conv + scale/bias (+ReLU) -------------------------------------------


def conv3x3_bn_relu_plain(x, w, scale, bias, *, relu: bool = True,
                          out_dtype=None):
    """Plain PyTorch version of :func:`conv3x3_bn_relu`: ``F.conv2d`` in
    float32 on the same operands (w cast to x's dtype first), then the
    epilogue, then one cast. On a CUDA tensor the caller keeps TF32 off."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    wf = w.to(x.dtype).to(torch.float32).permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, padding=1).permute(0, 2, 3, 1)
    y = y * scale + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(out_dtype).contiguous()


def _tiles(h: int, w: int) -> int:
    """8x16 pixel tiles of one h x w map."""
    return -(-h // PIXEL_TILE[0]) * -(-w // PIXEL_TILE[1])


def fwd_k_chunks(cin: int) -> int:
    """How many K chunks the bf16 forward walks: 16-channel chunks of the
    halo, or 32-wide chunks of K = 9*Cin when Cin is not a multiple of 8
    (its pixels cannot take 16-byte copies)."""
    if cin % 8:
        return -(-9 * cin // FWD_GATHER_CHUNK)
    return -(-cin // FWD_CIN_CHUNK)


def fwd_plan(b: int, h: int, w: int, cin: int, cout: int) -> tuple[int, int]:
    """(splits, workspace floats) of the bf16 :func:`conv3x3_bn_relu`.

    K is split over blocks when one image's grid gives fewer blocks than
    the card has SMs: as many splits as fill them, at most one per K chunk,
    and a float32 workspace of at most ``FWD_WORKSPACE_CAP`` at
    ``FWD_CAP_BATCH`` frames. The split count depends on (h, w, cin, cout)
    only, never on ``b``: it fixes each output's summation order, so a
    frame gives the same bits alone and inside a batch.
    """
    blocks = _tiles(h, w) * -(-cout // COUT_TILE)
    splits = min(fwd_k_chunks(cin), max(1, SMS // blocks))
    per_split = FWD_CAP_BATCH * h * w * cout * 4
    splits = max(1, min(splits, FWD_WORKSPACE_CAP // per_split))
    return splits, (splits * b * h * w * cout if splits > 1 else 0)


@shape_contract(x="b h w ci", w="3 3 ci co", scale="co", bias="co",
                out="b h w co")
def conv3x3_bn_relu(x, w, scale, bias, *, relu: bool = True, out_dtype=None,
                    splits: int | None = None):
    """Fused NHWC 3x3 SAME conv + per-channel scale/bias (+ ReLU).

    Args:
        x: [B, H, W, Cin], bfloat16 or float32.
        w: [3, 3, Cin, Cout] (HWIO), cast to x's dtype.
        scale, bias: [Cout] float32 epilogue coefficients.
        relu: apply max(y, 0) in the epilogue.
        out_dtype: output dtype (default x's; float32 also taken for a
            bfloat16 x).
        splits: the bf16 launch's K-split count (``ops/tuning.lookup``);
            None takes :func:`fwd_plan`'s. The float32 path and the plain
            version ignore it: neither splits K.
    """
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, scale, bias, relu=relu,
                                     out_dtype=out_dtype)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(
            f"conv3x3_bn_relu: want x [B,H,W,Cin] and w [3,3,Cin,Cout]; got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    b, h, width, cin = x.shape
    cout = w.shape[3]
    if w.shape[2] != cin or scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(
            f"conv3x3_bn_relu: shapes disagree: x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, scale {tuple(scale.shape)}, bias "
            f"{tuple(bias.shape)}"
        )
    w = w.to(x.dtype)
    code = _check_cuda("conv3x3_bn_relu", x, w, out_dtype, scale=scale,
                       bias=bias)
    if code == 0:
        splits, ws_numel = 1, 0
    else:
        planned, _ = fwd_plan(b, h, width, cin, cout)
        splits = planned if splits is None else int(splits)
        ws_numel = splits * b * h * width * cout if splits > 1 else 0
    if code and cin % 8 == 0 and x.data_ptr() % 16:
        raise ValueError("conv3x3_bn_relu: a bfloat16 x with Cin a multiple "
                         "of 8 must start on a 16-byte address")
    out = torch.empty((b, h, width, cout), dtype=out_dtype, device=x.device)
    ws = (torch.empty(ws_numel, dtype=torch.float32, device=x.device)
          if ws_numel else None)
    err = _kernel("conv3x3_bn_relu_launch")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), b, h, width,
        cin, cout, int(relu), splits, code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("conv3x3_bn_relu", err)
    graphs.count_launch(conv3x3_bn_relu)
    conv3x3_bn_relu.splits_taken[(h, width, cin, cout)] = splits
    return out


conv3x3_bn_relu.launches = 0
#: (H, W, Cin, Cout) -> the split count of that shape's latest launch
conv3x3_bn_relu.splits_taken = {}


# -- 1x1 conv + scale/bias (+ReLU) -------------------------------------------


def conv1x1_plain(x, w, scale, bias, *, relu: bool = False, out_dtype=None):
    """Plain PyTorch version of :func:`conv1x1`: a float32 matmul over Cin
    on the same operands, the epilogue, one cast."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    y = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32))
    y = y * scale + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(out_dtype).contiguous()


#: conv1x1's vector head takes Cout = 1 with Cin a multiple of one 16-byte
#: vector of x (8 bf16 or 4 float32) and at most CONV1X1_HEAD_VECTORS of
#: them per pixel (one per lane of a warp)
CONV1X1_HEAD_VECTORS = 32
_CONV1X1_PATHS = {0: "fma", 1: "head"}


def conv1x1_path(dtype, cin: int, cout: int, *,
                 x_aligned: bool = True) -> str:
    """Which kernel :func:`conv1x1` launches for a CUDA x of ``dtype`` and
    these widths: ``"head"`` (Cout = 1, Cin a multiple of one 16-byte
    vector, x on a 16-byte address: the streaming reduction) or ``"fma"``
    (Cout > 1, ragged widths, a misaligned view). The C entry decides by
    the same rule (``conv1x1_path``); this mirror is what the CPU tests
    pin and chip_smoke logs."""
    per_vector = 4 if dtype == torch.float32 else 8
    if (x_aligned and cout == 1 and cin % per_vector == 0
            and cin <= per_vector * CONV1X1_HEAD_VECTORS):
        return "head"
    return "fma"


def conv1x1_path_of_kernel(x, cout: int, out_dtype=None) -> str:
    """The C entry's own answer to :func:`conv1x1_path` for a CUDA ``x``,
    whose address decides the alignment. Builds the kernel's library: the
    card's machine only."""
    code = _DTYPES[(x.dtype, x.dtype if out_dtype is None else out_dtype)]
    path = _kernel("conv1x1_path")(x.data_ptr(), x.shape[-1], cout, code)
    return _CONV1X1_PATHS[path]


@shape_contract(x="b h w ci", w="ci co", scale="co", bias="co",
                out="b h w co")
def conv1x1(x, w, scale, bias, *, relu: bool = False, out_dtype=None):
    """Fused NHWC 1x1 conv + per-channel scale/bias (+ ReLU): the OutConv
    head with an identity scale and the conv bias in ``bias``.

    Args:
        x: [B, H, W, Cin], bfloat16 or float32.
        w: [Cin, Cout], cast to x's dtype.
        scale, bias: [Cout] float32.
        out_dtype: output dtype (default x's; float32 also taken for a
            bfloat16 x -- the head's logits).
    """
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return conv1x1_plain(x, w, scale, bias, relu=relu,
                             out_dtype=out_dtype)
    if x.dim() != 4 or w.dim() != 2 or w.shape[0] != x.shape[3]:
        raise ValueError(
            f"conv1x1: want x [B,H,W,Cin] and w [Cin,Cout]; got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    b, h, width, cin = x.shape
    cout = w.shape[1]
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(
            f"conv1x1: scale {tuple(scale.shape)} / bias "
            f"{tuple(bias.shape)} do not match Cout={cout}"
        )
    w = w.to(x.dtype)
    code = _check_cuda("conv1x1", x, w, out_dtype, scale=scale, bias=bias)
    out = torch.empty((b, h, width, cout), dtype=out_dtype, device=x.device)
    err = _kernel("conv1x1_launch")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b * h * width, cin, cout, int(relu), code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("conv1x1", err)
    graphs.count_launch(conv1x1)
    return out


conv1x1.launches = 0


# -- 2x2 stride-2 transposed conv + bias -----------------------------------------


def conv_transpose2x2_plain(x, w, bias=None, *, out_dtype=None):
    """Plain PyTorch version of :func:`conv_transpose2x2`, differentiable by
    autograd: four float32 (float64 for float64 operands) contractions
    over Cin, one per tap, with the
    spatially flipped tap (``out[2h+dy, 2w+dx] = x[h, w] @ w[1-dy, 1-dx]``),
    interleaved, the float32 bias added (when given), one cast. On a CUDA
    tensor the caller keeps TF32 off."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    b, h, width, _ = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    wf = w.to(x.dtype).to(acc)

    def tap(dy, dx):
        return torch.einsum("bhwi,io->bhwo", xf, wf[1 - dy, 1 - dx])

    # [B, H, 2 (dy), W, 2 (dx), Cout] -> [B, 2H, 2W, Cout]
    y = torch.stack([torch.stack([tap(dy, 0), tap(dy, 1)], dim=3)
                     for dy in (0, 1)], dim=2)
    y = y.reshape(b, 2 * h, 2 * width, w.shape[3])
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(out_dtype)


#: conv_transpose2x2's tensor-core path: bf16 x with Cin a multiple of
#: CONVT_CIN_STEP and Cout a multiple of COUT_TILE
CONVT_CIN_STEP = 16


def convt_path(dtype, cin: int, cout: int) -> str:
    """Which kernel :func:`conv_transpose2x2` launches for a CUDA x of
    ``dtype`` and these widths: ``"tensor_cores"`` (bf16 in, Cin % 16 ==
    0, Cout % 64 == 0: the ``wgmma`` implicit GEMM) or ``"fma"`` (float32,
    whose bar TF32 would break, and ragged widths: the CUDA-core kernel).
    The C entry decides by the same rule (``conv_transpose2x2_path``);
    this mirror is what the CPU tests pin and chip_smoke logs."""
    if (dtype == torch.bfloat16 and cin % CONVT_CIN_STEP == 0
            and cout % COUT_TILE == 0):
        return "tensor_cores"
    return "fma"


def convt_path_of_kernel(dtype, cin: int, cout: int,
                         out_dtype=None) -> str:
    """The C entry's own answer to :func:`convt_path` (builds the kernel's
    library; the card's machine only)."""
    code = _DTYPES[(dtype, dtype if out_dtype is None else out_dtype)]
    path = _kernel("conv_transpose2x2_path")(cin, cout, code)
    return {1: "tensor_cores", 0: "fma"}[path]


@shape_contract(x="b h w ci", w="2 2 ci co", bias="co")
def conv_transpose2x2(x, w, bias, *, out_dtype=None):
    """NHWC 2x2 stride-2 transposed conv + bias: the non-bilinear ``Up``
    upsampler, ``[B, H, W, Cin] -> [B, 2H, 2W, Cout]``.

    Args:
        x: [B, H, W, Cin], bfloat16 or float32.
        w: [2, 2, Cin, Cout] (HWIO, Flax's ``ConvTranspose`` layout; the
            taps land flipped: ``out[2h+dy, 2w+dx] = x[h, w] @
            w[1-dy, 1-dx]``), cast to x's dtype.
        bias: [Cout] float32, added in float32 before the one rounding.
        out_dtype: output dtype (default x's; float32 also taken for a
            bfloat16 x).
    """
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return conv_transpose2x2_plain(x, w, bias, out_dtype=out_dtype)
    if (x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (2, 2)
            or w.shape[2] != x.shape[3] or bias.shape != (w.shape[3],)):
        raise ValueError(
            f"conv_transpose2x2: want x [B,H,W,Cin], w [2,2,Cin,Cout] and "
            f"bias [Cout]; got {tuple(x.shape)}, {tuple(w.shape)} and "
            f"{tuple(bias.shape)}"
        )
    b, h, width, cin = x.shape
    cout = w.shape[3]
    w = w.to(x.dtype)
    code = _check_cuda("conv_transpose2x2", x, w, out_dtype, bias=bias)
    if (convt_path(x.dtype, cin, cout) == "tensor_cores"
            and (x.data_ptr() % 16 or w.data_ptr() % 16)):
        raise ValueError("conv_transpose2x2: the tensor-core path takes x "
                         "and w on 16-byte addresses")
    out = torch.empty((b, 2 * h, 2 * width, cout), dtype=out_dtype,
                      device=x.device)
    err = _kernel("conv_transpose2x2_launch")(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h,
        width, cin, cout, code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("conv_transpose2x2", err)
    graphs.count_launch(conv_transpose2x2)
    return out


conv_transpose2x2.launches = 0


# -- the weight gradient of a 3x3 SAME conv ------------------------------------


def conv3x3_grad_weights_plain(x, g):
    """Plain PyTorch version of :func:`conv3x3_grad_weights`: float32 on the
    same operands, one contraction over (b, h, w) per tap of the nine
    shifted views of the zero-padded x. On a CUDA tensor the caller keeps
    TF32 off."""
    h, w = x.shape[1:3]
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    gf = g.to(torch.float32)
    taps = [torch.einsum("bhwi,bhwo->io", xp[:, ky:ky + h, kx:kx + w], gf)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, x.shape[3], g.shape[3])


def dw_splits(b: int, h: int, w: int, cin: int, cout: int) -> int:
    """How many ways :func:`conv3x3_grad_weights` splits its pixel tiles:
    as many as keep every block in the first wave (a second, partial wave
    costs more than it spreads), at most one split per 8x16 tile, and a
    float32 workspace of at most ``DW_WORKSPACE_CAP``. (The float32 kernel
    walks 8x8 tiles, at least as many.)"""
    tiles = b * _tiles(h, w)
    if cin % 8:
        m_tiles, wave = -(-9 * cin // DW_GATHER_TILE), \
            DW_GATHER_BLOCKS_PER_SM * SMS
    else:
        m_tiles, wave = -(-cin // DW_CIN_TILE), SMS
    blocks = m_tiles * -(-cout // COUT_TILE)
    splits = min(tiles, max(1, wave // blocks))
    return max(1, min(splits, DW_WORKSPACE_CAP // (9 * cin * cout * 4)))


def conv3x3_grad_weights(x, g):
    """dL/dw of a stride-1 SAME 3x3 no-bias conv: ``[3, 3, Cin, Cout]``
    float32 = sum over (b, y, x) of ``xpad[b, y+ky, x+kx, :]^T g[b, y, x, :]``.

    Args:
        x: [B, H, W, Cin], the conv's input; bfloat16 or float32.
        g: [B, H, W, Cout], the gradient of its output; x's dtype.
    """
    if x.device.type == "cpu":
        return conv3x3_grad_weights_plain(x, g)
    if (x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]
            or x.dtype != g.dtype):
        raise ValueError(
            f"conv3x3_grad_weights: want x [B,H,W,Cin] and g [B,H,W,Cout] of "
            f"one dtype; got {tuple(x.shape)} {x.dtype} and "
            f"{tuple(g.shape)} {g.dtype}"
        )
    code = {torch.float32: 0, torch.bfloat16: 1}.get(x.dtype)
    if code is None:
        raise TypeError(f"conv3x3_grad_weights: unsupported dtype {x.dtype}")
    if code and x.shape[3] % 8 == 0 and x.data_ptr() % 16:
        raise ValueError("conv3x3_grad_weights: a bfloat16 x with Cin a "
                         "multiple of 8 must start on a 16-byte address")
    for label, t in (("x", x), ("g", g)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"conv3x3_grad_weights: {label} must be contiguous on "
                f"{x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"conv3x3_grad_weights: x is on {x.device} but the current "
            f"device is cuda:{torch.cuda.current_device()}")
    b, h, w, cin = x.shape
    cout = g.shape[3]
    splits = dw_splits(b, h, w, cin, cout)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, 3, 3, cin, cout), dtype=torch.float32,
                      device=x.device) if splits > 1 else dw)
    err = _kernel("conv3x3_grad_weights_launch")(
        x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(), b, h, w,
        cin, cout, splits, code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("conv3x3_grad_weights", err)
    graphs.count_launch(conv3x3_grad_weights)
    return dw


conv3x3_grad_weights.launches = 0


# -- the training conv ---------------------------------------------------------


def conv3x3_plain(x, w, padding=1):
    """A 3x3 SAME no-bias conv in plain torch, differentiable by autograd:
    ``F.conv2d`` in float32 (float64 for float64 operands) on the
    operands in x's dtype (w cast to it), one cast of the result to x's
    dtype. On a CUDA tensor the caller keeps TF32 off. ``padding`` is ``F.conv2d``'s (``(0, 1)`` for a map
    whose H already carries its halo rows)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    wf = w.to(x.dtype).to(acc).permute(3, 2, 0, 1)
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2), wf, padding=padding)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _unit_epilogue(c: int, device) -> tuple:
    return (torch.ones(c, dtype=torch.float32, device=device),
            torch.zeros(c, dtype=torch.float32, device=device))


class _Conv3x3(torch.autograd.Function):
    """y = conv(x, w) on :func:`conv3x3_bn_relu` with a unit epilogue;
    dx = conv(g, flipT(w)) on the same kernel, dw on
    :func:`conv3x3_grad_weights` (``ops/pallas/conv.py`` ``_conv3x3_fwd``
    and ``_conv3x3_bwd``)."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return conv3x3_bn_relu(x, w, *_unit_epilogue(w.shape[3], x.device),
                               relu=False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the spatially flipped, in/out-transposed kernel
            wt = w.flip(0, 1).transpose(2, 3).contiguous()
            dx = conv3x3_bn_relu(g, wt, *_unit_epilogue(w.shape[2], x.device),
                                 relu=False).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # cast to w's dtype as the reference does: bfloat16 weights get
            # a bfloat16-rounded gradient before autograd casts it back
            dw = conv3x3_grad_weights(x, g).to(w.dtype)
        return dx, dw


def conv3x3(x, w, impl: str = "auto"):
    """The training conv: a differentiable stride-1 SAME 3x3 no-bias conv,
    x [B, H, W, Cin] and w [3, 3, Cin, Cout] (HWIO) in one dtype.

    ``impl`` is ``ModelConfig.conv_impl``: ``"auto"``, ``"pallas"`` and
    ``"interpret"`` take the custom-VJP kernels (their plain versions for
    CPU tensors); ``"flax"`` and ``"xla"`` take :func:`conv3x3_plain` with
    autograd. The JAX package's small-channel and large-volume routing to
    XLA is a TPU workaround and does not carry over: every CUDA tensor
    launches the kernels.
    """
    if impl not in CONV_IMPLS:
        raise ValueError(f"unknown conv impl {impl!r} (one of {CONV_IMPLS})")
    if impl in PLAIN_CONV_IMPLS:
        return conv3x3_plain(x, w)
    return _Conv3x3.apply(x, w)
