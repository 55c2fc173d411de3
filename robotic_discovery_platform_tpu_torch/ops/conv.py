"""The U-Net's convolution kernels: hand-written CUDA for Hopper, each with
its plain PyTorch version beside it.

- :func:`conv3x3_bn_relu` (``csrc/conv3x3_bn_relu.cu``) replaces the TPU
  kernel ``robotic_discovery_platform_tpu/ops/pallas/conv.py``
  ``conv3x3_bn_relu``: NHWC 3x3 SAME conv + folded-BatchNorm scale/bias
  (+ ReLU), f32 accumulation, one rounding to the output type.
- :func:`conv1x1` (``csrc/conv1x1.cu``) replaces ``conv1x1`` of the same
  file (both its Cout = 1 squeeze body and its general body).

Layouts are the JAX package's: activations NHWC, 3x3 kernels HWIO
``[3, 3, Cin, Cout]``, 1x1 kernels ``[Cin, Cout]``, scale/bias ``[Cout]``
float32. The bound of each kernel on an H100 and what its design does
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

from robotic_discovery_platform_tpu_torch.ops import build

#: (input dtype, output dtype) -> the dtypes code of the C interface
_DTYPES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.bfloat16, torch.float32): 2,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w, scale, bias, out, B, H, W, Cin, Cout, relu, dtypes, stream
    "conv3x3_bn_relu": ("conv3x3_bn_relu_launch",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    # x, w, scale, bias, out, P, Cin, Cout, relu, dtypes, stream
    "conv1x1": ("conv1x1_launch",
                [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P]),
}
_fns: dict[str, ctypes._CFuncPtr] = {}


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5):
    """Fold inference BatchNorm into per-channel float32 (scale, bias):
    ``(x - mean) / sqrt(var + eps) * gamma + beta = x * scale + bias``."""
    gamma, beta, mean, var = (torch.as_tensor(t, dtype=torch.float32)
                              for t in (gamma, beta, mean, var))
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(build.library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_cuda(name: str, x, w, scale, bias, out_dtype):
    """Validate what the kernel takes; returns its dtypes code."""
    code = _DTYPES.get((x.dtype, out_dtype))
    if code is None:
        raise TypeError(
            f"{name}: unsupported dtypes {x.dtype} -> {out_dtype}; the "
            f"kernel takes {sorted((str(a), str(b)) for a, b in _DTYPES)}"
        )
    for label, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: x is on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{name}: scale and bias must be float32")
    return code


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


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


def conv3x3_bn_relu(x, w, scale, bias, *, relu: bool = True, out_dtype=None):
    """Fused NHWC 3x3 SAME conv + per-channel scale/bias (+ ReLU).

    Args:
        x: [B, H, W, Cin], bfloat16 or float32.
        w: [3, 3, Cin, Cout] (HWIO), cast to x's dtype.
        scale, bias: [Cout] float32 epilogue coefficients.
        relu: apply max(y, 0) in the epilogue.
        out_dtype: output dtype (default x's; float32 also taken for a
            bfloat16 x).
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
    code = _check_cuda("conv3x3_bn_relu", x, w, scale, bias, out_dtype)
    out = torch.empty((b, h, width, cout), dtype=out_dtype, device=x.device)
    err = _kernel("conv3x3_bn_relu")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, width, cin, cout, int(relu), code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on("conv3x3_bn_relu", err)
    conv3x3_bn_relu.launches += 1
    return out


conv3x3_bn_relu.launches = 0


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
    code = _check_cuda("conv1x1", x, w, scale, bias, out_dtype)
    out = torch.empty((b, h, width, cout), dtype=out_dtype, device=x.device)
    err = _kernel("conv1x1")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b * h * width, cin, cout, int(relu), code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on("conv1x1", err)
    conv1x1.launches += 1
    return out


conv1x1.launches = 0
