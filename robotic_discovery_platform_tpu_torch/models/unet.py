"""The U-Net as a plain PyTorch ``nn.Module``, unfolded: the plain
reference of the forward that :class:`ops.unet_infer.FoldedUNet` runs
through the hand-written kernels.

Same architecture and parameter tree as the JAX package's
``models/unet.py`` ``UNet``: DoubleConv blocks of (3x3 conv, no bias ->
BatchNorm -> ReLU) x 2, a 4-level encoder with 2x2 max-pooling, a decoder
with the align-corners bilinear upsample and ``[skip, upsampled]``
concatenation, and a 1x1 head with a bias. Submodules carry the Flax
names (``DoubleConv_0``, ``Down_2``, ``Conv_1``, ``BatchNorm_0`` ...) and
conv kernels stay HWIO, so a Flax ``{"params", "batch_stats"}`` tree maps
onto :meth:`nn.Module.state_dict` keys one to one
(:func:`models.weights.from_flax_variables`).

Layout at the public surface is the JAX package's: NHWC in, NHWC float32
logits out. Inside, convolutions run as ``F.conv2d`` on NCHW views with
the operands in the compute dtype and float32 accumulation.

``forward(x, train=True)`` is the training forward of the JAX package's
``UNet.apply(..., train=True)``: under a kernel ``ModelConfig.conv_impl``
each DoubleConv conv is the custom-VJP :func:`ops.conv.conv3x3` (the
hand-written forward, dx and dw kernels), and BatchNorm normalizes with
batch statistics in Flax's semantics and updates its running statistics.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from robotic_discovery_platform_tpu_torch.ops.conv import (
    conv3x3,
    conv3x3_plain,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    PLAIN_CONV_IMPLS,
    ModelConfig,
    check_supported,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    """``ModelConfig.compute_dtype`` -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported compute_dtype {name!r}; one of {sorted(_DTYPES)}"
        ) from None


def interp_matrix(out: int, inp: int) -> np.ndarray:
    """[out, inp] float32 align-corners linear interpolation weights."""
    if out == 1 or inp == 1:
        pos = np.zeros((out,))
    else:
        pos = np.arange(out) * (inp - 1) / (out - 1)
    i0 = np.clip(np.floor(pos).astype(int), 0, inp - 1)
    i1 = np.minimum(i0 + 1, inp - 1)
    frac = (pos - i0).astype(np.float32)
    m = np.zeros((out, inp), np.float32)
    np.add.at(m, (np.arange(out), i0), 1.0 - frac)
    np.add.at(m, (np.arange(out), i1), frac)
    return m


def interp_weights(out: int, inp: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """:func:`interp_matrix` rounded to ``dtype``, held as float32 on
    ``device``."""
    m = torch.from_numpy(interp_matrix(out, inp))
    return m.to(dtype).to(torch.float32).to(device)


def upsample_align_corners(x: torch.Tensor, h: int, w: int,
                           cache: dict | None = None) -> torch.Tensor:
    """Bilinear NHWC resize on the ``align_corners=True`` grid, as two
    interpolation matmuls: the matrices rounded to x's dtype, the
    contractions in float32, one cast back to x's dtype (the JAX
    package's ``models/unet.upsample_align_corners``; ``F.interpolate``
    rounds differently). ``cache`` keeps the matrices on the device
    between calls."""
    _, ih, iw, _ = x.shape

    def mat(out: int, inp: int) -> torch.Tensor:
        key = (out, inp, x.dtype, x.device)
        m = cache.get(key) if cache is not None else None
        if m is None:
            m = interp_weights(out, inp, x.dtype, x.device)
            if cache is not None:
                cache[key] = m
        return m

    y = torch.einsum("Hh,bhwc->bHwc", mat(h, ih), x.to(torch.float32))
    y = torch.einsum("Ww,bhwc->bhWc", mat(w, iw), y)
    return y.to(x.dtype)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max-pool of an NHWC tensor."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 1).contiguous()


# -- initializers ------------------------------------------------------------


def _kernel_init(init: str, t: torch.Tensor, fan_in: int,
                 gen: torch.Generator) -> None:
    """``"torch"``: U(+-sqrt(1/fan_in)), torch Conv2d's default
    kaiming_uniform_(a=sqrt(5)); ``"lecun"``: truncated normal with
    variance 1/fan_in (Flax's lecun_normal)."""
    with torch.no_grad():
        if init == "torch":
            bound = math.sqrt(1.0 / fan_in)
            t.uniform_(-bound, bound, generator=gen)
        elif init == "lecun":
            # stddev of a unit normal truncated to (-2, 2) is 0.8796...
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        else:
            raise ValueError(f"unknown init {init!r}")


def _bias_init(init: str, t: torch.Tensor, fan_in: int,
               gen: torch.Generator) -> None:
    """``"torch"``: U(+-1/sqrt(fan_in)); otherwise zeros."""
    with torch.no_grad():
        if init == "torch":
            bound = 1.0 / math.sqrt(fan_in)
            t.uniform_(-bound, bound, generator=gen)
        else:
            t.zero_()


# -- modules -----------------------------------------------------------------


class Conv3x3(nn.Module):
    """3x3 SAME conv without bias; ``kernel`` is HWIO [3, 3, Cin, Cout].
    With ``train=True`` and a kernel ``impl`` it is the custom-VJP
    :func:`ops.conv.conv3x3` on the kernel cast to x's dtype (the JAX
    package's ``TrainConv3x3``); otherwise the plain conv."""

    def __init__(self, cin: int, cout: int, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train and self.impl not in PLAIN_CONV_IMPLS:
            return conv3x3(x, self.kernel.to(x.dtype), self.impl)
        return conv3x3_plain(x, self.kernel)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, eps 1e-5, in Flax's order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, one cast
    back to the input's dtype.

    Inference normalizes with the running statistics. ``train=True``
    normalizes with the batch's, in Flax's ``nn.BatchNorm(momentum=0.9)``
    semantics (not ``nn.BatchNorm2d``'s): float32 statistics over (B, H,
    W), the variance as ``max(0, E[x^2] - E[x]^2)`` (biased), and running
    statistics updated as ``0.9 * running + (1 - 0.9) * batch``."""

    momentum = 0.9

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        mean, var = self.mean, self.var
        if train:
            xf = x.to(torch.float32)
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 1, 2))
                                  - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x.to(torch.float32) - mean) * mul + self.bias).to(x.dtype)


class DoubleConv(nn.Module):
    """(3x3 conv -> BatchNorm -> ReLU) x 2."""

    def __init__(self, cin: int, cout: int, mid: int | None = None,
                 impl: str = "auto"):
        super().__init__()
        mid = mid or cout
        self.Conv_0 = Conv3x3(cin, mid, impl)
        self.BatchNorm_0 = BatchNorm(mid)
        self.Conv_1 = Conv3x3(mid, cout, impl)
        self.BatchNorm_1 = BatchNorm(cout)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x, train), train))
        return torch.relu(self.BatchNorm_1(self.Conv_1(x, train), train))


class Down(nn.Module):
    """2x2 max-pool, then DoubleConv."""

    def __init__(self, cin: int, cout: int, impl: str = "auto"):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(cin, cout, impl=impl)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.DoubleConv_0(max_pool2x2(x), train)


class Up(nn.Module):
    """Align-corners bilinear upsample to the skip's size, concat
    ``[skip, upsampled]``, DoubleConv with a halved mid width."""

    def __init__(self, cin_up: int, cin_skip: int, cout: int,
                 impl: str = "auto"):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(cin_up + cin_skip, cout,
                                       mid=(cin_up + cin_skip) // 2,
                                       impl=impl)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                train: bool = False, cache: dict | None = None
                ) -> torch.Tensor:
        x = upsample_align_corners(x, skip.shape[1], skip.shape[2], cache)
        return self.DoubleConv_0(torch.cat([skip, x.to(skip.dtype)], dim=-1),
                                 train)


class Head(nn.Module):
    """1x1 conv with bias; ``kernel`` is [1, 1, Cin, Cout]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(1, 1, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel[0, 0].to(x.dtype).to(torch.float32)
        y = torch.matmul(x.to(torch.float32), w).to(x.dtype)
        return y + self.bias.to(x.dtype)


class UNet(nn.Module):
    """Encoder/decoder U-Net (bilinear decoder, BatchNorm). Call with NHWC
    input; returns NHWC float32 logits. ``dtype`` is the compute dtype of
    the activations; parameters stay float32. ``forward(x, train=True)``
    is the training forward (module docstring)."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self._interp: dict = {}  # upsample matrices, per shape and device
        f, impl = cfg.base_features, cfg.conv_impl
        widths = [f, 2 * f, 4 * f, 8 * f, 8 * f]  # 16 * f // 2, bilinear
        self.DoubleConv_0 = DoubleConv(cfg.in_channels, f, impl=impl)
        for i in range(4):
            setattr(self, f"Down_{i}", Down(widths[i], widths[i + 1], impl))
        # Up_i fuses widths[4 - i] (upsampled) with widths[3 - i] (skip)
        up_in = widths[4]
        for i, cout in enumerate([4 * f, 2 * f, f, f]):
            setattr(self, f"Up_{i}", Up(up_in, widths[3 - i], cout, impl))
            up_in = cout
        self.Conv_0 = Head(f, cfg.num_classes)

    def init_weights(self, gen: torch.Generator) -> UNet:
        """Draw every conv kernel and the head's bias from ``cfg.init`` on
        ``gen``, in parameter order; BatchNorm keeps scale 1, bias 0,
        mean 0, var 1."""
        for module in self.modules():
            if isinstance(module, (Conv3x3, Head)):
                kh, kw, cin, _ = module.kernel.shape
                _kernel_init(self.cfg.init, module.kernel, kh * kw * cin, gen)
            if isinstance(module, Head):
                _bias_init(self.cfg.init, module.bias, module.kernel.shape[2],
                           gen)
        return self

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        xs = [self.DoubleConv_0(x, train)]
        for i in range(4):
            xs.append(getattr(self, f"Down_{i}")(xs[-1], train))
        y = xs[4]
        for i in range(4):
            y = getattr(self, f"Up_{i}")(y, xs[3 - i], train, self._interp)
        return self.Conv_0(y).to(torch.float32)
