"""The U-Net as a plain PyTorch ``nn.Module``, unfolded: the plain
reference of the forward that :class:`ops.unet_infer.FoldedUNet` runs
through the hand-written kernels.

Same architecture and parameter tree as the JAX package's
``models/unet.py`` ``UNet``: DoubleConv blocks of (3x3 conv, no bias ->
norm -> ReLU) x 2 (``ModelConfig.norm``: BatchNorm, or GroupNorm over
``gcd(32, C)`` groups), a 4-level encoder with 2x2 max-pooling, a decoder
with the align-corners bilinear upsample (``bilinear=True``, the default)
or a 2x2 stride-2 transposed conv with a bias and a nearest resize to the
skip's size (``bilinear=False``, channel ladder ending at 16x the base
width), the ``[skip, upsampled]`` concatenation, and a 1x1 head with a
bias. Submodules carry the Flax
names (``DoubleConv_0``, ``Down_2``, ``Conv_1``, ``BatchNorm_0``,
``GroupNorm_0`` ...) and
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
GroupNorm keeps no running statistics: it normalizes each sample alike in
training and inference.
The non-bilinear decoder's transposed conv trains as a plain autograd op
(:func:`ops.conv.conv_transpose2x2_plain`), as the JAX package trains it
with Flax's ``nn.ConvTranspose`` and no kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from robotic_discovery_platform_tpu_torch.analysis.contracts import shape_contract
from robotic_discovery_platform_tpu_torch.ops.conv import (
    conv3x3,
    conv3x3_plain,
    conv_transpose2x2_plain,
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


@shape_contract(x="b ih iw c")
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


def nearest_indices(out: int, inp: int) -> np.ndarray:
    """Source index of each of ``out`` samples of a nearest resize from
    ``inp``: ``floor((i + 0.5) * inp / out)`` in float32, the half-pixel
    rule of ``jax.image.resize(..., "nearest")``."""
    pos = (np.arange(out, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(inp) / np.float32(out)
    return np.floor(pos).astype(np.int64)


def resize_nearest(x: torch.Tensor, h: int, w: int,
                   cache: dict | None = None) -> torch.Tensor:
    """Nearest NHWC resize to ``[B, h, w, C]`` with
    :func:`nearest_indices` (the identity where a size already matches).
    ``cache`` keeps the index vectors on the device between calls."""
    for axis, out in ((1, h), (2, w)):
        inp = x.shape[axis]
        if inp == out:
            continue
        key = ("nearest", out, inp, x.device)
        idx = cache.get(key) if cache is not None else None
        if idx is None:
            idx = torch.from_numpy(nearest_indices(out, inp)).to(x.device)
            if cache is not None:
                cache[key] = idx
        x = x.index_select(axis, idx)
    return x


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
    With ``train=True`` (or ``kernels_in_eval``, :func:`eval_on_kernels`)
    and a kernel ``impl`` it is the custom-VJP :func:`ops.conv.conv3x3` on
    the kernel cast to x's dtype (the JAX package's ``TrainConv3x3``);
    otherwise the plain conv."""

    def __init__(self, cin: int, cout: int, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        self.kernels_in_eval = False
        self.kernel = nn.Parameter(torch.zeros(3, 3, cin, cout))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if ((train or self.kernels_in_eval)
                and self.impl not in PLAIN_CONV_IMPLS):
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
    statistics updated as ``0.9 * running + (1 - 0.9) * batch``.

    ``sync`` (None by default) maps the batch's per-channel means of x
    and x² to the statistics to use: ``parallel/dp.sync_batch_norm`` sets
    it to an all-reduce over the data axis, so a data-parallel step
    normalizes over the global batch."""

    momentum = 0.9
    sync = None

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
            sq = (xf * xf).mean(dim=(0, 1, 2))
            if self.sync is not None:
                mean, sq = self.sync(mean, sq)
            var = torch.clamp_min(sq - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x.to(torch.float32) - mean) * mul + self.bias).to(x.dtype)


class GroupNorm(nn.Module):
    """Flax's ``nn.GroupNorm(num_groups=groups)`` over the last (channel)
    axis, with Flax's settings rather than ``torch.nn.GroupNorm``'s:
    epsilon 1e-6, the statistics of each sample's (H, W, channels of the
    group) in float32 as ``max(0, E[x^2] - E[x]^2)`` (Flax's fast
    variance), then ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    float32 and one cast back to the input's dtype. No running
    statistics: training and inference normalize alike."""

    eps = 1e-6

    def __init__(self, c: int, groups: int):
        super().__init__()
        if c % groups:
            raise ValueError(f"{groups} groups do not divide {c} channels")
        self.groups = groups
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, h, w, c = x.shape
        g = self.groups
        xf = x.to(torch.float32)
        grouped = xf.reshape(b, h, w, g, c // g)
        mean = grouped.mean(dim=(1, 2, 4))
        var = torch.clamp_min((grouped * grouped).mean(dim=(1, 2, 4))
                              - mean * mean, 0.0)
        mean = mean.repeat_interleave(c // g, dim=1)[:, None, None, :]
        var = var.repeat_interleave(c // g, dim=1)[:, None, None, :]
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def _norm(norm: str, c: int) -> nn.Module:
    """The JAX package's ``models/unet._norm``: BatchNorm, or GroupNorm
    over ``gcd(32, c)`` groups."""
    if norm == "batch":
        return BatchNorm(c)
    if norm == "group":
        return GroupNorm(c, math.gcd(32, c))
    raise ValueError(f"unknown norm {norm!r}")


class DoubleConv(nn.Module):
    """(3x3 conv -> norm -> ReLU) x 2; the norms are ``BatchNorm_0`` and
    ``BatchNorm_1``, or ``GroupNorm_0`` and ``GroupNorm_1``, as Flax names
    them."""

    def __init__(self, cin: int, cout: int, mid: int | None = None,
                 impl: str = "auto", norm: str = "batch"):
        super().__init__()
        mid = mid or cout
        kind = "BatchNorm" if norm == "batch" else "GroupNorm"
        self.Conv_0 = Conv3x3(cin, mid, impl)
        setattr(self, f"{kind}_0", _norm(norm, mid))
        self.Conv_1 = Conv3x3(mid, cout, impl)
        setattr(self, f"{kind}_1", _norm(norm, cout))
        self._norms = (f"{kind}_0", f"{kind}_1")

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        n0, n1 = (getattr(self, n) for n in self._norms)
        x = torch.relu(n0(self.Conv_0(x, train), train))
        return torch.relu(n1(self.Conv_1(x, train), train))


class Down(nn.Module):
    """2x2 max-pool, then DoubleConv."""

    def __init__(self, cin: int, cout: int, impl: str = "auto",
                 norm: str = "batch"):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(cin, cout, impl=impl, norm=norm)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.DoubleConv_0(max_pool2x2(x), train)


class ConvTranspose2x2(nn.Module):
    """2x2 stride-2 transposed conv with a bias, Flax's ``nn.ConvTranspose``
    in the compute dtype: ``kernel`` is [2, 2, Cin, Cout] (its taps land
    flipped, :func:`ops.conv.conv_transpose2x2`), the product is rounded to
    x's dtype and the bias added in that dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(2, 2, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2x2_plain(x, self.kernel) + self.bias.to(x.dtype)


class Up(nn.Module):
    """Upsample to the skip's size, concat ``[skip, upsampled]``,
    DoubleConv. ``bilinear``: the align-corners bilinear upsample and a
    halved mid width; otherwise ``ConvTranspose_0`` to ``cin_up // 2``
    channels, then a nearest resize to the skip's size (the identity when
    the sizes already match), and no halved mid width."""

    def __init__(self, cin_up: int, cin_skip: int, cout: int,
                 impl: str = "auto", bilinear: bool = True,
                 norm: str = "batch"):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.DoubleConv_0 = DoubleConv(cin_up + cin_skip, cout,
                                           mid=(cin_up + cin_skip) // 2,
                                           impl=impl, norm=norm)
        else:
            self.ConvTranspose_0 = ConvTranspose2x2(cin_up, cin_up // 2)
            self.DoubleConv_0 = DoubleConv(cin_up // 2 + cin_skip, cout,
                                           impl=impl, norm=norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                train: bool = False, cache: dict | None = None
                ) -> torch.Tensor:
        h, w = skip.shape[1], skip.shape[2]
        if self.bilinear:
            x = upsample_align_corners(x, h, w, cache)
        else:
            x = resize_nearest(self.ConvTranspose_0(x), h, w, cache)
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
    """Encoder/decoder U-Net (bilinear or transposed-conv decoder,
    BatchNorm or GroupNorm). Call with NHWC input; returns NHWC float32 logits.
    ``dtype`` is the compute dtype of the activations; parameters stay
    float32. ``forward(x, train=True)`` is the training forward (module
    docstring)."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self._interp: dict = {}  # upsample matrices, per shape and device
        f, impl, norm = cfg.base_features, cfg.conv_impl, cfg.norm
        factor = 2 if cfg.bilinear else 1
        widths = [f, 2 * f, 4 * f, 8 * f, 16 * f // factor]
        self.DoubleConv_0 = DoubleConv(cfg.in_channels, f, impl=impl,
                                       norm=norm)
        for i in range(4):
            setattr(self, f"Down_{i}", Down(widths[i], widths[i + 1], impl,
                                            norm))
        # Up_i fuses widths[4 - i] (upsampled) with widths[3 - i] (skip)
        up_in = widths[4]
        for i, cout in enumerate([8 * f // factor, 4 * f // factor,
                                  2 * f // factor, f]):
            setattr(self, f"Up_{i}", Up(up_in, widths[3 - i], cout, impl,
                                        cfg.bilinear, norm))
            up_in = cout
        self.Conv_0 = Head(f, cfg.num_classes)

    def init_weights(self, gen: torch.Generator) -> UNet:
        """Draw every conv kernel and bias from ``cfg.init`` on ``gen``, in
        parameter order; BatchNorm keeps scale 1, bias 0, mean 0, var 1,
        GroupNorm scale 1, bias 0.
        A transposed conv's "torch" init takes torch ``ConvTranspose2d``'s
        fan, ``Cout * 4``, for kernel and bias (the JAX package's
        ``models/unet.py`` ``Up``); "lecun" takes Flax's ``Cin * 4`` and a
        zero bias."""
        init = self.cfg.init
        for module in self.modules():
            if isinstance(module, (Conv3x3, Head)):
                kh, kw, cin, _ = module.kernel.shape
                _kernel_init(init, module.kernel, kh * kw * cin, gen)
            if isinstance(module, Head):
                _bias_init(init, module.bias, module.kernel.shape[2], gen)
            if isinstance(module, ConvTranspose2x2):
                _, _, cin, cout = module.kernel.shape
                _kernel_init(init, module.kernel,
                             4 * (cout if init == "torch" else cin), gen)
                _bias_init(init, module.bias, 4 * cout, gen)
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


def eval_on_kernels(net: UNet) -> UNet:
    """``net`` in eval mode with its 3x3 convs on the conv kernel
    (:func:`ops.conv.conv3x3`, a unit epilogue; the norm and ReLU apart):
    the unfolded forward that ``ServerConfig.model_forward="flax"``
    serves, and the only served forward of a group-norm net. Returns
    ``net`` itself."""
    for module in net.modules():
        if isinstance(module, Conv3x3):
            module.kernels_in_eval = True
    return net.eval()


def with_compute_dtype(net: UNet, dtype: str,
                       state: dict | None = None) -> UNet:
    """A copy of ``net`` whose activations compute in ``dtype`` (a
    ``ModelConfig.compute_dtype`` name), on ``net``'s device and in its
    train/eval mode, holding ``state`` (default: ``net``'s own); the
    parameters stay float32. The JAX package's
    ``models/unet.with_compute_dtype``, which the precision tiers use
    (``ops/quant.apply_precision``)."""
    device = next(net.parameters()).device
    clone = UNet(dataclasses.replace(net.cfg, compute_dtype=dtype)).to(device)
    clone.load_state_dict(net.state_dict() if state is None else state)
    return clone.train(net.training)
