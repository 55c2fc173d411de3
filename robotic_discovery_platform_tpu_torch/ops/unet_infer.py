"""The folded U-Net inference forward, on the hand-written kernels.

The port of the JAX package's ``ops/pallas/unet_infer.PallasUNet``: every
(conv -> BatchNorm -> ReLU) half-block of a DoubleConv is one
:func:`ops.conv.conv3x3_bn_relu` launch with BatchNorm folded into
scale/bias ahead of time (18 launches per forward: 2 in the encoder's
input block, 8 in the four Down blocks, 8 in the four Up blocks), and the
1x1 head is one :func:`ops.conv.conv1x1` launch emitting float32 logits.
The non-bilinear model (``ModelConfig(bilinear=False)``) adds one
:func:`ops.conv.conv_transpose2x2` launch per decoder step (4 per
forward). Max-pooling, the align-corners upsample, the nearest resize and
the skip concatenation stay plain torch, as they stayed XLA in the JAX
package.

Each 3x3 launch takes its K-split count from the tuning table
(:func:`ops.tuning.lookup`, the JAX package's ``_dispatch_3x3``), or
:func:`ops.conv.fwd_plan`'s where the table has no valid entry. A CUDA
graph keeps the split in force when it was captured.

:meth:`FoldedUNet.forward_plain` runs the same sequence through the
kernels' plain PyTorch versions: the reference the kernel forward is held
against on the card.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from robotic_discovery_platform_tpu_torch.models.unet import (
    UNet,
    compute_dtype,
    eval_on_kernels,
    max_pool2x2,
    resize_nearest,
    upsample_align_corners,
)
from robotic_discovery_platform_tpu_torch.ops import tuning
from robotic_discovery_platform_tpu_torch.ops.conv import (
    conv1x1,
    conv1x1_plain,
    conv3x3_bn_relu,
    conv3x3_bn_relu_plain,
    conv_transpose2x2,
    conv_transpose2x2_plain,
    fold_batchnorm,
)
from robotic_discovery_platform_tpu_torch.utils.config import check_supported
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device


def _tuned_conv3x3(x, w, scale, bias, *, relu: bool):
    """One :func:`conv3x3_bn_relu` launch with the tuning table's split
    for its shape (None: ``fwd_plan``'s)."""
    b, h, width, cin = x.shape
    splits = tuning.lookup(h, width, cin, w.shape[-1], batch=b,
                           dtype=str(x.dtype).removeprefix("torch."))
    return conv3x3_bn_relu(x, w, scale, bias, relu=relu, splits=splits)


class FoldedUNet:
    """Callable inference forward over a fixed :class:`UNet`'s weights.

    ``net(x)``: NHWC input (any float dtype) -> NHWC float32 logits, the
    same contract as ``UNet.forward``. Weights are moved to ``device``,
    folded there and cast to the compute dtype once, at construction.
    """

    def __init__(self, net: UNet, device: str | torch.device = "cuda"):
        check_supported(net.cfg)
        if net.cfg.norm != "batch":
            # the JAX package's PallasUNet refusal, word for word
            raise ValueError(
                "PallasUNet folds BatchNorm; got norm="
                f"{net.cfg.norm!r} (use the Flax module instead)"
            )
        self.cfg = net.cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(net.cfg.compute_dtype)
        self._interp: dict = {}  # upsample matrices and indices, per shape
        with torch.no_grad():
            self._layers = self._fold(net)

    def _fold(self, net: UNet) -> dict:
        dev, dt = self.device, self.dtype

        def double_conv(dc) -> list:
            taps = []
            for conv, bn in ((dc.Conv_0, dc.BatchNorm_0),
                             (dc.Conv_1, dc.BatchNorm_1)):
                # folded on the device that runs them, wherever the
                # module lives, so one set of weights folds to one result
                scale, bias = fold_batchnorm(*(
                    t.to(dev) for t in (bn.scale, bn.bias, bn.mean, bn.var)))
                taps.append((conv.kernel.to(dev, dt).contiguous(),
                             scale.to(dev).contiguous(),
                             bias.to(dev).contiguous()))
            return taps

        layers = {"inc": double_conv(net.DoubleConv_0)}
        for i in range(4):
            layers[f"down{i}"] = double_conv(getattr(net, f"Down_{i}").DoubleConv_0)
            up = getattr(net, f"Up_{i}")
            layers[f"up{i}"] = double_conv(up.DoubleConv_0)
            if not self.cfg.bilinear:
                ct = up.ConvTranspose_0
                layers[f"convt{i}"] = (
                    ct.kernel.to(dev, dt).contiguous(),
                    ct.bias.to(dev, torch.float32).contiguous())
        head = net.Conv_0
        layers["head"] = (
            head.kernel[0, 0].to(dev, dt).contiguous(),  # [Cin, Cout]
            torch.ones(head.kernel.shape[-1], device=dev),
            head.bias.to(dev, torch.float32).contiguous(),
        )
        return layers

    def on(self, device: str | torch.device) -> FoldedUNet:
        """The same folded weights copied to ``device`` (another serving
        ring position)."""
        twin = copy.copy(self)
        twin.device = resolve_device(device)
        twin._interp = {}

        def move(node):
            if isinstance(node, torch.Tensor):
                return node.to(twin.device)
            if isinstance(node, dict):
                return {k: move(v) for k, v in node.items()}
            return type(node)(move(v) for v in node)

        twin._layers = move(self._layers)
        return twin

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(x, _tuned_conv3x3, conv1x1, conv_transpose2x2)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The same forward through the kernels' plain PyTorch versions."""
        return self._forward(x, conv3x3_bn_relu_plain, conv1x1_plain,
                             conv_transpose2x2_plain)

    def _forward(self, x, conv3x3, conv1x1_head, convt) -> torch.Tensor:
        layers = self._layers

        def double_conv(y, taps):
            for w, scale, bias in taps:
                y = conv3x3(y, w, scale, bias, relu=True)
            return y

        x = x.to(self.dtype).contiguous()  # the kernels take dense NHWC
        xs = [double_conv(x, layers["inc"])]
        for i in range(4):
            xs.append(double_conv(max_pool2x2(xs[-1]), layers[f"down{i}"]))
        y = xs[4]
        for i in range(4):
            skip = xs[3 - i]
            h, w = skip.shape[1], skip.shape[2]
            if self.cfg.bilinear:
                up = upsample_align_corners(y, h, w, self._interp)
            else:
                up = resize_nearest(convt(y, *layers[f"convt{i}"]), h, w,
                                    self._interp)
            y = double_conv(torch.cat([skip, up.to(skip.dtype)], dim=-1),
                            layers[f"up{i}"])
        w, scale, bias = layers["head"]
        return conv1x1_head(y, w, scale, bias, relu=False,
                            out_dtype=torch.float32)


def reference_forward(net: UNet, device: str | torch.device = "cuda"
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The forward a reference analyzer (a gate's, a profile capture's, a
    rollout candidate's) runs over ``net`` on ``device``: folded onto the
    kernels (:class:`FoldedUNet`) where its norm folds, else a copy of the
    unfolded module on the conv kernel (:func:`models.unet.
    eval_on_kernels`), as the JAX package's reference analyzers run the
    Flax module whatever the norm."""
    if net.cfg.norm == "batch":
        return FoldedUNet(net, device=device)
    return eval_on_kernels(copy.deepcopy(net).to(resolve_device(device)))
