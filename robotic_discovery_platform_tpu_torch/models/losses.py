"""Segmentation losses and evaluation metrics, the JAX package's
``models/losses.py`` in the same formulas.

BCE is the default loss (the reference trains with ``BCEWithLogitsLoss``
only); the Dice term and the IoU / Dice / accuracy metrics are the JAX
package's additions. Every function takes logits and labels of shape
[..., H, W, C] and returns a scalar tensor; metrics threshold the sigmoid
at 0.5, the serving threshold.

Under a mesh that splits H (``parallel/dp.py``), a rank holds some rows
of each sample. The pixel means (BCE, accuracy) are then the rank's, and
their mean over equal shards is the global one; the per-sample ratios
(Dice, IoU) are not, so their numerators and denominators pass through
:func:`sample_sums`'s reduction (a sum over the spatial group) before
they divide.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_AXES = (-3, -2, -1)  # per-sample reduction over H, W, C

_reduce = contextvars.ContextVar("sample_sum_reduce", default=None)


@contextlib.contextmanager
def sample_sums(reduce):
    """Within the block, every per-sample sum over (H, W, C) of the
    functions below is passed through ``reduce`` (None: unchanged)."""
    token = _reduce.set(reduce)
    try:
        yield
    finally:
        _reduce.reset(token)


def _sum(t):
    """Per-sample sum over (H, W, C), through :func:`sample_sums`'s
    reduction."""
    total = t.sum(dim=_AXES)
    reduce = _reduce.get()
    return total if reduce is None else reduce(total)


def bce_with_logits(logits, labels):
    """Mean binary cross-entropy on logits, in the numerically stable form
    ``max(x, 0) - x * z + log1p(exp(-|x|))``."""
    x, z = logits, labels.to(logits.dtype)
    per = torch.clamp_min(x, 0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    return per.mean()


def dice_loss(logits, labels, eps: float = 1.0):
    """Soft Dice loss: 1 - the Dice coefficient of the sigmoid
    probabilities, per sample, averaged."""
    p = torch.sigmoid(logits)
    z = labels.to(logits.dtype)
    inter = _sum(p * z)
    denom = _sum(p) + _sum(z)
    dice = (2.0 * inter + eps) / (denom + eps)
    return (1.0 - dice).mean()


def bce_dice(logits, labels, dice_weight: float = 0.5):
    return ((1.0 - dice_weight) * bce_with_logits(logits, labels)
            + dice_weight * dice_loss(logits, labels))


def make_loss_fn(name: str, dice_weight: float = 0.5):
    """``TrainConfig.loss`` -> the loss function."""
    if name == "bce":
        return bce_with_logits
    if name == "dice":
        return dice_loss
    if name == "bce_dice":
        return lambda lg, lb: bce_dice(lg, lb, dice_weight)
    raise ValueError(f"unknown loss {name!r}")


def _masks(logits, labels, threshold: float):
    return torch.sigmoid(logits) > threshold, labels > 0.5


def binary_iou(logits, labels, threshold: float = 0.5, eps: float = 1e-7):
    """Foreground IoU per sample, averaged."""
    pred, z = _masks(logits, labels, threshold)
    inter = _sum(pred & z).to(torch.float32)
    union = _sum(pred | z).to(torch.float32)
    return ((inter + eps) / (union + eps)).mean()


def mean_iou(logits, labels, threshold: float = 0.5, eps: float = 1e-7):
    """mIoU over {background, foreground}, per sample, averaged."""
    pred, z = _masks(logits, labels, threshold)

    def iou(a, b):
        inter = _sum(a & b).to(torch.float32)
        union = _sum(a | b).to(torch.float32)
        return (inter + eps) / (union + eps)

    return (0.5 * (iou(pred, z) + iou(~pred, ~z))).mean()


def dice_coefficient(logits, labels, threshold: float = 0.5,
                     eps: float = 1e-7):
    pred, z = _masks(logits, labels, threshold)
    inter = _sum(pred & z).to(torch.float32)
    total = (_sum(pred) + _sum(z)).to(torch.float32)
    return ((2.0 * inter + eps) / (total + eps)).mean()


def pixel_accuracy(logits, labels, threshold: float = 0.5):
    pred, z = _masks(logits, labels, threshold)
    return (pred == z).to(torch.float32).mean()
