"""The per-frame analysis: frame -> mask -> curvature, on the device.

The port of the JAX package's ``ops/pipeline.py`` single-frame path:
``preprocess`` (antialiased bilinear resize to the model input as two
static float32 matmuls), the model forward, ``logits_to_native_masks``
(sigmoid, threshold, nearest resize back to the camera resolution), the
confidence margin, the mask coverage and the curvature profile. The
frame's host-to-device copy is the only transfer in; the result stays on
the device until the caller reads it.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from robotic_discovery_platform_tpu_torch.ops import geometry
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    check_supported,
)
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device


class FrameAnalysis(NamedTuple):
    mask: torch.Tensor  # [H, W] uint8 native-resolution binary mask
    mask_coverage: torch.Tensor  # percent of the frame covered
    profile: geometry.CurvatureProfile
    # mean |sigmoid(logit) - 0.5| at model resolution: distance from the
    # decision boundary (0 = maximally uncertain, 0.5 = saturated)
    confidence_margin: torch.Tensor


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] matrix R with ``R @ v == jax.image.resize(v, ...)``
    for 1-D antialiased bilinear resize: half-pixel sample centres, a
    triangle kernel widened by 1/scale when downscaling, per-output weight
    normalization and out-of-bounds zeroing."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)  # triangle kernel
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1e-7, weights / np.where(total != 0, total, 1), 0.0
    )
    in_bounds = ((sample_f >= -0.5) & (sample_f <= n_in - 0.5))[None, :]
    return np.where(in_bounds, weights, 0.0).T.astype(np.float32)


def preprocess(frames_rgb: torch.Tensor, img_size: int,
               r_h: torch.Tensor | None = None,
               r_w: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 [B, H, W, 3] RGB -> float32 [B, S, S, 3] in [0, 1]: the
    antialiased resize as an H contraction then a W contraction, in
    float32 (TF32 stays off on the card). ``r_h``/``r_w`` are the
    :func:`_resize_matrix` tables already on the device, if the caller
    keeps them."""
    h, w = frames_rgb.shape[1], frames_rgb.shape[2]
    dev = frames_rgb.device
    if r_h is None:
        r_h = torch.from_numpy(_resize_matrix(h, img_size)).to(dev)
    if r_w is None:
        r_w = torch.from_numpy(_resize_matrix(w, img_size)).to(dev)
    x = frames_rgb.to(torch.float32) / 255.0
    x = torch.einsum("Oh,bhwc->bOwc", r_h, x)
    return torch.einsum("Pw,bOwc->bOPc", r_w, x)


def logits_to_native_masks(logits: torch.Tensor, h: int, w: int,
                           threshold: float = 0.5) -> torch.Tensor:
    """[B, S, S, C] logits -> [B, H, W] uint8 masks: sigmoid > threshold at
    model resolution (any class, for C > 1), then a nearest resize with
    ``jax.image.resize``'s half-pixel rule (``mode="nearest-exact"``)."""
    if logits.shape[-1] == 1:
        prob = torch.sigmoid(logits[..., 0])
    else:
        prob = torch.amax(torch.sigmoid(logits), dim=-1)
    masks = (prob > threshold).to(torch.float32)
    masks = F.interpolate(masks[:, None], size=(h, w), mode="nearest-exact")
    return masks[:, 0].to(torch.uint8)


def confidence_margin(logits: torch.Tensor) -> torch.Tensor:
    """[B] mean |sigmoid(logit) - 0.5| over the model-resolution output
    (over every class channel for C > 1)."""
    if logits.shape[-1] == 1:
        return torch.mean(
            torch.abs(torch.sigmoid(logits[..., 0].to(torch.float32)) - 0.5),
            dim=(1, 2))
    return torch.mean(torch.abs(torch.sigmoid(logits.to(torch.float32)) - 0.5),
                      dim=(1, 2, 3))


def _as_device_frame(frame_rgb, depth, device: torch.device):
    """Host frames (numpy, possibly read-only wire views) or tensors ->
    uint8 RGB and float32 raw depth on ``device``. Depth crosses as its
    16-bit pattern and widens on the device (z16 is exact in float32)."""
    if not isinstance(frame_rgb, torch.Tensor):
        frame_rgb = torch.from_numpy(np.array(frame_rgb, np.uint8))
    if not isinstance(depth, torch.Tensor):
        depth = torch.from_numpy(
            np.array(depth, np.uint16).view(np.int16))
    frame_rgb = frame_rgb.to(device, non_blocking=True)
    depth = depth.to(device, non_blocking=True)
    if depth.dtype == torch.int16:
        depth = depth.to(torch.int32) & 0xFFFF
    return frame_rgb, depth.to(torch.float32)


def _f32_on(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def make_frame_analyzer(
    forward: Callable[[torch.Tensor], torch.Tensor],
    img_size: int = 256,
    geom_cfg: GeometryConfig = GeometryConfig(),
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
):
    """Build the single-frame analyzer around ``forward`` (NHWC float32
    -> NHWC float32 logits, e.g. :class:`ops.unet_infer.FoldedUNet`).

    Returns ``analyze(frame_rgb [H, W, 3] u8, depth [H, W] u16,
    intrinsics [3, 3], depth_scale) -> FrameAnalysis`` with unbatched
    fields on ``device``. Inputs may be numpy arrays or tensors; a caller
    that keeps the intrinsics and depth scale on the device as float32
    tensors saves their per-frame copies.
    """
    check_supported(geom_cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        # every float32 product of the analyzer is a full float32 product
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tables: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def analyze(frame_rgb, depth, intrinsics, depth_scale) -> FrameAnalysis:
        frame, raw_depth = _as_device_frame(frame_rgb, depth, device)
        h, w = frame.shape[0], frame.shape[1]
        mats = tables.get((h, w))
        if mats is None:
            mats = tables[(h, w)] = (
                torch.from_numpy(_resize_matrix(h, img_size)).to(device),
                torch.from_numpy(_resize_matrix(w, img_size)).to(device),
            )
        with torch.no_grad():
            x = preprocess(frame[None], img_size, *mats)
            logits = forward(x)
            masks = logits_to_native_masks(logits, h, w, threshold)
            margin = confidence_margin(logits)
            profile = geometry.compute_curvature_profile(
                masks[0], raw_depth, _f32_on(intrinsics, device),
                _f32_on(depth_scale, device), geom_cfg)
            # an exact count times the float32 reciprocal of the pixel count,
            # then the percent scaling: the JAX package's 100 * jnp.mean of
            # the 0/1 mask, to the bit
            count = torch.sum(masks[0], dtype=torch.int64).to(torch.float32)
            coverage = 100.0 * (count * (1.0 / (h * w)))
        return FrameAnalysis(mask=masks[0], mask_coverage=coverage,
                             profile=profile, confidence_margin=margin[0])

    return analyze
