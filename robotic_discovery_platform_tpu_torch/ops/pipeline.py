"""The per-frame analysis: frame -> mask -> curvature, on the device.

The port of the JAX package's ``ops/pipeline.py``: ``preprocess``
(antialiased bilinear resize to the model input as two static float32
matmuls), the model forward, ``logits_to_native_masks`` (sigmoid,
threshold, nearest resize back to the camera resolution), the confidence
margin, the mask coverage and the curvature profile, for one frame
(:func:`make_frame_analyzer`) or a batch (:func:`make_batch_analyzer`,
which can end in :func:`pack_analysis`: one [B, P] uint8 payload per
dispatch). The frames' host-to-device copy is the only transfer in; the
result stays on the device until the caller reads it.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from robotic_discovery_platform_tpu_torch.ops import geometry, pack
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    check_supported,
)
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device


class FrameAnalysis(NamedTuple):
    mask: torch.Tensor  # [(B,) H, W] uint8 native-resolution binary mask
    mask_coverage: torch.Tensor  # [(B,)] percent of the frame covered
    profile: geometry.CurvatureProfile  # leaves lead with B in batch mode
    # mean |sigmoid(logit) - 0.5| at model resolution: distance from the
    # decision boundary (0 = maximally uncertain, 0.5 = saturated)
    confidence_margin: torch.Tensor


@functools.lru_cache(maxsize=64)
def _header_on(h: int, w: int, n_pts: int,
               device: torch.device) -> torch.Tensor:
    """The row header on the device, copied there once per geometry (a
    per-dispatch copy from pageable memory would wait on the stream)."""
    return torch.from_numpy(pack.payload_header(h, w, n_pts).copy()).to(device)


def pack_analysis(out: FrameAnalysis, *, n_pts: int) -> torch.Tensor:
    """A batched :class:`FrameAnalysis` -> one ``[B, P]`` uint8 packed
    payload on the device (``ops/pack.py``'s row layout, byte for byte the
    JAX package's): the header, the float32 sidecar of coverage, mean and
    max curvature, validity and confidence margin, then the spline block,
    then the bitpacked mask, zero-padded to ``frame_payload_bytes``.

    Invalid profiles' curvatures are masked with ``where``, not
    multiplied, so a non-finite curvature on an invalid frame packs as the
    exact 0.0 the direct path reports."""
    b, h, w = out.mask.shape
    prof = out.profile
    if prof.spline_points.shape[-2] != n_pts:
        raise ValueError(
            f"spline block has {prof.spline_points.shape[-2]} samples; "
            f"the packed layout was declared with n_pts={n_pts}"
        )
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=out.mask.device)
    sidecar = torch.cat([
        torch.stack([
            out.mask_coverage.to(f32),
            torch.where(prof.valid, prof.mean_curvature, zero).to(f32),
            torch.where(prof.valid, prof.max_curvature, zero).to(f32),
            prof.valid.to(f32),
            out.confidence_margin.to(f32),
        ], dim=1),
        prof.spline_points.to(f32).reshape(b, -1),
    ], dim=1)
    header = _header_on(h, w, n_pts, out.mask.device)
    row = torch.zeros((b, pack.frame_payload_bytes(h, w, n_pts)),
                      dtype=torch.uint8, device=out.mask.device)
    side = sidecar.contiguous().view(torch.uint8)  # little-endian f32 bytes
    lo = pack.HEADER_BYTES + side.shape[1]
    row[:, :pack.HEADER_BYTES] = header
    row[:, pack.HEADER_BYTES:lo] = side
    row[:, lo:lo + h * pack.packed_row_bytes(w)] = pack.bitpack_mask(
        out.mask).reshape(b, -1)
    return row


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


def stage_batch(frames_rgb: torch.Tensor, depths: torch.Tensor,
                intrinsics: torch.Tensor, depth_scales: torch.Tensor,
                device: torch.device):
    """Host-to-device staging of one padded batch, off the analyzer's
    critical path: ``non_blocking`` copies on the current stream (the
    dispatcher's dispatch stream) from the dispatcher's pooled pinned host
    buffers, so staging batch N+1 overlaps batch N's compute. The caller
    keeps the host buffers untouched until the stream has passed the
    copies. On a CPU ``device`` the tensors come back as they are.

    Returns (frames u8 [B, H, W, 3], depths [B, H, W] as the z16 bit
    pattern in int16, intrinsics [B, 3, 3] f32, depth scales [B] f32)."""
    return tuple(t.to(device, non_blocking=True)
                 for t in (frames_rgb, depths, intrinsics, depth_scales))


def _analyzer(forward, img_size: int, geom_cfg: GeometryConfig,
              threshold: float, device):
    """The shared core: ``(frames [B, H, W, 3] u8, depths [B, H, W] z16,
    intrinsics [B, 3, 3], depth_scales [B]) -> FrameAnalysis`` with a
    leading B on every field, on ``device``."""
    check_supported(geom_cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        # every float32 product of the analyzer is a full float32 product
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tables: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def analyze(frames_rgb, depths, intrinsics, depth_scales) -> FrameAnalysis:
        frames, raw_depth = _as_device_frame(frames_rgb, depths, device)
        b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        mats = tables.get((h, w))
        if mats is None:
            mats = tables[(h, w)] = (
                torch.from_numpy(_resize_matrix(h, img_size)).to(device),
                torch.from_numpy(_resize_matrix(w, img_size)).to(device),
            )
        k = _f32_on(intrinsics, device)
        scales = _f32_on(depth_scales, device)
        with torch.no_grad():
            # frame by frame, so each frame's float32 resize sums are those
            # of a batch of one: a frame's mask does not depend on the batch
            # it rode in (the forward's kernels compute each pixel alone)
            x = torch.cat([preprocess(frames[i:i + 1], img_size, *mats)
                           for i in range(b)])
            logits = forward(x)
            masks = logits_to_native_masks(logits, h, w, threshold)
            margin = confidence_margin(logits)
            if b == 1:
                # one frame takes geom_cfg.kernel_impl's path (the fused
                # kernels by default); a batch runs the reference ops, as
                # the JAX package's vmapped leg pins "xla"
                profile = geometry.CurvatureProfile(*(
                    t[None] for t in geometry.compute_curvature_profile(
                        masks[0], raw_depth[0], k[0], scales[0], geom_cfg)))
            else:
                profile = geometry.compute_curvature_profile(
                    masks, raw_depth, k, scales, geom_cfg)
            # an exact count times the float32 reciprocal of the pixel
            # count, then the percent scaling: the JAX package's
            # 100 * jnp.mean of the 0/1 mask, to the bit
            count = torch.sum(masks, dim=(1, 2), dtype=torch.int64)
            coverage = 100.0 * (count.to(torch.float32) * (1.0 / (h * w)))
        return FrameAnalysis(mask=masks, mask_coverage=coverage,
                             profile=profile, confidence_margin=margin)

    return analyze


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
    core = _analyzer(forward, img_size, geom_cfg, threshold, device)
    device = resolve_device(device)

    def analyze(frame_rgb, depth, intrinsics, depth_scale) -> FrameAnalysis:
        out = core(_leading(frame_rgb), _leading(depth),
                   _f32_on(intrinsics, device)[None],
                   _f32_on(depth_scale, device)[None])
        return FrameAnalysis(
            mask=out.mask[0], mask_coverage=out.mask_coverage[0],
            profile=geometry.CurvatureProfile(*(t[0] for t in out.profile)),
            confidence_margin=out.confidence_margin[0])

    return analyze


def make_batch_analyzer(
    forward: Callable[[torch.Tensor], torch.Tensor],
    img_size: int = 256,
    geom_cfg: GeometryConfig = GeometryConfig(),
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
    *,
    pack: bool = False,
):
    """Batched analyzer for cross-stream micro-batching: one forward over
    ``[B, H, W, 3]``, the geometry over the batch.

    Returns ``analyze(frames [B, H, W, 3] u8, depths [B, H, W] (z16, as
    uint16 numpy or the int16 bit pattern of :func:`stage_batch`),
    intrinsics [B, 3, 3], depth_scales [B])``: a :class:`FrameAnalysis`
    with a leading B, or with ``pack=True`` the ``[B, P]`` uint8 payload
    of :func:`pack_analysis` (the dispatcher's one device-to-host copy).
    The call returns once the work is enqueued on the current stream.
    """
    core = _analyzer(forward, img_size, geom_cfg, threshold, device)
    if not pack:
        return core

    def analyze(frames_rgb, depths, intrinsics, depth_scales) -> torch.Tensor:
        return pack_analysis(core(frames_rgb, depths, intrinsics,
                                  depth_scales), n_pts=geom_cfg.num_samples)

    return analyze


def _leading(a):
    """A frame with a leading batch axis of one (numpy or tensor)."""
    return a[None] if isinstance(a, torch.Tensor) else np.asarray(a)[None]
