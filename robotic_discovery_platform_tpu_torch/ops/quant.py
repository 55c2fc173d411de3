"""Precision tiers for the serving path: bf16 activations and int8 weights
(the counterpart of the JAX package's ``ops/pallas/quant.py``).

- ``"f32"``: no transformation. :func:`apply_precision` returns the net it
  was given, so the tier serves exactly what the model was configured to
  serve (the reference the other tiers are gated against).
- ``"bf16"``: a copy of the net whose ``cfg.compute_dtype`` is
  ``"bfloat16"`` (:func:`models.unet.with_compute_dtype`); parameters
  stay float32, and the folded forward casts them to its compute dtype
  (``ops/unet_infer.FoldedUNet``).
- ``"int8"``: bf16 activations plus per-output-channel symmetric int8
  weight quantization of every conv kernel (the 3x3 DoubleConv convs, the
  2x2 transposed convs and the 1x1 head): ``w ~ round(w / s_c) * s_c``
  with ``s_c = max|w[..., c]| / 127``. The net carries the dequantized
  float32 values (exact int8-grid points), so the same kernels run them:
  no int8 tensor-core kernel, as the JAX package has none.

The port's :class:`models.unet.UNet` keeps the Flax names and HWIO
kernels, so its state-dict keys are the Flax paths joined by ``.`` and a
kernel's output-channel axis is its last, as in the JAX package.

Accuracy is not assumed: the servicer's warm-up holds a non-f32 tier to
the f32 outputs on golden frames (:func:`golden_frames`,
:func:`parity_report`, :func:`parity_gates_pass`;
``serving/server.VisionAnalysisService.warmup``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models.unet import (
    UNet,
    with_compute_dtype,
)
from robotic_discovery_platform_tpu_torch.utils.config import PRECISIONS

#: int8 symmetric range: [-127, 127] (the -128 code is unused, so the grid
#: is symmetric and dequantization needs one scale and no zero point)
_QMAX = 127


def resolve_precision(cfg_value: str, env: str | None = None) -> str:
    """The serving precision tier: ``RDP_PRECISION`` (or ``env``)
    overrides the config value, as in the JAX package."""
    raw = env if env is not None else os.environ.get("RDP_PRECISION")
    value = (raw if raw not in (None, "") else cfg_value).strip().lower()
    if value not in PRECISIONS:
        raise ValueError(
            f"unknown precision {value!r} (choose from {PRECISIONS})"
        )
    return value


# -- int8 weight quantization ------------------------------------------------


def quantize_int8(w: torch.Tensor, axis: int = -1):
    """Per-channel symmetric int8 quantization along ``axis``.

    Returns ``(q int8, scale float32)`` with ``scale`` shaped like ``w``
    reduced over every axis but ``axis`` (kept, so ``q * scale``
    broadcasts back). An all-zero channel gets scale 1 (its codes are 0).
    Every step is a correctly rounded float32 operation (``round`` halves
    to even, as ``jnp.round``), so the codes and scales are the JAX
    package's bit for bit, on the CPU and on the card. (The divisor 127
    is a tensor: on the card PyTorch divides by a Python scalar as a
    product with its rounded reciprocal.)"""
    w = w.to(torch.float32)
    axis = axis % w.dim()
    dims = [i for i in range(w.dim()) if i != axis]
    amax = torch.amax(torch.abs(w), dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, _QMAX),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` back to float32 (exact int8-grid values)."""
    return q.to(torch.float32) * scale


def fake_quantize_int8(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Quantize then dequantize: the int8-grid projection of ``w``."""
    return dequantize_int8(*quantize_int8(w, axis))


def _is_conv_kernel(path: tuple, leaf) -> bool:
    """A conv kernel of the U-Net's state: named ``kernel`` with a
    trailing output-channel axis (the 4-D HWIO 3x3 and 2x2 kernels and the
    1x1 head). BatchNorm parameters and statistics and conv biases stay
    float32: O(C) values whose quantization saves nothing."""
    return (bool(path) and path[-1] == "kernel"
            and getattr(leaf, "ndim", 0) >= 2)


def quantize_unet_variables(state: dict) -> tuple[dict, dict]:
    """Per-output-channel int8 quantization of every conv kernel of a
    :class:`UNet` state dict. Returns ``(quantized_state, report)``: the
    state with the kernels' dequantized float32 values (every other entry
    the same tensor), and the JAX package's report of the per-layer error
    and the int8 storage footprint."""
    report = {"layers": 0, "int8_bytes": 0, "f32_bytes": 0,
              "max_abs_err": 0.0, "max_rel_err": 0.0}
    quantized = {}
    for key, leaf in state.items():
        if not _is_conv_kernel(tuple(key.split(".")), leaf):
            quantized[key] = leaf
            continue
        q, scale = quantize_int8(leaf, axis=-1)
        dq = dequantize_int8(q, scale)
        err = float(torch.max(torch.abs(dq - leaf.to(torch.float32))))
        amax = float(torch.max(torch.abs(leaf)))
        report["layers"] += 1
        report["int8_bytes"] += q.numel() + 4 * scale.numel()
        report["f32_bytes"] += 4 * q.numel()
        report["max_abs_err"] = max(report["max_abs_err"], err)
        if amax > 0:
            report["max_rel_err"] = max(report["max_rel_err"], err / amax)
        quantized[key] = dq.to(leaf.dtype)
    return quantized, report


# -- precision application ---------------------------------------------------


def apply_precision(net: UNet, precision: str) -> tuple[UNet, dict | None]:
    """``net`` transformed for one serving precision tier (resolved through
    :func:`resolve_precision`, so ``RDP_PRECISION`` overrides it, as in
    the JAX package). Returns ``(net, report)``: at f32 the same object
    and None; otherwise a new net on ``net``'s device, in bf16 compute,
    whose conv kernels are int8-grid values at "int8"."""
    precision = resolve_precision(precision)
    if precision == "f32":
        return net, None
    if precision == "bf16":
        return (with_compute_dtype(net, "bfloat16"),
                {"tier": "bf16", "layers": 0})
    state, report = quantize_unet_variables(net.state_dict())
    report["tier"] = "int8"
    return with_compute_dtype(net, "bfloat16", state), report


# -- parity metrics ----------------------------------------------------------


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def mask_iou(a, b) -> float:
    """Intersection over union of two binary masks; 1.0 when both are
    empty (two all-background masks agree)."""
    a = _np(a) > 0
    b = _np(b) > 0
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(a, b).sum() / union)


def golden_frames(n: int, h: int, w: int, seed: int = 0) -> list:
    """``n`` deterministic synthetic actuator scenes (``io/frames.
    render_scene``) as ``(rgb u8 [h, w, 3], depth u16 [h, w])``: frames
    with real geometry, on which a tier's mask flips mean something (on
    noise, thresholded masks flip at random)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img, _, depth = render_scene(rng, h, w)
        out.append((img, depth))
    return out


def parity_report(ref_outputs, got_outputs) -> dict:
    """Compare two lists of FrameAnalysis-like outputs (the same frames
    through the f32 reference and a reduced-precision tier): mean and
    worst mask IoU, and the mean and worst absolute curvature delta over
    frames valid in both (a validity flip scores both magnitudes)."""
    ious, curv_errs = [], []
    valid_agree = 0
    for ref, got in zip(ref_outputs, got_outputs):
        ious.append(mask_iou(ref.mask, got.mask))
        rv = bool(_np(ref.profile.valid))
        gv = bool(_np(got.profile.valid))
        valid_agree += int(rv == gv)
        if rv and gv:
            for field in ("mean_curvature", "max_curvature"):
                curv_errs.append(abs(
                    float(_np(getattr(ref.profile, field)))
                    - float(_np(getattr(got.profile, field)))
                ))
        elif rv != gv:
            curv_errs.append(abs(float(_np(ref.profile.mean_curvature)))
                             + abs(float(_np(got.profile.mean_curvature))))
    return {
        "frames": len(ious),
        "mask_iou_mean": float(np.mean(ious)) if ious else 1.0,
        "mask_iou_min": float(np.min(ious)) if ious else 1.0,
        "curvature_err_mean": float(np.mean(curv_errs)) if curv_errs else 0.0,
        "curvature_err_max": float(np.max(curv_errs)) if curv_errs else 0.0,
        "valid_agreement": valid_agree / max(len(ious), 1),
    }


def parity_gates_pass(report: dict, min_iou: float,
                      max_curv_err: float) -> bool:
    """The warm-up gate: mean IoU at or above the floor and the worst
    curvature delta at or below the ceiling."""
    return (report["mask_iou_mean"] >= min_iou
            and report["curvature_err_max"] <= max_curv_err)
