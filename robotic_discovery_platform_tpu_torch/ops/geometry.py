"""Mask + depth -> point cloud -> edge -> B-spline -> curvature, as one
static-shape torch pipeline.

The port of the JAX package's ``ops/geometry.py``: dense pinhole
deprojection over the full H x W grid, edge extraction as ONE sort of a
packed int32 (x-bin, descending-y) key so each bin's top 5% by y is the
head of its segment, a fixed-knot penalized least-squares B-spline, and
curvature. Every data-dependent step is masked fixed-shape tensor code,
so the whole profile runs on the device with no host round trip;
graceful-zero results come as a ``valid=False`` flag with zeroed fields.

``GeometryConfig.kernel_impl`` picks the path of one frame, as in the
JAX package: ``"auto"`` (the default), ``"pallas"`` and ``"interpret"``
run the three fused geometry functions of :mod:`ops.geometry_kernels`
(their kernels on the card, their plain versions on the CPU); ``"xla"``
runs the reference ops below. Every function here also takes frames with
leading batch dimensions; a batch always runs the reference ops, as the
JAX package's vmapped leg pins ``"xla"``.

Parity with the JAX package: the deprojection maps and the x/y min/max
and valid count are bitwise; the sort is stable (``torch.sort(stable=
True)``), and the float-to-int casts clip in float first, so they never
depend on how a backend converts an out-of-range float.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from robotic_discovery_platform_tpu_torch.ops import bspline
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    check_supported,
    resolve_kernel_impl,
)

_F32 = torch.float32
_BIG = 1e30
_SHIFT = 1 << 25


class CurvatureProfile(NamedTuple):
    """Fixed-shape curvature result; when ``valid`` is False every
    curvature field is zeroed."""

    mean_curvature: torch.Tensor  # scalar
    max_curvature: torch.Tensor  # scalar
    spline_points: torch.Tensor  # [num_samples, 3]
    valid: torch.Tensor  # scalar bool
    num_cloud_points: torch.Tensor  # scalar int32 (diagnostics)
    num_edge_points: torch.Tensor  # scalar int32 (diagnostics)
    truncated: torch.Tensor  # scalar bool: a bin hit max_per_bin


def deproject(mask, depth, fx, fy, cx, cy, depth_scale, stride: int = 1):
    """Pinhole deprojection over the dense grid -> (x, y, z, valid) maps.

    ``depth`` is raw depth as float32 (z16 values are exact in float32),
    [..., H, W]; the intrinsics and ``depth_scale`` are float32 tensors
    that broadcast against it. With ``stride`` > 1 the maps are an s x s
    pooled view and coordinates point at each cell's centre."""
    h, w = depth.shape[-2:]
    off = (stride - 1) / 2.0
    v = torch.arange(h, dtype=_F32, device=depth.device)[:, None]
    u = torch.arange(w, dtype=_F32, device=depth.device)[None, :]
    v = (v * stride + off).expand(h, w)
    u = (u * stride + off).expand(h, w)
    z = depth.to(_F32) * depth_scale
    valid = (mask > 0) & (z > 0)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    return x, y, z, valid


def masked_stats(x, y, valid):
    """(x_min, x_max, y_min, y_max, n_valid int32) over the valid pixels of
    [..., H, W] maps, with the +-1e30 sentinels where none is valid."""
    big = torch.full((), _BIG, dtype=_F32, device=x.device)
    dims = (-2, -1)
    return (torch.amin(torch.where(valid, x, big), dim=dims),
            torch.amax(torch.where(valid, x, -big), dim=dims),
            torch.amin(torch.where(valid, y, big), dim=dims),
            torch.amax(torch.where(valid, y, -big), dim=dims),
            torch.sum(valid, dim=dims).to(torch.int32))


def _edge_points(x, y, z, valid, cfg: GeometryConfig, stats=None):
    """Bin x into ``num_bins`` equal bins over the valid x-range and keep
    the top ``max(1, floor(top_k_percent * n_b))`` points by y per bin,
    capped at ``max_per_bin``, for [..., H, W] maps.

    ``stats`` carries (x_min, x_max, y_min, y_max, n_valid) when the fused
    deprojection already folded them (:func:`masked_stats` otherwise):
    min/max and an integer count are the same values from either.

    Returns ([..., num_bins * max_per_bin, 3] points, their weights,
    edge_count, binnable flag, per-bin-cap flag)."""
    if (cfg.num_bins + 1) << 25 >= 2**31:
        raise ValueError(
            f"num_bins={cfg.num_bins} overflows the packed int32 sort key "
            "(needs (num_bins + 1) << 25 < 2^31, i.e. num_bins <= 62)"
        )
    dev = x.device
    lead = x.shape[:-2]
    p = x.shape[-2] * x.shape[-1]
    # one row per frame
    xs, ys, zs, v = (t.reshape(-1, p) for t in (x, y, z, valid))
    if stats is None:
        stats = masked_stats(x, y, valid)
    x_min, x_max, y_min, y_max, n_valid = (t.reshape(-1, 1) for t in stats)
    # divided by a device tensor: PyTorch's CUDA division by a host
    # scalar multiplies by its rounded reciprocal, one ulp off the
    # quotient, which moves the points on a bin boundary to the next bin
    bin_width = (x_max - x_min) / torch.full(
        (), float(cfg.num_bins), dtype=_F32, device=dev)
    binnable = (n_valid >= cfg.num_bins) & (bin_width > 0)
    safe_width = torch.where(bin_width > 0, bin_width,
                             torch.ones((), dtype=_F32, device=dev))
    bin_idx = torch.clamp(torch.floor((xs - x_min) / safe_width),
                          0, cfg.num_bins - 1).to(torch.int32)

    # one packed int32 key: (bin << 25) | 25-bit quantized descending y;
    # the product is clipped in float before the int cast
    q_scale = (torch.full((), float(_SHIFT - 1), dtype=_F32, device=dev)
               / torch.clamp_min(y_max - y_min, 1e-12))
    qy = torch.clamp((y_max - ys) * q_scale, 0.0,
                     float(_SHIFT - 2)).to(torch.int32)
    key = torch.where(v, bin_idx * _SHIFT + qy,
                      torch.full_like(qy, cfg.num_bins * _SHIFT))
    sorted_key, sorted_idx = torch.sort(key, dim=-1, stable=True)
    bins = torch.arange(cfg.num_bins + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(
        sorted_key, (bins * _SHIFT).expand(key.shape[0], -1).contiguous()
    ).to(torch.int32)
    starts, ends = bounds[:, :-1], bounds[:, 1:]
    n_b = ends - starts
    k_b = torch.where(
        n_b > 0,
        torch.clamp_min(
            torch.floor(n_b.to(_F32) * torch.full(
                (), cfg.top_k_percent, dtype=_F32, device=dev)).to(torch.int32),
            1),
        torch.zeros_like(n_b),
    )
    rank = torch.arange(cfg.max_per_bin, dtype=torch.int32, device=dev)
    gather = torch.clamp(starts[:, :, None] + rank, 0, p - 1)
    sel = torch.gather(sorted_idx, 1, gather.reshape(key.shape[0], -1).long())
    e_pts = torch.stack([torch.gather(t, 1, sel) for t in (xs, ys, zs)],
                        dim=-1)
    keep = ((rank < torch.clamp_max(k_b, cfg.max_per_bin)[:, :, None])
            & (rank < n_b[:, :, None]))
    e_w = keep.reshape(key.shape[0], -1).to(_F32) * binnable.to(_F32)
    truncated = (torch.any((k_b > cfg.max_per_bin) & (n_b > 0), dim=-1)
                 & binnable[:, 0])
    n = e_w.shape[-1]
    return (e_pts.reshape(*lead, n, 3), e_w.reshape(*lead, n),
            torch.sum(e_w, dim=-1).to(torch.int32).reshape(lead),
            binnable.reshape(lead), truncated.reshape(lead))


def _sort_by_x(pts, w):
    """Sort edge points by x (stable), padded points last."""
    key = torch.where(w > 0, pts[..., 0],
                      torch.full((), _BIG, dtype=_F32, device=pts.device))
    order = torch.argsort(key, dim=-1, stable=True)
    return (torch.take_along_dim(pts, order[..., None], dim=-2),
            torch.take_along_dim(w, order, dim=-1))


def compute_curvature_profile(mask, depth, intrinsics, depth_scale,
                              cfg: GeometryConfig = GeometryConfig()
                              ) -> CurvatureProfile:
    """Full profile for one frame, or for a batch of frames.

    Args:
        mask: [..., H, W] binary/uint8 mask tensor.
        depth: [..., H, W] raw depth (z16 values) as a float32 tensor, on
            the same device.
        intrinsics: [..., 3, 3] pinhole matrices (float32 tensor, same
            device).
        depth_scale: depth-to-metres factor: float32 tensor of shape
            [...] (or a float).
        cfg: static geometry configuration. A single frame (2-D ``mask``)
            takes the fused path under ``kernel_impl`` "auto"/"pallas"/
            "interpret"; a batch runs the reference ops.

    Every field of the result has the leading dimensions of ``mask``.
    """
    check_supported(cfg)
    dev = depth.device
    lead = depth.shape[:-2]
    fused = resolve_kernel_impl(cfg.kernel_impl) == "fused" and not lead
    intrinsics = torch.as_tensor(intrinsics, dtype=_F32, device=dev)
    depth_scale = torch.as_tensor(depth_scale, dtype=_F32, device=dev)
    fx, fy = intrinsics[..., 0, 0], intrinsics[..., 1, 1]
    cx, cy = intrinsics[..., 0, 2], intrinsics[..., 1, 2]
    depth = depth.to(_F32)

    s = max(1, int(cfg.stride))
    native_cloud_count = None
    if s > 1:
        # exact native-resolution cloud count for the validity gate, then
        # an s x s max-pool of the masked depth (each pooled cell keeps its
        # deepest masked pixel or is invalid)
        native_cloud_count = torch.sum((mask > 0) & (depth > 0),
                                       dim=(-2, -1)).to(torch.int32)
        h, w = depth.shape[-2:]
        masked_depth = torch.where(mask > 0, depth, torch.zeros_like(depth))
        masked_depth = F.max_pool2d(masked_depth.reshape(-1, 1, h, w), s, s)
        masked_depth = masked_depth.reshape(*lead, *masked_depth.shape[-2:])
        mask = (masked_depth > 0).to(torch.uint8)
        depth = masked_depth

    if fused:
        from robotic_discovery_platform_tpu_torch.ops import geometry_kernels

        x, y, z, valid_map, stats = geometry_kernels.deproject_edge_stats(
            mask, depth, fx, fy, cx, cy, depth_scale, stride=s)
        cloud_count = stats[4]
    else:
        def per_pixel(t):  # [...] -> [..., 1, 1] against the maps
            return t[..., None, None]

        x, y, z, valid_map = deproject(
            mask, depth, per_pixel(fx), per_pixel(fy), per_pixel(cx),
            per_pixel(cy), per_pixel(depth_scale), stride=s)
        stats = None
        cloud_count = torch.sum(valid_map, dim=(-2, -1)).to(torch.int32)
    e_pts, e_w, edge_count, binnable, bin_capped = _edge_points(
        x, y, z, valid_map, cfg, stats)
    s_pts, s_w = _sort_by_x(e_pts, e_w)

    impl = "fused" if fused else "xla"
    knots = bspline.clamped_uniform_knots(cfg.num_ctrl, cfg.spline_degree)
    ctrl, _ = bspline.fit_bspline(s_pts, s_w, knots, cfg.spline_degree,
                                  cfg.spline_smoothing, impl=impl)
    u_fine = torch.linspace(0.0, 1.0, cfg.num_samples, dtype=_F32, device=dev)
    kappa, k_valid, r = bspline.curvature_profile(ctrl, knots, u_fine,
                                                  cfg.spline_degree, impl=impl)
    n_kv = torch.sum(k_valid, dim=-1)
    zero = torch.zeros((), dtype=_F32, device=dev)
    mean_k = torch.where(n_kv > 0,
                         torch.sum(kappa, dim=-1) / torch.clamp_min(n_kv, 1),
                         zero)
    max_k = torch.amax(torch.where(k_valid, kappa, zero), dim=-1)

    # validity gates: the native-resolution cloud cutoff (exact count when
    # striding) and the edge cutoff on the pooled selection scaled by s^2
    gate_cloud = (native_cloud_count if native_cloud_count is not None
                  else cloud_count)
    ok = ((gate_cloud >= cfg.min_cloud_points)
          & binnable
          & (edge_count * (s * s) >= cfg.min_edge_points)
          & (n_kv > 0))
    return CurvatureProfile(
        mean_curvature=torch.where(ok, mean_k, zero),
        max_curvature=torch.where(ok, max_k, zero),
        spline_points=torch.where(ok[..., None, None], r, torch.zeros_like(r)),
        valid=ok,
        num_cloud_points=cloud_count,
        num_edge_points=edge_count,
        truncated=bin_capped,
    )
