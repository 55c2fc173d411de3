"""The geometry kernels of one frame: hand-written CUDA for Hopper, each
with its plain PyTorch version beside it (the counterpart of the JAX
package's ``ops/pallas/geometry.py``).

- :func:`deproject_edge_stats` (``csrc/deproject_edge_stats.cu``): the
  pinhole deprojection maps and the masked x/y min/max and valid count in
  one pass; bitwise equal to its plain version.
- :func:`bspline_design` (``csrc/bspline_design.cu``): the basis of the
  edge points' chord parameters contracted straight into the fit's Gram
  matrix and right-hand side, in float64; the basis never reaches device
  memory.
- :func:`bspline_curvature` (``csrc/bspline_curvature.cu``): r, r', r''
  and the curvature formula at the sample parameters, in one launch.

``ops/geometry.compute_curvature_profile`` reaches them under
``GeometryConfig.kernel_impl`` "auto" (the default), "pallas" and
"interpret". The bound of each kernel on an H100 and what its design does
about it are stated at the top of its source.

Dispatch, as in ``ops/conv.py``: a wrapper takes its plain version only
for a tensor that lies on the CPU. For a CUDA tensor it launches its
kernel on the current stream or raises; nothing falls back. Each wrapper
counts its launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.ops import build, bspline, geometry

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "deproject_edge_stats_blocks": ("deproject_edge_stats", [_I, _I]),
    # mask, depth, params, x, y, z, valid, part_f, part_n, stats_f,
    # stats_n, H, W, stride, stream
    "deproject_edge_stats_launch": (
        "deproject_edge_stats", [_P] * 11 + [_I, _I, _I, _P]),
    "bspline_design_blocks": ("bspline_design", [_I]),
    # pts, w, u, knots, gram, rhs, part, N, D, K, degree, stream
    "bspline_design_launch": ("bspline_design", [_P] * 7 + [_I] * 4 + [_P]),
    # ctrl, u, knots, m1, m2, kappa, valid, r, N, K, degree, stream
    "bspline_curvature_launch": (
        "bspline_curvature", [_P] * 8 + [_I] * 3 + [_P]),
}


def _fn(symbol: str):
    name, argtypes = _SIGNATURES[symbol]
    return build.function(name, symbol, argtypes)


def _check_cuda(name: str, *tensors) -> torch.device:
    """Every tensor on the current CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensors are on {dev} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# -- deproject + masked edge statistics ---------------------------------------


def deproject_edge_stats_plain(mask, depth, fx, fy, cx, cy, depth_scale, *,
                               stride: int = 1):
    """Plain PyTorch version of :func:`deproject_edge_stats`: the reference
    ``geometry.deproject`` and ``geometry.masked_stats``."""
    x, y, z, valid = geometry.deproject(mask, depth, fx, fy, cx, cy,
                                        depth_scale, stride)
    return x, y, z, valid, geometry.masked_stats(x, y, valid)


def deproject_edge_stats(mask, depth, fx, fy, cx, cy, depth_scale, *,
                         stride: int = 1):
    """Fused pinhole deprojection + masked edge statistics of one frame.

    Args:
        mask: [H, W] mask (nonzero = set; uint8 is taken as it is).
        depth: [H, W] raw depth, float32 (z16 values are exact).
        fx, fy, cx, cy, depth_scale: float32 scalars (0-d tensors on the
            same device, or floats).
        stride: the pooled-view stride, as in ``geometry.deproject``.

    Returns ``(x, y, z, valid, (x_min, x_max, y_min, y_max, n_valid))``:
    float32 maps, a bool map, float32 statistics with the +-1e30 sentinels
    and an int32 count, all bitwise those of the plain version.
    """
    if depth.device.type == "cpu":
        return deproject_edge_stats_plain(mask, depth, fx, fy, cx, cy,
                                          depth_scale, stride=stride)
    if depth.dim() != 2 or mask.shape != depth.shape:
        raise ValueError(
            f"deproject_edge_stats: want mask and depth [H, W]; got "
            f"{tuple(mask.shape)} and {tuple(depth.shape)}"
        )
    if mask.dtype != torch.uint8:
        mask = (mask > 0).to(torch.uint8)
    depth = depth.to(torch.float32).contiguous()
    mask = mask.contiguous()
    dev = _check_cuda("deproject_edge_stats", mask, depth)
    params = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                          for v in (fx, fy, cx, cy, depth_scale)])
    h, w = depth.shape
    blocks = _fn("deproject_edge_stats_blocks")(h, w)
    x, y, z = (torch.empty((h, w), dtype=torch.float32, device=dev)
               for _ in range(3))
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    part_f = torch.empty((blocks, 4), dtype=torch.float32, device=dev)
    part_n = torch.empty((blocks,), dtype=torch.int32, device=dev)
    stats_f = torch.empty((4,), dtype=torch.float32, device=dev)
    stats_n = torch.empty((1,), dtype=torch.int32, device=dev)
    err = _fn("deproject_edge_stats_launch")(
        mask.data_ptr(), depth.data_ptr(), params.data_ptr(), x.data_ptr(),
        y.data_ptr(), z.data_ptr(), valid.data_ptr(), part_f.data_ptr(),
        part_n.data_ptr(), stats_f.data_ptr(), stats_n.data_ptr(), h, w,
        int(stride), _stream(dev))
    build.check("deproject_edge_stats", err)
    deproject_edge_stats.launches += 1
    return x, y, z, valid, (stats_f[0], stats_f[1], stats_f[2], stats_f[3],
                            stats_n[0])


deproject_edge_stats.launches = 0


# -- fused B-spline design contractions ---------------------------------------


def bspline_design_plain(points, weights, u, knots, degree: int = 3):
    """Plain PyTorch version of :func:`bspline_design`: the basis matrix,
    then two matrix products (``bspline._design``)."""
    return bspline._design(points, weights, u, knots, degree)


def bspline_design(points, weights, u, knots, degree: int = 3):
    """``(B^T W B [C, C], B^T W X [C, D])`` of one frame's fit, float64.

    Args:
        points: [N, D] float64 points; weights: [N] float64; u: [N]
            float64 chord parameters (``bspline.chord_length_params``).
        knots: the static knot vector (numpy), C + degree + 1 long.
    """
    if points.device.type == "cpu":
        return bspline_design_plain(points, weights, u, knots, degree)
    n, d = points.shape
    if weights.shape != (n,) or u.shape != (n,):
        raise ValueError(
            f"bspline_design: points {tuple(points.shape)}, weights "
            f"{tuple(weights.shape)}, u {tuple(u.shape)} disagree"
        )
    for label, t in (("points", points), ("weights", weights), ("u", u)):
        if t.dtype != torch.float64:
            raise TypeError(f"bspline_design: {label} must be float64")
    kn = bspline._static(knots, u)
    dev = _check_cuda("bspline_design", points, weights, u, kn)
    k = kn.shape[0]
    c = k - degree - 1
    blocks = _fn("bspline_design_blocks")(n)
    gram = torch.empty((c, c), dtype=torch.float64, device=dev)
    rhs = torch.empty((c, d), dtype=torch.float64, device=dev)
    part = torch.empty((blocks, c * c + c * d), dtype=torch.float64,
                       device=dev)
    err = _fn("bspline_design_launch")(
        points.data_ptr(), weights.data_ptr(), u.data_ptr(), kn.data_ptr(),
        gram.data_ptr(), rhs.data_ptr(), part.data_ptr(), n, d, k, degree,
        _stream(dev))
    build.check("bspline_design", err)
    bspline_design.launches += 1
    return gram, rhs


bspline_design.launches = 0


# -- fused curvature evaluation -------------------------------------------------


def bspline_curvature_plain(ctrl, u, knots, degree: int = 3):
    """Plain PyTorch version of :func:`bspline_curvature`: the reference
    ``bspline.curvature_profile`` (three design products, then the
    formula)."""
    return bspline.curvature_profile(ctrl, knots, u, degree)


def bspline_curvature(ctrl, u, knots, degree: int = 3):
    """Curvature profile of one frame's spline at ``u``:
    ``(kappa [N], valid [N] bool, r [N, 3])``, float32.

    Args:
        ctrl: [C, 3] float32 control points; u: [N] float32 parameters.
        knots: the static knot vector (numpy); degree 2 to 5.
    """
    if ctrl.device.type == "cpu":
        return bspline_curvature_plain(ctrl, u, knots, degree)
    knots_np = np.asarray(knots, np.float64)
    c = knots_np.shape[0] - degree - 1
    if ctrl.shape != (c, 3) or u.dim() != 1:
        raise ValueError(
            f"bspline_curvature: want ctrl [{c}, 3] and u [N]; got "
            f"{tuple(ctrl.shape)} and {tuple(u.shape)}"
        )
    if ctrl.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("bspline_curvature: ctrl and u must be float32")
    ctrl, u = ctrl.contiguous(), u.contiguous()
    key = tuple(knots_np.tolist())
    kn = bspline._static(knots_np, u)
    m1 = bspline._static(bspline._deriv_matrix_product(key, degree, 1), u)
    m2 = bspline._static(bspline._deriv_matrix_product(key, degree, 2), u)
    dev = _check_cuda("bspline_curvature", ctrl, u, kn, m1, m2)
    n = u.shape[0]
    kappa = torch.empty((n,), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    r = torch.empty((n, 3), dtype=torch.float32, device=dev)
    err = _fn("bspline_curvature_launch")(
        ctrl.data_ptr(), u.data_ptr(), kn.data_ptr(), m1.data_ptr(),
        m2.data_ptr(), kappa.data_ptr(), valid.data_ptr(), r.data_ptr(), n,
        knots_np.shape[0], degree, _stream(dev))
    build.check("bspline_curvature", err)
    bspline_curvature.launches += 1
    return kappa, valid, r


bspline_curvature.launches = 0
