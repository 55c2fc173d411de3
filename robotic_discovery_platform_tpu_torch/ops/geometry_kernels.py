"""The geometry kernels of one frame: hand-written CUDA for Hopper, each
with its plain PyTorch version beside it (the counterpart of the JAX
package's ``ops/pallas/geometry.py``).

- :func:`deproject_edge_stats` (``csrc/deproject_edge_stats.cu``): the
  pinhole deprojection maps and the masked x/y min/max and valid count in
  one launch that reads the five scalars in place and folds the blocks'
  partial rows in its last block (a ticket counter per stream); bitwise
  equal to its plain version (the tiling and the fold are mirrored in
  numpy by tests/test_torch_port_geometry_kernels.py).
- :func:`bspline_design` (``csrc/bspline_design.cu``): the basis of the
  edge points' chord parameters contracted straight into the fit's Gram
  matrix and right-hand side, in float64, in one launch; the basis never
  reaches device memory, and each point computes only the ``degree + 1``
  nonzero entries of its row (mirrored in Python, and held against
  ``bspline._basis_columns``, by tests/test_torch_port_geometry_kernels.py).
- :func:`bspline_curvature` (``csrc/bspline_curvature.cu``): r, r', r''
  and the curvature formula at the sample parameters, in one launch; each
  sample computes only its windowed basis and the columns of the banded
  derivative products it can reach (:func:`derivative_bands`).

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
import functools
import threading

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.ops import (
    bspline,
    build,
    geometry,
    graphs,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "deproject_edge_stats_blocks": ("deproject_edge_stats", [_I, _I]),
    # mask, depth, fx, fy, cx, cy, depth_scale, x, y, z, valid, part,
    # stats_f, stats_n, ticket, H, W, stride, stream
    "deproject_edge_stats_launch": (
        "deproject_edge_stats", [_P] * 15 + [_I, _I, _I, _P]),
    # pts, w, u, knots, gram, rhs, N, D, K, degree, stream
    "bspline_design_launch": ("bspline_design", [_P] * 6 + [_I] * 4 + [_P]),
    # ctrl, u, knots, m1 band, m2 band, kappa, valid, r, N, K, degree,
    # ctrl's two strides, stream
    "bspline_curvature_launch": (
        "bspline_curvature", [_P] * 8 + [_I] * 5 + [_P]),
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


#: floats of one block's partial row: x_min, x_max, y_min, y_max, n
_DEPROJECT_PART = 5
_tickets: dict[tuple[int, int], torch.Tensor] = {}  # guarded_by: _tickets_lock
_tickets_lock = threading.Lock()


def _ticket(dev: torch.device) -> torch.Tensor:
    """The zeroed int32 counter that :func:`deproject_edge_stats` takes its
    blocks' tickets from on the current stream of ``dev``: one per (device,
    stream), so concurrent streams never share one, made once on that
    stream. The kernel sets it back to 0 at its end.

    A CUDA graph bakes in the counter of the stream it was captured on:
    each ``ops/graphs.GraphCache`` captures on a stream of its own, so two
    caches' graphs replayed at the same time never share a counter. The
    counter must exist before the capture (the cache's warm-up makes it):
    one made during a capture would live in the graph's memory pool, so
    that raises."""
    key = (dev.index, _stream(dev))
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "deproject_edge_stats: no ticket counter for the "
                    "capturing stream; run the function on that stream "
                    "once before capturing it")
            t = _tickets[key] = torch.zeros((1,), dtype=torch.int32,
                                            device=dev)
    return t


def deproject_edge_stats(mask, depth, fx, fy, cx, cy, depth_scale, *,
                         stride: int = 1):
    """Fused pinhole deprojection + masked edge statistics of one frame.

    Args:
        mask: [H, W] mask (nonzero = set; uint8 is taken as it is).
        depth: [H, W] raw depth, float32 (z16 values are exact).
        fx, fy, cx, cy, depth_scale: float32 scalars: one-element tensors
            on the same device, read in place by the kernel (the 0-d views
            of an intrinsics matrix need no copy), or floats.
        stride: the pooled-view stride, as in ``geometry.deproject``.

    Returns ``(x, y, z, valid, (x_min, x_max, y_min, y_max, n_valid))``:
    float32 maps, a bool map, float32 statistics with the +-1e30 sentinels
    and an int32 count, all bitwise those of the plain version. On the
    card this is one kernel launch and no copy when the five scalars are
    float32 tensors on the card.
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
    params = [torch.as_tensor(v, dtype=torch.float32, device=depth.device)
              for v in (fx, fy, cx, cy, depth_scale)]
    if any(p.numel() != 1 for p in params):
        raise ValueError("deproject_edge_stats: fx, fy, cx, cy and "
                         "depth_scale must be scalars")
    dev = _check_cuda("deproject_edge_stats", mask, depth, *params)
    h, w = depth.shape
    blocks = _fn("deproject_edge_stats_blocks")(h, w)
    if blocks < 0:
        raise ValueError(f"deproject_edge_stats: {h}x{w} is past the "
                         "kernel's 32-bit indexing")
    x, y, z = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    part = torch.empty((blocks, _DEPROJECT_PART), dtype=torch.float32,
                       device=dev)
    stats_f = torch.empty((4,), dtype=torch.float32, device=dev)
    stats_n = torch.empty((1,), dtype=torch.int32, device=dev)
    err = _fn("deproject_edge_stats_launch")(
        mask.data_ptr(), depth.data_ptr(), *(p.data_ptr() for p in params),
        x.data_ptr(), y.data_ptr(), z.data_ptr(), valid.data_ptr(),
        part.data_ptr(), stats_f.data_ptr(), stats_n.data_ptr(),
        _ticket(dev).data_ptr(), h, w, int(stride), _stream(dev))
    build.check("deproject_edge_stats", err)
    graphs.count_launch(deproject_edge_stats)
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
    if np.any(np.diff(np.asarray(knots, np.float64)) < 0):
        raise ValueError("bspline_design: the knots must be non-decreasing")
    kn = bspline._static(knots, u)
    dev = _check_cuda("bspline_design", points, weights, u, kn)
    k = kn.shape[0]
    c = k - degree - 1
    gram = torch.empty((c, c), dtype=torch.float64, device=dev)
    rhs = torch.empty((c, d), dtype=torch.float64, device=dev)
    err = _fn("bspline_design_launch")(
        points.data_ptr(), weights.data_ptr(), u.data_ptr(), kn.data_ptr(),
        gram.data_ptr(), rhs.data_ptr(), n, d, k, degree, _stream(dev))
    build.check("bspline_design", err)
    graphs.count_launch(bspline_design)
    return gram, rhs


bspline_design.launches = 0


# -- fused curvature evaluation -------------------------------------------------


def bspline_curvature_plain(ctrl, u, knots, degree: int = 3):
    """Plain PyTorch version of :func:`bspline_curvature`: the reference
    ``bspline.curvature_profile`` (three design products, then the
    formula)."""
    return bspline.curvature_profile(ctrl, knots, u, degree)


def derivative_bands(knots_key: tuple, degree: int):
    """The bands of the curvature's static derivative matrices, float64:
    ``m1 = bspline._deriv_matrix_product(.., 1)`` [C+1, C] is nonzero only
    at rows c and c + 1 of column c, ``m2`` (order 2) [C+2, C] only at rows
    c .. c + 2 (products of two-banded matrices), so
    ``m1b[c, t] = m1[c + t, c]`` (t < 2) and ``m2b[c, t] = m2[c + t, c]``
    (t < 3) hold every nonzero."""
    bands = []
    for order in (1, 2):
        m = bspline._deriv_matrix_product(knots_key, degree, order)
        c = np.arange(m.shape[1])
        bands.append(np.stack([m[c + t, c] for t in range(order + 1)], 1))
    return tuple(bands)


@functools.lru_cache(maxsize=64)
def _curvature_tables(knots_key: tuple, degree: int, device: torch.device):
    """(knots [K], m1 band [C, 2], m2 band [C, 3]) as float32 tensors on
    ``device``, made once per knot vector, degree and device: the wrapper
    neither rebuilds nor hashes the full derivative matrices per call.
    Callers never write to them."""
    tables = (np.asarray(knots_key, np.float64),
              *derivative_bands(knots_key, degree))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=torch.float32) for a in tables)


def bspline_curvature(ctrl, u, knots, degree: int = 3):
    """Curvature profile of one frame's spline at ``u``:
    ``(kappa [N], valid [N] bool, r [N, 3])``, float32.

    Args:
        ctrl: [C, 3] float32 control points, any strides (the fit's solve
            leaves them column-major: the kernel reads them in place);
            u: [N] float32 parameters.
        knots: the static knot vector (numpy); degree 2 to 5.
    """
    if ctrl.device.type == "cpu":
        return bspline_curvature_plain(ctrl, u, knots, degree)
    key = tuple(np.asarray(knots, np.float64).tolist())
    c = len(key) - degree - 1
    if ctrl.shape != (c, 3) or u.dim() != 1:
        raise ValueError(
            f"bspline_curvature: want ctrl [{c}, 3] and u [N]; got "
            f"{tuple(ctrl.shape)} and {tuple(u.shape)}"
        )
    if ctrl.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("bspline_curvature: ctrl and u must be float32")
    u = u.contiguous()
    dev = _check_cuda("bspline_curvature", u)
    if ctrl.device != dev:
        raise ValueError(f"bspline_curvature: ctrl on {ctrl.device}, u on "
                         f"{dev}")
    kn, m1b, m2b = _curvature_tables(key, degree, dev)
    n = u.shape[0]
    kappa = torch.empty((n,), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    r = torch.empty((n, 3), dtype=torch.float32, device=dev)
    err = _fn("bspline_curvature_launch")(
        ctrl.data_ptr(), u.data_ptr(), kn.data_ptr(), m1b.data_ptr(),
        m2b.data_ptr(), kappa.data_ptr(), valid.data_ptr(), r.data_ptr(), n,
        len(key), degree, *ctrl.stride(), _stream(dev))
    build.check("bspline_curvature", err)
    graphs.count_launch(bspline_curvature)
    return kappa, valid, r


bspline_curvature.launches = 0
