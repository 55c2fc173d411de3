"""Fixed-knot cubic B-spline fitting, in torch.

The port of the JAX package's ``ops/bspline.py``: a clamped knot vector
with uniform interior knots (static, numpy), the Cox-de Boor basis, a
weighted penalized least-squares fit (P-spline) solved as one [C, C]
system, and curvature from the first and second derivative bases. Every
function takes and returns fixed-shape tensors; padded points carry
weight 0. Matrix products run in float32 (on the card the caller keeps
TF32 off).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def clamped_uniform_knots(num_ctrl: int, degree: int = 3) -> np.ndarray:
    """Clamped knot vector on [0, 1] with uniform interior knots; length
    ``num_ctrl + degree + 1``, the first/last ``degree + 1`` pinned."""
    if num_ctrl <= degree:
        raise ValueError(f"num_ctrl ({num_ctrl}) must exceed degree ({degree})")
    interior = np.linspace(0.0, 1.0, num_ctrl - degree + 1)[1:-1]
    return np.concatenate(
        [np.zeros(degree + 1), interior, np.ones(degree + 1)]
    ).astype(np.float64)


def _basis_columns(uu: torch.Tensor, knots: torch.Tensor,
                   degree: int) -> torch.Tensor:
    """Cox-de Boor recursion on a column of parameters ``uu`` [N, 1] with
    ``knots`` already in uu's dtype and device -> [N, num_ctrl]."""
    n_knots = knots.shape[0]
    zero = torch.zeros((), dtype=uu.dtype, device=uu.device)
    one = torch.ones((), dtype=uu.dtype, device=uu.device)
    # degree 0: indicator of the half-open span, closed at the top so u == 1
    # lands in the last nonempty span; zero-width spans never fire
    t_lo = knots[:-1][None, :]
    t_hi = knots[1:][None, :]
    last_span = t_hi >= knots[-1]
    b = torch.where(
        (uu >= t_lo) & ((uu < t_hi) | (last_span & (uu <= t_hi))), one, zero
    )
    b = torch.where((t_hi - t_lo) > 0, b, zero)
    for d in range(1, degree + 1):
        n_b = n_knots - 1 - d
        t_i = knots[:n_b][None, :]
        t_id = knots[d:d + n_b][None, :]
        t_i1 = knots[1:1 + n_b][None, :]
        t_id1 = knots[d + 1:d + 1 + n_b][None, :]
        denom_l = t_id - t_i
        denom_r = t_id1 - t_i1
        left = torch.where(
            denom_l > 0, (uu - t_i) / torch.where(denom_l > 0, denom_l, one),
            zero,
        )
        right = torch.where(
            denom_r > 0, (t_id1 - uu) / torch.where(denom_r > 0, denom_r, one),
            zero,
        )
        b = left * b[:, :n_b] + right * b[:, 1:1 + n_b]
    if b.shape[-1] != n_knots - degree - 1:
        raise ValueError(f"basis has {b.shape[-1]} columns for {n_knots} knots")
    return b


@functools.lru_cache(maxsize=64)
def _constant(values: tuple, shape: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A static table on the device, made once per (values, dtype,
    device): per-frame host-to-device copies of the knots and derivative
    matrices would each wait on the stream. Callers never write to it."""
    return torch.tensor(values, dtype=torch.float64).reshape(shape).to(
        device=device, dtype=dtype)


def _static(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    a = np.asarray(a, np.float64)
    return _constant(tuple(a.ravel().tolist()), a.shape, like.dtype,
                     like.device)


def bspline_basis(u: torch.Tensor, knots, degree: int = 3) -> torch.Tensor:
    """[N] parameters in [0, 1] -> [N, num_ctrl] basis matrix B with
    ``spline(u) = B @ ctrl`` (``knots`` static, numpy)."""
    return _basis_columns(u[:, None], _static(knots, u), degree)


@functools.lru_cache(maxsize=None)
def _deriv_matrix_product(knots_key: tuple, degree: int,
                          order: int) -> np.ndarray:
    """Static product ``M_{p-order+1} @ ... @ M_p`` mapping the
    degree-(p-order) basis to the order-th derivative of the degree-p
    basis (``knots_key`` is the knot vector as a tuple)."""
    knots_np = np.asarray(knots_key)
    n_knots = knots_np.shape[0]

    def deriv_matrix(d: int) -> np.ndarray:
        n_hi = n_knots - 1 - d
        m = np.zeros((n_hi + 1, n_hi))
        for i in range(n_hi):
            dl = knots_np[i + d] - knots_np[i]
            dr = knots_np[i + d + 1] - knots_np[i + 1]
            if dl > 0:
                m[i, i] += d / dl
            if dr > 0:
                m[i + 1, i] -= d / dr
        return m

    low = degree - order
    return functools.reduce(
        np.matmul, [deriv_matrix(d) for d in range(low + 1, degree + 1)]
    )


def bspline_basis_derivative(u: torch.Tensor, knots, degree: int = 3,
                             order: int = 1) -> torch.Tensor:
    """Basis matrix of the ``order``-th derivative of the degree-``degree``
    basis: ``spline^(k)(u) = D @ ctrl``."""
    if order == 0:
        return bspline_basis(u, knots, degree)
    knots_np = np.asarray(knots, np.float64)
    num_ctrl = knots_np.shape[0] - degree - 1
    low = degree - order
    if low < 0:
        return torch.zeros((u.shape[0], num_ctrl), dtype=u.dtype,
                           device=u.device)
    b = bspline_basis(u, knots_np, low)
    m = _deriv_matrix_product(tuple(knots_np.tolist()), degree, order)
    return b @ _static(m, b)


def chord_length_params(points: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Normalized cumulative chord-length parameters [N] for pre-sorted
    [N, D] points; a segment counts only when both its ends have weight,
    padded points inherit the running parameter.

    The parameters are clipped to 1. A parallel prefix sum (the JAX
    package's on the CPU, this one on the card) can round the last valid
    point's running sum above the total; its parameter then lands past
    the last knot span, its basis row is all zeros and the point drops
    out of the fit. Clipped, it always counts, as in exact arithmetic."""
    w = weights.to(points.dtype)
    deltas = torch.linalg.vector_norm(torch.diff(points, dim=0), dim=1)
    seg_w = w[1:] * w[:-1]
    cum = torch.cat([torch.zeros(1, dtype=points.dtype, device=points.device),
                     torch.cumsum(deltas * seg_w, dim=0)])
    total = cum[-1]
    u = torch.clamp_max(cum / torch.clamp_min(total, 1e-12), 1.0)
    return torch.where(total > 1e-12, u, torch.zeros_like(cum))


def second_difference_penalty(num_ctrl: int) -> np.ndarray:
    """P-spline penalty ``P = D2.T @ D2`` on control points (static)."""
    d2 = np.diff(np.eye(num_ctrl), n=2, axis=0)
    return d2.T @ d2


def fit_bspline(points: torch.Tensor, weights: torch.Tensor, knots,
                degree: int = 3, smoothing: float = 1e-3):
    """Weighted penalized least-squares B-spline fit: solves
    ``(B^T W B + lam * P + 1e-8 I) C = B^T W X`` with
    ``lam = smoothing * max(sum(w), 1)``.

    The fit runs in float64 and returns ``points``' dtype. Its sums run
    over thousands of points in an order that differs between backends
    (the card's scan and GEMM against the CPU's), and curvature amplifies
    control-point rounding about a hundredfold; in float64 the card and
    the CPU agree to the last float32 bit, nearly always.

    The [C, C] solve is ``torch.linalg.solve_ex`` (LU, as
    ``torch.linalg.solve``) without its error check, which would wait on
    the device; a singular system gives non-finite control points, as the
    JAX package's ``jnp.linalg.solve`` does.

    Returns (ctrl [num_ctrl, D], u [N]).
    """
    pts = points.to(torch.float64)
    w = weights.to(torch.float64)
    u = chord_length_params(pts, w)
    num_ctrl = np.asarray(knots).shape[0] - degree - 1
    b = bspline_basis(u, knots, degree)
    bw = b * w[:, None]
    gram = bw.T @ b
    rhs = bw.T @ pts
    lam = smoothing * torch.clamp_min(torch.sum(w), 1.0)
    pen = _static(second_difference_penalty(num_ctrl), pts)
    eye = torch.eye(num_ctrl, dtype=pts.dtype, device=pts.device)
    reg = gram + lam * pen + 1e-8 * eye
    ctrl, _ = torch.linalg.solve_ex(reg, rhs)
    return ctrl.to(points.dtype), u.to(points.dtype)


def evaluate_bspline(ctrl: torch.Tensor, knots, u: torch.Tensor,
                     degree: int = 3, order: int = 0) -> torch.Tensor:
    """The spline (or its ``order``-th derivative) at ``u``: [N, D]."""
    return bspline_basis_derivative(u, knots, degree, order) @ ctrl


def _curvature_formula(r1: torch.Tensor, r2: torch.Tensor):
    """kappa = ||r' x r''|| / ||r'||^3 with the degenerate-tangent guard."""
    num = torch.linalg.vector_norm(torch.linalg.cross(r1, r2), dim=-1)
    den = torch.linalg.vector_norm(r1, dim=-1)
    valid = den > 1e-6
    d = torch.clamp_min(den, 1e-6)
    kappa = torch.where(valid, num / (d * d * d), torch.zeros_like(num))
    return kappa, valid


def curvature_profile(ctrl: torch.Tensor, knots, u: torch.Tensor,
                      degree: int = 3):
    """kappa(u) along the fitted curve, plus the sample points.

    Returns (kappa [N], valid [N] bool, r [N, D])."""
    r = evaluate_bspline(ctrl, knots, u, degree, order=0)
    r1 = evaluate_bspline(ctrl, knots, u, degree, order=1)
    r2 = evaluate_bspline(ctrl, knots, u, degree, order=2)
    kappa, valid = _curvature_formula(r1, r2)
    return kappa, valid, r
