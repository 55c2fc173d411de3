"""The port's fused geometry functions (ops/geometry_kernels.py) against
the JAX package's Pallas geometry kernels in interpret mode, on the CPU,
where each wrapper runs its plain version; and the curvature profile under
the default ``kernel_impl="auto"`` against JAX's ``"interpret"``.

Tolerances, fixed before measuring:
- deproject_edge_stats: maps, validity and the x/y min/max and count
  bitwise;
- bspline_design: the port's float64 against JAX's float32 on the same
  chord parameters, every Gram and right-hand-side entry within 1e-4 of
  the sum of its terms' magnitudes (|BW|^T|B| and |BW|^T|X|, float64);
- bspline_curvature: validity equal; kappa within rtol 1e-3 plus
  1e-3 * max|kappa|; r within rtol 1e-4 plus 1e-5 * max|r|; on control
  points that are all zero (no tangent at all) validity and kappa equal
  (equal nonzero control points are not compared: their tangent is
  rounding noise, which the two packages round differently around the
  1e-6 guard);
- compute_curvature_profile: as tests/test_torch_port_geometry.py
  (curvature and spline rtol 1e-3, validity and counts exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.ops import bspline as jbspline
from robotic_discovery_platform_tpu.ops import geometry as jgeom
from robotic_discovery_platform_tpu.ops.pallas import geometry as pgeom
from robotic_discovery_platform_tpu.utils.config import (
    GeometryConfig as JaxGeometryConfig,
)
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.ops import bspline as tbspline
from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
from robotic_discovery_platform_tpu_torch.ops import geometry_kernels as gk
from robotic_discovery_platform_tpu_torch.serving.ingest import (
    default_intrinsics,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    resolve_kernel_impl,
)

H, W = 96, 128
PARAMS = np.asarray([100.0, 110.0, 64.0, 48.0, 0.001], np.float32)


def _mask_and_depth(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "scene":
        _, mask, depth = render_scene(rng, H, W)
        return (mask > 0).astype(np.uint8), depth
    if kind == "random":
        mask = (rng.random((H, W)) > 0.4).astype(np.uint8)
    elif kind == "empty":
        mask = np.zeros((H, W), np.uint8)
    else:  # speckle
        mask = np.zeros((H, W), np.uint8)
        mask[::17, ::13] = 1
    depth = (rng.random((H, W)) * 800 + 100).astype(np.uint16)
    depth[::7, ::5] = 0  # z == 0 holes
    return mask, depth


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["scene", "random", "empty", "speckle"])
def test_deproject_edge_stats_matches_jax_interpret(kind, stride):
    mask, depth = _mask_and_depth(kind, 7)
    if stride > 1:  # the pooled view the stride path analyzes
        md = np.where(mask > 0, depth, 0).reshape(
            H // stride, stride, W // stride, stride).max(axis=(1, 3))
        mask, depth = (md > 0).astype(np.uint8), md.astype(np.uint16)

    @jax.jit
    def jax_kernel(m, d, p):
        return pgeom.deproject_edge_stats(m, d, p[0], p[1], p[2], p[3], p[4],
                                          stride=stride, interpret=True)

    want = jax_kernel(jnp.asarray(mask), jnp.asarray(depth),
                      jnp.asarray(PARAMS))
    args = (torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
            *(torch.tensor(v) for v in PARAMS))
    launches = gk.deproject_edge_stats.launches
    got = gk.deproject_edge_stats(*args, stride=stride)
    assert gk.deproject_edge_stats.launches == launches  # plain on the CPU
    for a, b in zip([*got[:4], *got[4]], [*want[:4], *want[4]]):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    plain = gk.deproject_edge_stats_plain(*args, stride=stride)
    for a, b in zip([*got[:4], *got[4]], [*plain[:4], *plain[4]]):
        assert torch.equal(a, b)


def _design_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    wts = (rng.random(n) > 0.3).astype(np.float32)
    u = np.asarray(jbspline.chord_length_params(jnp.asarray(pts),
                                                jnp.asarray(wts)))
    return pts, wts, np.minimum(u, 1.0).astype(np.float32)


@pytest.mark.parametrize("n,c", [(256, 16), (6400, 16), (300, 9)])
def test_bspline_design_matches_jax_interpret(n, c):
    knots = jbspline.clamped_uniform_knots(c, 3)
    pts, wts, u = _design_inputs(n, n + c)
    jgram, jrhs = pgeom.bspline_design(
        jnp.asarray(pts), jnp.asarray(wts), jnp.asarray(u),
        pgeom.static_knots(knots), 3, interpret=True)
    t64 = [torch.from_numpy(a.astype(np.float64)) for a in (pts, wts, u)]
    gram, rhs = gk.bspline_design(*t64, knots, 3)
    assert gram.dtype == rhs.dtype == torch.float64
    assert gram.shape == (c, c) and rhs.shape == (c, 3)
    mag_gram, mag_rhs = gk.bspline_design_plain(
        t64[0].abs(), t64[1].abs(), t64[2], knots, 3)
    for got, want, mag in ((gram, jgram, mag_gram), (rhs, jrhs, mag_rhs)):
        err = np.abs(got.numpy() - np.asarray(want, np.float64))
        assert np.all(err <= 1e-4 * mag.numpy()), err.max()


def test_fit_bspline_fused_path_matches_the_reference():
    """The fused fit (design through bspline_design) and the reference fit
    are the same float64 computation on the CPU."""
    knots = jbspline.clamped_uniform_knots(16, 3)
    pts, wts, _ = _design_inputs(640, 3)
    tp, tw = torch.from_numpy(pts), torch.from_numpy(wts)
    ref = tbspline.fit_bspline(tp, tw, knots, impl="xla")
    fused = tbspline.fit_bspline(tp, tw, knots, impl="fused")
    for a, b in zip(ref, fused):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown fit impl"):
        tbspline.fit_bspline(tp, tw, knots, impl="pallas")


@pytest.mark.parametrize("case", ["random", "scene", "degenerate"])
def test_bspline_curvature_matches_jax_interpret(case):
    c = 16
    knots = jbspline.clamped_uniform_knots(c, 3)
    rng = np.random.default_rng(21)
    if case == "random":
        ctrl = rng.normal(size=(c, 3)).astype(np.float32)
    elif case == "scene":  # a fitted top edge: small coordinates, in metres
        x = np.linspace(-0.1, 0.1, c)
        ctrl = np.stack([x, -0.05 + 0.4 * x ** 2, 0.8 + 0.01 * x],
                        axis=1).astype(np.float32)
    else:
        ctrl = np.zeros((c, 3), np.float32)
    u = np.linspace(0.0, 1.0, 100, dtype=np.float32)
    jk, jv, jr = pgeom.bspline_curvature(
        jnp.asarray(ctrl), jnp.asarray(u), pgeom.static_knots(knots), 3,
        interpret=True)
    tk, tv, tr = gk.bspline_curvature(torch.from_numpy(ctrl),
                                      torch.from_numpy(u), knots, 3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jk, jr = np.asarray(jk), np.asarray(jr)
    if case == "degenerate":
        assert not tv.any()
        np.testing.assert_array_equal(tk.numpy(), jk)
        return
    assert tv.all()
    np.testing.assert_allclose(tk.numpy(), jk, rtol=1e-3,
                               atol=1e-3 * np.abs(jk).max())
    np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-4,
                               atol=1e-5 * np.abs(jr).max())


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("seed", [0, 4, 9])
def test_curvature_profile_auto_matches_jax_interpret(seed, stride):
    h, w = 120, 160
    _, mask, depth = render_scene(np.random.default_rng(seed), h, w)
    mask = (mask > 0).astype(np.uint8)
    k = default_intrinsics(w, h).astype(np.float32)
    want = jgeom.compute_curvature_profile(
        jnp.asarray(mask), jnp.asarray(depth), jnp.asarray(k), 0.001,
        JaxGeometryConfig(kernel_impl="interpret", stride=stride))
    cfg = GeometryConfig(stride=stride)
    assert cfg.kernel_impl == "auto" and resolve_kernel_impl("auto") == "fused"
    got = tgeom.compute_curvature_profile(
        torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
        torch.from_numpy(k), 0.001, cfg)
    assert bool(got.valid)
    for field in ("valid", "num_cloud_points", "num_edge_points",
                  "truncated"):
        assert np.asarray(getattr(want, field)) == getattr(got, field).numpy()
    for field in ("mean_curvature", "max_curvature", "spline_points"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-3, atol=0.0, err_msg=field)
    # the fused path and the reference ops agree on the CPU as well
    ref = tgeom.compute_curvature_profile(
        torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
        torch.from_numpy(k), 0.001, GeometryConfig(stride=stride,
                                                   kernel_impl="xla"))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl,want", [("auto", "fused"), ("pallas", "fused"),
                                       ("interpret", "fused"), ("xla", "xla")])
def test_kernel_impl_resolution(impl, want):
    assert resolve_kernel_impl(impl) == want
    with pytest.raises(ValueError, match="unknown kernel_impl"):
        resolve_kernel_impl("triton")
