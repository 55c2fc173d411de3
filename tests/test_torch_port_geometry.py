"""The port's geometry (ops/geometry.py, ops/bspline.py) against the JAX
package's ``compute_curvature_profile(kernel_impl="xla")`` on the CPU, on
the same mask and depth.

Tolerances, fixed before measuring:
- deprojection maps, x/y min/max and the valid count: bitwise;
- selected edge-point keys: equal as multisets (JAX's ``lax.sort`` does
  not promise stable ties);
- control points: rtol 1e-4; kappa, mean and max curvature: rtol 1e-3;
- validity flags and counts: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.ops import bspline as jbspline
from robotic_discovery_platform_tpu.ops import geometry as jgeom
from robotic_discovery_platform_tpu.utils.config import (
    GeometryConfig as JaxGeometryConfig,
)
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.ops import bspline as tbspline
from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
from robotic_discovery_platform_tpu_torch.serving.ingest import (
    default_intrinsics,
)
from robotic_discovery_platform_tpu_torch.utils.config import GeometryConfig

H, W = 120, 160
SCALE = 0.001


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs in
    several worker processes at once, and torch's pool of one thread per
    core, oversubscribed, waits on itself at every small op
    (tests/test_torch_port_quant.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(case: str):
    """(mask u8, depth u16) for one case: rendered scenes, plus the
    graceful-zero frames the reference rejects."""
    rng = np.random.default_rng(sum(map(ord, case)))
    _, mask, depth = render_scene(rng, H, W)
    mask = (mask > 0).astype(np.uint8)
    if case == "empty_mask":
        mask[:] = 0
    elif case == "few_cloud_points":  # < min_cloud_points = 100
        keep = np.zeros_like(mask)
        ys, xs = np.nonzero(mask)
        keep[ys[:60], xs[:60]] = 1
        mask = keep
    elif case == "zero_x_range":  # every valid point in one column
        col = np.zeros_like(mask)
        col[:, W // 2] = 1
        mask = col
    elif case == "no_depth":  # a mask but no valid depth under it
        depth = np.where(mask > 0, 0, depth).astype(np.uint16)
    return mask, depth


CASES = ["scene_a", "scene_b", "empty_mask", "few_cloud_points",
         "zero_x_range", "no_depth"]


def _profiles(case: str, stride: int):
    mask, depth = _scene(case)
    k = default_intrinsics(W, H).astype(np.float32)
    want = jgeom.compute_curvature_profile(
        jnp.asarray(mask), jnp.asarray(depth), jnp.asarray(k), SCALE,
        JaxGeometryConfig(kernel_impl="xla", stride=stride))
    got = tgeom.compute_curvature_profile(
        torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
        torch.from_numpy(k), SCALE, GeometryConfig(stride=stride))
    return want, got


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_curvature_profile_matches_jax(case, stride):
    want, got = _profiles(case, stride)
    for field in ("valid", "num_cloud_points", "num_edge_points",
                  "truncated"):
        assert np.asarray(getattr(want, field)) == getattr(got, field).numpy()
    for field in ("mean_curvature", "max_curvature", "spline_points"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-3, atol=0.0, err_msg=field)
    valid = bool(got.valid)
    assert valid == case.startswith("scene"), case
    if not valid:  # graceful zero: every curvature field zeroed
        assert float(got.mean_curvature) == float(got.max_curvature) == 0.0
        assert not got.spline_points.any()


@pytest.mark.parametrize("stride", [1, 2])
def test_edge_stages_match_jax(stride):
    """Deprojection bitwise, edge-point keys as multisets, control points
    and kappa on the same points."""
    mask, depth = _scene("scene_a")
    if stride > 1:  # the pooled view the stride path analyzes
        md = np.where(mask > 0, depth, 0).reshape(
            H // stride, stride, W // stride, stride).max(axis=(1, 3))
        mask, depth = (md > 0).astype(np.uint8), md.astype(np.uint16)
    k = default_intrinsics(W, H).astype(np.float32)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    jmaps = jgeom.deproject(jnp.asarray(mask), jnp.asarray(depth), fx, fy,
                            cx, cy, jnp.float32(SCALE), stride=stride)
    tmaps = tgeom.deproject(
        torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
        *(torch.tensor(v) for v in (fx, fy, cx, cy, np.float32(SCALE))),
        stride=stride)
    for a, b in zip(jmaps, tmaps):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    valid = tmaps[3].numpy()
    x, y = np.asarray(jmaps[0]), np.asarray(jmaps[1])
    np.testing.assert_array_equal(
        [tmaps[0].numpy()[valid].min(), tmaps[0].numpy()[valid].max(),
         tmaps[1].numpy()[valid].min(), tmaps[1].numpy()[valid].max(),
         valid.sum()],
        [x[valid].min(), x[valid].max(), y[valid].min(), y[valid].max(),
         np.asarray(jmaps[3]).sum()])

    jcfg, tcfg = JaxGeometryConfig(kernel_impl="xla"), GeometryConfig()
    je = jgeom._edge_points(*jmaps, jcfg)
    te = tgeom._edge_points(*tmaps, tcfg)

    def keys(pts, w):
        sel = np.asarray(w) > 0
        return sorted(map(tuple, np.asarray(pts)[sel].tolist()))

    assert keys(te[0].numpy(), te[1].numpy()) == keys(je[0], je[1])
    for a, b in zip(je[2:], te[2:]):
        assert np.asarray(a) == b.numpy()

    js_pts, js_w = jgeom._sort_by_x(je[0], je[1])
    ts_pts, ts_w = tgeom._sort_by_x(te[0], te[1])
    knots = jbspline.clamped_uniform_knots(tcfg.num_ctrl, tcfg.spline_degree)
    jc, _ = jbspline.fit_bspline(js_pts, js_w, knots)
    tc, _ = tbspline.fit_bspline(ts_pts, ts_w, knots)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4)
    u = np.linspace(0.0, 1.0, tcfg.num_samples, dtype=np.float32)
    jk, jv, jr = jbspline.curvature_profile(jc, knots, jnp.asarray(u))
    tk, tv, tr = tbspline.curvature_profile(
        torch.from_numpy(np.array(jc)), knots, torch.from_numpy(u))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_bspline_basis_matches_jax(order):
    knots = jbspline.clamped_uniform_knots(16, 3)
    u = np.linspace(0.0, 1.0, 57, dtype=np.float32)
    want = np.asarray(jbspline.bspline_basis_derivative(
        jnp.asarray(u), knots, 3, order))
    got = tbspline.bspline_basis_derivative(torch.from_numpy(u), knots, 3,
                                            order).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if order == 0:  # partition of unity
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)
