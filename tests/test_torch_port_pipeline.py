"""The port's single-frame analyzer (ops/pipeline.py) against the JAX
package's, on the CPU.

Tolerances, fixed before measuring:
- resize matrices: equal (the same numpy code);
- preprocess: atol 1e-5 on [0, 1] pixels (float32 sums in another order);
- native masks: equal, index for index (``mode="nearest-exact"``);
- confidence margin and coverage: rtol 1e-5;
- the analyzer end to end against the JAX analyzer on PallasUNet in
  interpret mode: masks equal, curvature as tests/test_torch_port_geometry
  (rtol 1e-3), validity and counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.ops import bspline as jbspline
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.ops.pallas.unet_infer import PallasUNet
from robotic_discovery_platform_tpu.utils.config import (
    GeometryConfig as JaxGeometryConfig,
)
from robotic_discovery_platform_tpu.utils.config import ModelConfig as JaxModelConfig
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models.weights import (
    unet_from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.ops import bspline as tbspline
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving.ingest import (
    default_intrinsics,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ModelConfig,
)


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


@pytest.mark.parametrize("n_in,n_out", [(480, 256), (640, 256), (120, 64),
                                        (100, 256), (64, 64)])
def test_resize_matrix_and_preprocess_match_jax(n_in, n_out):
    np.testing.assert_array_equal(tpipe._resize_matrix(n_in, n_out),
                                  jpipe._resize_matrix(n_in, n_out))
    rng = np.random.default_rng(n_in + n_out)
    frame = rng.integers(0, 256, (1, n_in, n_in // 2 + 7, 3), dtype=np.uint8)
    want = np.asarray(jpipe.preprocess(jnp.asarray(frame), n_out))
    got = tpipe.preprocess(torch.from_numpy(frame), n_out).numpy()
    assert got.shape == want.shape == (1, n_out, n_out, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,h,w", [(256, 480, 640), (256, 120, 160),
                                   (64, 100, 100), (64, 128, 96)])
def test_native_masks_and_margin_match_jax(s, h, w):
    rng = np.random.default_rng(s + h + w)
    logits = rng.normal(0.0, 2.0, (1, s, s, 1)).astype(np.float32)
    want = np.asarray(jpipe.logits_to_native_masks(jnp.asarray(logits), h, w))
    got = tpipe.logits_to_native_masks(torch.from_numpy(logits), h, w).numpy()
    assert got.dtype == np.uint8 and got.shape == (1, h, w)
    np.testing.assert_array_equal(got, want)
    want_m = np.mean(np.abs(1 / (1 + np.exp(-logits[..., 0])) - 0.5),
                     axis=(1, 2))
    got_m = tpipe.confidence_margin(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5)


def _median_biased_variables(size: int, frame: np.ndarray):
    """JAX variables (numpy) for base_features 8 in float32 (the test-size
    model; the bfloat16 forward is held to its own bar in
    tests/test_torch_port_model.py), BatchNorm statistics from
    a numpy seed, and the head bias set so half of ``frame``'s logits are
    positive: a structured mask, not an all-or-nothing one."""
    cfg = JaxModelConfig(base_features=8, compute_dtype="float32")
    model = build_unet(cfg)
    variables = jax.tree.map(np.asarray,
                             init_unet(model, jax.random.key(0), size))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.05, 0.2, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    x = jpipe.preprocess(jnp.asarray(frame)[None], size)
    median = float(np.median(np.asarray(model.apply(variables, x))))
    variables["params"]["Conv_0"]["bias"] = (
        variables["params"]["Conv_0"]["bias"] - median).astype(np.float32)
    return model, variables


def _jax_edge_fit_inputs(mask, depth, k, stride):
    """The JAX package's sorted edge points and weights for one frame, as
    its compute_curvature_profile builds them (kernel_impl="xla")."""
    from robotic_discovery_platform_tpu.ops import geometry as jgeom

    if stride > 1:
        h, w = mask.shape
        md = np.where(mask > 0, depth, 0).reshape(
            h // stride, stride, w // stride, stride).max(axis=(1, 3))
        mask, depth = (md > 0).astype(np.uint8), md.astype(np.uint16)
    maps = jgeom.deproject(jnp.asarray(mask), jnp.asarray(depth), k[0, 0],
                           k[1, 1], k[0, 2], k[1, 2], jnp.float32(0.001),
                           stride=stride)
    e = jgeom._edge_points(*maps, JaxGeometryConfig(kernel_impl="xla"))
    return jgeom._sort_by_x(e[0], e[1])


@pytest.mark.parametrize("seed,stride", [(3, 1), (3, 2), (6, 2)])
def test_frame_analyzer_matches_jax(seed, stride):
    """The analyzer end to end, against the JAX analyzer on PallasUNet in
    interpret mode. The frames are ones on which the reference keeps every
    edge point in its spline fit (asserted below); on some frames it drops
    the last one (test_chord_parameters_clip_at_one), and there the two
    packages fit different point sets by design."""
    size, h, w = 64, 120, 160
    rgb, _, depth = render_scene(np.random.default_rng(seed), h, w)
    model, variables = _median_biased_variables(size, rgb)
    k = default_intrinsics(w, h).astype(np.float32)

    pnet = PallasUNet(model, variables, interpret=True)
    janalyze = jpipe.make_frame_analyzer(
        model, img_size=size,
        geom_cfg=JaxGeometryConfig(kernel_impl="xla", stride=stride),
        forward=lambda _v, x: pnet(x))
    want = janalyze(variables, rgb, depth, k, np.float32(0.001))
    pts, wts = _jax_edge_fit_inputs(np.asarray(want.mask), depth, k, stride)
    assert float(np.max(np.asarray(jbspline.chord_length_params(pts, wts)))) <= 1.0

    net = unet_from_flax_variables(
        ModelConfig(base_features=8, compute_dtype="float32"), variables)
    tanalyze = tpipe.make_frame_analyzer(
        FoldedUNet(net, device="cpu"), img_size=size,
        geom_cfg=GeometryConfig(stride=stride), device="cpu")
    got = tanalyze(rgb, depth, k, 0.001)

    mask = got.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    assert 5.0 < 100 * mask.mean() < 95.0  # a structured mask
    np.testing.assert_allclose(float(got.mask_coverage),
                               float(want.mask_coverage), rtol=1e-5)
    np.testing.assert_allclose(float(got.confidence_margin),
                               float(want.confidence_margin), rtol=1e-5)
    for field in ("valid", "num_cloud_points", "num_edge_points",
                  "truncated"):
        assert (getattr(got.profile, field).numpy()
                == np.asarray(getattr(want.profile, field))), field
    for field in ("mean_curvature", "max_curvature", "spline_points"):
        np.testing.assert_allclose(getattr(got.profile, field).numpy(),
                                   np.asarray(getattr(want.profile, field)),
                                   rtol=1e-3, atol=0.0, err_msg=field)


def test_chord_parameters_clip_at_one():
    """A fault of the reference, kept visible: on this frame the JAX
    package's parallel prefix sum rounds the last valid edge point's
    chord parameter above 1, its basis row is all zeros and the point
    drops out of the fit. The port clips the parameters to 1, so every
    weighted point counts: its control points equal a float64 fit of all
    of them."""
    size, h, w = 64, 120, 160
    rgb, _, depth = render_scene(np.random.default_rng(6), h, w)
    model, variables = _median_biased_variables(size, rgb)
    x = jpipe.preprocess(jnp.asarray(rgb)[None], size)
    mask = np.asarray(jpipe.logits_to_native_masks(
        model.apply(variables, x), h, w))[0]
    k = default_intrinsics(w, h).astype(np.float32)
    pts, wts = _jax_edge_fit_inputs(mask, depth, k, 1)
    knots = jbspline.clamped_uniform_knots(16, 3)

    ju = np.asarray(jbspline.chord_length_params(pts, wts))
    last = int(np.flatnonzero(np.asarray(wts) > 0)[-1])
    assert ju[last] > 1.0  # the reference's rounding
    assert not np.asarray(jbspline.bspline_basis(
        jnp.asarray(ju), knots))[last].any()  # so its point has no weight

    tpts = torch.from_numpy(np.array(pts))
    twts = torch.from_numpy(np.array(wts))
    tu = tbspline.chord_length_params(tpts, twts).numpy()
    assert tu.max() == 1.0 and tu[last] == 1.0
    ctrl, _ = tbspline.fit_bspline(tpts, twts, knots)

    p64, w64 = np.asarray(pts, np.float64), np.asarray(wts, np.float64)
    seg = np.linalg.norm(np.diff(p64, axis=0), axis=1) * w64[1:] * w64[:-1]
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    u64 = cum / cum[-1]
    b = tbspline.bspline_basis(torch.from_numpy(u64), knots).numpy()
    bw = b * w64[:, None]
    reg = (bw.T @ b + 1e-3 * w64.sum() * jbspline.second_difference_penalty(16)
           + 1e-8 * np.eye(16))
    want = np.linalg.solve(reg, bw.T @ p64)
    np.testing.assert_allclose(ctrl.numpy(), want, rtol=1e-4)
