"""The port's scan batch analyzer (ops/pipeline.make_scan_batch_analyzer,
``ServerConfig.batch_impl="scan"``) on the CPU: against the JAX package's
``make_scan_batch_analyzer`` and against the port's own single-frame
analyzer, and the servicer's answers with ``batch_impl="scan"`` and with
``egress_pack=False`` against the packed dense and direct ones.

Tolerances, fixed before measuring:
- against JAX (B = 3, base_features 8, float32, JAX's forward in interpret
  mode; the bars of tests/test_torch_port_batched_serving.py for the dense
  batch): masks and coverage equal; validity equal; confidence margin rtol
  1e-5; mean/max curvature and the spline block rtol 1e-3, on frames where
  the reference keeps every edge point in its fit (asserted);
- against the port's single-frame analyzer: every packed row and every
  unpacked leaf equal bit for bit (the same frame path, frame by frame);
- servicers: scan answers (packed or not) equal to the direct path's bit
  for bit; dense answers (packed or not) equal to the direct path's in
  status, mask payload and coverage, curvature and spline rtol 1e-5 (a
  dense batch of more than one frame runs the reference geometry).
"""

import threading

import numpy as np
import pytest
import torch
from test_torch_port_batched_serving import SEEDS, SIZE, H, W, _batch
from test_torch_port_pipeline import (
    _jax_edge_fit_inputs,
    _median_biased_variables,
)

from robotic_discovery_platform_tpu.ops import bspline as jbspline
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.ops.pallas.unet_infer import PallasUNet
from robotic_discovery_platform_tpu.utils.config import (
    GeometryConfig as JaxGeometryConfig,
)
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models.weights import (
    unet_from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import egress, ingest
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    ModelConfig,
    ServerConfig,
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


@pytest.fixture(scope="module")
def setup():
    frames = [render_scene(np.random.default_rng(s), H, W)[::2]
              for s in SEEDS]  # (rgb, depth)
    model, variables = _median_biased_variables(SIZE, frames[0][0])
    net = unet_from_flax_variables(
        ModelConfig(base_features=8, compute_dtype="float32"), variables)
    return frames, model, variables, FoldedUNet(net, device="cpu")


def test_scan_analyzer_matches_jax(setup):
    frames, model, variables, folded = setup
    rgb, depth, k, scales = _batch(frames)
    pnet = PallasUNet(model, variables, interpret=True)
    want = jpipe.make_scan_batch_analyzer(
        model, img_size=SIZE, geom_cfg=JaxGeometryConfig(),
        forward=lambda _v, x: pnet(x))(variables, rgb, depth, k, scales)
    rows = tpipe.make_scan_batch_analyzer(
        folded, img_size=SIZE, device="cpu", pack=True)(rgb, depth, k, scales)
    for i in range(3):
        got = egress.PackedResult(rows[i].numpy())
        wmask = np.asarray(want.mask[i])
        np.testing.assert_array_equal(got.unpack_mask(), wmask)
        coverage, mean_k, max_k, valid, margin = got.scalars()
        assert coverage == float(want.mask_coverage[i])
        assert valid == bool(want.profile.valid[i]) and valid
        np.testing.assert_allclose(margin, float(want.confidence_margin[i]),
                                   rtol=1e-5)
        pts, wts = _jax_edge_fit_inputs(wmask, depth[i], k[i], 1)
        assert float(np.max(np.asarray(
            jbspline.chord_length_params(pts, wts)))) <= 1.0
        np.testing.assert_allclose(
            [mean_k, max_k], [float(want.profile.mean_curvature[i]),
                              float(want.profile.max_curvature[i])],
            rtol=1e-3)
        np.testing.assert_allclose(
            got.spline(), np.asarray(want.profile.spline_points[i]),
            rtol=1e-3)


def test_scan_rows_equal_the_frame_analyzer_rows(setup):
    frames, _, _, folded = setup
    rgb, depth, k, scales = _batch(frames)
    scan = tpipe.make_scan_batch_analyzer(folded, img_size=SIZE,
                                          device="cpu", pack=True)
    scan_leaves = tpipe.make_scan_batch_analyzer(folded, img_size=SIZE,
                                                 device="cpu")
    frame = tpipe.make_frame_analyzer(folded, img_size=SIZE, device="cpu",
                                      pack=True)
    frame_leaves = tpipe.make_frame_analyzer(folded, img_size=SIZE,
                                             device="cpu")
    rows = scan(rgb, depth, k, scales).numpy()
    leaves = scan_leaves(rgb, depth, k, scales)
    assert scan.graphs.guard.name == "pipeline.scan_batch_analyzer"
    assert scan.graphs.guard.stats.budget == 8
    for i in range(3):
        np.testing.assert_array_equal(rows[i],
                                      frame(rgb[i], depth[i], k[i], scales[i]))
        one = frame_leaves(rgb[i], depth[i], k[i], scales[i])
        assert torch.equal(leaves.mask[i], one.mask)
        assert torch.equal(leaves.mask_coverage[i], one.mask_coverage)
        assert torch.equal(leaves.confidence_margin[i], one.confidence_margin)
        for got, want in zip(leaves.profile, one.profile):
            assert torch.equal(got[i], want)


def test_scan_and_unpacked_servicers_answer_as_the_packed_dense_one(
        setup, tmp_path):
    frames, _, _, folded = setup
    requests = [ingest.raw_request(rgb, d, mask_format=i % 3)
                for i, (rgb, d) in enumerate(frames * 2)]
    base = dict(model_img_size=SIZE, calibration_path=str(tmp_path / "n.npz"))

    def serve(name, streams=1, **kw):
        service = VisionAnalysisService(
            folded, cfg=ServerConfig(metrics_csv=str(tmp_path / f"{name}.csv"),
                                     **base, **kw), device="cpu")
        got: dict = {}

        def stream(sid):
            got[sid] = list(service.analyze_stream(iter(requests)))

        threads = [threading.Thread(target=stream, args=(s,))
                   for s in range(streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        sizes = (dict(service.dispatcher.dispatch_sizes)
                 if service.dispatcher is not None else {})
        service.close()
        assert sum(n * c for n, c in sizes.items()) == (
            streams * len(requests) if sizes else 0)
        return [got[s] for s in range(streams)], sizes

    (want,), _ = serve("direct")
    assert {"OK"} <= {r.status for r in want}
    batched = dict(batch_window_ms=20.0, max_batch=4)
    for name, kw in (("dense", {}), ("dense_unpacked", {"egress_pack": False}),
                     ("scan", {"batch_impl": "scan"}),
                     ("scan_unpacked", {"batch_impl": "scan",
                                        "egress_pack": False})):
        outs, sizes = serve(name, streams=3, **batched, **kw)
        assert max(sizes) > 1, name  # streams met in a dispatch
        for out in outs:
            for i, (g, w) in enumerate(zip(out, want)):
                assert (g.status, g.mask, g.mask_coverage) == (
                    w.status, w.mask, w.mask_coverage), (name, i)
                if name.startswith("scan"):
                    assert (g.mean_curvature, g.max_curvature,
                            g.packed_spline, g.spline_points) == (
                                w.mean_curvature, w.max_curvature,
                                w.packed_spline, w.spline_points), (name, i)
                    continue
                np.testing.assert_allclose(
                    [g.mean_curvature, g.max_curvature],
                    [w.mean_curvature, w.max_curvature], rtol=1e-5, atol=0)
                if requests[i].mask_format:
                    np.testing.assert_allclose(
                        egress.decode_spline_wire(g.packed_spline),
                        egress.decode_spline_wire(w.packed_spline), rtol=1e-5)
                else:
                    np.testing.assert_allclose(
                        [[p.x, p.y, p.z] for p in g.spline_points],
                        [[p.x, p.y, p.z] for p in w.spline_points], rtol=1e-5)
