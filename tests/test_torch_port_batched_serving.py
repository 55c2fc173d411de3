"""The port's batched path on the CPU: the batched analyzer
(ops/pipeline.make_batch_analyzer) against the JAX package's
``make_batch_analyzer(pack=True)`` and against the port's own
single-frame analyzer frame by frame, and the servicer with
``batch_window_ms > 0`` under concurrent streams against the direct path.

Tolerances, fixed before measuring:
- against JAX (B = 3, base_features 8, float32, JAX's forward in
  interpret mode): masks and the packed mask bits equal; coverage equal;
  validity equal; confidence margin rtol 1e-5; mean/max curvature and the
  spline block rtol 1e-3 (tests/test_torch_port_geometry.py), on frames
  where the reference keeps every edge point in its fit (asserted);
- against the port's single-frame analyzer: masks, coverage, validity and
  counts equal; confidence margin rtol 1e-6; curvature and spline points
  rtol 1e-5 (a batch runs the reference geometry in batched products);
- servicer, batched against direct: statuses, mask payloads (every wire
  format) and coverage equal; curvature and spline rtol 1e-5.
"""

import threading

import numpy as np
import pytest
import torch
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
from robotic_discovery_platform_tpu_torch.ops import pack as tpack
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import egress, ingest
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    ModelConfig,
    ServerConfig,
)

SIZE, H, W = 64, 120, 160
SEEDS = (3, 4, 5)


@pytest.fixture(scope="module")
def setup():
    frames = [render_scene(np.random.default_rng(s), H, W)[::2]
              for s in SEEDS]  # (rgb, depth)
    model, variables = _median_biased_variables(SIZE, frames[0][0])
    net = unet_from_flax_variables(
        ModelConfig(base_features=8, compute_dtype="float32"), variables)
    return frames, model, variables, FoldedUNet(net, device="cpu")


def _batch(frames):
    k = ingest.default_intrinsics(W, H).astype(np.float32)
    return (np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
            np.repeat(k[None], len(frames), 0),
            np.full(len(frames), 0.001, np.float32))


def test_batched_analyzer_matches_jax_packed_rows(setup):
    frames, model, variables, folded = setup
    rgb, depth, k, scales = _batch(frames)
    pnet = PallasUNet(model, variables, interpret=True)
    janalyze = jpipe.make_batch_analyzer(
        model, img_size=SIZE, geom_cfg=JaxGeometryConfig(),
        forward=lambda _v, x: pnet(x), pack=True)
    want = np.asarray(janalyze(variables, rgb, depth, k, scales))
    tanalyze = tpipe.make_batch_analyzer(folded, img_size=SIZE, device="cpu",
                                         pack=True)
    got = tanalyze(rgb, depth, k, scales).numpy()
    assert got.shape == want.shape == (
        3, tpack.frame_payload_bytes(H, W, GeometryConfig().num_samples))
    for i in range(3):
        g, w = egress.PackedResult(got[i]), egress.PackedResult(want[i])
        np.testing.assert_array_equal(g.mask_bits, w.mask_bits)
        np.testing.assert_array_equal(got[i][:tpack.HEADER_BYTES],
                                      want[i][:tpack.HEADER_BYTES])
        gc, gmean, gmax, gvalid, gmargin = g.scalars()
        wc, wmean, wmax, wvalid, wmargin = w.scalars()
        assert (gc, gvalid) == (wc, wvalid) and gvalid
        np.testing.assert_allclose(gmargin, wmargin, rtol=1e-5)
        pts, wts = _jax_edge_fit_inputs(g.unpack_mask(), depth[i], k[i], 1)
        assert float(np.max(np.asarray(
            jbspline.chord_length_params(pts, wts)))) <= 1.0
        np.testing.assert_allclose([gmean, gmax], [wmean, wmax], rtol=1e-3)
        np.testing.assert_allclose(g.spline(), w.spline(), rtol=1e-3)
        assert 5.0 < gc < 95.0  # structured masks


def test_batched_analyzer_matches_the_single_frame_analyzer(setup):
    frames, _, _, folded = setup
    rgb, depth, k, scales = _batch(frames)
    batched = tpipe.make_batch_analyzer(folded, img_size=SIZE, device="cpu")
    out = batched(rgb, depth, k, scales)
    single = tpipe.make_frame_analyzer(folded, img_size=SIZE, device="cpu")
    rows = tpipe.make_batch_analyzer(folded, img_size=SIZE, device="cpu",
                                     pack=True)(rgb, depth, k, scales)
    for i in range(3):
        one = single(rgb[i], depth[i], k[i], scales[i])
        assert torch.equal(out.mask[i], one.mask)
        assert out.mask_coverage[i] == one.mask_coverage
        torch.testing.assert_close(out.confidence_margin[i],
                                   one.confidence_margin, rtol=1e-6, atol=0)
        for field in ("valid", "num_cloud_points", "num_edge_points",
                      "truncated"):
            assert getattr(out.profile, field)[i] == getattr(one.profile,
                                                             field), field
        for field in ("mean_curvature", "max_curvature", "spline_points"):
            torch.testing.assert_close(getattr(out.profile, field)[i],
                                       getattr(one.profile, field),
                                       rtol=1e-5, atol=0)
        # the packed rows carry exactly the leaves they were packed from
        pr = egress.PackedResult(rows[i].numpy())
        np.testing.assert_array_equal(pr.unpack_mask(), out.mask[i].numpy())
        assert pr.scalars()[0] == float(out.mask_coverage[i])
        assert pr.scalars()[3] == bool(out.profile.valid[i])
    # one frame in a batch of one takes the single-frame (fused) path
    one = batched(rgb[:1], depth[:1], k[:1], scales[:1])
    assert torch.equal(one.profile.mean_curvature[0],
                       single(rgb[0], depth[0], k[0], scales[0])
                       .profile.mean_curvature)


def test_batched_servicer_answers_concurrent_streams_as_the_direct_path(
        setup, tmp_path):
    frames, _, _, folded = setup
    requests = [ingest.raw_request(rgb, d, mask_format=i % 3)
                for i, (rgb, d) in enumerate(frames * 2)]
    base = dict(model_img_size=SIZE, metrics_flush_every=1,
                calibration_path=str(tmp_path / "none.npz"))
    direct = VisionAnalysisService(
        folded, cfg=ServerConfig(metrics_csv=str(tmp_path / "d.csv"), **base),
        device="cpu")
    want = list(direct.analyze_stream(iter(requests)))
    direct.close()
    batched = VisionAnalysisService(
        folded, cfg=ServerConfig(metrics_csv=str(tmp_path / "b.csv"),
                                 batch_window_ms=20.0, max_batch=4, **base),
        device="cpu")
    assert batched.dispatcher is not None
    batched.warmup(W, H)
    got: dict = {}

    def stream(sid):
        got[sid] = list(batched.analyze_stream(iter(requests)))

    threads = [threading.Thread(target=stream, args=(s,)) for s in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    sizes = dict(batched.dispatcher.dispatch_sizes)
    batched.close()
    assert sum(n * c for n, c in sizes.items()) == 3 * len(requests)
    assert max(sizes) > 1  # streams met in a dispatch
    rows = (tmp_path / "b.csv").read_text().strip().splitlines()
    assert len(rows) == 1 + 3 * len(requests)
    assert {"OK"} <= {r.status for r in want}
    for sid in range(3):
        assert len(got[sid]) == len(requests)
        for i, (w, g) in enumerate(zip(want, got[sid])):
            assert g.status == w.status, (sid, i)
            assert g.mask == w.mask, (sid, i)  # byte-equal, every format
            assert g.mask_coverage == w.mask_coverage
            assert g.packed_spline == b"" or len(g.packed_spline) == len(
                w.packed_spline)
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
            assert g.proc_time_ms > 0


def test_shed_frames_end_the_stream_as_resource_exhausted(setup, tmp_path):
    """At the backlog cap (here 0) a submit is shed: the stream ends with
    OverloadedError, which the gRPC adapter answers RESOURCE_EXHAUSTED."""
    grpc = pytest.importorskip("grpc")
    from robotic_discovery_platform_tpu_torch.serving import grpc_service
    from robotic_discovery_platform_tpu_torch.serving.admission import (
        OverloadedError,
    )

    frames, _, _, folded = setup
    service = VisionAnalysisService(
        folded, cfg=ServerConfig(model_img_size=SIZE, batch_window_ms=2.0,
                                 max_backlog=0,
                                 metrics_csv=str(tmp_path / "m.csv")),
        device="cpu")
    request = ingest.raw_request(*frames[0])
    with pytest.raises(OverloadedError, match="backlog at cap"):
        list(service.analyze_stream(iter([request])))

    class Context:
        def is_active(self):
            return True

        def abort(self, code, details):
            raise RuntimeError((code, details))

    from robotic_discovery_platform_tpu_torch.serving.proto import vision_pb2

    pb = vision_pb2.AnalysisRequest(
        color_image=vision_pb2.Image(data=request.color_image.data, width=W,
                                     height=H, format=1),
        depth_image=vision_pb2.Image(data=request.depth_image.data, width=W,
                                     height=H, format=1))
    with pytest.raises(RuntimeError) as err:
        list(grpc_service.GrpcVisionService(service)
             .AnalyzeActuatorPerformance(iter([pb]), Context()))
    code, details = err.value.args[0]
    assert code == grpc.StatusCode.RESOURCE_EXHAUSTED and "backlog" in details
    service.close()
