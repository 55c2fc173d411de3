"""The port's serving path (serving/) against the JAX package's server, on
the CPU: the same request stream into the JAX gRPC server and into the
port's servicer (in process and over the port's own gRPC server), the
service golden through the port, and the wire codecs.

Tolerances, fixed before measuring:
- statuses, coverage and the bits/RLE mask payloads: identical; PNG masks
  compared as decoded pixels;
- curvature and spline points: rtol 1e-3 (tests/test_torch_port_geometry);
- the service golden: the tolerances stated in tests/test_service_golden.py.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

grpc = pytest.importorskip("grpc")
cv2 = pytest.importorskip("cv2")

from robotic_discovery_platform_tpu import tracking  # noqa: E402
from robotic_discovery_platform_tpu.models.unet import (  # noqa: E402
    build_unet,
    init_unet,
)
from robotic_discovery_platform_tpu.ops import bspline as jbspline  # noqa: E402
from robotic_discovery_platform_tpu.ops import geometry as jgeom  # noqa: E402
from robotic_discovery_platform_tpu.ops import pipeline as jpipe  # noqa: E402
from robotic_discovery_platform_tpu.serving import egress as jegress  # noqa: E402
from robotic_discovery_platform_tpu.serving import server as jserver  # noqa: E402
from robotic_discovery_platform_tpu.serving.proto import (  # noqa: E402
    vision_grpc,
    vision_pb2,
)
from robotic_discovery_platform_tpu.tools.import_torch_weights import (  # noqa: E402
    convert_state_dict,
)
from robotic_discovery_platform_tpu.utils.config import (  # noqa: E402
    GeometryConfig as JaxGeometryConfig,
)
from robotic_discovery_platform_tpu.utils.config import (  # noqa: E402
    ModelConfig as JaxModelConfig,
)
from robotic_discovery_platform_tpu.utils.config import (  # noqa: E402
    ServerConfig as JaxServerConfig,
)
from robotic_discovery_platform_tpu_torch.io.frames import (  # noqa: E402
    load_calibration,
    render_scene,
)
from robotic_discovery_platform_tpu_torch.models.weights import (  # noqa: E402
    unet_from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet  # noqa: E402
from robotic_discovery_platform_tpu_torch.serving import (  # noqa: E402
    egress,
    grpc_service,
    ingest,
    messages,
)
from robotic_discovery_platform_tpu_torch.serving.server import (  # noqa: E402
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils.config import (  # noqa: E402
    ModelConfig,
    ServerConfig,
)

GOLDEN = Path(__file__).parent / "golden"
REPO = Path(__file__).resolve().parent.parent
H, W, SIZE = 120, 160, 64


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


def _model_and_variables():
    """base_features 8, float32, BatchNorm statistics from a numpy seed and
    the head bias at frame 0's median logit (structured masks)."""
    cfg = JaxModelConfig(base_features=8, compute_dtype="float32")
    model = build_unet(cfg)
    variables = jax.tree.map(np.asarray,
                             init_unet(model, jax.random.key(0), SIZE))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.05, 0.2, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    rgb, _, _ = render_scene(np.random.default_rng(100), H, W)
    x = jpipe.preprocess(jnp.asarray(rgb)[None], SIZE)
    median = float(np.median(np.asarray(model.apply(variables, x))))
    variables["params"]["Conv_0"]["bias"] = (
        variables["params"]["Conv_0"]["bias"] - median).astype(np.float32)
    return cfg, model, variables


def _frames():
    rng = np.random.default_rng(100)
    return [render_scene(rng, H, W)[::2] for _ in range(6)]  # (rgb, depth)


def _to_proto(req: messages.AnalysisRequest):
    def image(img):
        return vision_pb2.Image(data=img.data, width=img.width,
                                height=img.height, format=img.format)

    return vision_pb2.AnalysisRequest(
        color_image=image(req.color_image), depth_image=image(req.depth_image),
        model=req.model, mask_format=req.mask_format)


def _over_grpc(port: int, requests) -> list:
    with grpc.insecure_channel(f"localhost:{port}") as channel:
        stub = vision_grpc.VisionAnalysisServiceStub(channel)
        return list(stub.AnalyzeActuatorPerformance(iter(requests)))


def _mask_of(payload: bytes) -> np.ndarray:
    mask = egress.decode_mask_wire(payload)
    if mask is None:
        mask = (cv2.imdecode(np.frombuffer(payload, np.uint8),
                             cv2.IMREAD_GRAYSCALE) > 0).astype(np.uint8)
    return mask


def _reference_keeps_every_edge_point(mask, depth) -> bool:
    """False on frames where the JAX package drops its last edge point
    from the spline fit (tests/test_torch_port_pipeline.py::
    test_chord_parameters_clip_at_one)."""
    k = ingest.default_intrinsics(W, H).astype(np.float32)
    maps = jgeom.deproject(jnp.asarray(mask), jnp.asarray(depth), k[0, 0],
                           k[1, 1], k[0, 2], k[1, 2], jnp.float32(0.001))
    e = jgeom._edge_points(*maps, JaxGeometryConfig(kernel_impl="xla"))
    pts, wts = jgeom._sort_by_x(e[0], e[1])
    return float(np.max(np.asarray(
        jbspline.chord_length_params(pts, wts)))) <= 1.0


def test_servicer_matches_jax_server(tmp_path):
    cfg, _, variables = _model_and_variables()
    uri = f"file:{tmp_path}/mlruns"
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    with tracking.start_run():
        tracking.log_model(variables, cfg,
                           registered_model_name="Actuator-Segmenter")
    frames = _frames()
    requests = [ingest.raw_request(rgb, depth, mask_format=i % 3)
                for i, (rgb, depth) in enumerate(frames)]
    protos = [_to_proto(r) for r in requests]

    jserver_, jservicer = jserver.build_server(JaxServerConfig(
        address="localhost:0", tracking_uri=uri, model_img_size=SIZE,
        metrics_csv=str(tmp_path / "jax.csv"), reload_poll_s=0.0,
        calibration_path=str(tmp_path / "none.npz")))
    port = jserver_.add_insecure_port("localhost:0")
    jserver_.start()
    try:
        want = _over_grpc(port, protos)
    finally:
        jserver_.stop(grace=None)
        jservicer.close()

    net = unet_from_flax_variables(
        ModelConfig(base_features=8, compute_dtype="float32"), variables)
    folded = FoldedUNet(net, device="cpu")
    pcfg = ServerConfig(address="localhost:0", model_img_size=SIZE,
                        metrics_csv=str(tmp_path / "port.csv"),
                        metrics_flush_every=1,
                        calibration_path=str(tmp_path / "none.npz"))
    service = VisionAnalysisService(folded, cfg=pcfg, device="cpu")
    got = list(service.analyze_stream(iter(requests)))
    service.close()
    server, servicer = grpc_service.build_server(pcfg, folded, device="cpu")
    server.start()
    try:
        got_grpc = _over_grpc(servicer.bound_port, protos)
    finally:
        server.stop(grace=None)
        servicer.close()

    assert len(want) == len(got) == len(got_grpc) == len(requests)
    rows = (tmp_path / "port.csv").read_text().strip().splitlines()
    assert rows[0] == "timestamp,mean_curvature,max_curvature,mask_coverage_percent"
    assert len(rows) == 1 + 2 * len(requests)  # in process, then gRPC
    statuses = set()
    for i, (req, w, g, gg) in enumerate(zip(requests, want, got, got_grpc)):
        statuses.add(w.status)
        assert g.status == w.status == gg.status, i
        mask = _mask_of(g.mask)
        np.testing.assert_array_equal(mask, _mask_of(w.mask))
        if req.mask_format in (1, 2):
            assert g.mask == w.mask == gg.mask  # byte-identical payloads
        else:
            assert gg.mask == g.mask
        assert np.float32(g.mask_coverage) == w.mask_coverage
        assert g.proc_time_ms > 0 and gg.proc_time_ms > 0
        assert _reference_keeps_every_edge_point(mask, frames[i][1]), i
        np.testing.assert_allclose(
            [g.mean_curvature, g.max_curvature],
            [w.mean_curvature, w.max_curvature], rtol=1e-3, atol=0.0)
        assert (gg.mean_curvature, gg.max_curvature) == (
            g.mean_curvature, g.max_curvature)
        if req.mask_format:
            assert not w.spline_points and not g.spline_points
            np.testing.assert_allclose(
                egress.decode_spline_wire(g.packed_spline),
                jegress.decode_spline_wire(w.packed_spline), rtol=1e-3)
        else:
            np.testing.assert_allclose(
                [[p.x, p.y, p.z] for p in g.spline_points],
                [[p.x, p.y, p.z] for p in w.spline_points], rtol=1e-3)
    assert "OK" in statuses


def test_service_golden_through_the_port(tmp_path):
    """tests/golden/service_golden.npz (the reference server's responses
    to 20 encoded frames) through the port's servicer, under the
    tolerances of tests/test_service_golden.py."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_service_golden import _spearman

    g = np.load(GOLDEN / "service_golden.npz", allow_pickle=True)
    size = int(g["model_size"])
    jcfg = JaxModelConfig(base_features=int(g["base_features"]),
                          compute_dtype="float32")
    variables = jax.tree.map(np.asarray, convert_state_dict(
        torch.load(GOLDEN / "torch_unet_f8.pt", weights_only=True), jcfg))
    net = unet_from_flax_variables(
        ModelConfig(base_features=jcfg.base_features, compute_dtype="float32"),
        variables)
    mtx, _, depth_scale = load_calibration(GOLDEN / "calibration.npz")
    service = VisionAnalysisService(
        FoldedUNet(net, device="cpu"), mtx, depth_scale,
        ServerConfig(model_img_size=size,
                     metrics_csv=str(tmp_path / "metrics.csv")),
        device="cpu")
    requests = [messages.AnalysisRequest(
        color_image=messages.Image(g["jpgs"][i].tobytes(), size, size),
        depth_image=messages.Image(g["pngs"][i].tobytes(), size, size))
        for i in range(len(g["valid"]))]
    responses = list(service.analyze_stream(iter(requests)))
    service.close()

    assert len(responses) == len(requests)
    ours_mean, ours_max = [], []
    for i, resp in enumerate(responses):
        golden_valid = bool(g["valid"][i])
        assert (resp.status == "OK") == golden_valid, (i, resp.status)
        mask = _mask_of(resp.mask)
        gm = g["masks"][i]
        union = np.logical_or(mask, gm).sum()
        iou = np.logical_and(mask, gm).sum() / union if union else 1.0
        assert iou >= 0.995, (i, iou)
        assert abs(resp.mask_coverage - g["mask_coverage"][i]) <= 0.1, i
        ours_mean.append(resp.mean_curvature)
        ours_max.append(resp.max_curvature)
        if not golden_valid:
            assert resp.mean_curvature == 0.0
            assert len(resp.spline_points) == 0
            continue
        gmk, gxk = g["mean_curvature"][i], g["max_curvature"][i]
        assert 1 / 16 <= resp.mean_curvature / gmk <= 16, i
        assert 1 / 100 <= resp.max_curvature / gxk <= 100, i
        sp = np.array([[p.x, p.y, p.z] for p in resp.spline_points])
        gsp = g["spline_points"][i]
        extent = np.linalg.norm(gsp.max(0) - gsp.min(0))
        nearest = np.sqrt(
            ((sp[:, None, :] - gsp[None, :, :]) ** 2).sum(-1)).min(1)
        assert np.sqrt((nearest ** 2).mean()) / extent <= 0.15, i
    valid = np.asarray(g["valid"], bool)
    if valid.sum() >= 5:
        assert _spearman(np.asarray(ours_mean)[valid],
                         g["mean_curvature"][valid]) >= 0.7
        assert _spearman(np.asarray(ours_max)[valid],
                         g["max_curvature"][valid]) >= 0.7


@pytest.mark.parametrize("h,w,p", [(120, 160, 0.5), (7, 13, 0.9), (5, 8, 0.0)])
def test_mask_wire_codecs_match_jax(h, w, p):
    mask = (np.random.default_rng(h * w).random((h, w)) < p).astype(np.uint8)
    bits = np.packbits(mask, axis=-1)
    assert (egress.encode_bits_wire(bits, h, w)
            == jegress.encode_bits_wire(bits, h, w))
    assert (egress.encode_rle_wire(mask, h, w)
            == jegress.encode_rle_wire(mask, h, w))
    for fmt in (0, 1, 2):
        payload = egress.encode_mask(mask, fmt)
        np.testing.assert_array_equal(_mask_of(payload), mask)
    assert egress.encode_png_mask(mask) == cv2.imencode(".png", mask * 255)[1].tobytes()
    # the stdlib writer, for machines without cv2: same pixels
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(egress.png_gray8(mask * 255), np.uint8),
                     cv2.IMREAD_GRAYSCALE), mask * 255)
    sys.path.insert(0, str(REPO))
    import chip_smoke

    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None  # the decoder chip_smoke uses without cv2
    try:
        np.testing.assert_array_equal(
            chip_smoke.decode_png(egress.png_gray8(mask * 255)), mask * 255)
    finally:
        sys.modules["cv2"] = saved


@pytest.mark.parametrize("case", ["raw_size", "coef_lane", "bad_jpeg",
                                  "shape_mismatch"])
def test_bad_frames_answer_errors_and_the_stream_lives_on(case, tmp_path):
    rng = np.random.default_rng(5)
    rgb, _, depth = render_scene(rng, H, W)
    good = ingest.raw_request(rgb, depth)
    bad = ingest.raw_request(rgb, depth)
    if case == "raw_size":
        bad.color_image.data = bad.color_image.data[:-3]
        want = "ERROR: ValueError: raw color payload"
    elif case == "coef_lane":
        # raw pixels labelled as a coefficient payload: malformed
        bad.color_image.format = ingest.FORMAT_COEF
        want = "ERROR: ValueError: coefficient payload: bad magic"
    elif case == "bad_jpeg":
        bad.color_image = messages.Image(b"not a jpeg", W, H, 0)
        want = "ERROR: ValueError: failed to decode color payload"
    else:
        bad.depth_image = ingest.raw_request(rgb[:, :-1], depth[:, :-1]).depth_image
        want = "ERROR: ValueError: depth frame is"
    _, model, variables = _model_and_variables()
    net = unet_from_flax_variables(
        ModelConfig(base_features=8, compute_dtype="float32"), variables)
    service = VisionAnalysisService(
        FoldedUNet(net, device="cpu"),
        cfg=ServerConfig(model_img_size=SIZE,
                         metrics_csv=str(tmp_path / "m.csv")), device="cpu")
    out = list(service.analyze_stream(iter([bad, good])))
    service.close()
    assert out[0].status.startswith(want), out[0].status
    assert out[0].proc_time_ms > 0 and not out[0].mask
    assert out[1].status.startswith(("OK", "DEGRADED"))
    rows = (tmp_path / "m.csv").read_text().strip().splitlines()
    assert len(rows) == 2  # header + the good frame only


@pytest.mark.parametrize("h,w,seed", [(120, 160, 0), (480, 640, 3)])
def test_synthetic_frames_match_jax(h, w, seed):
    """The port's copies of render_scene and SyntheticSource give the JAX
    package's frames bit for bit, with the same intrinsics."""
    from robotic_discovery_platform_tpu.io import frames as jframes
    from robotic_discovery_platform_tpu.training.synthetic import (
        render_scene as jax_render_scene,
    )
    from robotic_discovery_platform_tpu_torch.io import frames as tframes

    for got, want in zip(render_scene(np.random.default_rng(seed), h, w),
                         jax_render_scene(np.random.default_rng(seed), h, w)):
        np.testing.assert_array_equal(got, want)
    ours = tframes.SyntheticSource(width=w, height=h, seed=seed, n_frames=2)
    theirs = jframes.SyntheticSource(width=w, height=h, seed=seed, n_frames=2)
    for _ in range(3):
        a, b = ours.get_frames(), theirs.get_frames()
        if b[0] is None:
            assert a == (None, None)
            continue
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(ours.intrinsics(), theirs.intrinsics())
    assert ours.depth_scale == theirs.depth_scale


def _scope_service(tmp_path, device):
    """A direct-path servicer built on the CPU (a blank forward) whose
    ``device`` then reads ``device``: what its direct path enters is
    recorded, and its analyzers run on the CPU tensors they were built
    for (the camera geometry is staged before the switch)."""
    def forward(x):
        return torch.zeros((*x.shape[:3], 1), dtype=torch.float32)

    service = VisionAnalysisService(
        forward, cfg=ServerConfig(model_img_size=32,
                                  metrics_csv=str(tmp_path / "m.csv")),
        device="cpu")
    service._geometry(64, 48).staged()
    service.device = torch.device(device)
    return service


@pytest.mark.parametrize("entry", ["analyze_frame", "warmup", "warmup_coef"])
def test_direct_path_enters_its_own_card(entry, tmp_path, monkeypatch):
    """``analyze_frame``, ``warmup`` and ``warmup_coef`` of a servicer on
    ``cuda:1`` run the analyzer inside ``torch.cuda.device(cuda:1)``: the
    kernel wrappers take tensors on the current device only."""
    import contextlib

    entered, inside, calls = [], [], []

    @contextlib.contextmanager
    def device_cm(dev):
        entered.append(torch.device(dev))
        inside.append(True)
        try:
            yield
        finally:
            inside.pop()

    monkeypatch.setattr(torch.cuda, "device", device_cm)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    service = _scope_service(tmp_path, "cuda:1")
    for name in ("analyze", "analyze_coef"):
        inner = getattr(service, name)

        def recorded(*args, _inner=inner, _name=name):
            calls.append((_name, bool(inside)))
            return _inner(*args)

        # the analyzers are fields of the servicer's generation (Engine)
        service._engine = service._engine._replace(**{name: recorded})
    if entry == "analyze_frame":
        rgb, _, depth = render_scene(np.random.default_rng(0), 48, 64)
        service.analyze_frame(rgb, depth)
    else:
        getattr(service, entry)(64, 48)
    service.close()
    want = "analyze_coef" if entry == "warmup_coef" else "analyze"
    assert calls == [(want, True)]
    assert entered and set(entered) == {torch.device("cuda", 1)}


def test_direct_path_on_the_cpu_enters_no_card(tmp_path, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: entered.append(dev))
    service = _scope_service(tmp_path, "cpu")
    rgb, _, depth = render_scene(np.random.default_rng(0), 48, 64)
    service.analyze_frame(rgb, depth)
    service.warmup(64, 48)
    service.warmup_coef(64, 48)
    service.close()
    assert entered == []
