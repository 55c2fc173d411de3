"""The port's lab tools and guards against the JAX package's, on the CPU:
``tools/import_torch_weights`` (a reference ``.pth`` read straight into
the port's UNet), ``tools/collect_data``, ``tools/calibrate_camera``,
``tools/make_dataset``, ``tools/geometry_parity``, ``utils/flops`` and
``utils/transferguard``.

Tolerances, fixed before measuring:
- imported weights: logits within 1e-4 max-abs of the torch module's own
  (float32) and of the JAX package's import (float32);
- synthesized files, collected captures and pseudo-labels: equal to the
  JAX tools' byte for byte (float32 compute);
- the parity corpus: scene draws equal to the JAX tool's; a 12-scene
  corpus within the envelope of tests/test_geometry.py (median relative
  error against the analytic curvature < 5%, 75th percentile < 8%);
- calibration: the focal length within 10%, reprojection error < 1 px
  (tests/test_mlops.py); the JAX tool's camera matrix within 1e-6
  relative (cv2's solver is not bitwise repeatable between calls: one
  package's two calls on the same views differ by about 1e-12 in fx, the
  two packages' by about 6e-8; set after that measurement);
- flops: every count equal to the JAX module's; the U-Net forward's equal
  to ``torch.utils.flop_counter.FlopCounterMode`` over the plain CPU
  forward.
"""

import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models.unet import build_unet
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu.utils import flops as jflops
from robotic_discovery_platform_tpu.utils import transferguard as jguard
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import (
    ReplaySource,
    SyntheticSource,
)
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.tools import (
    calibrate_camera,
    collect_data,
    geometry_parity,
    import_torch_weights,
    make_dataset,
)
from robotic_discovery_platform_tpu_torch.utils import config
from robotic_discovery_platform_tpu_torch.utils import flops
from robotic_discovery_platform_tpu_torch.utils import transferguard

NAME = "Actuator-Segmenter"


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


@pytest.fixture(autouse=True)
def _restore_tracking():
    prev = (tracking.get_tracking_uri(), jtracking.get_tracking_uri())
    yield
    tracking.set_tracking_uri(prev[0])
    jtracking.set_tracking_uri(prev[1])


# -- import_torch_weights ----------------------------------------------------------


def _reference_net(seed: int = 0):
    """``bench_reference.build_torch_unet(base_features=8)`` with
    BatchNorm statistics moved off their init by a few train-mode passes
    (the JAX package's tests/test_torch_parity.py recipe)."""
    from bench_reference import build_torch_unet

    torch.manual_seed(seed)
    tm = build_torch_unet(base_features=8).train()
    with torch.no_grad():
        for _ in range(3):
            tm(torch.rand(1, 3, 64, 64))
    tm.eval()
    x = torch.rand(2, 3, 64, 64)
    with torch.no_grad():
        want = tm(x).numpy()
    return tm, x, want


CFG = config.ModelConfig(base_features=8, compute_dtype="float32")


def test_convert_state_dict_matches_torch_and_the_jax_import():
    from robotic_discovery_platform_tpu.tools.import_torch_weights import (
        convert_state_dict as jconvert,
    )

    tm, x, want = _reference_net()
    net = import_torch_weights.convert_state_dict(tm.state_dict(), CFG)
    assert isinstance(net, tunet.UNet) and not net.training
    xn = x.numpy().transpose(0, 2, 3, 1)
    with torch.no_grad():
        got = net(torch.from_numpy(xn)).numpy()[..., 0]
    np.testing.assert_allclose(got, want[:, 0], atol=1e-4, rtol=0)

    jcfg = jconfig.ModelConfig(**dataclasses.asdict(CFG))
    jvars = jconvert(tm.state_dict(), jcfg)
    jgot = np.asarray(build_unet(jcfg).apply(jvars, jnp.asarray(xn),
                                             train=False))[..., 0]
    np.testing.assert_allclose(got, jgot, atol=1e-4, rtol=0)
    # the same tree, read with no Flax tree in between
    mine = weights.to_flax_variables(net)
    theirs = jax.tree.map(np.asarray, jvars)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, b)


def test_convert_state_dict_takes_a_transposed_conv_decoder():
    """``bilinear=False``: the transposed convs' [Cin, Cout, kH, kW]
    weights land in the port's flipped [2, 2, Cin, Cout] kernels; the
    import equals the JAX package's and a ConvTranspose2d layer's output
    equals the port's layer."""
    from robotic_discovery_platform_tpu.tools.import_torch_weights import (
        convert_state_dict as jconvert,
    )

    torch.manual_seed(1)
    layer = torch.nn.ConvTranspose2d(6, 4, kernel_size=2, stride=2)
    port_layer = tunet.ConvTranspose2x2(6, 4)
    w = layer.weight.detach().numpy()
    with torch.no_grad():
        port_layer.kernel.copy_(torch.from_numpy(np.ascontiguousarray(
            w.transpose(2, 3, 0, 1)[::-1, ::-1])))
        port_layer.bias.copy_(layer.bias)
        x = torch.rand(2, 6, 5, 7)
        np.testing.assert_allclose(
            port_layer(x.permute(0, 2, 3, 1)).numpy(),
            layer(x).permute(0, 2, 3, 1).numpy(), atol=1e-6, rtol=0)

    cfg = config.ModelConfig(base_features=4, compute_dtype="float32",
                             bilinear=False)
    source = tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(2))
    jvars = jconvert(_as_reference_state(source),
                     jconfig.ModelConfig(**dataclasses.asdict(cfg)))
    net = import_torch_weights.convert_state_dict(
        _as_reference_state(source), cfg)
    for a, b in zip(jax.tree.leaves(weights.to_flax_variables(net)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jvars))):
        np.testing.assert_array_equal(a, b)
    for k, v in source.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k


def _as_reference_state(net: tunet.UNet) -> dict:
    """A port UNet's weights as a reference ``state_dict`` (OIHW convs,
    [Cin, Cout, kH, kW] transposed convs, BatchNorm's four tensors plus
    ``num_batches_tracked``), in the reference's order and names."""
    out = {}
    s = net.state_dict()
    for path, kind in import_torch_weights._slot_order(net.cfg):
        prefix = ".".join(path)
        stage = import_torch_weights._stage_of_path(path)
        if kind == "conv":
            out[f"{stage}.{prefix}.weight"] = s[f"{prefix}.kernel"].permute(
                3, 2, 0, 1)
        elif kind == "head":
            out[f"{stage}.weight"] = s[f"{prefix}.kernel"].permute(3, 2, 0, 1)
            out[f"{stage}.bias"] = s[f"{prefix}.bias"]
        elif kind == "convt":
            out[f"{stage}.up.weight"] = s[f"{prefix}.kernel"].flip(
                0, 1).permute(2, 3, 0, 1)
            out[f"{stage}.up.bias"] = s[f"{prefix}.bias"]
        else:
            for ref, leaf in (("weight", "scale"), ("bias", "bias"),
                              ("running_mean", "mean"),
                              ("running_var", "var")):
                out[f"{stage}.{prefix}.{ref}"] = s[f"{prefix}.{leaf}"]
            out[f"{stage}.{prefix}.num_batches_tracked"] = torch.tensor(3)
    return out


@pytest.mark.parametrize("fault", ["truncated", "swapped", "shape",
                                   "group_norm"])
def test_convert_state_dict_refuses_a_mismatched_checkpoint(fault):
    tm, _, _ = _reference_net()
    sd = dict(tm.state_dict())
    cfg = CFG
    if fault == "truncated":
        sd.pop(next(iter(sd)))
        match = "checkpoint"
    elif fault == "swapped":
        keys = list(sd)
        i = keys.index("down1.block.1.block.0.weight")
        j = keys.index("up4.conv.block.0.weight")
        keys[i], keys[j] = keys[j], keys[i]
        sd = {k: sd[k] for k in keys}
        match = "mapped into stage|shape mismatch"
    elif fault == "shape":
        cfg = config.ModelConfig(base_features=16, compute_dtype="float32")
        match = "shape mismatch"
    else:
        cfg = dataclasses.replace(CFG, norm="group")
        match = "BatchNorm"
    with pytest.raises(ValueError, match=match):
        import_torch_weights.convert_state_dict(sd, cfg)


@pytest.mark.parametrize("store", ["file", "http"])
def test_import_checkpoint_registers_and_the_jax_package_serves_it(
        store, tmp_path):
    """``import_checkpoint(register=True)`` (and the CLI's ``--register
    --tracking-uri``) log the imported net through the port's tracking, to
    a file store or an MLflow server; the JAX package loads the version
    and computes the torch module's function."""
    from fake_mlflow_server import FakeMlflowServer

    tm, x, want = _reference_net()
    pth = tmp_path / "best_segmentation_model.pth"
    torch.save(tm.state_dict(), pth)
    with FakeMlflowServer() as http_uri:
        uri = f"file:{tmp_path}/mlruns" if store == "file" else http_uri
        tracking.set_tracking_uri(uri)
        tracking.set_experiment("Actuator Segmentation")
        net, version = import_torch_weights.import_checkpoint(
            pth, CFG, register=True)
        assert version == 1
        run_store = tracking.store_for(uri)
        assert tracking.load_model(f"models:/{NAME}/1", store=run_store,
                                   device="cpu")[0] == CFG
        jtracking.set_tracking_uri(uri if store == "file"
                                   else f"mlflow-rest+{uri}")
        model, variables = jtracking.load_model(f"models:/{NAME}/1")
        got = np.asarray(model.apply(
            variables, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
            train=False))[..., 0]
        np.testing.assert_allclose(got, want[:, 0], atol=1e-4, rtol=0)
        if store == "file":
            # the CLI (ModelConfig() widths: refuses this base-8 file)
            with pytest.raises(ValueError, match="shape mismatch"):
                import_torch_weights.main([str(pth), "--register",
                                           "--tracking-uri", uri])


# -- collect_data, calibrate_camera, make_dataset --------------------------------


def test_collect_and_replay_equal_the_jax_collector(tmp_path):
    """The port collector's run directory replays to the same frames, and
    its files are the JAX collector's byte for byte."""
    from robotic_discovery_platform_tpu.io.frames import (
        SyntheticSource as JSyntheticSource,
    )
    from robotic_discovery_platform_tpu.tools import (
        collect_data as jcollect,
    )

    run_dir = collect_data.collect(
        SyntheticSource(width=96, height=64, n_frames=5),
        config.CollectConfig(output_root=str(tmp_path / "port")),
        n_frames=3, interval_s=0.0)
    jrun_dir = jcollect.collect(
        JSyntheticSource(width=96, height=64, n_frames=5),
        jconfig.CollectConfig(output_root=str(tmp_path / "jax")),
        n_frames=3, interval_s=0.0)
    replay = ReplaySource(run_dir, loop=False)
    replay.start()
    frames = []
    while True:
        c, d = replay.get_frames()
        if c is None:
            break
        frames.append((c, d))
    assert len(frames) == 3
    assert frames[0][0].shape == (64, 96, 3)
    assert frames[0][1].dtype == np.uint16
    files = sorted(p.relative_to(run_dir) for p in run_dir.rglob("*.*"))
    assert files == sorted(p.relative_to(jrun_dir)
                           for p in jrun_dir.rglob("*.*"))
    for rel in files:
        assert (run_dir / rel).read_bytes() == (jrun_dir / rel).read_bytes()
    assert (dataclasses.asdict(config.CollectConfig())
            == dataclasses.asdict(jconfig.CollectConfig()))


def test_calibration_from_synthetic_views(tmp_path):
    """Checkerboard views rendered through a known camera: the solver
    recovers the focal length (tests/test_mlops.py's case), the JAX tool
    finds the same intrinsics, and the saved file loads as the server's
    calibration."""
    import cv2

    from robotic_discovery_platform_tpu.tools import (
        calibrate_camera as jcalibrate,
    )
    from robotic_discovery_platform_tpu_torch.io.frames import (
        load_calibration,
    )

    cfg = config.CalibrationConfig(output_path=str(tmp_path / "calib.npz"))
    cols, rows = cfg.checkerboard_cols, cfg.checkerboard_rows
    sq = 40  # px per square in the flat pattern
    pattern = np.zeros(((rows + 1) * sq, (cols + 1) * sq), np.uint8)
    for r in range(rows + 1):
        for c in range(cols + 1):
            if (r + c) % 2 == 0:
                pattern[r * sq:(r + 1) * sq, c * sq:(c + 1) * sq] = 255
    pattern = np.pad(pattern, 40, constant_values=128)

    f, w, h = 600.0, 640, 480
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    rng = np.random.default_rng(0)
    views = []
    for _ in range(10):
        rvec = rng.uniform(-0.25, 0.25, 3)
        tvec = np.array([rng.uniform(-40, 40), rng.uniform(-40, 40),
                         rng.uniform(420, 560)])
        r_mat, _ = cv2.Rodrigues(rvec)
        hmat = k @ np.column_stack([r_mat[:, 0], r_mat[:, 1], tvec])
        ph, pw = pattern.shape
        scale = 0.8
        pre = np.array([[scale, 0, -scale * pw / 2],
                        [0, scale, -scale * ph / 2],
                        [0, 0, 1.0]])
        views.append(cv2.warpPerspective(pattern, (hmat @ pre).astype(
            np.float64), (w, h), borderValue=128))

    result = calibrate_camera.calibrate_from_images(views, cfg, save=True)
    assert result.n_views >= cfg.min_captures
    fx = result.camera_matrix[0, 0]
    assert abs(fx - f) / f < 0.1, fx
    assert result.mean_reprojection_error < 1.0
    jresult = jcalibrate.calibrate_from_images(
        views, jconfig.CalibrationConfig(**dataclasses.asdict(cfg)),
        save=False)
    # cv2's solver does not repeat bit for bit from call to call
    np.testing.assert_allclose(result.camera_matrix, jresult.camera_matrix,
                               rtol=1e-6, atol=0)
    assert result.n_views == jresult.n_views
    np.testing.assert_array_equal(
        calibrate_camera.object_grid(cfg),
        jcalibrate.object_grid(jconfig.CalibrationConfig()))
    loaded = load_calibration(result.output_path)
    np.testing.assert_allclose(loaded[0], result.camera_matrix)
    with pytest.raises(ValueError, match="found the checkerboard"):
        calibrate_camera.calibrate_from_images(views[:2], cfg, save=False)


def test_config_sections_of_the_tools_match_jax():
    for name in ("CameraConfig", "CalibrationConfig", "CollectConfig"):
        assert (dataclasses.asdict(getattr(config, name)())
                == dataclasses.asdict(getattr(jconfig, name)())), name
    platform = config.from_dict(config.PlatformConfig, {
        "camera": {"fps": 15}, "calibration": {"min_captures": 7},
        "collect": {"capture_interval_s": 0.25}})
    assert (platform.camera.fps, platform.calibration.min_captures,
            platform.collect.capture_interval_s) == (15, 7, 0.25)
    parsed = config.parse_config(["--camera.width", "320",
                                  "--calibration.square_size_mm", "20",
                                  "--collect.output_root", "/data/raw"])
    assert parsed.camera.width == 320
    assert parsed.calibration.square_size_mm == 20.0
    assert parsed.collect.output_root == "/data/raw"
    assert ({f.name for f in dataclasses.fields(config.PlatformConfig)}
            == {f.name for f in dataclasses.fields(jconfig.PlatformConfig)})


def test_synthesize_equals_the_jax_tool(tmp_path):
    from robotic_discovery_platform_tpu.tools import make_dataset as jmake

    out = make_dataset.synthesize(tmp_path / "port", n=3, width=96,
                                  height=64, seed=5)
    jout = jmake.synthesize(tmp_path / "jax", n=3, width=96, height=64,
                            seed=5)
    files = sorted(p.relative_to(out) for p in out.rglob("*.png"))
    assert len(files) == 6
    assert files == sorted(p.relative_to(jout) for p in jout.rglob("*.png"))
    for rel in files:
        assert (out / rel).read_bytes() == (jout / rel).read_bytes()


def test_pseudo_label_equals_the_jax_tool(tmp_path):
    """A registered model (float32 compute) labels a collector run: the
    port's frame analyzer on the CPU writes the same pairs as the JAX
    tool's jitted Flax forward."""
    import cv2

    from robotic_discovery_platform_tpu.tools import make_dataset as jmake

    tm, _, _ = _reference_net(seed=4)
    net = import_torch_weights.convert_state_dict(tm.state_dict(), CFG)
    with torch.no_grad():  # masks with edges: the head at a median logit
        x = torch.rand(1, 64, 64, 3, generator=torch.Generator()
                       .manual_seed(0))
        net.Conv_0.bias -= torch.median(net(x))
    uri = f"file:{tmp_path}/mlruns"
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    with tracking.start_run():
        tracking.log_model(weights.to_flax_variables(net), CFG,
                           registered_model_name=NAME)
    run_dir = collect_data.collect(
        SyntheticSource(width=96, height=64, n_frames=6, seed=2),
        config.CollectConfig(output_root=str(tmp_path / "raw")),
        n_frames=4, interval_s=0.0)
    n = make_dataset.pseudo_label(run_dir, tmp_path / "port",
                                  f"models:/{NAME}/1", img_size=64,
                                  min_coverage_pct=0.0, device="cpu")
    jtracking.set_tracking_uri(uri)
    jn = jmake.pseudo_label(run_dir, tmp_path / "jax", f"models:/{NAME}/1",
                            img_size=64, min_coverage_pct=0.0)
    assert n == jn == 4
    masks = sorted((tmp_path / "port" / "masks").glob("*.png"))
    assert len(masks) == 4
    covered = 0
    for sub in ("images", "masks"):
        for p in sorted((tmp_path / "port" / sub).glob("*.png")):
            want = tmp_path / "jax" / sub / p.name
            assert p.read_bytes() == want.read_bytes(), (sub, p.name)
            if sub == "masks":
                m = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
                covered += int(0 < m.mean() < 255)
    assert covered  # a mask with both classes, not a constant


# -- geometry_parity -----------------------------------------------------------------


def test_random_scene_draws_equal_the_jax_tool():
    from robotic_discovery_platform_tpu.tools import (
        geometry_parity as jparity,
    )

    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        got = geometry_parity.random_scene(rng)
        want = jparity.random_scene(jrng)
        assert got[5] == want[5]
        for a, b in zip(got[:5], want[:5]):
            np.testing.assert_array_equal(a, b)


def test_corpus_sample_within_the_jax_envelope(tmp_path):
    """A 12-scene corpus on the CPU (the plain versions of the geometry
    kernels) tracks the analytic curvature within the envelope that
    tests/test_geometry.py holds the JAX engine to, at stride 1 and 2, and
    ``main`` writes its report where ``--out`` says."""
    result = geometry_parity.run_corpus(12, seed=7, device="cpu")
    assert result["n_scenes"] == 12
    for s in (1, 2):
        e = np.asarray([abs(sc[f"stride{s}"]["mean"] - sc["true_curvature"])
                        / sc["true_curvature"] for sc in result["scenes"]])
        assert all(sc[f"stride{s}"]["valid"] for sc in result["scenes"])
        assert np.percentile(e, 75) < 0.08, (s, e)
        assert np.median(e) < 0.05, (s, e)
    assert geometry_parity.DEFAULT_OUT.parent.name == "reports"
    out = tmp_path / "corpus.json"
    geometry_parity.main(["--scenes", "2", "--seed", "7", "--device", "cpu",
                          "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["n_scenes"] == 2 and written["device"] == "cpu"
    assert written["scenes"] == json.loads(json.dumps(
        result["scenes"][:2]))


def test_edge_bins_take_the_true_quotient_as_the_card_computes(monkeypatch):
    """The edge binning's bin width is the IEEE quotient on the card too.
    PyTorch's CUDA division of a tensor by a host number multiplies by
    the number's float32 reciprocal; on scene 6 of the seed-0 corpus that
    put the bin width one ulp low and moved 1877 points to the next bin,
    and the card's mean curvature 0.25% from the CPU's. Emulated here
    (``Tensor / number`` as ``Tensor * float32(1 / number)``): the edge
    points equal those of the true division."""
    import sys

    from robotic_discovery_platform_tpu_torch.ops import geometry
    from robotic_discovery_platform_tpu_torch.utils.config import (
        GeometryConfig,
    )

    sys.path.insert(0, str(geometry_parity.REPO / "tests"))
    from oracle import oracle_curvature

    rng = np.random.default_rng(0)
    scenes = []
    while len(scenes) < 7:
        scene = geometry_parity.random_scene(rng)
        if oracle_curvature(*scene[:4])[0] != 0.0:
            scenes.append(scene)
    mask, depth, k, scale = scenes[6][:4]
    k = torch.as_tensor(np.asarray(k, np.float32))
    maps = geometry.deproject(
        torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
        k[0, 0], k[1, 1], k[0, 2], k[1, 2],
        torch.tensor(scale, dtype=torch.float32))
    cfg = GeometryConfig()
    want = geometry._edge_points(*maps, cfg)
    real = torch.Tensor.__truediv__

    def card_like(self, other):
        if isinstance(other, (int, float)) and self.is_floating_point():
            inv = np.float32(1.0) / np.float32(other)
            return self * torch.tensor(inv, dtype=self.dtype)
        return real(self, other)

    monkeypatch.setattr(torch.Tensor, "__truediv__", card_like)
    got = geometry._edge_points(*maps, cfg)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


# -- utils/flops ---------------------------------------------------------------------

JAX_ROOFLINES = {
    "conv3x3_roofline_ms": (64, 48, 32, 16, 2),
    "conv1x1_roofline_ms": (256, 256, 64, 1, 8),
    "conv_transpose2x2_roofline_ms": (16, 16, 1024, 512, 4),
    "deproject_roofline_ms": (480, 640),
    "bspline_design_roofline_ms": (6400, 16),
    "bspline_curvature_roofline_ms": (100, 16),
    "jpeg_dequant_roofline_ms": (7200, 8),
    "jpeg_idct_roofline_ms": (7200, 8),
    "chroma_upsample_roofline_ms": (480, 640, 2),
    "ycbcr_to_rgb_roofline_ms": (480, 640, 2),
    "jpeg_decode_roofline_ms": (480, 640, 8),
    "mask_bitpack_roofline_ms": (480, 640, 8),
}


@pytest.mark.parametrize("name", sorted(JAX_ROOFLINES))
def test_roofline_counts_equal_the_jax_module(name):
    args = JAX_ROOFLINES[name]
    got, want = getattr(flops, name)(*args), getattr(jflops, name)(*args)
    assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"])
    # the bound at the port's H100 peaks
    assert got["compute_ms"] == pytest.approx(
        got["flops"] / (flops.H100_PEAK_BF16_TFLOPS * 1e12) * 1e3)
    assert got["memory_ms"] == pytest.approx(
        got["bytes"] / (flops.H100_HBM_GBPS * 1e9) * 1e3)


def test_every_jax_function_has_its_port():
    names = {n for n, f in inspect.getmembers(jflops, inspect.isfunction)
             if f.__module__ == jflops.__name__}
    assert names <= set(dir(flops))
    assert names - {"roofline_ms", "mfu", "unet_forward_flops",
                    "unet_train_step_flops"} == set(JAX_ROOFLINES)
    for subs in ({"jpeg_decode_roofline_ms": (480, 640, 1, "444")},
                 {"jpeg_decode_roofline_ms": (480, 640, 1, "422")}):
        for name, args in subs.items():
            assert (getattr(flops, name)(*args)["flops"]
                    == getattr(jflops, name)(*args)["flops"])
    assert flops.mfu(1e12, 1.0, 100.0) == jflops.mfu(1e12, 1.0, 100.0)
    assert flops.roofline_ms(5, 7, 1.0, 1.0) == jflops.roofline_ms(
        5, 7, 1.0, 1.0)


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("base,img", [(64, 256), (8, 64)])
def test_unet_counts_equal_the_jax_module(bilinear, base, img):
    for fn in ("unet_forward_flops",):
        assert (getattr(flops, fn)(img, base, bilinear=bilinear)
                == getattr(jflops, fn)(img, base, bilinear=bilinear))
    assert (flops.unet_train_step_flops(4, img, base, bilinear=bilinear)
            == jflops.unet_train_step_flops(4, img, base, bilinear=bilinear))


@pytest.mark.parametrize("bilinear", [True, False])
def test_unet_forward_flops_equal_the_flop_counter(bilinear):
    """The analytic count against PyTorch's own counter over the plain
    forward (its convs, the upsample's contractions or the transposed
    convs, and the head's matmul)."""
    from torch.utils.flop_counter import FlopCounterMode

    net = tunet.UNet(config.ModelConfig(base_features=8,
                                        compute_dtype="float32",
                                        bilinear=bilinear)).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(torch.rand(1, 64, 64, 3))
    assert counter.get_total_flops() == flops.unet_forward_flops(
        64, 8, bilinear=bilinear)


# the bounds chip_smoke.py printed before they moved into utils/flops
# (H100 SXM peaks; ms and the word of the bound), at main-path shapes
PRINTED_BOUNDS = [
    ("conv3x3_bn_relu_cost", (1, 256, 256, 64, 64, 2), "bf16",
     (2.0 * 256 * 256 * 9 * 64 * 64,
      (256 * 256 * 64 + 9 * 64 * 64 + 256 * 256 * 64) * 2 + 8 * 64)),
    ("conv1x1_cost", (1, 256, 256, 64, 1, 2, 4), "bf16",
     (2.0 * 256 * 256 * 64, (256 * 256 * 64 + 64) * 2 + 8 + 256 * 256 * 4)),
    ("conv_transpose2x2_cost", (8, 16, 16, 1024, 512, 2), "bf16",
     (2.0 * 8 * 16 * 16 * 1024 * 4 * 512,
      (8 * 16 * 16 * 1024 + 4 * 1024 * 512 + 4 * 8 * 16 * 16 * 512) * 2
      + 4 * 512)),
    ("deproject_edge_stats_cost", (480, 640), "f32",
     (10.0 * 480 * 640, 480 * 640 * 18 + 40)),
    ("bspline_design_cost", (6400, 16, 20, 3), "f64",
     (2.0 * 6400 * (16 + 12), 8 * (6400 * 5 + 20 + 256 + 48))),
    ("bitpack_mask_cost", (8, 480, 640), "f32",
     (16.0 * 8 * 480 * 80, 8 * 480 * 640 + 8 * 480 * 80)),
    ("dequant_idct_cost", (8, 4800), None,
     (8 * 4800 * (16 * 62 + 64 * 4), 8 * 4800 * 64 * 6 + 8 * 64 * 4 + 256)),
]


@pytest.mark.parametrize("name,args,peak,want",
                         PRINTED_BOUNDS, ids=[b[0] for b in PRINTED_BOUNDS])
def test_kernel_costs_are_the_arithmetic_chip_smoke_printed(name, args,
                                                           peak, want):
    got = getattr(flops, name)(*args)
    assert got == pytest.approx(want, rel=0, abs=0)
    if peak is not None:
        rate = {"bf16": flops.H100_BF16_FLOPS, "f32": flops.H100_F32_FLOPS,
                "f64": flops.H100_F64_FLOPS}[peak]
        t_ops, t_bytes = want[0] / rate, want[1] / 3.35e12
        assert flops.bound_ms(*got, rate) == (
            max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def test_train_conv_costs_and_the_int32_rate():
    costs = flops.train_conv_costs(4, 128, 128, 256)
    act = 4 * 128 * 128 * 2
    f = 2.0 * 4 * 128 * 128 * 9 * 128 * 256
    assert costs == {
        "dw": (f, act * (128 + 256) + 9 * 128 * 256 * 4),
        "fwd": (f, act * (128 + 256) + 9 * 128 * 256 * 2 + 8 * 256),
        "dx": (f, act * (128 + 256) + 9 * 128 * 256 * 2 + 8 * 128),
    }
    assert flops.bspline_curvature_cost(100, 16, 20, 3) == (
        float(2 * 3 * (2 * 17 + 3 * 18) + 100 * (2 * 3 * 9 + 40)),
        float(4 * (48 + 100 + 20 + 34 + 54) + 100 * 17))
    assert flops.int32_ops_per_s(132, 1980.0) == 132 * 64 * 1980e6


# -- utils/transferguard -------------------------------------------------------------


@pytest.mark.parametrize("raw", ["", "off", "strict", "STRICT", "disallow",
                                 "1", "true", "on", "log", "warn", "bogus"])
def test_guard_mode_parsing_matches_jax(raw, monkeypatch):
    monkeypatch.setenv("RDP_TRANSFER_GUARD", raw)
    assert (transferguard.resolve_transfer_guard()
            == jguard.resolve_transfer_guard())


@pytest.fixture()
def sync_modes(monkeypatch):
    """``torch.cuda.set_sync_debug_mode`` stubbed: the modes set, in
    order; ``sync()`` stands for a synchronising call, raising in "error"
    and recording a warning in "warn", as the card's PyTorch does."""
    modes: list = []
    monkeypatch.setattr(transferguard, "_set_mode", modes.append)
    monkeypatch.setattr(transferguard, "_MODE", transferguard._ProcessMode())
    warned: list = []

    def sync():
        current = transferguard._MODE.current
        if current == "error":
            raise RuntimeError("called a synchronizing CUDA operation")
        if current == "warn":
            warned.append(True)

    return modes, sync, warned


def test_guard_off_adds_nothing():
    fn = lambda x: x  # noqa: E731
    assert transferguard.apply(fn, "off") is fn
    with pytest.raises(ValueError, match="unknown transfer guard mode"):
        transferguard.apply(fn, "sometimes")


def test_strict_guard_exempts_the_first_call_per_signature(sync_modes):
    modes, sync, _ = sync_modes
    calls: list = []

    def hot(x, inject):
        calls.append(transferguard._MODE.current)
        if inject:
            sync()
        return x

    guarded = transferguard.apply(hot, "strict")
    assert guarded.__transfer_guard__ == "strict"
    a, b = np.zeros((2, 3), np.float32), np.zeros((4, 3), np.float32)
    guarded(a, True)  # cold: compiles and syncs by design
    guarded(a, False)
    with pytest.raises(RuntimeError, match="synchronizing"):
        guarded(a, True)
    guarded(b, True)  # a new shape: cold again
    assert calls == ["default", "error", "error", "default"]
    assert modes == ["error", "default", "error", "default"]
    assert transferguard._MODE.current == "default"


def test_log_guard_warns_and_goes_on(sync_modes):
    modes, sync, warned = sync_modes
    guarded = transferguard.apply(lambda: sync(), "log")
    guarded()
    guarded()
    assert warned == [True] and modes == ["warn", "default"]


def test_an_exempt_call_turns_the_guard_off_for_its_length(sync_modes):
    """The mode is process-wide: while one thread's guarded call runs, an
    exempt (warm-up) call on another thread turns it off until it
    returns, and the strictest guarded call in flight wins."""
    import threading

    modes, sync, _ = sync_modes
    inside, release = threading.Event(), threading.Event()

    def slow(x):
        inside.set()
        release.wait(5)

    guarded = transferguard.apply(slow, "strict")
    guarded(1)
    worker = threading.Thread(target=guarded, args=(1,))
    worker.start()
    inside.wait(5)
    assert transferguard._MODE.current == "error"
    cold = transferguard.apply(lambda: sync(), "strict")
    cold()  # exempt: does not raise while the other call is guarded
    assert transferguard._MODE.current == "error"
    release.set()
    worker.join(5)
    assert transferguard._MODE.current == "default"
    assert modes == ["error", "default", "error", "default"]


def test_the_hot_entries_are_guarded(sync_modes, monkeypatch):
    """Under ``RDP_TRANSFER_GUARD=strict`` the pipeline's analyzers and the
    trainer's steps come back guarded; attribute reads pass through, a
    frame analyzer answers as unguarded, and a step graph's warm-up,
    capture and first replay are exempt."""
    from robotic_discovery_platform_tpu_torch.io.frames import render_scene
    from robotic_discovery_platform_tpu_torch.ops import graphs, pipeline
    from robotic_discovery_platform_tpu_torch.ops.unet_infer import (
        FoldedUNet,
    )
    from robotic_discovery_platform_tpu_torch.serving.ingest import (
        default_intrinsics,
    )
    from robotic_discovery_platform_tpu_torch.training import trainer

    modes, _, _ = sync_modes
    net = tunet.UNet(config.ModelConfig(base_features=4,
                                        compute_dtype="float32"))
    forward = FoldedUNet(net.init_weights(torch.Generator().manual_seed(0)),
                         device="cpu")
    rgb, _, depth = render_scene(np.random.default_rng(0), 48, 64)
    k = default_intrinsics(64, 48)
    plain = pipeline.make_frame_analyzer(forward, img_size=32, device="cpu")
    monkeypatch.setenv("RDP_TRANSFER_GUARD", "strict")
    analyze = pipeline.make_frame_analyzer(forward, img_size=32,
                                           device="cpu", pack=True)
    assert analyze.__transfer_guard__ == "strict"
    assert analyze.graphs is analyze.__wrapped__.graphs
    want = pipeline.make_frame_analyzer(forward, img_size=32, device="cpu",
                                        pack=True).eager(rgb, depth, k, 0.001)
    for _ in range(3):
        np.testing.assert_array_equal(analyze(rgb, depth, k, 0.001), want)
    assert modes == ["error", "default", "error", "default"]
    assert not hasattr(plain, "__transfer_guard__")
    for make in (pipeline.make_batch_analyzer,
                 pipeline.make_scan_batch_analyzer):
        assert make(forward, img_size=32,
                    device="cpu").__transfer_guard__ == "strict"

    step = graphs.StepGraph(lambda: None, graphs.recompile.capture_guard(
        "test.guarded_step", None), torch.device("cpu"))
    stages = []
    guarded = trainer.ScanEpochs._guarded(step)
    for _ in range(3):
        stages.append(step.stage)
        guarded()
    assert stages == ["warm-up", "eager", "eager"]
