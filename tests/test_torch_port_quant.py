"""The port's precision tiers (ops/quant.py, the servicer's warm-up parity
gate) against the JAX package's ``ops/pallas/quant.py``, on the CPU.

Seeded weights go through both packages as the same numpy tree.
Tolerances, fixed before measuring:

- int8 codes, scales, dequantized kernels and the quantization report:
  bitwise / exactly equal (every step is a correctly rounded float32
  operation in both packages);
- the tiers' forwards at ``tests/test_quant.py``'s fixture (base 8,
  64x64, a float32 model with its head bias moved to the median logit):
  the f32 tier atol = rtol = 2e-4, the bf16 and int8 tiers relative L2 of
  the logits <= 2e-2 (tests/test_torch_port_model.py's bars). Logits, not
  masks: at the median logit, bf16 masks flip between summation orders;
- ``parity_report`` and ``parity_gates_pass``: equal results on equal
  inputs;
- a trained net's tier reports at the camera's 480x640
  (``test_trained_tier_gate_matches_jax_at_camera_size``): mean mask IoU
  within 2e-3 and worst |d curvature| within 1% of the JAX package's,
  and the same verdict at the default bars (set after a first
  measurement, which differed by at most 6.3e-4 and 0.04%: the two
  forwards' float32 sums flip a few mask pixels at the threshold);
- the servicer's gate report against the same report computed apart
  (reference and tier analyzers run eagerly): equal.

The mask IoU of each tier against f32 is recorded for both packages
(``test_tier_iou_figures``, printed with ``-s``), not gated: the JAX
package's own bar there (``tests/test_quant.py``, IoU >= 0.98) is missed
by its int8 tier.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.ops import pipeline as jpipeline
from robotic_discovery_platform_tpu.ops.pallas import quant as jquant
from robotic_discovery_platform_tpu.ops.pallas.unet_infer import PallasUNet
from robotic_discovery_platform_tpu.utils.config import (
    ModelConfig as JaxModelConfig,
)
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.models.unet import UNet
from robotic_discovery_platform_tpu_torch.ops import pipeline, quant
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import ingest, server
from robotic_discovery_platform_tpu_torch.utils.config import (
    ModelConfig,
    ServerConfig,
)

IMG = 64
BASE = 8
INTR = np.asarray(
    [[0.94 * IMG, 0, IMG / 2], [0, 0.94 * IMG, IMG / 2], [0, 0, 1]],
    np.float32,
)
CFG = ModelConfig(base_features=BASE, compute_dtype="float32")
NAME = "Actuator-Segmenter"
#: the serving camera's (height, width)
CAMERA = (480, 640)


#: the trained fixture net's 60 Adam steps (lr 1e-3, batches of 8, bce)
#: on 64 synthetic scenes at 64x64, its state dict saved to argv[1]: run
#: by a child interpreter (``training_child``)
_TRAIN_SCRIPT = """
import sys
import numpy as np
import torch
from robotic_discovery_platform_tpu_torch.models import losses
from robotic_discovery_platform_tpu_torch.training import synthetic, trainer
from robotic_discovery_platform_tpu_torch.utils.config import ModelConfig

torch.manual_seed(0)
net = trainer.init_model(ModelConfig(base_features=8, compute_dtype="float32"),
                         0, torch.device("cpu"))
xs, ys = trainer.normalize_arrays(*synthetic.generate_arrays(64, 64, 64,
                                                             seed=0))
xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
optimizer = trainer.make_optimizer(net, 1e-3)
loss_fn = losses.make_loss_fn("bce")
order = np.random.default_rng(0)
for _ in range(60):
    idx = torch.from_numpy(order.choice(len(xs), 8, replace=False))
    trainer.train_step(net, optimizer, loss_fn, xs[idx], ys[idx])
np.savez(sys.argv[1], **{k: v.numpy() for k, v in net.state_dict().items()})
"""


@pytest.fixture(scope="module", autouse=True)
def training_child(tmp_path_factory):
    """The trained fixture net's training, started with the module so it
    runs beside the tests before the camera tests, in a child interpreter
    on this process's own intra-op thread count: training's float sums
    split by thread count, and the camera tests' bars were set on the net
    trained so. Its threads sleep rather than spin while they wait for
    each other (``OMP_WAIT_POLICY``; the same sums, so the same net),
    which under loaded neighbours took the 60 steps from about 600 s to
    260. Yields the child and the file it writes."""
    out = tmp_path_factory.mktemp("trained") / "state.npz"
    child = subprocess.Popen(
        [sys.executable, "-c", _TRAIN_SCRIPT, str(out)],
        cwd=Path(__file__).resolve().parent.parent,
        env={**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads()),
             "OMP_WAIT_POLICY": "PASSIVE"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield child, out
    if child.returncode is None:  # nobody waited for it
        child.kill()
        child.communicate()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread(training_child):
    """Torch on one intra-op thread for this module. The suite runs in
    several worker processes at once, each with torch's pool of one
    thread per core: oversubscribed, the pools' threads wait on each
    other at every small op (the camera fixtures' 60 training steps took
    about 10 s each instead of 0.12, and their setup was billed 913 s in
    a six-worker run, 17 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_model_and_vars():
    """``tests/test_quant.py``'s ``model_and_vars``: numpy leaves."""
    model = build_unet(JaxModelConfig(base_features=BASE,
                                      compute_dtype="float32"))
    variables = jax.jit(lambda k: init_unet(model, k, img_size=IMG))(
        jax.random.key(0))
    return model, jax.tree.map(np.asarray, variables)


@pytest.fixture(scope="module")
def confident_vars(jax_model_and_vars):
    """``tests/test_quant.py``'s ``confident_vars``: the head bias moved to
    the median logit of golden frame 0, so masks are not empty."""
    model, variables = jax_model_and_vars
    frame, _ = jquant.golden_frames(1, IMG, IMG)[0]
    x = jpipeline.preprocess(jnp.asarray(frame)[None], IMG)
    logits = model.apply(variables, x, train=False)
    flat = flax.traverse_util.flatten_dict(variables)
    key = ("params", "Conv_0", "bias")
    flat[key] = np.asarray(flat[key] - jnp.median(logits))
    return flax.traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def trained_vars(training_child):
    """The fixture's model trained for 60 Adam steps (lr 1e-3, batches of
    8, bce) on 64 synthetic scenes at 64x64 (``_TRAIN_SCRIPT``), as numpy
    Flax variables: its masks follow the actuator, as a served model's do
    (train loss about 0.4 from 0.7)."""
    child, out = training_child
    log, _ = child.communicate()
    assert child.returncode == 0, log.decode(errors="replace")
    with np.load(out) as state:
        net = UNet(CFG)
        net.load_state_dict({k: torch.from_numpy(state[k])
                             for k in state.files})
    return weights.to_flax_variables(net.eval())


def _bits(a) -> np.ndarray:
    """An array's bytes, for a bitwise comparison."""
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- quantization -------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [
    ((3, 3, 8, 16), -1), ((2, 2, 8, 4), -1), ((1, 1, 8, 1), -1),
    ((16, 8), -1), ((4, 6), 0)])
def test_quantize_int8_matches_jax(shape, axis):
    """Codes and scales bit for bit, with one all-zero channel (scale 1)
    and a value exactly half a step from a grid point."""
    rng = np.random.default_rng(int(np.prod(shape)))
    w = rng.normal(size=shape).astype(np.float32)
    zero = [slice(None)] * len(shape)
    zero[axis] = 0
    w[tuple(zero)] = 0.0
    if shape[axis] > 1:  # channel 1's first value at half a step
        w = np.moveaxis(w, axis, -1).copy()
        step = np.abs(w[..., 1]).max() / np.float32(127)
        w.reshape(-1, shape[axis])[0, 1] = np.float32(0.5) * step
        w = np.moveaxis(w, -1, axis).copy()
    q, scale = quant.quantize_int8(torch.from_numpy(w), axis)
    jq, jscale = jquant.quantize_int8(jnp.asarray(w), axis)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == jscale.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(jscale))
    assert float(scale.reshape(-1)[0]) == 1.0  # the zero channel
    np.testing.assert_array_equal(
        _bits(quant.dequantize_int8(q, scale).numpy()),
        _bits(jquant.dequantize_int8(jq, jscale)))
    np.testing.assert_array_equal(
        _bits(quant.fake_quantize_int8(torch.from_numpy(w), axis).numpy()),
        _bits(jquant.fake_quantize_int8(jnp.asarray(w), axis)))


@pytest.mark.parametrize("bilinear", [True, False])
def test_quantize_unet_variables_matches_jax(bilinear):
    """The same report, and every quantized kernel bit for bit through
    ``from_flax_variables``; each kernel is quantized along its output
    channels (HWIO's last axis: the 1x1 head and the transposed convs
    included), every other entry untouched."""
    jcfg = JaxModelConfig(base_features=4, bilinear=bilinear,
                          compute_dtype="float32")
    model = build_unet(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: init_unet(model, k, img_size=32))(jax.random.key(1)))
    jq, jreport = jquant.quantize_unet_variables(variables)
    state = weights.from_flax_variables(variables)
    got, report = quant.quantize_unet_variables(state)
    assert report == jreport
    want = weights.from_flax_variables(jax.tree.map(np.asarray, jq))
    assert set(got) == set(want) == set(state)
    kernels = [k for k in state if k.endswith(".kernel")]
    assert report["layers"] == len(kernels) > 0
    if not bilinear:
        assert any("ConvTranspose_0" in k for k in kernels)
    assert "Conv_0.kernel" in kernels  # the 1x1 head
    for key in state:
        np.testing.assert_array_equal(_bits(got[key].numpy()),
                                      _bits(want[key].numpy()), err_msg=key)
        if key in kernels:
            w = state[key]
            _, scale = quant.quantize_int8(w)
            assert scale.shape == (1,) * (w.dim() - 1) + (w.shape[-1],), key
            assert not torch.equal(got[key], w), key
        else:
            assert got[key] is state[key], key


def test_apply_precision_tiers(jax_model_and_vars):
    _, variables = jax_model_and_vars
    net = weights.unet_from_flax_variables(CFG, variables)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    same, report = quant.apply_precision(net, "f32")
    assert same is net and report is None
    bf16, report = quant.apply_precision(net, "bf16")
    assert bf16 is not net and report == {"tier": "bf16", "layers": 0}
    assert bf16.cfg == dataclasses.replace(CFG, compute_dtype="bfloat16")
    assert bf16.dtype == torch.bfloat16 and not bf16.training
    for k, v in bf16.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    int8, report = quant.apply_precision(net, "int8")
    assert int8.cfg.compute_dtype == "bfloat16"
    _, jreport = jquant.quantize_unet_variables(variables)
    assert report == {**jreport, "tier": "int8"}
    qstate, _ = quant.quantize_unet_variables(before)
    for k, v in int8.state_dict().items():
        assert torch.equal(v, qstate[k]), k
    for k, v in net.state_dict().items():  # the input net is untouched
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="unknown precision"):
        quant.apply_precision(net, "fp4")


@pytest.mark.parametrize("cfg_value,env", [
    ("f32", None), ("f32", ""), ("f32", "int8"), ("bf16", None),
    ("int8", "f32"), ("F32", " BF16 "), ("f32", "tf32"), ("fp4", None)])
def test_resolve_precision_as_jax(cfg_value, env, monkeypatch):
    """``RDP_PRECISION`` overrides the field, as in the JAX package."""
    if env is None:
        monkeypatch.delenv("RDP_PRECISION", raising=False)
    else:
        monkeypatch.setenv("RDP_PRECISION", env)
    try:
        want = jquant.resolve_precision(cfg_value)
    except ValueError as exc:
        with pytest.raises(ValueError, match="unknown precision"):
            quant.resolve_precision(cfg_value)
        assert "unknown precision" in str(exc)
    else:
        assert quant.resolve_precision(cfg_value) == want
    assert (quant.resolve_precision("f32", env="int8")
            == jquant.resolve_precision("f32", env="int8") == "int8")


# -- the tiers' forwards ------------------------------------------------------


@pytest.mark.parametrize("form", ["unet", "folded"])
@pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
def test_tier_forward_matches_jax(tier, form, jax_model_and_vars,
                                  confident_vars):
    """Each tier's logits on the golden frames against the JAX tier's: the
    unfolded net against ``UNet.apply``, the folded forward (plain ops on
    the CPU) against the JAX package's folded forward on its XLA convs
    (``PallasUNet(force="xla")``, which rounds at the same points)."""
    model, _ = jax_model_and_vars
    m, v, _ = jquant.apply_precision(model, confident_vars, tier)
    net, _ = quant.apply_precision(
        weights.unet_from_flax_variables(CFG, confident_vars), tier)
    folded = FoldedUNet(net, device="cpu")
    for frame, _ in jquant.golden_frames(2, IMG, IMG):
        x = np.array(jpipeline.preprocess(jnp.asarray(frame)[None], IMG))
        if form == "unet":
            want = np.asarray(m.apply(v, jnp.asarray(x), train=False),
                              np.float32)
        else:
            want = np.asarray(PallasUNet(m, v, force="xla")(jnp.asarray(x)),
                              np.float32)
        with torch.no_grad():
            xt = torch.from_numpy(x)
            got = (net(xt) if form == "unet" else folded(xt)).numpy()
        assert got.shape == want.shape == (1, IMG, IMG, 1)
        if tier == "f32":
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
        else:
            assert _rel_l2(got, want) <= 2e-2, (tier, form,
                                                _rel_l2(got, want))


def test_tier_iou_figures(jax_model_and_vars, confident_vars):
    """Each tier's parity report against f32 on four golden frames, the
    JAX package's (its analyzer, ``tests/test_quant.py``'s test) beside
    the port's (the folded forward the servicer runs), printed as one JSON
    line per tier. Recorded, not gated (module docstring); the frames must
    carry masks that are neither empty nor full."""
    model, _ = jax_model_and_vars
    frames = jquant.golden_frames(4, IMG, IMG)
    jouts, touts = {}, {}
    for tier in ("f32", "bf16", "int8"):
        m, v, _ = jquant.apply_precision(model, confident_vars, tier)
        janalyze = jpipeline.make_frame_analyzer(m, img_size=IMG)
        jouts[tier] = [janalyze(v, f, d, INTR, np.float32(0.001))
                       for f, d in frames]
        net, _ = quant.apply_precision(
            weights.unet_from_flax_variables(CFG, confident_vars), tier)
        analyze = pipeline.make_frame_analyzer(
            FoldedUNet(net, device="cpu"), img_size=IMG, device="cpu")
        touts[tier] = [analyze(f, d, INTR, 0.001) for f, d in frames]
    coverage = [float(o.mask_coverage) for o in touts["f32"]]
    print(json.dumps({"port_f32_coverage": coverage}))
    assert sum(0 < c < 100 for c in coverage) >= 2, coverage
    for tier in ("bf16", "int8"):
        jrep = jquant.parity_report(jouts["f32"], jouts[tier])
        rep = quant.parity_report(touts["f32"], touts[tier])
        print(json.dumps({"tier": tier, "jax": jrep, "port": rep}))
        assert rep["frames"] == jrep["frames"] == 4
        assert 0.0 < rep["mask_iou_min"] <= rep["mask_iou_mean"] <= 1.0
        assert np.isfinite(rep["curvature_err_max"])


@pytest.fixture(scope="module")
def camera_outputs(jax_model_and_vars, trained_vars):
    """The trained net's analyses of four golden frames at the camera's
    480x640 (focal-length default intrinsics, depth scale 0.001), per
    tier: the JAX package's analyzer and the port's."""
    model, _ = jax_model_and_vars
    h, w = CAMERA
    k = ingest.default_intrinsics(w, h).astype(np.float32)
    frames = quant.golden_frames(4, h, w)
    jouts, touts = {}, {}
    for tier in ("f32", "bf16", "int8"):
        m, v, _ = jquant.apply_precision(model, trained_vars, tier)
        janalyze = jpipeline.make_frame_analyzer(m, img_size=IMG)
        jouts[tier] = [janalyze(v, f, d, k, np.float32(0.001))
                       for f, d in frames]
        net, _ = quant.apply_precision(
            weights.unet_from_flax_variables(CFG, trained_vars), tier)
        analyze = pipeline.make_frame_analyzer(
            FoldedUNet(net, device="cpu"), img_size=IMG, device="cpu")
        touts[tier] = [analyze(f, d, k, 0.001) for f, d in frames]
    return jouts, touts


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_trained_tier_gate_matches_jax_at_camera_size(tier, camera_outputs):
    """A trained net's tier against f32 at the served camera size, the JAX
    package's report beside the port's (one JSON line each with ``-s``,
    with each frame's f32 curvature): within the module's bars, and the
    same verdict at the default gate. The curvature of a 480x640 top edge
    reaches thousands of 1/m where the edge kinks, in both packages, so a
    tier that moves a few edge pixels moves it by far more than the 0.5
    ceiling."""
    jouts, touts = camera_outputs
    coverage = [float(o.mask_coverage) for o in touts["f32"]]
    assert sum(0 < c < 100 for c in coverage) >= 2, coverage
    jrep = jquant.parity_report(jouts["f32"], jouts[tier])
    rep = quant.parity_report(touts["f32"], touts[tier])
    print(json.dumps({
        "tier": tier, "camera": CAMERA, "coverage": coverage,
        "f32_curvature": [[float(o.profile.mean_curvature),
                           float(o.profile.max_curvature)]
                          for o in touts["f32"]],
        "jax": jrep, "port": rep}))
    assert rep["frames"] == jrep["frames"] == 4
    assert rep["valid_agreement"] == jrep["valid_agreement"]
    assert rep["mask_iou_mean"] < 1.0  # the tier moves the masks
    assert abs(rep["mask_iou_mean"] - jrep["mask_iou_mean"]) <= 2e-3
    assert rep["curvature_err_max"] == pytest.approx(
        jrep["curvature_err_max"], rel=1e-2)
    cfg = ServerConfig()
    bars = (cfg.quant_parity_min_iou, cfg.quant_parity_max_curv_err)
    assert (quant.parity_gates_pass(rep, *bars)
            == jquant.parity_gates_pass(jrep, *bars))


# -- parity metrics -----------------------------------------------------------


def _outputs(valids, means, masks):
    """FrameAnalysis-like records: numpy leaves for the JAX package's
    report, tensors for the port's."""
    def one(v, k, m, to):
        prof = types.SimpleNamespace(valid=to(np.bool_(v)),
                                     mean_curvature=to(np.float32(k)),
                                     max_curvature=to(np.float32(2 * k)))
        return types.SimpleNamespace(mask=to(m), profile=prof)

    return ([one(*a, np.asarray) for a in zip(valids, means, masks)],
            [one(*a, torch.as_tensor) for a in zip(valids, means, masks)])


def test_parity_report_and_gate_match_jax():
    rng = np.random.default_rng(5)
    masks = [(rng.random((8, 8)) < p).astype(np.uint8)
             for p in (0.0, 0.3, 0.5, 0.9, 0.0)]
    flip = [m.copy() for m in masks]
    flip[1][0, :] ^= 1
    flip[3][:, 2] ^= 1
    ref_j, ref_t = _outputs([True, True, False, True, False],
                            [0.5, 1.25, 0.0, 3.0, 0.0], masks)
    got_j, got_t = _outputs([True, False, False, True, True],
                            [0.75, 0.0, 0.0, 2.5, 0.125], flip)
    want = jquant.parity_report(ref_j, got_j)
    got = quant.parity_report(ref_t, got_t)
    assert got == want
    assert quant.parity_report([], []) == jquant.parity_report([], [])
    for a, b in zip(masks, flip):
        assert quant.mask_iou(torch.from_numpy(a), b) == jquant.mask_iou(a, b)
    for iou in (0.0, want["mask_iou_mean"], 0.95, 1.01):
        for curv in (0.0, want["curvature_err_max"], 10.0):
            assert (quant.parity_gates_pass(got, iou, curv)
                    == jquant.parity_gates_pass(want, iou, curv))


def test_golden_frames_match_jax():
    for (f, d), (jf, jd) in zip(quant.golden_frames(3, 48, 64, seed=2),
                                jquant.golden_frames(3, 48, 64, seed=2)):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(d, jd)


# -- the servicer -------------------------------------------------------------


def _registry(tmp_path, variables) -> str:
    uri = f"file:{tmp_path}/mlruns"
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    with tracking.start_run():
        tracking.log_model(variables, CFG, registered_model_name=NAME)
    tracking.store_for(uri).set_alias(NAME, "staging", 1)
    return uri


def _server_cfg(tmp_path, uri, **kw) -> ServerConfig:
    return ServerConfig(model_img_size=IMG, tracking_uri=uri,
                        metrics_csv=str(tmp_path / "metrics.csv"),
                        calibration_path=str(tmp_path / "none.npz"), **kw)


def _gate_apart(variables, tier, service) -> tuple[dict, list]:
    """The gate's comparison made apart from the servicer: golden frames
    at the camera size through the f32 and ``tier`` analyzers of
    ``variables``, run eagerly; the report and the f32 coverages."""
    h, w = CAMERA
    net = weights.unet_from_flax_variables(CFG, variables)
    k, scale = service._camera(w, h), np.float32(service.depth_scale)
    frames = quant.golden_frames(service.cfg.quant_parity_frames, h, w)
    outs = {}
    for t in ("f32", tier):
        served, _ = quant.apply_precision(net, t)
        analyze = pipeline.make_frame_analyzer(
            FoldedUNet(served, device="cpu"), img_size=IMG, device="cpu")
        outs[t] = [analyze.eager(f, d, k, scale) for f, d in frames]
    return (quant.parity_report(outs["f32"], outs[tier]),
            [float(o.mask_coverage) for o in outs["f32"]])


@pytest.mark.parametrize("path", ["direct", "batched"])
def test_server_warmup_parity_gate_passes(path, trained_vars,
                                          tmp_path, monkeypatch):
    """``tests/test_quant.py::test_server_warmup_parity_gate_passes``: an
    int8 servicer from the registry warms up through its gate, on the
    direct path and through the dispatcher, at the camera's 480x640.

    The net is trained and its int8 tier moves the golden frames' masks
    (IoU < 1 on non-trivial masks), which the default bars refuse
    (``test_trained_tier_gate_matches_jax_at_camera_size``). So the bars
    sit at the report of the same comparison made apart: the gate passes
    and keeps that very report, and a floor a hair above it refuses."""
    monkeypatch.delenv("RDP_PRECISION", raising=False)
    uri = _registry(tmp_path, trained_vars)
    cfg = _server_cfg(tmp_path, uri, precision="int8",
                      batch_window_ms=2.0 if path == "batched" else 0.0,
                      max_batch=2)
    h, w = CAMERA
    probe = server.build_service(cfg, device="cpu")
    try:
        want, coverage = _gate_apart(trained_vars, "int8", probe)
    finally:
        probe.close()
    assert sum(0 < c < 100 for c in coverage) >= 2, coverage
    assert want["mask_iou_min"] < 1.0, want
    bars = dict(quant_parity_min_iou=want["mask_iou_mean"],
                quant_parity_max_curv_err=want["curvature_err_max"])
    service = server.build_service(dataclasses.replace(cfg, **bars),
                                   warmup_shape=(w, h), device="cpu")
    try:
        assert service.precision == "int8"
        assert service.parity is not None
        assert service.parity["frames"] == cfg.quant_parity_frames
        assert service.parity == want
        # the gate's reference is the registered net, untransformed
        assert service._pristine.cfg == CFG
        got = service.analyze_frame(*quant.golden_frames(1, h, w)[0])
        assert got.mask_bytes
    finally:
        service.close()
    bars["quant_parity_min_iou"] += 1e-9
    with pytest.raises(RuntimeError, match="parity gate"):
        server.build_service(dataclasses.replace(cfg, **bars),
                             warmup_shape=(w, h), device="cpu")


def test_server_warmup_parity_gate_fails_closed(jax_model_and_vars,
                                                tmp_path, monkeypatch):
    """An unsatisfiable IoU floor keeps the servicer from coming up."""
    monkeypatch.delenv("RDP_PRECISION", raising=False)
    _, variables = jax_model_and_vars
    uri = _registry(tmp_path, variables)
    cfg = _server_cfg(tmp_path, uri, precision="int8",
                      quant_parity_min_iou=1.01)
    with pytest.raises(RuntimeError, match="parity gate"):
        server.build_service(cfg, warmup_shape=(IMG, IMG), device="cpu")
    service = server.build_service(cfg, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="parity gate"):
            service.warmup(IMG, IMG)
        assert service.parity is None
    finally:
        service.close()


def test_f32_tier_skips_gate(jax_model_and_vars, tmp_path, monkeypatch):
    """At f32 the gate does nothing and the registered net is served
    untransformed; a caller's own forward serves only at f32."""
    monkeypatch.delenv("RDP_PRECISION", raising=False)
    _, variables = jax_model_and_vars
    uri = _registry(tmp_path, variables)
    cfg = _server_cfg(tmp_path, uri, quant_parity_min_iou=1.01)
    service = server.build_service(cfg, warmup_shape=(IMG, IMG),
                                   device="cpu")
    try:
        assert service.precision == "f32" and service.parity is None
        assert service._pristine is None
    finally:
        service.close()
    folded = FoldedUNet(weights.unet_from_flax_variables(CFG, variables),
                        device="cpu")
    for tier in ("bf16", "int8"):
        with pytest.raises(ValueError, match="untransformed net"):
            server.build_service(dataclasses.replace(cfg, precision=tier),
                                 folded, device="cpu")


def test_rdp_precision_serves_the_tier(jax_model_and_vars, confident_vars,
                                       tmp_path, monkeypatch):
    """``RDP_PRECISION=int8`` over ``precision="f32"`` serves int8 through
    ``build_service``, as the JAX server does: the served frame is the
    int8 net's, not the f32 net's."""
    uri = _registry(tmp_path, confident_vars)
    cfg = _server_cfg(tmp_path, uri)
    monkeypatch.setenv("RDP_PRECISION", "int8")
    # no warm-up: at the median-logit head this int8 net fails the gate's
    # curvature ceiling (as the JAX package's does); the gate has its tests
    service = server.build_service(cfg, device="cpu")
    try:
        assert service.precision == "int8"
        assert service._pristine is not None
        monkeypatch.delenv("RDP_PRECISION")  # the references' own tiers
        net = weights.unet_from_flax_variables(CFG, confident_vars)
        rgb, depth = quant.golden_frames(1, IMG, IMG)[0]
        got = service.analyze_frame(rgb, depth, mask_format=1)
        masks = {}
        for tier in ("f32", "int8"):
            served, _ = quant.apply_precision(net, tier)
            analyze = pipeline.make_frame_analyzer(
                FoldedUNet(served, device="cpu"), img_size=IMG,
                device="cpu")
            masks[tier] = analyze(rgb, depth, service._camera(IMG, IMG),
                                  service.depth_scale).mask.numpy()
        assert not np.array_equal(masks["f32"], masks["int8"])
        bits = np.packbits(masks["int8"], axis=-1).tobytes()
        assert got.mask_bytes.endswith(bits)
    finally:
        service.close()
