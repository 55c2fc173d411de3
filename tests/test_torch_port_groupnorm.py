"""Group norm (``ModelConfig(norm="group")``) in the port against the JAX
package, on the CPU: the layer and the forward against Flax's
``nn.GroupNorm`` U-Net, one train step against the JAX step,
``train_model`` with checkpoints, resume and registration, weights
across in both directions, the folded forward's refusal (the JAX
``PallasUNet``'s error) and serving through ``model_forward="flax"``:
direct, batched, the scan dispatch, a hot reload and the bf16 tier.

The JAX package draws the variables (its own init, with scale in
[0.5, 1.5] and the norms' biases from a numpy seed so that they matter);
both packages get the same numpy tree.

Tolerances, fixed before measuring:
- the GroupNorm layer: float32 atol = rtol = 1e-5; bfloat16 atol = rtol =
  1e-2 (a bfloat16 ulp);
- the forward at base 8 and 64x64: float32 logits within 1e-4 max-abs,
  bfloat16 within 2e-2 relative L2;
- one train step (float32, ``conv_impl="interpret"``): loss rtol 1e-5,
  updated parameters relative L2 1e-4 (the batch-norm step's bars,
  tests/test_torch_port_training.py);
- weights and artifacts: bit for bit;
- served answers: statuses identical; each served mask the port's own
  forward's bit for bit, and the JAX servicer's outside the frame pixels
  of model pixels whose masks differ between the two forwards (a logit
  at the threshold, see ``_same``); on frames with none, every field as
  tests/test_torch_port_deploy.py holds them (packed mask payloads and
  coverage identical, curvature rtol 1e-3 where the JAX fit keeps every
  edge point, as tests/test_torch_port_pipeline.py compares);
- the bf16 tier's logits within 2e-2 relative L2 of the JAX tier's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models import losses as jlosses
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.ops.pallas import quant as jquant
from robotic_discovery_platform_tpu.ops.pallas.unet_infer import PallasUNet
from robotic_discovery_platform_tpu.serving import server as jserver
from robotic_discovery_platform_tpu.training import trainer as jtrainer
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import losses as tlosses
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.ops import conv
from robotic_discovery_platform_tpu_torch.ops.unet_infer import (
    FoldedUNet,
    reference_forward,
)
from robotic_discovery_platform_tpu_torch.serving import ingest
from robotic_discovery_platform_tpu_torch.serving import server as tserver
from robotic_discovery_platform_tpu_torch.training import checkpoint
from robotic_discovery_platform_tpu_torch.training import synthetic
from robotic_discovery_platform_tpu_torch.training import trainer
from robotic_discovery_platform_tpu_torch.utils import config

NAME = "Actuator-Segmenter"
SIZE, BASE = 64, 8
H, W = 120, 160


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


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _jcfg(dtype: str = "float32", **kw) -> jconfig.ModelConfig:
    return jconfig.ModelConfig(base_features=BASE, compute_dtype=dtype,
                               norm="group", **kw)


def _pcfg(dtype: str = "float32", **kw) -> config.ModelConfig:
    return config.ModelConfig(**dataclasses.asdict(_jcfg(dtype, **kw)))


def _variables(dtype: str = "float32", seed: int = 0, img: int = SIZE):
    """JAX-initialized group-norm variables (numpy leaves): scale drawn
    in [0.5, 1.5] and the norms' biases from a numpy seed."""
    model = build_unet(_jcfg(dtype))
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_unet(model, key, img))(jax.random.key(seed)))
    assert sorted(variables) == ["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        keys = [p.key for p in path]
        if keys[-1] == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if keys[-1] == "bias" and keys[-2].startswith("GroupNorm"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    return model, {"params": jax.tree_util.tree_map_with_path(
        leaf, variables["params"])}


def _input(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)


# -- the layer and the forward ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 48, 64])
def test_group_norm_layer_matches_flax(c, dtype):
    """``models/unet.GroupNorm`` against ``nn.GroupNorm(gcd(32, C))`` of
    Flax 0.12 (epsilon 1e-6, fast variance, float32 statistics) on the
    same input, scale and bias."""
    import math

    rng = np.random.default_rng(c)
    x = rng.normal(0.3, 1.5, (2, 9, 7, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.1, c).astype(np.float32)
    jdt = jnp.dtype(dtype)
    layer = fnn.GroupNorm(num_groups=math.gcd(32, c), dtype=jdt)
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(layer.apply(
        {"params": {"scale": scale, "bias": bias}}, xj).astype(jnp.float32))
    gn = tunet.GroupNorm(c, math.gcd(32, c))
    with torch.no_grad():
        gn.scale.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
            tunet.compute_dtype(dtype))
        got = gn(xt)
        assert got.dtype == xt.dtype
        assert torch.equal(gn(xt, train=True), got)  # no running state
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax(dtype):
    model, variables = _variables(dtype)
    x = _input()
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    net = weights.unet_from_flax_variables(_pcfg(dtype), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        # eval mode and the kernels' eval forward compute the same
        assert np.array_equal(
            tunet.eval_on_kernels(net)(torch.from_numpy(x)).numpy(), got)
    assert got.shape == want.shape == (1, SIZE, SIZE, 1)
    assert np.std(want) > 0.1  # a live network
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert _rel_l2(got, want) <= 2e-2


# -- training ---------------------------------------------------------------------

TINY = dict(conv_impl="interpret")


@pytest.fixture(scope="module")
def one_step():
    """One step of each package from the same group-norm variables on the
    same batch: the JAX ``core_train_step`` (custom-VJP Pallas convs in
    interpret mode, no batch statistics), the port's ``train_step`` on
    ``conv3x3``."""
    rng = np.random.default_rng(21)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    _, variables = _variables(img=32)
    model = build_unet(_jcfg(**TINY))
    tx = optax.adam(1e-3)
    state = jtrainer.TrainState(
        params=variables["params"], opt_state=tx.init(variables["params"]),
        batch_stats={}, epoch=jnp.asarray(0, jnp.int32),
        best_val_loss=jnp.asarray(jnp.inf, jnp.float32))
    step = jax.jit(jtrainer.core_train_step(model, tx,
                                            jlosses.bce_with_logits))
    jstate, jloss = step(state, jnp.asarray(x), jnp.asarray(y))
    want = {"loss": float(jloss),
            "params": _flat(jax.device_get(jstate.params))}

    net = tunet.UNet(_pcfg(**TINY))
    net.load_state_dict(weights.from_flax_variables(variables))
    opt = trainer.make_optimizer(net, 1e-3)
    before = (conv.conv3x3_bn_relu.launches,
              conv.conv3x3_grad_weights.launches)
    loss = trainer.train_step(net, opt, tlosses.bce_with_logits,
                              torch.from_numpy(x), torch.from_numpy(y))
    # CPU tensors take the training conv's plain versions: no launch
    assert (conv.conv3x3_bn_relu.launches,
            conv.conv3x3_grad_weights.launches) == before
    got = {"loss": float(loss),
           "params": {k: v.numpy() for k, v in net.state_dict().items()}}
    return got, want


def test_train_step_loss_matches_jax(one_step):
    got, want = one_step
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_train_step_updates_match_jax(one_step):
    got, want = one_step
    assert sorted(got["params"]) == sorted(want["params"])
    keys = sorted(want["params"])
    assert _rel_l2(np.concatenate([got["params"][k].ravel() for k in keys]),
                   np.concatenate([want["params"][k].ravel() for k in keys])
                   ) <= 1e-4


@pytest.fixture(scope="module")
def arrays():
    return synthetic.generate_arrays(16, 32, 32, seed=3)


def _train_cfgs(root, **kw):
    fields = dict(epochs=2, batch_size=4, img_size=32, learning_rate=1e-4,
                  validation_split=0.25, async_checkpointing=True)
    fields.update(kw)
    port = config.TrainConfig(tracking_uri=f"file:{root}/port/mlruns",
                              checkpoint_dir=f"{root}/port/ckpt", **fields)
    ref = jconfig.TrainConfig(tracking_uri=f"file:{root}/jax/mlruns",
                              checkpoint_dir=f"{root}/jax/ckpt", **fields)
    return port, ref


def _from_jax_init(monkeypatch):
    """The port's trainer starts from the JAX package's init."""
    def init_model(model_cfg, seed, device):
        model = build_unet(jconfig.ModelConfig(
            **dataclasses.asdict(model_cfg)))
        variables = jax.device_get(jax.jit(
            lambda key: init_unet(model, key, 32))(jax.random.key(seed)))
        net = tunet.UNet(model_cfg)
        net.load_state_dict(weights.from_flax_variables(variables))
        return net.to(device)

    monkeypatch.setattr(trainer, "init_model", init_model)


def _history(uri: str, run_id: str, store_for) -> dict:
    store = store_for(uri)
    return {key: [h["value"] for h in store.get_metric_history(run_id, key)]
            for key in ("train_loss", "val_loss")}


def test_train_model_checkpoints_and_registers(tmp_path, arrays,
                                              monkeypatch):
    """``train_model`` of a group-norm net over two epochs from the JAX
    init: finite losses, checkpoints without BatchNorm statistics, and a
    registered version that the JAX package loads bit for bit. (The
    per-epoch losses are not held to the JAX package's run: from the
    same init, the JAX package's float32 group-norm steps lie 5-18% of
    the update from a float64 run of the same steps, the port's 0.05-5%,
    so two epochs of the two drift apart by more than either's own
    rounding.)"""
    _from_jax_init(monkeypatch)
    port_cfg, _ = _train_cfgs(tmp_path)
    model_cfg = _pcfg()
    port = trainer.train_model(port_cfg, model_cfg, arrays=arrays,
                               device="cpu")
    got = _history(port_cfg.tracking_uri, port.run_id, tracking.store_for)
    for key in ("train_loss", "val_loss"):
        assert len(got[key]) == 2 and np.all(np.isfinite(got[key]))
    assert port.registry_version == 1

    state = checkpoint.CheckpointManager(port_cfg.checkpoint_dir).restore()
    assert state["epoch"] == 2
    assert not any(k.endswith((".mean", ".var")) for k in state["model"])
    assert any("GroupNorm_1" in k for k in state["model"])

    jtracking.set_tracking_uri(port_cfg.tracking_uri)
    try:
        jmodel, jvars = jtracking.load_model(f"models:/{NAME}/1")
    finally:
        jtracking.set_tracking_uri("file:ml/mlruns")
    assert jmodel.norm == "group" and sorted(jvars) == ["params"]
    _, net = tracking.load_model(
        f"models:/{NAME}/1", store=tracking.store_for(port_cfg.tracking_uri),
        device="cpu")
    mine = weights.to_flax_variables(net)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jvars)),
                    jax.tree.leaves(mine)):
        np.testing.assert_array_equal(a, b)


def test_resume_and_scan_epoch_of_a_group_norm_net(tmp_path, arrays):
    """One epoch then a resume to two equals an unbroken two-epoch run bit
    for bit (the checkpoint carries the order's generator), and the scan
    epoch (``StepGraph``, eager on the CPU) trains the group-norm net to
    the same losses as the streamed epoch."""
    model_cfg = _pcfg()
    runs = {}
    for name, kw in (("unbroken", {}), ("scan", {"epoch_mode": "scan"})):
        cfg, _ = _train_cfgs(tmp_path / name, **kw)
        res = trainer.train_model(cfg, model_cfg, arrays=arrays,
                                  register=False, device="cpu")
        runs[name] = (_history(cfg.tracking_uri, res.run_id,
                               tracking.store_for),
                      checkpoint.CheckpointManager(
                          cfg.checkpoint_dir).restore()["model"])
    cfg, _ = _train_cfgs(tmp_path / "resumed", epochs=1)
    trainer.train_model(cfg, model_cfg, arrays=arrays, register=False,
                        device="cpu")
    cfg = dataclasses.replace(cfg, epochs=2)
    res = trainer.train_model(cfg, model_cfg, arrays=arrays, resume=True,
                              register=False, device="cpu")
    assert res.epochs_run == 1
    resumed = checkpoint.CheckpointManager(cfg.checkpoint_dir).restore()
    for k, v in runs["unbroken"][1].items():
        assert torch.equal(resumed["model"][k], v), k
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(runs["scan"][0][key],
                                   runs["unbroken"][0][key], rtol=1e-5)


# -- weights -----------------------------------------------------------------------


def test_weights_carry_across_both_ways(tmp_path):
    """A group-norm artifact directory written by either package is the
    same bytes, and each package loads what the other wrote."""
    model, variables = _variables()
    jcfg = _jcfg()
    jtracking.save_model(variables, jcfg, tmp_path / "jax")
    net = weights.unet_from_flax_variables(_pcfg(), variables)
    weights.save_model(weights.to_flax_variables(net), net.cfg,
                       tmp_path / "port")
    for name in (weights.MODEL_CONFIG_FILE, weights.MODEL_WEIGHTS_FILE):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    assert json.loads((tmp_path / "port" / weights.MODEL_CONFIG_FILE
                       ).read_text())["norm"] == "group"
    cfg, loaded = weights.load_model_dir(tmp_path / "jax", device="cpu")
    assert cfg == net.cfg
    jmodel, jloaded = jtracking.load_model_dir(tmp_path / "port")
    x = _input()
    with torch.no_grad():
        got = loaded(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(jloaded, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# -- serving -----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_folded_forward_refuses_group_norm_as_pallas_unet(mode):
    """``model_forward`` "auto" and "pallas" fold the net, which refuses a
    group norm with the JAX ``PallasUNet``'s ``ValueError``, word for
    word; the reference analyzers' forward takes the unfolded module."""
    model, variables = _variables()
    with pytest.raises(ValueError) as jerr:
        PallasUNet(model, variables)
    net = weights.unet_from_flax_variables(_pcfg(), variables)
    with pytest.raises(ValueError) as err:
        tserver.tier_forward(net, "f32", torch.device("cpu"), mode)
    assert str(err.value) == str(jerr.value)
    assert "folds BatchNorm; got norm='group'" in str(err.value)
    with pytest.raises(ValueError, match="use the Flax module instead"):
        FoldedUNet(net, device="cpu")
    forward = reference_forward(net, device="cpu")
    assert isinstance(forward, tunet.UNet) and forward is not net
    x = torch.from_numpy(_input())
    with torch.no_grad():
        assert torch.equal(forward(x), net(x))


def _served_variables(seed: int) -> dict:
    """Group-norm variables whose head bias sits at a frame's median logit
    (the deploy test's recipe), so masks have edges."""
    model, variables = _variables(seed=seed)
    rgb, _, _ = render_scene(np.random.default_rng(100), H, W)
    x = jpipe.preprocess(jnp.asarray(rgb)[None], SIZE)
    median = float(np.median(np.asarray(model.apply(variables, x))))
    variables["params"]["Conv_0"]["bias"] = (
        variables["params"]["Conv_0"]["bias"] - median).astype(np.float32)
    return variables


def _register(uri: str, variables: dict) -> int:
    prev = jtracking.get_tracking_uri()
    jtracking.set_tracking_uri(uri)
    try:
        jtracking.set_experiment("Actuator Segmentation")
        with jtracking.start_run():
            version = jtracking.log_model(variables, _jcfg(),
                                          registered_model_name=NAME)
        jtracking.Client().set_registered_model_alias(NAME, "staging",
                                                      version)
    finally:
        jtracking.set_tracking_uri(prev)
    return version


def _frames(n: int = 4):
    rng = np.random.default_rng(100)
    return [render_scene(rng, H, W)[::2] for _ in range(n)]  # (rgb, depth)


def _port_answers(service, frames):
    return [(r.status, r.mask, r.mask_coverage, r.mean_curvature,
             r.max_curvature)
            for r in service.analyze_stream(iter(
                [ingest.raw_request(rgb, depth, mask_format=1)
                 for rgb, depth in frames]))]


def _jax_answers(jservice, frames):
    out = []
    for rgb, depth in frames:
        res = jservice._analyze_frame(rgb, depth, mask_format=1)
        out.append(("OK" if res.valid else tserver.STATUS_DEGRADED,
                    res.mask_png, float(np.float32(res.coverage)),
                    res.mean_k, res.max_k))
    return out


def _model_masks(logits_fn, frames) -> list:
    """Each frame's mask at the model's resolution (sigmoid > 0.5), from
    ``logits_fn(rgb) -> [1, S, S, 1]`` numpy logits."""
    return [logits_fn(rgb)[0, ..., 0] for rgb, _ in frames]


def _jax_logits(model, variables):
    return lambda rgb: np.asarray(jax.nn.sigmoid(model.apply(
        variables, jpipe.preprocess(jnp.asarray(rgb)[None], SIZE)))) > 0.5


def _port_logits(net):
    from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe

    def run(rgb):
        with torch.no_grad():
            x = tpipe.preprocess(torch.from_numpy(rgb)[None], SIZE)
            return torch.sigmoid(net(x)).numpy() > 0.5

    return run


def _native(model_mask: np.ndarray) -> np.ndarray:
    """A model-resolution mask on the frame's grid, by the port's nearest
    resize (``ops/pipeline.logits_to_native_masks``)."""
    from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe

    m = torch.from_numpy(model_mask.astype(np.float32))[None, ..., None]
    return tpipe.logits_to_native_masks(m * 2 - 1, H, W)[0].numpy()


def _reference_keeps_every_point(mask: np.ndarray, depth) -> bool:
    """Whether the JAX package's spline fit keeps every edge point of this
    frame (stride 1). On some frames its parallel prefix sum rounds the
    last chord parameter above 1 and drops that point, where the port
    clips to 1 (ROADMAP queue 3, tests/test_torch_port_pipeline.py::
    test_chord_parameters_clip_at_one): there the two fit different point
    sets by design."""
    from robotic_discovery_platform_tpu.ops import bspline as jbspline
    from robotic_discovery_platform_tpu.ops import geometry as jgeom
    from robotic_discovery_platform_tpu_torch.serving.ingest import (
        default_intrinsics,
    )

    k = default_intrinsics(W, H).astype(np.float32)
    maps = jgeom.deproject(jnp.asarray(mask), jnp.asarray(depth), k[0, 0],
                           k[1, 1], k[0, 2], k[1, 2], jnp.float32(0.001))
    e = jgeom._edge_points(*maps, jconfig.GeometryConfig(kernel_impl="xla"))
    pts, wts = jgeom._sort_by_x(e[0], e[1])
    u = np.asarray(jbspline.chord_length_params(pts, wts))
    return bool(u[np.asarray(wts) > 0].max(initial=0.0) <= 1.0)


def _same(got, want, port_masks, jax_masks, frames):
    """The port's answers against the JAX servicer's. The port's served
    mask is its own forward's, bit for bit. The two forwards compute one
    function to float32 rounding, which group norm's E[x^2] - E[x]^2
    amplifies where a group's mean dwarfs its spread, so a model pixel
    whose logit lies at the threshold may fall on either side: the masks
    are equal outside the frame pixels of model pixels whose two masks
    differ, and every field is equal on frames with none."""
    from robotic_discovery_platform_tpu_torch.serving.egress import (
        decode_mask_wire,
    )

    compared = 0
    for g, w, pm, jm, (_, depth) in zip(got, want, port_masks, jax_masks,
                                        frames, strict=True):
        assert g[0] == w[0]
        served = decode_mask_wire(g[1])
        assert np.array_equal(served, _native(pm))
        unsure = _native(pm != jm).astype(bool)
        assert np.array_equal(served[~unsure],
                              decode_mask_wire(w[1])[~unsure])
        if not unsure.any():
            assert g[1] == w[1]  # packed mask bits, byte for byte
            assert g[2] == w[2]
            if g[0] == "OK" and _reference_keeps_every_point(served, depth):
                np.testing.assert_allclose(g[3:], w[3:], rtol=1e-3,
                                           atol=0.0)
                compared += 1
    return compared


@pytest.mark.parametrize("leg", ["direct", "batched", "scan"])
def test_flax_forward_serves_a_group_norm_net_as_the_jax_servicer(
        leg, tmp_path):
    """``model_forward="flax"`` serves the group-norm net: direct, batched
    and through the scan dispatch, the port's answers equal the JAX
    servicer's (which takes the Flax forward) on version 1, and again
    after the ``staging`` alias moves and both reload to version 2."""
    uri = f"file:{tmp_path}/mlruns"
    v1 = _register(uri, _served_variables(0))
    fields = {"direct": {},
              "batched": dict(batch_window_ms=5.0, max_batch=2),
              "scan": dict(batch_window_ms=5.0, max_batch=2,
                           batch_impl="scan")}[leg]
    common = dict(address="localhost:0", tracking_uri=uri,
                  model_img_size=SIZE, model_forward="flax",
                  calibration_path=str(tmp_path / "none.npz"),
                  reload_poll_s=0.0, **fields)
    pcfg = config.ServerConfig(metrics_csv=str(tmp_path / "p.csv"), **common)
    jcfg = jconfig.ServerConfig(metrics_csv=str(tmp_path / "j.csv"),
                                **common)
    frames = _frames()
    service = tserver.build_service(pcfg, device="cpu")
    prev = jtracking.get_tracking_uri()
    try:
        model, variables, version = jserver.resolve_serving_model(jcfg)
    finally:
        jtracking.set_tracking_uri(prev)
    jservice = jserver.VisionAnalysisService(model, variables, None, 0.001,
                                             jcfg, version=version)
    store = tracking.store_for(uri)

    def masks(version):
        _, net = tracking.load_model(f"models:/{NAME}/{version}",
                                     store=store, device="cpu")
        jmodel, jvars = jtracking.load_model_dir(
            store.version_path(NAME, version))
        return (_model_masks(_port_logits(net), frames),
                _model_masks(_jax_logits(jmodel, jvars), frames))

    try:
        service.warmup(W, H)
        jservice.warmup(W, H)
        assert service.current_version == jservice.current_version == v1
        before = _port_answers(service, frames)
        compared = _same(before, _jax_answers(jservice, frames), *masks(v1),
                         frames)
        assert any(b[0] == "OK" for b in before)
        v2 = _register(uri, _served_variables(1))
        assert service.maybe_reload() and jservice.maybe_reload()
        assert service.current_version == jservice.current_version == v2
        after = _port_answers(service, frames)
        compared += _same(after, _jax_answers(jservice, frames),
                          *masks(v2), frames)
        assert [a[1] for a in after] != [b[1] for b in before]
        assert compared >= 4  # curvature held on most of the 8 answers
    finally:
        service.close()
        jservice.close()


def test_auto_forward_server_refuses_a_group_norm_net(tmp_path):
    """A server with the default ``model_forward="auto"`` refuses to build
    from a registered group-norm net, as the JAX servicer does where it
    folds (on its accelerator)."""
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, _served_variables(0))
    cfg = config.ServerConfig(address="localhost:0", tracking_uri=uri,
                              model_img_size=SIZE,
                              metrics_csv=str(tmp_path / "p.csv"),
                              calibration_path=str(tmp_path / "none.npz"))
    with pytest.raises(ValueError, match="PallasUNet folds BatchNorm"):
        tserver.build_service(cfg, device="cpu")


def test_bf16_tier_of_a_group_norm_net_matches_jax():
    """``apply_precision`` at "bf16" under the "flax" forward: the served
    forward computes in bfloat16 from the float32 weights, as the JAX
    tier's Flax module does; the untransformed net is kept for the
    gate."""
    model, variables = _variables()
    net = weights.unet_from_flax_variables(_pcfg(), variables)
    forward, pristine = tserver.tier_forward(net, "bf16",
                                             torch.device("cpu"), "flax")
    assert pristine is net and forward.cfg.compute_dtype == "bfloat16"
    jmodel, jvars, report = jquant.apply_precision(model, variables, "bf16")
    assert report["tier"] == "bf16"
    x = _input()
    with torch.no_grad():
        got = forward(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    assert _rel_l2(got, want) <= 2e-2
