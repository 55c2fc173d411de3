"""The port's non-bilinear U-Net (``ModelConfig(bilinear=False)``: the 2x2
stride-2 transposed-conv decoder) against the JAX package's, on the CPU:
the transposed conv's plain version (the kernel's reference), the module
forward in eval and train mode, the folded forward, one train step, the
weights both ways, and a server built from a registered non-bilinear
model.

The JAX package draws the variables; both packages get the same numpy
tree; inputs come from numpy seeds. Tolerances, fixed before measuring:
- the transposed conv: float32 atol = rtol = 1e-5 (float32 sums of 12
  products in another order); bfloat16 outputs within one bfloat16 ulp
  (rtol 2^-7) of the JAX package's, which rounds the same float32 sums;
- forwards (float32, base 8, 32x32 and 72x72, where the nearest resize
  after the transposed conv is not the identity): atol = rtol = 2e-4
  (tests/test_torch_port_model.py's bar); train-mode running statistics
  rtol 1e-5 (atol 1e-6) as in tests/test_torch_port_training.py;
- one train step: tests/test_torch_port_training.py's bars (loss rtol
  1e-5; updated parameters and statistics relative L2 1e-4), against the
  JAX package's step taken in float64. Its float32 step is not the
  reference here: on the CPU, the JAX package's float32 train-mode
  gradients of this network lie 3.0e-2 (relative L2) from its own float64
  gradients, where the port's float32 gradients lie 1.6e-6 from them
  (base 8 at 32x32, B = 2, on the CPU; the bilinear network's float32
  gradients agree across the packages to 1e-5);
- weights and artifacts: bitwise, the msgpack bytes equal to Flax's;
- the registry-served model: masks equal to a directly built
  ``FoldedUNet``'s.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import serialization

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models import losses as jlosses
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.ops.pallas import conv as jconv
from robotic_discovery_platform_tpu.ops.pallas.unet_infer import PallasUNet
from robotic_discovery_platform_tpu.training import trainer as jtrainer
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import losses as tlosses
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.ops import conv, pipeline
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import egress, ingest, server
from robotic_discovery_platform_tpu_torch.training import trainer
from robotic_discovery_platform_tpu_torch.utils import config

BASE = 8
CFG = config.ModelConfig(base_features=BASE, compute_dtype="float32",
                         bilinear=False)


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


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_model(cfg=CFG):
    return build_unet(jconfig.ModelConfig(**dataclasses.asdict(cfg)))


def _variables(size: int, seed: int = 0, cfg=CFG):
    """JAX-initialized variables (numpy leaves) with BatchNorm statistics
    and scales drawn from a numpy seed, so folding matters."""
    model = _jax_model(cfg)
    variables = jax.device_get(jax.jit(lambda key: init_unet(
        model, key, size))(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key == "scale" else np.asarray(a)),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.05, 0.2, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return model, {"batch_stats": stats, "params": params}


# -- the transposed conv ---------------------------------------------------------


@pytest.mark.parametrize("dtype,impl", [("float32", "interpret"),
                                        ("float32", "xla"),
                                        ("bfloat16", "xla")])
def test_conv_transpose2x2_plain_matches_jax(dtype, impl):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 12, 10)) / 4).astype(np.float32)
    bias = rng.normal(0, 0.1, 10).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    want = (jconv.conv_transpose2x2(xj, jnp.asarray(w), jnp.asarray(bias),
                                    interpret=True) if impl == "interpret"
            else jconv.conv_transpose2x2_xla(xj, jnp.asarray(w),
                                             jnp.asarray(bias)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = conv.conv_transpose2x2_plain(xt, torch.from_numpy(w),
                                       torch.from_numpy(bias))
    assert got.dtype == xt.dtype and got.shape == (2, 10, 14, 10)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                                   atol=1e-6)


def test_conv_transpose2x2_layout_and_the_cpu_wrapper():
    """The flipped-tap convention is torch ``conv_transpose2d`` on
    ``w.flip(0, 1).permute(2, 3, 0, 1)`` (the library comparator's
    layout); the wrapper on CPU tensors is the plain version and counts no
    launch."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 4, 6, 8, generator=gen)
    w = torch.randn(2, 2, 8, 5, generator=gen)
    bias = torch.randn(5, generator=gen)
    before = conv.conv_transpose2x2.launches
    got = conv.conv_transpose2x2(x, w, bias)
    assert conv.conv_transpose2x2.launches == before
    assert torch.equal(got, conv.conv_transpose2x2_plain(x, w, bias))
    ref = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                             w.flip(0, 1).permute(2, 3, 0, 1), bias,
                             stride=2).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,cin,cout,want", [
    # the non-bilinear ladder (input 16^2 .. 128^2) in bf16
    (torch.bfloat16, 1024, 512, "tensor_cores"),
    (torch.bfloat16, 512, 256, "tensor_cores"),
    (torch.bfloat16, 256, 128, "tensor_cores"),
    (torch.bfloat16, 128, 64, "tensor_cores"),
    # float32 (TF32 would break its bar) and ragged widths
    (torch.float32, 1024, 512, "fma"),
    (torch.bfloat16, 40, 24, "fma"),
    (torch.bfloat16, 48, 96, "fma"),
    (torch.bfloat16, 8, 64, "fma"),
])
def test_conv_transpose2x2_path_rule(dtype, cin, cout, want):
    """Which kernel a CUDA x takes: the tensor cores for bf16 with Cin %
    16 == 0 and Cout % 64 == 0, the CUDA cores otherwise; the C entry's
    rule (``tensor_cores`` in csrc/conv_transpose2x2.cu, which chip_smoke
    asks on the card) names the same widths."""
    assert conv.convt_path(dtype, cin, cout) == want
    src = (Path(conv.__file__).resolve().parents[1] / "csrc"
           / "conv_transpose2x2.cu").read_text()
    rule = re.search(r"bool tensor_cores\(int Cin, int Cout, int dtypes\) "
                     r"\{\s*return ([^;]*);", src).group(1)
    assert " ".join(rule.split()) == (
        f"(dtypes == 1 || dtypes == 2) && Cin % {conv.CONVT_CIN_STEP} == 0 "
        f"&& Cout % {conv.COUT_TILE} == 0")


@pytest.mark.parametrize("out,inp", [(9, 8), (72, 72), (18, 16), (5, 4)])
def test_nearest_resize_matches_jax(out, inp):
    x = np.random.default_rng(out).normal(size=(1, inp, inp, 2)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, out, out, 2), "nearest")
    got = tunet.resize_nearest(torch.from_numpy(x), out, out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- forwards -----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eval", "train", "folded"])
@pytest.mark.parametrize("size", [32, 72])
def test_forward_matches_jax(size, mode):
    """The module against ``UNet(bilinear=False).apply`` in eval and train
    mode (train: the port's custom-VJP conv path, the JAX package's Flax
    convs; the updated running statistics too), and the folded forward
    (plain versions on the CPU) against ``PallasUNet`` in interpret
    mode."""
    model, variables = _variables(size)
    x = np.random.default_rng(size).uniform(
        0, 1, (2, size, size, 3)).astype(np.float32)
    net = weights.unet_from_flax_variables(
        dataclasses.replace(CFG, conv_impl="interpret"), variables)
    xt = torch.from_numpy(x)
    if mode == "eval":
        want = model.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = net(xt)
    elif mode == "train":
        want, upd = model.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        with torch.no_grad():
            got = net(xt, train=True)
        stats = _flat(jax.device_get(upd["batch_stats"]))
        state = net.state_dict()
        for k, v in stats.items():
            np.testing.assert_allclose(state[k].numpy(), v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    else:
        want = PallasUNet(model, variables, interpret=True)(jnp.asarray(x))
        with torch.no_grad():
            got = FoldedUNet(net, device="cpu").forward_plain(xt)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, size, size, 1)
    assert np.std(want) > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_folded_forward_hands_the_kernel_what_it_takes(monkeypatch):
    """From a bfloat16 net, the folded forward calls the transposed-conv
    kernel four times per frame with dense bfloat16 operands, float32 bias
    and the ladder's shapes, then resizes to the skip's size."""
    from robotic_discovery_platform_tpu_torch.ops import unet_infer

    calls = []
    kernel = unet_infer.conv_transpose2x2

    def checking(x, w, bias, **kw):
        assert x.dtype == w.dtype == torch.bfloat16
        assert bias.dtype == torch.float32 and bias.shape == (w.shape[3],)
        assert x.is_contiguous() and w.is_contiguous() and bias.is_contiguous()
        calls.append((tuple(x.shape), tuple(w.shape)))
        return kernel(x, w, bias, **kw)

    monkeypatch.setattr(unet_infer, "conv_transpose2x2", checking)
    net = tunet.UNet(dataclasses.replace(CFG, compute_dtype="bfloat16"))
    net.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = FoldedUNet(net.eval(), device="cpu")(torch.rand(1, 72, 72, 3))
    assert logits.shape == (1, 72, 72, 1) and logits.dtype == torch.float32
    f = BASE
    assert calls == [((1, 4, 4, 16 * f), (2, 2, 16 * f, 8 * f)),
                     ((1, 9, 9, 8 * f), (2, 2, 8 * f, 4 * f)),
                     ((1, 18, 18, 4 * f), (2, 2, 4 * f, 2 * f)),
                     ((1, 36, 36, 2 * f), (2, 2, 2 * f, f))]


def test_init_draws_the_reference_fans():
    """torch init: kernel and bias U(+-1/sqrt(4 * Cout)) (torch
    ConvTranspose2d's fan, the JAX package's); lecun: a zero bias."""
    net = tunet.UNet(CFG).init_weights(torch.Generator().manual_seed(1))
    jvars = _variables(32)[1]["params"]
    for i in range(4):
        ct = getattr(net, f"Up_{i}").ConvTranspose_0
        bound = 1 / np.sqrt(4 * ct.kernel.shape[3])
        for t, j in ((ct.kernel, "kernel"), (ct.bias, "bias")):
            jt = jvars[f"Up_{i}"]["ConvTranspose_0"][j]
            assert tuple(t.shape) == jt.shape
            for a in (t.detach().numpy(), jt):
                assert np.abs(a).max() <= bound
                if j == "kernel":  # enough draws to come near the bound
                    assert np.abs(a).max() > 0.8 * bound
    lecun = tunet.UNet(dataclasses.replace(CFG, init="lecun")).init_weights(
        torch.Generator().manual_seed(1))
    assert not lecun.Up_0.ConvTranspose_0.bias.any()
    assert lecun.Up_0.ConvTranspose_0.kernel.std() > 0


# -- one train step ----------------------------------------------------------------

TINY = dataclasses.replace(CFG, conv_impl="interpret")


@pytest.fixture(scope="module")
def one_step():
    """One step of each package from the JAX init on the same 32x32 batch
    (tests/test_torch_port_training.py's ``one_step`` with the
    transposed-conv decoder): the JAX package's ``core_train_step`` in
    float64 (module docstring), the port's ``train_step`` in float32 on
    ``conv3x3`` (its plain versions on the CPU)."""
    rng = np.random.default_rng(21)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    variables = jax.device_get(jax.jit(lambda key: init_unet(
        _jax_model(TINY), key, 32))(jax.random.key(0)))
    with jax.enable_x64(True):
        model = _jax_model(dataclasses.replace(TINY, compute_dtype="float64",
                                               conv_impl="flax"))
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        tx = optax.adam(1e-3)
        state = jtrainer.TrainState(
            params=v64["params"], opt_state=tx.init(v64["params"]),
            batch_stats=v64["batch_stats"],
            epoch=jnp.asarray(0, jnp.int32),
            best_val_loss=jnp.asarray(jnp.inf, jnp.float64))
        step = jax.jit(jtrainer.core_train_step(model, tx,
                                                jlosses.bce_with_logits))
        jstate, jloss = step(state, jnp.asarray(x, jnp.float64),
                             jnp.asarray(y, jnp.float64))
        want = {"loss": float(jloss),
                "params": _flat(jax.device_get(jstate.params)),
                "batch_stats": _flat(jax.device_get(jstate.batch_stats))}

    net = tunet.UNet(TINY)
    net.load_state_dict(weights.from_flax_variables(variables))
    opt = trainer.make_optimizer(net, 1e-3)
    loss = trainer.train_step(net, opt, tlosses.bce_with_logits,
                              torch.from_numpy(x), torch.from_numpy(y))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    got = {"loss": float(loss),
           "params": {k: v for k, v in state.items() if k in want["params"]},
           "batch_stats": {k: v for k, v in state.items()
                           if k in want["batch_stats"]}}
    return got, want


def test_train_step_loss_matches_jax(one_step):
    got, want = one_step
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("tree", ["params", "batch_stats"])
def test_train_step_updates_match_jax(one_step, tree):
    got, want = one_step
    assert sorted(got[tree]) == sorted(want[tree])
    assert "Up_0.ConvTranspose_0.kernel" in want["params"]
    keys = sorted(want[tree])
    assert _rel_l2(np.concatenate([got[tree][k].ravel() for k in keys]),
                   np.concatenate([want[tree][k].ravel() for k in keys])
                   ) <= 1e-4


# -- weights, artifacts and the registry --------------------------------------------


def test_weights_carry_across_both_ways(tmp_path):
    """JAX tree -> port state dict -> JAX tree is the identity, with
    ``Up_i/ConvTranspose_0/{kernel, bias}``; the msgpack bytes and the
    artifact directory equal Flax's and the JAX package's."""
    _, variables = _variables(32, seed=5)
    net = weights.unet_from_flax_variables(CFG, variables)
    np.testing.assert_array_equal(
        net.Up_2.ConvTranspose_0.kernel.detach().numpy(),
        variables["params"]["Up_2"]["ConvTranspose_0"]["kernel"])
    back = weights.to_flax_variables(net)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    assert weights.write_flax_msgpack(back) == serialization.to_bytes(
        variables)
    weights.save_model(back, CFG, tmp_path / "port")
    jtracking.save_model(variables, jconfig.ModelConfig(
        **dataclasses.asdict(CFG)), str(tmp_path / "jax"))
    for name in (weights.MODEL_CONFIG_FILE, weights.MODEL_WEIGHTS_FILE):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    cfg, loaded = weights.load_model_dir(tmp_path / "jax", device="cpu")
    assert cfg == CFG
    assert all(torch.equal(loaded.state_dict()[k], v)
               for k, v in net.state_dict().items())


@pytest.mark.parametrize("batch_window_ms", [0.0, 2.0])
def test_registry_serves_a_non_bilinear_model(tmp_path, batch_window_ms):
    """A registered non-bilinear model served by ``build_service`` (direct
    and batched) answers with the masks of a directly built FoldedUNet."""
    _, variables = _variables(32, seed=9)
    uri = f"file:{tmp_path}/mlruns"
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    with tracking.start_run():
        tracking.log_model(variables, CFG,
                           registered_model_name="Actuator-Segmenter")
    tracking.store_for(uri).set_alias("Actuator-Segmenter", "staging", 1)
    cfg = config.ServerConfig(tracking_uri=uri, model_img_size=32,
                              batch_window_ms=batch_window_ms, max_batch=2,
                              metrics_csv=str(tmp_path / "m.csv"),
                              calibration_path=str(tmp_path / "none.npz"))
    service = server.build_service(cfg, device="cpu")
    assert service.model_version == 1
    direct = pipeline.make_frame_analyzer(
        FoldedUNet(weights.unet_from_flax_variables(CFG, variables),
                   device="cpu"), img_size=32, device="cpu")
    rng = np.random.default_rng(3)
    frames = [render_scene(rng, 48, 64) for _ in range(2)]
    try:
        responses = list(service.analyze_stream(iter(
            [ingest.raw_request(rgb, depth, mask_format=1)
             for rgb, _, depth in frames])))
        for resp, (rgb, _, depth) in zip(responses, frames):
            k = torch.from_numpy(service._camera(64, 48))
            want = direct(rgb, depth, k, service.depth_scale)
            assert resp.status.startswith(("OK", "DEGRADED")), resp.status
            np.testing.assert_array_equal(
                egress.decode_mask_wire(resp.mask), want.mask.numpy())
            assert resp.mask_coverage == float(want.mask_coverage)
    finally:
        service.close()

