"""The port's U-Net (models/unet.py), its weights (models/weights.py) and
the folded forward (ops/unet_infer.py) against the JAX package, on the CPU.

The JAX package draws the variables (its own init plus BatchNorm
statistics from a numpy seed, so that folding matters); both packages get
the same numpy tree. Tolerances, fixed before measuring:
- float32 forwards: atol = rtol = 2e-4 (tests/test_torch_parity.py's bar);
- bfloat16 forwards: relative L2 of the logits <= 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu import tracking
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.ops.pallas.unet_infer import PallasUNet
from robotic_discovery_platform_tpu.utils.config import ModelConfig as JaxModelConfig
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.utils.config import ModelConfig

SIZE = 64
BASE = 8


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


def _variables(dtype: str, seed: int = 0):
    """JAX-initialized variables (numpy leaves) with BatchNorm statistics
    drawn from a numpy seed."""
    model = build_unet(JaxModelConfig(base_features=BASE, compute_dtype=dtype))
    variables = jax.tree.map(np.asarray,
                             init_unet(model, jax.random.key(seed), SIZE))
    rng = np.random.default_rng(seed)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.05, 0.2, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key == "scale" else a),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])
    return model, {"params": params, "batch_stats": stats}


def _input(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize(
    "dtype,forward",
    [("float32", "unet"), ("bfloat16", "unet"),
     ("float32", "folded"), ("bfloat16", "folded")],
)
def test_forward_matches_jax(dtype, forward):
    """The unfolded module against ``UNet.apply(train=False)``; the folded
    forward (plain ops on the CPU) against ``UNet.apply`` in float32 and, in
    bfloat16, against the JAX package's folded forward on its XLA convs
    (``PallasUNet(force="xla")``), which rounds at the same points (folding
    moves bfloat16 roundings, so the unfolded bfloat16 net is another
    function)."""
    model, variables = _variables(dtype)
    x = _input()
    if forward == "folded" and dtype == "bfloat16":
        want = np.asarray(PallasUNet(model, variables, force="xla")(
            jnp.asarray(x)))
    else:
        want = np.asarray(model.apply(variables, jnp.asarray(x),
                                      train=False))
    net = weights.unet_from_flax_variables(
        ModelConfig(base_features=BASE, compute_dtype=dtype), variables)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = (net(xt) if forward == "unet"
               else FoldedUNet(net, device="cpu")(xt)).numpy()
    assert got.shape == want.shape == (1, SIZE, SIZE, 1)
    assert got.dtype == np.float32
    assert np.std(want) > 0.1  # a live network, not a constant head
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    else:
        assert _rel_l2(got, want) <= 2e-2


def test_folded_forward_matches_pallas_unet_interpret():
    """FoldedUNet (plain ops) against PallasUNet in interpret mode, f32."""
    model, variables = _variables("float32", seed=3)
    x = _input(4)
    want = np.asarray(PallasUNet(model, variables, interpret=True)(
        jnp.asarray(x)))
    net = weights.unet_from_flax_variables(
        ModelConfig(base_features=BASE, compute_dtype="float32"), variables)
    folded = FoldedUNet(net, device="cpu")
    with torch.no_grad():
        got = folded(torch.from_numpy(x)).numpy()
        plain = folded.forward_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(got, plain)  # CPU wrappers = plain ops


@pytest.mark.parametrize("source", ["from_flax_variables", "load_model_dir"])
def test_weights_carry_across(source, tmp_path):
    """Every Flax leaf lands on the port's state-dict key of the same path,
    with its value; an artifact directory written by the JAX package's
    tracking.save_model loads the same weights."""
    model, variables = _variables("float32", seed=5)
    cfg = ModelConfig(base_features=BASE, compute_dtype="float32")
    if source == "from_flax_variables":
        state = weights.from_flax_variables(variables)
        net = weights.unet_from_flax_variables(cfg, variables)
    else:
        tracking.save_model(variables, JaxModelConfig(
            base_features=BASE, compute_dtype="float32"), tmp_path / "model")
        loaded_cfg, net = weights.load_model_dir(tmp_path / "model",
                                                 device="cpu")
        assert loaded_cfg == cfg
        state = {k: v for k, v in net.state_dict().items()}
    flat = {}
    for tree in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                variables[tree])[0]:
            flat[".".join(p.key for p in path)] = np.asarray(leaf)
    own = tunet.UNet(cfg).state_dict()
    assert set(state) == set(flat) == set(own)
    for key, want in flat.items():
        assert tuple(state[key].shape) == want.shape == tuple(own[key].shape)
        np.testing.assert_array_equal(state[key].numpy(), want)
    assert not net.training


@pytest.mark.parametrize("variant", ["multi", "aux"])
def test_variant_params_carry_across(variant, tmp_path):
    """A JAX zoo variant's param tree at the published widths (``multi``:
    the [1, 1, 64, 4] head; ``aux``: base 16) lands on the port's variant
    UNet leaf for leaf, through the variables and through an artifact
    directory, and its logits match the JAX forward within the float32
    bar."""
    from robotic_discovery_platform_tpu.models import variants as jvariants
    from robotic_discovery_platform_tpu_torch.models import variants

    jcfg = jvariants.VARIANTS[variant].model_config(
        JaxModelConfig(compute_dtype="float32"))
    cfg = variants.VARIANTS[variant].model_config(
        ModelConfig(compute_dtype="float32"))
    assert (cfg.base_features, cfg.num_classes) == (
        jcfg.base_features, jcfg.num_classes)
    model = jvariants.build_variant_model(jvariants.VARIANTS[variant],
                                          JaxModelConfig(
                                              compute_dtype="float32"))
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_unet(model, key, SIZE))(jax.random.key(7)))
    rng = np.random.default_rng(7)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.05, 0.2, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    head = variables["params"]["Conv_0"]["kernel"]
    assert head.shape == ((1, 1, 64, 4) if variant == "multi"
                          else (1, 1, 16, 1))
    net = weights.unet_from_flax_variables(cfg, variables)
    tracking.save_model(variables, jcfg, tmp_path / "model")
    loaded_cfg, loaded = weights.load_model_dir(tmp_path / "model",
                                                device="cpu")
    assert loaded_cfg == cfg
    own = variants.build_variant_model(variants.VARIANTS[variant],
                                       ModelConfig(compute_dtype="float32"))
    assert set(net.state_dict()) == set(own.state_dict())
    for key, t in own.state_dict().items():
        assert tuple(net.state_dict()[key].shape) == tuple(t.shape)
        np.testing.assert_array_equal(net.state_dict()[key].numpy(),
                                      loaded.state_dict()[key].numpy())
    x = _input(8)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
        folded = FoldedUNet(net, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, SIZE, SIZE, cfg.num_classes)
    assert np.std(want) > 0.01
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(folded, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("init", ["torch", "lecun"])
def test_init_family(init):
    """``"torch"``: conv kernels U(+-sqrt(1/fan_in)), head bias
    U(+-1/sqrt(fan_in)); ``"lecun"``: truncated normal, std sqrt(1/fan_in)
    before truncation, head bias zero. Same generator seed, same weights."""
    cfg = ModelConfig(base_features=BASE, init=init)
    net = tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    again = tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(net.state_dict().items(),
                                 again.state_dict().items()):
        assert torch.equal(p, q), name
    for name, p in net.named_parameters():
        if not name.endswith("kernel"):
            continue
        kh, kw, cin, _ = p.shape
        bound = float(np.sqrt(1.0 / (kh * kw * cin)))
        if init == "torch":
            assert float(p.detach().abs().max()) <= bound
            assert abs(float(p.detach().std()) - bound / np.sqrt(3)) < 0.2 * bound
        else:
            std = bound / 0.87962566103423978
            assert float(p.detach().abs().max()) <= 2 * std + 1e-6
            if p.numel() > 1000:
                assert abs(float(p.detach().std()) - bound) < 0.15 * bound
    head_bias = net.Conv_0.bias.detach()
    if init == "torch":
        assert float(head_bias.abs().max()) <= 1 / np.sqrt(BASE)
        assert float(head_bias.abs().max()) > 0
    else:
        assert float(head_bias.abs().max()) == 0.0
    for m in net.modules():
        if isinstance(m, tunet.BatchNorm):
            assert torch.equal(m.var, torch.ones_like(m.var))
            assert torch.equal(m.scale, torch.ones_like(m.scale))


def test_folded_forward_hands_the_kernels_what_they_take(monkeypatch):
    """What surrounds the CUDA kernels, checked on the CPU: from the
    analyzer's preprocessed input, the folded forward makes exactly 18
    conv3x3_bn_relu calls and one conv1x1 call per frame, each with dense
    (contiguous) operands in the dtypes the kernels take, weights already
    in the compute dtype, and float32 scale/bias of the right length."""
    from robotic_discovery_platform_tpu_torch.ops import pipeline
    from robotic_discovery_platform_tpu_torch.ops import unet_infer

    calls = []

    def checking(name, fn, allowed):
        def wrapper(x, w, scale, bias, **kw):
            out_dtype = kw.get("out_dtype") or x.dtype
            assert (x.dtype, out_dtype) in allowed, (name, x.dtype, out_dtype)
            assert w.dtype == x.dtype, (name, w.dtype)
            for t in (x, w, scale, bias):
                assert t.is_contiguous(), name
            assert scale.dtype == bias.dtype == torch.float32
            assert scale.shape == bias.shape == (w.shape[-1],)
            assert x.shape[-1] == w.shape[-2]
            calls.append((name, tuple(x.shape), tuple(w.shape)))
            return fn(x, w, scale, bias, **kw)
        return wrapper

    kernels = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32)}
    monkeypatch.setattr(unet_infer, "conv3x3_bn_relu", checking(
        "conv3x3_bn_relu", unet_infer.conv3x3_bn_relu, kernels))
    monkeypatch.setattr(unet_infer, "conv1x1", checking(
        "conv1x1", unet_infer.conv1x1, kernels))
    _, variables = _variables("bfloat16")
    net = weights.unet_from_flax_variables(
        ModelConfig(base_features=BASE), variables)
    frame = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (1, 120, 160, 3), dtype=np.uint8))
    x = pipeline.preprocess(frame, SIZE)
    with torch.no_grad():
        logits = FoldedUNet(net, device="cpu")(x)
    assert logits.dtype == torch.float32 and logits.is_contiguous()
    assert [c[0] for c in calls] == ["conv3x3_bn_relu"] * 18 + ["conv1x1"]
    assert calls[0][1] == (1, SIZE, SIZE, 3)
    assert calls[-1][1:] == ((1, SIZE, SIZE, BASE), (BASE, 1))
