"""The port's model artifacts and registry against the JAX package's: the
msgpack writer and reader (byte for byte against Flax), the variable-tree
conversions, ``save_model``, stores written by one package and resolved
by the other, and a server that starts from the registry.

Tolerances, fixed before measuring: artifacts and stores byte-equal or
bitwise; the forward of a model registered by the port and loaded by the
JAX package within rtol 1e-5 (atol 1e-5) of the port's, in float32; the
registry-built server's masks equal to a directly built ``FoldedUNet``'s.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.ops import pipeline
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import egress, server
from robotic_discovery_platform_tpu_torch.training import synthetic, trainer
from robotic_discovery_platform_tpu_torch.utils import config

SMALL = config.ModelConfig(base_features=4, compute_dtype="float32")
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


def _net(seed: int, cfg=SMALL) -> tunet.UNet:
    net = tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(seed))
    gen = np.random.default_rng(seed)
    with torch.no_grad():  # BatchNorm statistics and affine away from 1/0
        for m in net.modules():
            if isinstance(m, tunet.BatchNorm):
                c = m.mean.shape[0]
                m.mean.copy_(torch.from_numpy(gen.normal(0, 0.1, c)))
                m.var.copy_(torch.from_numpy(gen.uniform(0.5, 2.0, c)))
                m.scale.copy_(torch.from_numpy(gen.uniform(0.5, 1.5, c)))
    return net.eval()


def _jax_variables(seed: int, cfg=SMALL) -> dict:
    model = build_unet(jconfig.ModelConfig(**dataclasses.asdict(cfg)))
    return jax.device_get(jax.jit(lambda key: init_unet(model, key, 32))(
        jax.random.key(seed)))


# -- msgpack and the variable trees ---------------------------------------------


@pytest.mark.parametrize("case", ["port_tree", "jax_init", "edge_cases"])
def test_msgpack_writer_is_byte_equal_to_flax(case):
    if case == "port_tree":
        tree = weights.to_flax_variables(_net(0))
    elif case == "jax_init":
        tree = _jax_variables(1)
    else:
        rng = np.random.default_rng(0)
        tree = {
            "k" * 40: {f"leaf_{i:02d}": rng.normal(size=(i + 1,)).astype(
                np.float32) for i in range(17)},  # str8 key, map16
            "scalar": np.float32(2.5),  # a numpy scalar leaf
            "zero_d": np.asarray(1.0, np.float64),
            "ints": np.arange(70000, dtype=np.int32),  # bin32 payload
            "wide": np.zeros((3, 300), np.float32),  # uint16 dim
            "empty": {},
        }
    assert weights.write_flax_msgpack(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("case", ["port_tree", "jax_init"])
def test_msgpack_reader_reads_what_flax_writes(case):
    tree = (weights.to_flax_variables(_net(2)) if case == "port_tree"
            else _jax_variables(2))
    got = weights.read_flax_msgpack(serialization.to_bytes(tree))
    want = serialization.msgpack_restore(serialization.to_bytes(tree))

    def same(a, b):
        if isinstance(b, dict):
            return list(a) == list(b) and all(same(a[k], b[k]) for k in b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))

    assert same(got, want)


def test_variable_tree_conversions_are_inverse():
    variables = _jax_variables(3)
    state = weights.from_flax_variables(variables)
    net = tunet.UNet(SMALL)
    net.load_state_dict(state, strict=True)
    back = weights.to_flax_variables(net)
    flat_a = weights._flatten(back["params"]) | weights._flatten(
        back["batch_stats"])
    flat_b = weights._flatten(variables["params"]) | weights._flatten(
        variables["batch_stats"])
    assert sorted(flat_a) == sorted(flat_b)
    assert all(np.array_equal(flat_a[k], flat_b[k]) for k in flat_b)
    assert list(back) == ["batch_stats", "params"]


def test_save_model_is_byte_equal_to_the_jax_package(tmp_path):
    tree = weights.to_flax_variables(_net(4))
    cfg = dataclasses.replace(SMALL, conv_impl="flax")
    weights.save_model(tree, cfg, tmp_path / "port")
    jtracking.save_model(tree, jconfig.ModelConfig(**dataclasses.asdict(cfg)),
                         tmp_path / "jax")
    for name in (weights.MODEL_CONFIG_FILE, weights.MODEL_WEIGHTS_FILE):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


# -- stores read by both packages -----------------------------------------------


def _register(api, uri, trees, cfg, alias_version):
    """Register ``trees`` as versions 1.. of NAME in ``api``'s package and
    point ``staging`` at ``alias_version``."""
    api.set_tracking_uri(uri)
    api.set_experiment("Actuator Segmentation")
    versions = []
    with api.start_run():
        for tree in trees:
            versions.append(api.log_model(tree, cfg,
                                          registered_model_name=NAME))
    api.store_for(uri).set_alias(NAME, "staging", alias_version)
    return versions


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_resolves_in_the_other_package(tmp_path, writer):
    uri = f"file:{tmp_path}/mlruns"
    trees = [weights.to_flax_variables(_net(5)),
             weights.to_flax_variables(_net(6))]
    if writer == "jax":
        versions = _register(jtracking, uri, trees,
                             jconfig.ModelConfig(**dataclasses.asdict(SMALL)),
                             1)
    else:
        versions = _register(tracking, uri, trees, SMALL, 1)
    assert versions == [1, 2]
    jstore, store = jtracking.store_for(uri), tracking.store_for(uri)
    for ref in ("@staging", "/latest", "/2"):
        path = tracking.resolve_model_uri(f"models:/{NAME}{ref}", store)
        assert path == jtracking.resolve_model_uri(f"models:/{NAME}{ref}",
                                                   jstore)
    # the port loads the alias's version with its weights bit for bit
    _, net = tracking.load_model(f"models:/{NAME}@staging", store,
                                 device="cpu")
    assert all(torch.equal(net.state_dict()[k], v)
               for k, v in _net(5).state_dict().items())
    # and the JAX package loads what either wrote
    _, jvars = jtracking.load_model(f"models:/{NAME}@staging", jstore)
    assert np.array_equal(
        np.asarray(jvars["params"]["Conv_0"]["kernel"]),
        _net(5).state_dict()["Conv_0.kernel"].numpy())


def test_port_registered_model_loads_in_the_jax_package(tmp_path):
    """A model trained and registered by the port's ``train_model`` loads
    through the JAX package's ``load_model_dir``; both forwards agree."""
    arrays = synthetic.generate_arrays(8, 32, 32, seed=1)
    cfg = config.TrainConfig(epochs=1, batch_size=4, img_size=32,
                             validation_split=0.25,
                             tracking_uri=f"file:{tmp_path}/mlruns",
                             checkpoint_dir=str(tmp_path / "ckpt"))
    res = trainer.train_model(cfg, SMALL, arrays=arrays, device="cpu")
    assert res.registry_version == 1
    store = tracking.store_for(cfg.tracking_uri)
    path = tracking.resolve_model_uri(f"models:/{NAME}/1", store)
    model_cfg, net = weights.load_model_dir(path, device="cpu")
    assert model_cfg == SMALL
    jmodel, jvars = jtracking.load_model_dir(path)
    x = np.random.default_rng(8).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert json.loads((path / weights.MODEL_CONFIG_FILE).read_text()) == \
        dataclasses.asdict(SMALL)


# -- serving from the registry ----------------------------------------------------


def test_serving_resolves_the_alias_first_then_the_latest(tmp_path):
    uri = f"file:{tmp_path}/mlruns"
    cfg = config.ServerConfig(tracking_uri=uri)
    with pytest.raises(KeyError):
        server.resolve_serving_version(cfg)
    _register(tracking, uri, [weights.to_flax_variables(_net(s))
                              for s in (7, 8, 9)], SMALL, 2)
    assert server.resolve_serving_version(cfg) == 2
    assert server.resolve_serving_version(
        dataclasses.replace(cfg, model_alias="production")) == 3
    model_cfg, net, version = server.resolve_serving_model(cfg, device="cpu")
    assert (model_cfg, version) == (SMALL, 2)
    assert all(torch.equal(net.state_dict()[k], v)
               for k, v in _net(8).state_dict().items())


def test_build_service_serves_the_registered_model(tmp_path):
    """With no forward, the servicer loads the registry's staging version
    and its masks equal those of a FoldedUNet built from that version's
    weights directly."""
    uri = f"file:{tmp_path}/mlruns"
    _register(tracking, uri, [weights.to_flax_variables(_net(s))
                              for s in (10, 11)], SMALL, 1)
    cfg = config.ServerConfig(tracking_uri=uri, model_img_size=32,
                              metrics_csv=str(tmp_path / "m.csv"),
                              calibration_path=str(tmp_path / "none.npz"))
    service = server.build_service(cfg, device="cpu")
    assert service.model_version == 1
    direct = pipeline.make_frame_analyzer(FoldedUNet(_net(10), device="cpu"),
                                          img_size=32, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(2):
        rgb, _, depth = render_scene(rng, 48, 64)
        got = service.analyze_frame(rgb, depth)
        k = torch.from_numpy(service._camera(64, 48))
        want = direct(rgb, depth, k, service.depth_scale)
        assert got.coverage == float(want.mask_coverage)
        assert got.valid == bool(want.profile.valid)
        assert got.mask_bytes == egress.encode_mask(want.mask.numpy(), 0)
    service.close()
