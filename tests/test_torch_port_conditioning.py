"""How exact the port's float32 training gradients are, beside the JAX
package's: both against the same step computed in float64.

The training parity tests (tests/test_torch_port_training.py) hold the
port to the JAX package within 1e-4. That bar leaves room for the two
packages' float32 summation orders only where the step is well
conditioned; this test backs the statement, made there, that the port's
float32 gradients lie no farther from a float64 run of the step than the
JAX package's own float32 gradients do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.models import losses as jlosses
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.models import losses as tlosses
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models.weights import (
    from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.utils import config


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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


def _jax_grads(variables, x, y, compute_dtype):
    cfg = jconfig.ModelConfig(base_features=8, compute_dtype=compute_dtype,
                              conv_impl="flax")
    model = build_unet(cfg)
    dt = jnp.dtype(compute_dtype)

    def loss(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x, dt), train=True, mutable=["batch_stats"])
        return jlosses.bce_with_logits(logits.astype(dt), jnp.asarray(y, dt))

    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                          variables["params"])
    return _flat(jax.device_get(jax.jit(jax.grad(loss))(params)))


def test_port_float32_gradients_are_as_exact_as_the_references():
    rng = np.random.default_rng(21)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    cfg = config.ModelConfig(base_features=8, compute_dtype="float32")
    model = build_unet(jconfig.ModelConfig(**dataclasses.asdict(cfg)))
    variables = jax.device_get(jax.jit(
        lambda key: init_unet(model, key, 32))(jax.random.key(0)))

    ref32 = _jax_grads(variables, x, y, "float32")
    with jax.enable_x64(True):
        ref64 = _jax_grads(variables, x, y, "float64")

    net = tunet.UNet(cfg)
    net.load_state_dict(from_flax_variables(variables))
    tlosses.bce_with_logits(net(torch.from_numpy(x), train=True),
                            torch.from_numpy(y)).backward()
    port = {k: p.grad.double().numpy() for k, p in net.named_parameters()}

    keys = sorted(ref64)
    assert sorted(port) == keys

    def dist(grads):
        a = np.concatenate([grads[k].ravel() for k in keys])
        b = np.concatenate([ref64[k].ravel() for k in keys])
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert dist(port) <= dist(ref32)
