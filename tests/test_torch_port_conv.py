"""The port's conv ops (robotic_discovery_platform_tpu_torch/ops/conv.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py. Inputs come from a numpy seed and go into both packages.

Tolerances, fixed before measuring:
- conv3x3_bn_relu in float32: atol = rtol = 1e-4 (the JAX package's own
  Pallas-vs-XLA bar, tests/test_pallas.py);
- conv1x1 in float32: 1e-5;
- fold_batchnorm: 1e-6 relative (float32 rsqrt on two backends).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.ops.pallas import conv as jconv
from robotic_discovery_platform_tpu_torch.ops import conv as tconv


def _operands(rng, b, h, w, cin, cout, taps):
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    shape = (3, 3, cin, cout) if taps == 9 else (cin, cout)
    wt = (rng.normal(size=shape) / np.sqrt(taps * cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    return x, wt, scale, bias


@pytest.mark.parametrize(
    "b,h,w,cin,cout,relu",
    [
        (1, 16, 16, 3, 8, True),     # the first layer's Cin = 3
        (1, 12, 20, 16, 32, True),   # a U-Net-like layer
        (2, 7, 9, 5, 6, False),      # ragged H, W, channels; batch 2
        (1, 37, 53, 3, 24, True),    # the ragged chip_smoke shape
    ],
    ids=["cin3", "unet_layer", "ragged_b2_norelu", "ragged_37x53"],
)
def test_conv3x3_bn_relu_matches_jax_interpret(b, h, w, cin, cout, relu):
    rng = np.random.default_rng(h * 100 + cin)
    x, wt, scale, bias = _operands(rng, b, h, w, cin, cout, 9)
    want = np.asarray(jconv.conv3x3_bn_relu(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(scale),
        jnp.asarray(bias), relu=relu, interpret=True))
    got = tconv.conv3x3_bn_relu(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(scale),
        torch.from_numpy(bias), relu=relu).numpy()
    assert got.shape == want.shape == (b, h, w, cout)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    if relu:
        assert (got >= 0).all()


@pytest.mark.parametrize(
    "b,h,w,cin,cout,relu",
    [
        (1, 16, 16, 8, 1, False),    # the squeezed Cout = 1 head
        (2, 8, 12, 6, 5, True),      # the general body, ReLU on
    ],
    ids=["head_cout1", "general"],
)
def test_conv1x1_matches_jax_interpret(b, h, w, cin, cout, relu):
    rng = np.random.default_rng(cin * 10 + cout)
    x, wt, scale, bias = _operands(rng, b, h, w, cin, cout, 1)
    want = np.asarray(jconv.conv1x1(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(scale),
        jnp.asarray(bias), relu=relu, out_dtype=jnp.float32,
        interpret=True))
    got = tconv.conv1x1(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(scale),
        torch.from_numpy(bias), relu=relu, out_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (b, h, w, cout)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("op", ["conv3x3", "conv1x1"])
def test_bf16_cpu_wrapper_is_the_plain_version(op):
    """bf16 operands with a float32 head output: on a CPU tensor the
    wrapper returns exactly its plain version's result (one rounding of
    the float32 epilogue)."""
    rng = np.random.default_rng(7)
    taps = 9 if op == "conv3x3" else 1
    x, wt, scale, bias = _operands(rng, 1, 9, 11, 4, 3, taps)
    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wt),
            torch.from_numpy(scale), torch.from_numpy(bias))
    if op == "conv3x3":
        got = tconv.conv3x3_bn_relu(*args)
        want = tconv.conv3x3_bn_relu_plain(*args)
        assert got.dtype == torch.bfloat16
    else:
        got = tconv.conv1x1(*args, out_dtype=torch.float32)
        want = tconv.conv1x1_plain(*args, out_dtype=torch.float32)
        assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [1, 8, 64])
def test_fold_batchnorm_matches_jax(c):
    rng = np.random.default_rng(c)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 0.1, c).astype(np.float32)
    mean = rng.normal(0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.05, 2.0, c).astype(np.float32)
    js, jb = jconv.fold_batchnorm({"scale": gamma, "bias": beta},
                                  {"mean": mean, "var": var})
    ts, tb = tconv.fold_batchnorm(gamma, beta, mean, var)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)
