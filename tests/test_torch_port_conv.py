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

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.ops.pallas import conv as jconv
from robotic_discovery_platform_tpu_torch.ops import conv as tconv


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


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16, as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def _conv1x1_cout1_mirror(x, w, scale, bias, relu):
    """A numpy mirror of csrc/conv1x1.cu's summation order for Cout = 1 and
    bfloat16 x, w (as float32 values): x [P, Cin], w [Cin]. On the vector
    head (``conv1x1_path``), G lanes share a pixel (the least power of two
    covering its Cin / 8 chunks of 8 channels); lane g sums chunk g in
    ascending channel order, and the G partials
    meet in an xor butterfly (offsets G/2 .. 1). On the FMA path one sum
    runs over Cin in ascending order. A product of two bfloat16 values is
    exact in float32, so each float32 add here rounds as ``fmaf`` does.
    Then the epilogue (multiply, add, ReLU) in float32."""
    p_, cin = x.shape
    if tconv.conv1x1_path(torch.bfloat16, cin, 1) == "fma":
        acc = np.zeros(p_, np.float32)
        for ci in range(cin):
            acc = acc + x[:, ci] * w[ci]
    else:
        e = 8
        chunks = cin // e
        g_lanes = 1
        while g_lanes < chunks:
            g_lanes *= 2
        part = []
        for g in range(g_lanes):
            acc = np.zeros(p_, np.float32)
            for ci in range(g * e, g * e + e) if g < chunks else ():
                acc = acc + x[:, ci] * w[ci]
            part.append(acc)
        m = g_lanes // 2
        while m >= 1:
            part = [part[i] + part[i ^ m] for i in range(g_lanes)]
            m //= 2
        acc = part[0]
    y = acc * np.float32(scale[0]) + np.float32(bias[0])
    return np.maximum(y, np.float32(0.0)) if relu else y


@pytest.mark.parametrize("cin,relu", [(64, False), (64, True), (8, False),
                                      (6, True)])
def test_conv1x1_head_order_matches_jax_interpret(cin, relu):
    """The head's summation order (its numpy mirror: the lane partials and
    the butterfly at Cin = 64 and 8, one ascending sum at Cin = 6, which no
    16-byte vector divides) against the JAX package's ``conv1x1`` in
    interpret mode on the same bfloat16 operands, float32 out, at
    atol = rtol = 1e-5."""
    rng = np.random.default_rng(cin + 100 * relu)
    x, wt, scale, bias = _operands(rng, 2, 9, 13, cin, 1, 1)
    x, wt = _bf16(x), _bf16(wt)
    want = np.asarray(jconv.conv1x1(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(bias), relu=relu,
        out_dtype=jnp.float32, interpret=True))
    got = _conv1x1_cout1_mirror(x.reshape(-1, cin), wt[:, 0], scale, bias,
                                relu)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want.reshape(-1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "dtype,cin,cout,aligned,want",
    [
        (torch.bfloat16, 64, 1, True, "head"),     # the U-Net head
        (torch.bfloat16, 8, 1, True, "head"),
        (torch.float32, 64, 1, True, "head"),      # a float32 head: 4/vector
        (torch.float32, 6, 1, True, "fma"),        # no whole vector
        (torch.bfloat16, 6, 1, True, "fma"),
        (torch.bfloat16, 264, 1, True, "fma"),     # past 32 vectors a pixel
        (torch.float32, 128, 1, True, "head"),     # 32 vectors
        (torch.bfloat16, 64, 1, False, "fma"),     # a misaligned view
        (torch.bfloat16, 48, 40, True, "fma"),     # Cout > 1: the GEMM body
        (torch.bfloat16, 64, 16, False, "fma"),
        (torch.bfloat16, 48, 2, True, "fma"),
        (torch.bfloat16, 40, 16, True, "fma"),
        (torch.float32, 48, 40, True, "fma"),
    ],
)
def test_conv1x1_path_rule(dtype, cin, cout, aligned, want):
    """Which kernel a CUDA x takes: the vector head for Cout = 1 with Cin a
    multiple of one 16-byte vector (at most 32 of them) on a 16-byte
    address, FMA otherwise (every Cout > 1); the C entry's rule
    (``pick_path`` in csrc/conv1x1.cu, which chip_smoke asks on the card)
    names the same widths."""
    assert tconv.conv1x1_path(dtype, cin, cout, x_aligned=aligned) == want
    src = (Path(tconv.__file__).resolve().parents[1] / "csrc"
           / "conv1x1.cu").read_text()
    body = re.search(r"int pick_path\(bool x16, int Cin, int Cout, int "
                     r"dtypes\) \{(.*?)\n\}", src, re.S).group(1)
    rules = [" ".join(r.split()) for r in re.findall(r"if \((.*?)\)\s*return",
                                                     body, re.S)]
    assert rules == [
        "x16 && Cout == 1 && Cin % e == 0 && Cin <= e * "
        "head::MAX_VECTORS",
    ]
    assert body.rstrip().endswith("return PATH_FMA;")
    assert "const int e = dtypes == 0 ? 4 : 8;" in body
    assert re.search(r"MAX_VECTORS = (\d+);", src).group(1) == str(
        tconv.CONV1X1_HEAD_VECTORS)


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


# -- the training conv: custom VJP and weight gradient -------------------------
#
# Tolerances, fixed before measuring: y, dx and dw of the port's conv3x3
# (plain versions on the CPU) against the JAX package's custom VJP in
# interpret mode within relative L2 1e-5 in float32 and 1e-2 in bfloat16
# (both sides round y, dx and dw to bfloat16, dw after its float32
# accumulation, as the reference's VJP does); the plain weight gradient
# against the JAX kernel in interpret mode within relative L2 1e-5.


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(3, 8), (16, 16)])
def test_conv3x3_vjp_matches_jax_interpret(cin, cout, dtype):
    import jax

    rng = np.random.default_rng(cin * 31 + cout)
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    g = rng.normal(size=(2, 8, 8, cout)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, g))
    y_ref, vjp = jax.vjp(lambda a, b: jconv.conv3x3(a, b, "interpret"),
                         jx, jw)
    dx_ref, dw_ref = vjp(jg)

    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    y = tconv.conv3x3(tx, tw, "interpret")
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tx.grad.dtype == tw.grad.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    for name, got, want in (("y", y, y_ref), ("dx", tx.grad, dx_ref),
                            ("dw", tw.grad, dw_ref)):
        want = np.asarray(want.astype(jnp.float32))
        assert got.shape == want.shape, name
        assert _rel_l2(_as_np(got), want) <= tol, name


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 3, 8), (2, 8, 8, 16, 16),
                                            (1, 16, 16, 64, 8)])
def test_conv3x3_grad_weights_plain_matches_jax_interpret(b, h, w, cin, cout):
    rng = np.random.default_rng(b * 7 + cin)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    g = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    want = np.asarray(jconv.conv3x3_grad_weights(
        jnp.asarray(x), jnp.asarray(g), interpret=True))
    got = tconv.conv3x3_grad_weights(torch.from_numpy(x), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (3, 3, cin, cout)
    assert _rel_l2(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("impl", ["flax", "xla"])
def test_conv3x3_plain_impls_match_the_kernel_path(impl):
    """The plain convs with autograd compute the custom VJP's y, dx and dw
    (float32, relative L2 1e-5); unknown impl names are refused."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 9, 7, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 5, 6)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 9, 7, 6)).astype(np.float32))
    grads = {}
    for name in (impl, "auto"):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = tconv.conv3x3(a, b, name)
        y.backward(g)
        grads[name] = (y.detach(), a.grad, b.grad)
    for got, want in zip(grads[impl], grads["auto"]):
        assert _rel_l2(got.numpy(), want.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="unknown conv impl"):
        tconv.conv3x3(x, w, "cuda")


def test_conv3x3_skips_dx_for_an_input_without_grad():
    """The first layer's image input takes no gradient: backward leaves
    it alone and still fills dw."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(1, 6, 6, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 4)).astype(
        np.float32)).requires_grad_()
    tconv.conv3x3(x, w, "auto").sum().backward()
    assert x.grad is None and w.grad is not None
    want = tconv.conv3x3_grad_weights_plain(x, torch.ones(1, 6, 6, 4))
    assert torch.allclose(w.grad, want, rtol=1e-6, atol=1e-6)


# (H = W, Cin, Cout) of the 18 training convs of the default model
_TRAIN_SHAPES = [(256, 3, 64), (256, 64, 64), (128, 64, 128), (128, 128, 128),
                 (64, 128, 256), (64, 256, 256), (32, 256, 512),
                 (32, 512, 512), (16, 512, 512), (16, 512, 512),
                 (32, 1024, 512), (32, 512, 256), (64, 512, 256),
                 (64, 256, 128), (128, 256, 128), (128, 128, 64),
                 (256, 128, 64), (256, 64, 64)]


@pytest.mark.parametrize("s,cin,cout", sorted(set(_TRAIN_SHAPES)))
def test_dw_split_count_fills_the_card_within_the_workspace_cap(s, cin, cout):
    """At the training batch (B = 4) the weight-gradient kernel's split
    count lies in [1, number of 8x16 pixel tiles], keeps the float32
    workspace under its cap, and fills one wave of blocks on the 132 SMs
    (one per SM, four for the gather kernel of Cin = 3): no more blocks
    than that unless one split already gives more, and one more split
    would overshoot unless the tiles or the cap run out first."""
    splits = tconv.dw_splits(4, s, s, cin, cout)
    th, tw = tconv.PIXEL_TILE
    tiles = 4 * -(-s // th) * -(-s // tw)
    if cin % 8:
        m_tiles = -(-9 * cin // tconv.DW_GATHER_TILE)
        wave = tconv.DW_GATHER_BLOCKS_PER_SM * tconv.SMS
    else:
        m_tiles, wave = -(-cin // tconv.DW_CIN_TILE), tconv.SMS
    blocks = m_tiles * -(-cout // tconv.COUT_TILE)
    per_split = 9 * cin * cout * 4
    assert 1 <= splits <= tiles
    assert splits == 1 or splits * per_split <= tconv.DW_WORKSPACE_CAP
    assert splits == 1 or splits * blocks <= wave
    assert ((splits + 1) * blocks > wave or splits == tiles
            or (splits + 1) * per_split > tconv.DW_WORKSPACE_CAP)


# (H = W, Cin, Cout) of the bf16 forward's launches: the default model's
# 18 (serving and training forward), their dx (Cin and Cout swapped), and
# the non-bilinear model's 16^2 layers
_FWD_SHAPES = sorted(set(_TRAIN_SHAPES) | {(s, co, ci) for s, ci, co in
                                          _TRAIN_SHAPES}
                     | {(16, 512, 1024), (16, 1024, 1024), (32, 1024, 512)})


@pytest.mark.parametrize("s,cin,cout", _FWD_SHAPES)
def test_fwd_split_count_fills_the_card_and_ignores_the_batch(s, cin, cout):
    """The bf16 forward's split count lies in [1, K chunks]; it is the
    same at B = 1, 4 and 8 (a frame's bits alone and inside a batch rest
    on it); one image's grid times the splits reaches the 132 SMs unless
    the K chunks or the workspace cap at B = 8 run out first, or one more
    split would overshoot; the workspace at B = 8 stays under its cap."""
    chunks = tconv.fwd_k_chunks(cin)
    plans = {b: tconv.fwd_plan(b, s, s, cin, cout) for b in (1, 4, 8)}
    splits = plans[1][0]
    assert {p[0] for p in plans.values()} == {splits}
    assert 1 <= splits <= chunks
    th, tw = tconv.PIXEL_TILE
    blocks = -(-s // th) * -(-s // tw) * -(-cout // tconv.COUT_TILE)
    per_split = tconv.FWD_CAP_BATCH * s * s * cout * 4
    assert (splits * blocks >= tconv.SMS // 2 or splits == chunks
            or (splits + 1) * per_split > tconv.FWD_WORKSPACE_CAP)
    assert (splits + 1) * blocks > tconv.SMS or splits == chunks or (
        (splits + 1) * per_split > tconv.FWD_WORKSPACE_CAP)
    for b, (n, ws) in plans.items():
        assert ws == (n * b * s * s * cout if n > 1 else 0)
    assert plans[8][1] * 4 <= tconv.FWD_WORKSPACE_CAP


def test_fwd_splits_only_the_narrow_maps():
    """The wide maps fill the card alone: no split, no workspace, one
    kernel; the 16^2 and 32^2 maps split K."""
    assert tconv.fwd_plan(1, 256, 256, 64, 64) == (1, 0)
    assert tconv.fwd_plan(1, 256, 256, 3, 64) == (1, 0)
    assert tconv.fwd_plan(1, 16, 16, 512, 512)[0] > 1
    assert tconv.fwd_plan(1, 32, 32, 1024, 512)[0] > 1
    # Cin = 3 flattens (tap, ci) into one 32-wide K chunk
    assert tconv.fwd_k_chunks(3) == 1 and tconv.fwd_k_chunks(40) == 3
