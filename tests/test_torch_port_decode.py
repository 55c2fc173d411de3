"""The port's coefficient lane against the JAX package's, on the CPU: the
host half of the split JPEG decode (serving/entropy.py, a copy), the
dequant + islow IDCT (ops/decode.py, whose kernel's plain version runs
here), the device half of the decode (ops/pipeline.decode_coef_batch), the
coefficient analyzers, the dispatcher's ``submit_coef`` and the servicer's
``format = 2`` and on-chip-decode paths.

JPEG bytes come from ``cv2.imencode``; other inputs from numpy seeds.
Tolerances, fixed before measuring:
- the entropy decode, the wire payload, the IDCT and the whole decode:
  bitwise (integer arithmetic throughout; the decode also bitwise against
  ``cv2.imdecode`` of the same bytes);
- the coefficient analyzer against the JAX package's: the pipeline bars of
  tests/test_torch_port_pipeline.py (masks, validity and counts equal;
  coverage and margin rtol 1e-5; curvature and spline rtol 1e-3);
- the coefficient lane against the pixel lane on the cv2-decoded pixels,
  within the port: identical (mask bytes, scalars, packed rows).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from robotic_discovery_platform_tpu.models.unet import (  # noqa: E402
    build_unet,
    init_unet,
)
from robotic_discovery_platform_tpu.ops import pipeline as jpipe  # noqa: E402
from robotic_discovery_platform_tpu.ops.pallas import decode as jdecode  # noqa: E402
from robotic_discovery_platform_tpu.ops.pallas.unet_infer import (  # noqa: E402
    PallasUNet,
)
from robotic_discovery_platform_tpu.serving import entropy as jentropy  # noqa: E402
from robotic_discovery_platform_tpu.utils.config import (  # noqa: E402
    GeometryConfig as JaxGeometryConfig,
)
from robotic_discovery_platform_tpu.utils.config import (  # noqa: E402
    ModelConfig as JaxModelConfig,
)
from robotic_discovery_platform_tpu_torch.io.frames import render_scene  # noqa: E402
from robotic_discovery_platform_tpu_torch.models.weights import (  # noqa: E402
    unet_from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.ops import decode  # noqa: E402
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe  # noqa: E402
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet  # noqa: E402
from robotic_discovery_platform_tpu_torch.serving import (  # noqa: E402
    entropy,
    ingest,
    messages,
)
from robotic_discovery_platform_tpu_torch.serving.batching import (  # noqa: E402
    BatchDispatcher,
    _CoefBucketBuffers,
    _Pending,
)
from robotic_discovery_platform_tpu_torch.serving.server import (  # noqa: E402
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils.config import (  # noqa: E402
    ModelConfig,
    ServerConfig,
)

_SF = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
}
H, W = 56, 72  # not a multiple of 16: the MCU padding and chroma crop


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


def _scene(h, w, seed=0):
    """A structured RGB frame (gradients, a disc, a little noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3) % 256, (yy * 2 + xx) % 256,
                    ((xx + yy) * 2) % 256], axis=-1).astype(np.uint8)
    disc = (yy - h // 2) ** 2 + (xx - w // 2) ** 2 < (min(h, w) // 3) ** 2
    img[disc] = (200, 64, 32)
    noise = rng.integers(-8, 8, img.shape)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def _jpeg(rgb, subsampling="420", quality=90, restart=0) -> bytes:
    params = [int(cv2.IMWRITE_JPEG_QUALITY), quality,
              int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(_SF[subsampling])]
    if restart:
        params += [int(cv2.IMWRITE_JPEG_RST_INTERVAL), restart]
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1].copy(), params)
    assert ok
    return buf.tobytes()


def _cv2_rgb(jpg: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _same_frame(a, b) -> None:
    assert (a.height, a.width, a.subsampling) == (b.height, b.width,
                                                  b.subsampling)
    for name in ("y", "cb", "cr", "qy", "qc"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


# -- the host half: entropy decode and the wire payload -----------------------


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("subsampling", ["444", "420", "422"])
def test_parse_jpeg_matches_jax(subsampling, quality):
    jpg = _jpeg(_scene(H, W, quality), subsampling, quality)
    got = entropy.parse_jpeg(jpg)
    assert got.subsampling == subsampling
    _same_frame(got, jentropy.parse_jpeg(jpg))


def test_parse_jpeg_with_restart_markers_matches_jax():
    jpg = _jpeg(_scene(64, 80, 4), "420", 90, restart=2)
    assert b"\xff\xd0" in jpg  # the stream carries RST markers
    _same_frame(entropy.parse_jpeg(jpg), jentropy.parse_jpeg(jpg))


@pytest.mark.parametrize("subsampling", ["444", "420", "422"])
def test_pack_unpack_match_jax(subsampling):
    jpg = _jpeg(_scene(H, W, 5), subsampling)
    frame = entropy.parse_jpeg(jpg)
    payload = entropy.pack_coefficients(frame)
    assert payload == jentropy.pack_coefficients(jentropy.parse_jpeg(jpg))
    back = entropy.unpack_coefficients(payload)
    _same_frame(back, frame)
    _same_frame(back, jentropy.unpack_coefficients(payload))


def _malformed(case: str) -> tuple[str, bytes]:
    jpg = _jpeg(_scene(H, W, 6))
    payload = entropy.pack_coefficients(entropy.parse_jpeg(jpg))
    sos = jpg.index(b"\xff\xda")
    return {
        "truncated_scan": ("parse", jpg[:sos + 40]),
        "not_a_jpeg": ("parse", b"\x89PNG\r\n\x1a\n" + jpg[8:]),
        "corrupt_scan": ("parse", jpg[:sos + 20] + b"\xff\x00" * 8
                         + b"\xff\xd9"),
        "short_payload": ("unpack", payload[:10]),
        "bad_magic": ("unpack", b"XXXX" + payload[4:]),
        "wrong_length": ("unpack", payload[:-2]),
    }[case]


@pytest.mark.parametrize("case", ["truncated_scan", "not_a_jpeg",
                                  "corrupt_scan", "short_payload",
                                  "bad_magic", "wrong_length"])
def test_malformed_streams_raise_value_error_like_jax(case):
    kind, data = _malformed(case)
    port, ref = ((entropy.parse_jpeg, jentropy.parse_jpeg) if kind == "parse"
                 else (entropy.unpack_coefficients,
                       jentropy.unpack_coefficients))
    with pytest.raises(ValueError) as want:
        ref(data)
    with pytest.raises(ValueError) as got:
        port(data)
    assert str(got.value) == str(want.value)


def test_progressive_jpeg_is_unsupported():
    ok, buf = cv2.imencode(".jpg", _scene(H, W), [
        int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1])
    with pytest.raises(ValueError, match="^unsupported"):
        entropy.parse_jpeg(buf.tobytes())


# -- dequant + IDCT -------------------------------------------------------------


def _coefs(b, n, lim=2047, qmax=255, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(-lim, lim + 1, (b, n, 64)).astype(np.int16)
    q = rng.integers(1, qmax + 1, (b, 64)).astype(np.uint16)
    return c, q


@pytest.mark.parametrize("b,n,lim,qmax", [
    (1, 1, 2047, 255), (2, 37, 2047, 255), (3, 300, 64, 16),
    (2, 50, 32767, 65535)])
def test_dequant_idct_plain_matches_jax_xla_bitwise(b, n, lim, qmax):
    """Full baseline range (|coef| <= 2047, q <= 255), typical values, and
    the whole int16 x uint16 range, where the int32 sums wrap."""
    c, q = _coefs(b, n, lim, qmax, seed=n)
    want = np.asarray(jdecode.dequant_idct(c, q, impl="xla"))
    got = decode.dequant_idct_plain(torch.from_numpy(c),
                                    torch.from_numpy(q.astype(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (b, n, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dequant_idct_plain_matches_jax_interpret_bitwise():
    c, q = _coefs(2, 24, seed=3)
    want = np.asarray(jdecode.dequant_idct(c, q, impl="interpret"))
    np.testing.assert_array_equal(
        decode.dequant_idct_plain(torch.from_numpy(c), torch.from_numpy(
            q.astype(np.int32))).numpy(), want)


def test_dequant_idct_wrapper_on_cpu_is_the_plain_version():
    c, q = _coefs(1, 9, seed=4)
    ct, qt = torch.from_numpy(c), torch.from_numpy(q.astype(np.int32))
    before = decode.dequant_idct.launches
    assert torch.equal(decode.dequant_idct(ct, qt),
                       decode.dequant_idct_plain(ct, qt))
    assert decode.dequant_idct.launches == before
    dc = np.zeros((1, 1, 64), np.int16)
    dc[0, 0, 0] = 10  # a DC-only block is flat
    flat = decode.dequant_idct(torch.from_numpy(dc),
                               torch.full((1, 64), 8, dtype=torch.int32))
    assert torch.unique(flat).numel() == 1


def _source_basis() -> np.ndarray:
    """``ISLOW_A`` of csrc/dequant_idct.cu as an [8, 8] int64 array."""
    src = (Path(decode.__file__).resolve().parents[1] / "csrc"
           / "dequant_idct.cu").read_text()
    body = re.search(r"__constant__ int32_t ISLOW_A\[64\] = \{(.*?)\};", src,
                     re.S).group(1)
    return np.asarray([int(v) for v in body.replace(",", " ").split()],
                      np.int64).reshape(8, 8)


def test_pass_matrices_are_the_separable_form_of_the_source_basis():
    """The two [64, 64] pass matrices are exactly ``kron(A, I8).T`` and
    ``kron(I8, A).T``, zero outside that pattern, for the ``A`` that the
    kernel holds in its source (equal to ``islow_basis`` and to the JAX
    package's basis)."""
    a = _source_basis()
    np.testing.assert_array_equal(a, decode.islow_basis())
    np.testing.assert_array_equal(a, jdecode.islow_basis())
    m1, m2 = decode._pass_matrices()
    eye = np.eye(8, dtype=np.int64)
    np.testing.assert_array_equal(m1, np.kron(a, eye).T)
    np.testing.assert_array_equal(m2, np.kron(eye, a).T)
    # flattened index 8*row + col: pass 1 mixes rows within a column,
    # pass 2 columns within a row; every other entry is 0
    k = np.arange(64)
    same_col = (k[:, None] % 8) == (k[None, :] % 8)
    same_row = (k[:, None] // 8) == (k[None, :] // 8)
    assert not np.any(m1[~same_col]) and not np.any(m2[~same_row])
    assert np.count_nonzero(m1) == np.count_nonzero(m2) == 8 * 64
    for m, jm in zip((m1, m2), jdecode._pass_matrices()):
        np.testing.assert_array_equal(m, np.asarray(jm))


def _separable_mirror(c: np.ndarray, q: np.ndarray) -> np.ndarray:
    """A numpy mirror of csrc/dequant_idct.cu: each 8x8 block dequantized
    in uint32, pass 1 applies A to each column and pass 2 to each row,
    each sum taken in uint32 (wrapping) in the kernel's order, each DESCALE
    an arithmetic shift of the value read as int32."""
    a = _source_basis().astype(np.uint32)
    b, n, _ = c.shape
    x = (c.astype(np.int32).astype(np.uint32)
         * q.astype(np.uint32)[:, None, :]).reshape(b * n, 8, 8)

    def one_pass(v):  # v[..., k, lane] -> out[..., i, lane], A @ v
        out = np.zeros_like(v)
        for i in range(8):
            for k in range(8):
                out[:, i, :] += a[i, k] * v[:, k, :]
        return out

    def descale(v, shift):
        return ((v + np.uint32(1 << (shift - 1))).view(np.int32)
                >> shift).astype(np.uint32)

    ws = descale(one_pass(x), 11)  # columns: x[block, row, col]
    s = one_pass(ws.transpose(0, 2, 1)).transpose(0, 2, 1)  # rows
    out = descale(s, 18).view(np.int32) + 128
    return np.clip(out, 0, 255).astype(np.int32).reshape(b, n, 64)


def _idct_case(case: str):
    """(coefs int16 [B, N, 64], q uint16 [B, 64]) of a named case."""
    rng = np.random.default_rng(17)
    if case == "random":
        return _coefs(2, 37, seed=9)
    if case == "n1":
        return _coefs(3, 1, seed=10)
    if case == "ragged":
        return _coefs(2, 1237, seed=11)
    q = np.full((2, 64), 255, np.uint16)
    shape = (2, 24, 64)
    c = {"plus2047": np.full(shape, 2047),
         "minus2047": np.full(shape, -2047),
         "signs2047": rng.choice(np.array([-2047, 2047]), shape)}[case]
    return c.astype(np.int16), q


@pytest.mark.parametrize("case", ["random", "n1", "ragged", "plus2047",
                                  "minus2047", "signs2047"])
def test_separable_idct_mirror_matches_jax_bitwise(case):
    """The separable uint32 passes, mirrored in numpy, bitwise equal to
    JAX ``dequant_idct(impl="interpret")`` and to the port's plain
    version: the full baseline range (|coef| <= 2047, q <= 255), N = 1, a
    ragged N, and every coefficient at +-2047 with q = 255, where the
    int32 sums wrap."""
    c, q = _idct_case(case)
    got = _separable_mirror(c, q)
    want = np.asarray(jdecode.dequant_idct(c, q, impl="interpret"))
    plain = decode.dequant_idct_plain(
        torch.from_numpy(c), torch.from_numpy(q.astype(np.int32))).numpy()
    assert got.dtype == want.dtype == plain.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    if case.endswith("2047"):  # pass 1's exact sums leave the int32 range
        deq = (c.astype(np.int64) * q.astype(np.int64)[:, None, :])
        exact = np.einsum("ir,mrj->mij", _source_basis(),
                          deq.reshape(-1, 8, 8))
        assert np.abs(exact).max() >= 2**31


# -- the device half of the decode ----------------------------------------------


@pytest.mark.parametrize("subsampling", ["444", "420", "422"])
def test_decode_coef_batch_matches_jax_and_cv2_bitwise(subsampling):
    jpgs = [_jpeg(_scene(H, W, s), subsampling, q)
            for s, q in ((1, 90), (2, 60))]
    frames = [entropy.parse_jpeg(j) for j in jpgs]
    stacked = [np.stack([getattr(f, k) for f in frames])
               for k in ("y", "cb", "cr", "qy", "qc")]
    got = tpipe.decode_coef_batch(
        *(torch.from_numpy(a.astype(np.int32 if a.dtype == np.uint16
                                    else a.dtype)) for a in stacked),
        height=H, width=W, subsampling=subsampling)
    assert got.dtype == torch.uint8 and got.shape == (2, H, W, 3)
    want = np.asarray(jpipe.decode_coef_batch(
        *stacked, height=H, width=W, subsampling=subsampling, impl="xla"))
    np.testing.assert_array_equal(got.numpy(), want)
    for i, jpg in enumerate(jpgs):
        np.testing.assert_array_equal(got[i].numpy(), _cv2_rgb(jpg))


def test_standard_tables_and_the_blank_frame():
    """The Annex K tables scaled as libjpeg scales them (cv2 at quality
    75 writes the same tables), and the warm-up frame decodes to gray."""
    frame = entropy.parse_jpeg(_jpeg(_scene(H, W), "420", 75))
    qy, qc = ingest.quant_tables(75)
    np.testing.assert_array_equal(frame.qy, qy)
    np.testing.assert_array_equal(frame.qc, qc)
    np.testing.assert_array_equal(ingest.quant_tables(50)[0],
                                  ingest.STANDARD_QUANT_TABLES[0])
    blank = ingest.blank_coefficient_frame(H, W, "422")
    rgb = tpipe.decode_coef_batch(*tpipe.coef_planes(blank), height=H,
                                  width=W, subsampling="422")
    assert torch.equal(rgb, torch.full((1, H, W, 3), 128, dtype=torch.uint8))


# -- the analyzers ---------------------------------------------------------------

SIZE, FH, FW = 64, 120, 160


@pytest.fixture(scope="module")
def scene():
    """A rendered frame sent as a JPEG, its coefficients, the cv2-decoded
    pixels, and a float32 base-8 model whose head bias puts half of the
    decoded frame's logits above zero (structured masks)."""
    rgb, _, depth = render_scene(np.random.default_rng(3), FH, FW)
    jpg = _jpeg(rgb, "420", 90)
    decoded = _cv2_rgb(jpg)
    model = build_unet(JaxModelConfig(base_features=8,
                                      compute_dtype="float32"))
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_unet(model, key, SIZE))(jax.random.key(0)))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.05, 0.2, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    x = jpipe.preprocess(jnp.asarray(decoded)[None], SIZE)
    median = float(np.median(np.asarray(model.apply(variables, x))))
    variables["params"]["Conv_0"]["bias"] = (
        variables["params"]["Conv_0"]["bias"] - median).astype(np.float32)
    net = unet_from_flax_variables(
        ModelConfig(base_features=8, compute_dtype="float32"), variables)
    return {"jpg": jpg, "frame": entropy.parse_jpeg(jpg), "rgb": decoded,
            "depth": depth, "model": model, "variables": variables,
            "folded": FoldedUNet(net, device="cpu"),
            "k": ingest.default_intrinsics(FW, FH).astype(np.float32)}


def test_coef_batch_analyzer_matches_jax(scene):
    """The port's coefficient analyzer against the JAX package's (its
    decode on the XLA path, its forward PallasUNet in interpret mode)."""
    cf, depth, k = scene["frame"], scene["depth"], scene["k"]
    pnet = PallasUNet(scene["model"], scene["variables"], interpret=True)
    janalyze = jpipe.make_coef_batch_analyzer(
        scene["model"], img_size=SIZE,
        geom_cfg=JaxGeometryConfig(kernel_impl="xla"),
        forward=lambda _v, x: pnet(x), height=FH, width=FW,
        subsampling=cf.subsampling)
    want = janalyze(scene["variables"], cf.y[None], cf.cb[None],
                    cf.cr[None], cf.qy[None], cf.qc[None], depth[None],
                    k[None], np.asarray([0.001], np.float32))
    analyze = tpipe.make_coef_batch_analyzer(
        scene["folded"], img_size=SIZE, device="cpu", height=FH, width=FW,
        subsampling=cf.subsampling)
    got = analyze(*tpipe.coef_planes(cf), depth[None], k[None],
                  np.asarray([0.001], np.float32))
    mask = got.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    assert 5.0 < 100 * mask.mean() < 95.0  # a structured mask
    np.testing.assert_allclose(got.mask_coverage.numpy(),
                               np.asarray(want.mask_coverage), rtol=1e-5)
    np.testing.assert_allclose(got.confidence_margin.numpy(),
                               np.asarray(want.confidence_margin), rtol=1e-5)
    for field in ("valid", "num_cloud_points", "num_edge_points",
                  "truncated"):
        np.testing.assert_array_equal(
            getattr(got.profile, field).numpy(),
            np.asarray(getattr(want.profile, field)), err_msg=field)
    for field in ("mean_curvature", "max_curvature", "spline_points"):
        np.testing.assert_allclose(getattr(got.profile, field).numpy(),
                                   np.asarray(getattr(want.profile, field)),
                                   rtol=1e-3, atol=0.0, err_msg=field)


def test_coef_frame_analyzer_equals_the_pixel_analyzer(scene):
    """Within the port: one coefficient frame and its cv2-decoded pixels
    give the same analysis, bit for bit."""
    k = torch.from_numpy(scene["k"])
    got = tpipe.make_coef_frame_analyzer(
        scene["folded"], img_size=SIZE, device="cpu")(
        scene["frame"], scene["depth"], k, 0.001)
    want = tpipe.make_frame_analyzer(
        scene["folded"], img_size=SIZE, device="cpu")(
        scene["rgb"], scene["depth"], k, 0.001)
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.mask_coverage, want.mask_coverage)
    for a, b in zip(got.profile, want.profile):
        assert torch.equal(a, b)


# -- the dispatcher's coefficient lane ------------------------------------------


def _dispatcher(scene, **kw):
    folded = scene["folded"]

    def factory(height, width, subsampling):
        return tpipe.make_coef_batch_analyzer(
            folded, img_size=SIZE, device="cpu", height=height, width=width,
            subsampling=subsampling, pack=True)

    return BatchDispatcher(
        tpipe.make_batch_analyzer(folded, img_size=SIZE, device="cpu",
                                  pack=True),
        window_ms=1.0, max_batch=4, watchdog_interval_s=0.0, device="cpu",
        coef_analyzer_factory=factory, **kw)


def test_submit_coef_bitwise_matches_pixel_lane(scene):
    """The same JPEG submitted as decoded pixels and as coefficients gives
    byte-equal packed rows through the real dispatcher (the coefficient
    lane groups by geometry and subsampling and decodes on the device)."""
    disp = _dispatcher(scene)
    try:
        ref = disp.submit(scene["rgb"], scene["depth"], scene["k"], 0.001,
                          timeout_s=60.0)
        got = disp.submit_coef(scene["frame"], scene["depth"], scene["k"],
                               0.001, timeout_s=60.0)
        np.testing.assert_array_equal(got.payload, ref.payload)
        assert got.unpack_mask().any()
        ref.release()
        got.release()
        disp.warm_coef(scene["frame"], np.stack([scene["depth"]] * 2),
                       np.stack([scene["k"]] * 2),
                       np.full((2,), 0.001, np.float32))
    finally:
        disp.stop()


def test_submit_coef_rejects_wrong_types(scene):
    disp = _dispatcher(scene)
    try:
        with pytest.raises(TypeError, match="CoefficientFrame"):
            disp.submit_coef(np.zeros((8, 8, 3), np.uint8),
                             np.zeros((8, 8), np.uint16),
                             np.eye(3, dtype=np.float32), 0.001)
        with pytest.raises(ValueError, match="depth"):
            disp.submit_coef(scene["frame"], np.zeros((4, 4), np.uint16),
                             np.eye(3, dtype=np.float32), 0.001)
    finally:
        disp.stop()


def test_coef_frame_without_factory_errors_frame(scene):
    disp = BatchDispatcher(lambda *a: None, window_ms=1.0, max_batch=2,
                           watchdog_interval_s=0.0, device="cpu")
    try:
        with pytest.raises(ValueError, match="coef_analyzer_factory"):
            disp.submit_coef(scene["frame"], scene["depth"], scene["k"],
                             0.001, timeout_s=10.0)
    finally:
        disp.stop()


def test_coef_bucket_buffers_fill_and_pad(scene):
    p0 = _Pending(scene["frame"], scene["depth"], scene["k"], 0.001)
    cf1 = entropy.parse_jpeg(_jpeg(scene["rgb"], "420", 60))
    p1 = _Pending(cf1, scene["depth"][::-1].copy(), scene["k"], 0.002)
    bufs = _CoefBucketBuffers(("key",), p0, 3, pin=False)
    bufs.fill(0, p0)
    bufs.fill(1, p1)
    bufs.pad(2)
    y, cb, cr, qy, qc, depths, intr, scales = (t.numpy()
                                               for t in bufs.tensors)
    np.testing.assert_array_equal(y[1], cf1.y)
    np.testing.assert_array_equal(y[2], scene["frame"].y)  # pad replicates 0
    np.testing.assert_array_equal(qc[1], cf1.qc.astype(np.int32))
    assert qy.dtype == np.int32
    np.testing.assert_array_equal(depths[1].view(np.uint16), p1.depth)
    np.testing.assert_array_equal(scales, np.float32([0.001, 0.002, 0.001]))


# -- the servicer ------------------------------------------------------------------


def _service(scene, tmp_path, **cfg):
    return VisionAnalysisService(
        scene["folded"], cfg=ServerConfig(
            model_img_size=SIZE, metrics_csv=str(tmp_path / "m.csv"), **cfg),
        device="cpu")


@pytest.mark.parametrize("batch_window_ms", [0.0, 2.0])
def test_format2_requests_answer_as_the_decoded_pixels(scene, tmp_path,
                                                       batch_window_ms):
    """A ``format = 2`` request gets the response of a raw request of the
    cv2-decoded pixels, byte for byte, in every mask format, directly and
    batched."""
    service = _service(scene, tmp_path, batch_window_ms=batch_window_ms,
                       max_batch=4)
    try:
        service.warmup_coef(FW, FH)
        for fmt in (0, 1, 2):
            want, got = service.analyze_stream(iter([
                ingest.raw_request(scene["rgb"], scene["depth"],
                                   mask_format=fmt),
                ingest.coef_request(scene["frame"], scene["depth"],
                                    mask_format=fmt)]))
            assert want.status.startswith(("OK", "DEGRADED"))
            for field in ("status", "mask", "mask_coverage",
                          "mean_curvature", "max_curvature",
                          "packed_spline", "spline_points"):
                assert getattr(got, field) == getattr(want, field), field
    finally:
        service.close()


def test_onchip_decode_sends_jpegs_down_the_coefficient_lane(
        scene, tmp_path, monkeypatch):
    monkeypatch.delenv("RDP_ONCHIP_DECODE", raising=False)
    assert not ingest.resolve_onchip_decode(False)
    assert ingest.resolve_onchip_decode(True)
    monkeypatch.setenv("RDP_ONCHIP_DECODE", "strict")
    assert ingest.resolve_onchip_decode(False)
    monkeypatch.setenv("RDP_ONCHIP_DECODE", "0")
    assert not ingest.resolve_onchip_decode(True)
    monkeypatch.delenv("RDP_ONCHIP_DECODE")

    img = messages.Image(scene["jpg"], FW, FH, ingest.FORMAT_ENCODED)
    assert isinstance(ingest.decode_color(img), np.ndarray)
    _same_frame(ingest.decode_color(img, onchip=True), scene["frame"])
    png = cv2.imencode(".png", scene["rgb"])[1].tobytes()
    assert isinstance(ingest.decode_color(
        messages.Image(png, FW, FH, 0), onchip=True), np.ndarray)

    service = _service(scene, tmp_path, onchip_decode=True)
    assert service.onchip
    lanes = []
    coef = service.analyze_coef
    # the analyzers are fields of the servicer's generation (Engine)
    monkeypatch.setattr(service, "_engine", service._engine._replace(
        analyze_coef=lambda *a: lanes.append("coef") or coef(*a)))
    depth = messages.Image(np.ascontiguousarray(scene["depth"], "<u2")
                           .tobytes(), FW, FH, ingest.FORMAT_RAW)
    got, = service.analyze_stream(iter([messages.AnalysisRequest(
        color_image=img, depth_image=depth)]))
    want, = service.analyze_stream(iter([ingest.raw_request(
        scene["rgb"], scene["depth"])]))
    service.close()
    assert lanes == ["coef"]
    assert (got.status, got.mask, got.mask_coverage) == (
        want.status, want.mask, want.mask_coverage)


def test_coef_dims_mismatch_answers_an_error(scene, tmp_path):
    request = ingest.coef_request(scene["frame"], scene["depth"])
    request.color_image.width = FW + 8
    service = _service(scene, tmp_path)
    out, = service.analyze_stream(iter([request]))
    service.close()
    assert out.status.startswith("ERROR: ValueError: coefficient payload is")


def test_chip_smoke_encoder_matches_libjpeg():
    """chip_smoke.py's numpy JPEG forward half (the card's machine has no
    cv2) against libjpeg's at the same quality and subsampling on a
    rendered frame: the same tables, at least 98% of the quantized
    coefficients equal (libjpeg's integer DCT rounds a few .5 cases the
    other way), and the decoded frame's PSNR against the source within
    0.1 dB of libjpeg's."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    rgb, _, _ = render_scene(np.random.default_rng(2), FH, FW)
    qy, qc = ingest.quant_tables(chip_smoke.COEF_QUALITY)
    ours = chip_smoke.encode_coefficients(entropy, rgb, qy, qc)
    jpg = _jpeg(rgb, "420", chip_smoke.COEF_QUALITY)
    ref = entropy.parse_jpeg(jpg)
    np.testing.assert_array_equal(ref.qy, qy)
    np.testing.assert_array_equal(ref.qc, qc)
    for name in ("y", "cb", "cr"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.shape == b.shape and np.mean(a == b) >= 0.98, name
    dec = tpipe.decode_coef_batch(*tpipe.coef_planes(ours), height=FH,
                                  width=FW, subsampling="420")[0].numpy()
    assert abs(chip_smoke.psnr_db(dec, rgb)
               - chip_smoke.psnr_db(_cv2_rgb(jpg), rgb)) <= 0.1
