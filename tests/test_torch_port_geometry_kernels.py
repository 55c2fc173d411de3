"""The port's fused geometry functions (ops/geometry_kernels.py) against
the JAX package's Pallas geometry kernels in interpret mode, on the CPU,
where each wrapper runs its plain version; and the curvature profile under
the default ``kernel_impl="auto"`` against JAX's ``"interpret"``.

Tolerances, fixed before measuring:
- deproject_edge_stats: maps, validity and the x/y min/max and count
  bitwise (and a numpy mirror of the kernel's tiling and fold, bitwise);
- bspline_design: the port's float64 against JAX's float32 on the same
  chord parameters, every Gram and right-hand-side entry within 1e-4 of
  the sum of its terms' magnitudes (|BW|^T|B| and |BW|^T|X|, float64);
- bspline_curvature: validity equal; kappa within rtol 1e-3 plus
  1e-3 * max|kappa|; r within rtol 1e-4 plus 1e-5 * max|r|; on control
  points that are all zero (no tangent at all) validity and kappa equal
  (equal nonzero control points are not compared: their tangent is
  rounding noise, which the two packages round differently around the
  1e-6 guard);
- compute_curvature_profile: as tests/test_torch_port_geometry.py
  (curvature and spline rtol 1e-3, validity and counts exact).
"""

import re
from pathlib import Path

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.ops import bspline as jbspline
from robotic_discovery_platform_tpu.ops import geometry as jgeom
from robotic_discovery_platform_tpu.ops.pallas import geometry as pgeom
from robotic_discovery_platform_tpu.utils.config import (
    GeometryConfig as JaxGeometryConfig,
)
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.ops import bspline as tbspline
from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
from robotic_discovery_platform_tpu_torch.ops import geometry_kernels as gk
from robotic_discovery_platform_tpu_torch.serving.ingest import (
    default_intrinsics,
)
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    resolve_kernel_impl,
)

H, W = 96, 128
PARAMS = np.asarray([100.0, 110.0, 64.0, 48.0, 0.001], np.float32)


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


def _mask_and_depth(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "scene":
        _, mask, depth = render_scene(rng, H, W)
        return (mask > 0).astype(np.uint8), depth
    if kind == "random":
        mask = (rng.random((H, W)) > 0.4).astype(np.uint8)
    elif kind == "empty":
        mask = np.zeros((H, W), np.uint8)
    else:  # speckle
        mask = np.zeros((H, W), np.uint8)
        mask[::17, ::13] = 1
    depth = (rng.random((H, W)) * 800 + 100).astype(np.uint16)
    depth[::7, ::5] = 0  # z == 0 holes
    return mask, depth


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["scene", "random", "empty", "speckle"])
def test_deproject_edge_stats_matches_jax_interpret(kind, stride):
    mask, depth = _mask_and_depth(kind, 7)
    if stride > 1:  # the pooled view the stride path analyzes
        md = np.where(mask > 0, depth, 0).reshape(
            H // stride, stride, W // stride, stride).max(axis=(1, 3))
        mask, depth = (md > 0).astype(np.uint8), md.astype(np.uint16)

    @jax.jit
    def jax_kernel(m, d, p):
        return pgeom.deproject_edge_stats(m, d, p[0], p[1], p[2], p[3], p[4],
                                          stride=stride, interpret=True)

    want = jax_kernel(jnp.asarray(mask), jnp.asarray(depth),
                      jnp.asarray(PARAMS))
    args = (torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
            *(torch.tensor(v) for v in PARAMS))
    launches = gk.deproject_edge_stats.launches
    got = gk.deproject_edge_stats(*args, stride=stride)
    assert gk.deproject_edge_stats.launches == launches  # plain on the CPU
    for a, b in zip([*got[:4], *got[4]], [*want[:4], *want[4]]):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    plain = gk.deproject_edge_stats_plain(*args, stride=stride)
    for a, b in zip([*got[:4], *got[4]], [*plain[:4], *plain[4]]):
        assert torch.equal(a, b)


def _deproject_source_constants() -> tuple[int, int, int]:
    """(THREADS, PIX, PART) of csrc/deproject_edge_stats.cu: threads per
    block, consecutive pixels of a row per thread, floats of a block's
    partial row."""
    src = (Path(gk.__file__).resolve().parents[1] / "csrc"
           / "deproject_edge_stats.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                     .group(1)) for name in ("THREADS", "PIX", "PART"))


def _deproject_mirror(mask, depth, params, stride: int):
    """A numpy mirror of csrc/deproject_edge_stats.cu: each thread takes
    PIX consecutive pixels of one row (reads past the row's end see mask
    0 and depth 0), THREADS threads a block; every float32 operation in
    the kernel's order, each rounded once (numpy float32 has no FMA);
    each block's partial row (x_min, x_max, y_min, y_max, n as a float),
    then the last block's fold of the rows in block order."""
    threads, pix, _ = _deproject_source_constants()
    f32, big = np.float32, np.float32(1e30)
    fx, fy, cx, cy, ds = (f32(v) for v in params)
    h, w = depth.shape
    wq = -(-w // pix)
    blocks = max(1, -(-h * wq // threads))
    d = np.zeros((h, wq * pix), f32)
    m = np.zeros((h, wq * pix), np.uint8)
    d[:, :w], m[:, :w] = depth, mask
    off = f32((stride - 1) * 0.5)
    vv = np.arange(h, dtype=f32)[:, None] * f32(stride) + off
    uu = np.arange(wq * pix, dtype=f32)[None, :] * f32(stride) + off
    z = d * ds
    ok = (m > 0) & (z > f32(0))
    x = ((uu - cx) * z) / fx
    y = ((vv - cy) * z) / fy
    quad = np.arange(h)[:, None] * wq + np.arange(wq * pix)[None, :] // pix
    block = quad // threads
    rows = []
    for b in range(blocks):
        sel = ok & (block == b)
        rows.append((x[sel].min(initial=big), x[sel].max(initial=-big),
                     y[sel].min(initial=big), y[sel].max(initial=-big),
                     f32(sel.sum())))
    s, n = [big, -big, big, -big], 0
    for row in rows:  # the last block's fold, in block order
        s = [min(s[0], row[0]), max(s[1], row[1]), min(s[2], row[2]),
             max(s[3], row[3])]
        n += int(row[4])
    return (x[:, :w], y[:, :w], z[:, :w], ok[:, :w],
            (*(f32(v) for v in s), np.int32(n)))


def _deproject_case(case: str):
    """(mask, depth as float32, stride) of a tiling case."""
    rng = np.random.default_rng(21)
    h, w, stride = {"ragged": (37, 53, 1), "ragged_s2": (45, 70, 2),
                    "scene": (96, 128, 1), "scene_s2": (48, 64, 2),
                    "none_valid": (37, 53, 1), "one_valid": (45, 70, 2),
                    "one_valid_tail": (37, 53, 1)}[case]
    if case.startswith("scene"):
        _, mask, depth = render_scene(rng, 96, 128)
        mask = (mask > 0).astype(np.uint8)
        if stride > 1:
            md = np.where(mask > 0, depth, 0).reshape(
                h, stride, w, stride).max(axis=(1, 3))
            mask, depth = (md > 0).astype(np.uint8), md
        return mask, depth.astype(np.float32), stride
    mask = (rng.random((h, w)) > 0.5).astype(np.uint8)
    depth = (rng.random((h, w)) * 800 + 100).astype(np.uint16)
    depth[::5, ::3] = 0
    if case == "none_valid":
        depth[mask > 0] = 0  # masked pixels have no depth
    elif case.startswith("one_valid"):
        mask[:] = 0
        r, c = (h // 2, w // 3) if case == "one_valid" else (h - 1, w - 1)
        mask[r, c], depth[r, c] = 1, 500
    return mask, depth.astype(np.float32), stride


@pytest.mark.parametrize("case", ["ragged", "ragged_s2", "scene", "scene_s2",
                                  "none_valid", "one_valid",
                                  "one_valid_tail"])
def test_deproject_tiling_mirror_matches_jax_interpret(case):
    """The kernel's 4-pixel tiling and its block-ordered fold, mirrored in
    numpy, bitwise equal to JAX's Pallas kernel in interpret mode and to
    the port's plain version: W % 4 != 0 (53, 70), strides 1 and 2, a
    frame with no valid pixel (the +-1e30 sentinels, count 0) and frames
    with one valid pixel (one of them in the ragged tail of the last
    row)."""
    mask, depth, stride = _deproject_case(case)
    _, pix, part = _deproject_source_constants()
    assert part == gk._DEPROJECT_PART  # the wrapper sizes the scratch
    h, w = depth.shape
    assert (w % pix != 0) == case.startswith(("ragged", "none", "one"))
    got = _deproject_mirror(mask, depth, PARAMS, stride)
    n = int(got[4][4])
    assert n == {"none_valid": 0, "one_valid": 1,
                 "one_valid_tail": 1}.get(case, n)
    if n == 0:
        big = np.float32(1e30)
        assert list(got[4][:4]) == [big, -big, big, -big]

    want = pgeom.deproject_edge_stats(
        jnp.asarray(mask), jnp.asarray(depth), *(jnp.float32(v)
                                                 for v in PARAMS),
        stride=stride, interpret=True)
    plain = gk.deproject_edge_stats_plain(
        torch.from_numpy(mask), torch.from_numpy(depth),
        *(torch.tensor(v) for v in PARAMS), stride=stride)
    for a, b, c in zip([*got[:4], *got[4]], [*want[:4], *want[4]],
                       [*plain[:4], *plain[4]]):
        b, c = np.asarray(b), c.numpy()
        assert np.asarray(a).dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(c, b)


def test_ticket_counter_is_per_stream(monkeypatch):
    """The wrapper's ticket counter: one zeroed int32 per (device, stream),
    the same tensor again for the same stream, another for another
    stream."""
    streams = iter([11, 11, 12])
    monkeypatch.setattr(gk, "_stream", lambda dev: next(streams))
    monkeypatch.setattr(gk, "_tickets", {})
    dev = torch.device("cpu")
    a, b, c = gk._ticket(dev), gk._ticket(dev), gk._ticket(dev)
    assert a is b and a is not c
    assert a.dtype == torch.int32 and a.shape == (1,) and int(a) == 0
    assert set(gk._tickets) == {(None, 11), (None, 12)}


def _design_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    wts = (rng.random(n) > 0.3).astype(np.float32)
    u = np.asarray(jbspline.chord_length_params(jnp.asarray(pts),
                                                jnp.asarray(wts)))
    return pts, wts, np.minimum(u, 1.0).astype(np.float32)


@pytest.mark.parametrize("n,c", [(256, 16), (6400, 16), (300, 9)])
def test_bspline_design_matches_jax_interpret(n, c):
    knots = jbspline.clamped_uniform_knots(c, 3)
    pts, wts, u = _design_inputs(n, n + c)
    jgram, jrhs = pgeom.bspline_design(
        jnp.asarray(pts), jnp.asarray(wts), jnp.asarray(u),
        pgeom.static_knots(knots), 3, interpret=True)
    t64 = [torch.from_numpy(a.astype(np.float64)) for a in (pts, wts, u)]
    gram, rhs = gk.bspline_design(*t64, knots, 3)
    assert gram.dtype == rhs.dtype == torch.float64
    assert gram.shape == (c, c) and rhs.shape == (c, 3)
    mag_gram, mag_rhs = gk.bspline_design_plain(
        t64[0].abs(), t64[1].abs(), t64[2], knots, 3)
    for got, want, mag in ((gram, jgram, mag_gram), (rhs, jrhs, mag_rhs)):
        err = np.abs(got.numpy() - np.asarray(want, np.float64))
        assert np.all(err <= 1e-4 * mag.numpy()), err.max()


def _basis_windows(u, knots, p: int, dtype=float):
    """A pure-Python mirror of ``basis_window`` in csrc/bspline_design.cu
    (``dtype=float``: float64) and of the same recursion in
    csrc/bspline_curvature.cu (``dtype=np.float32``): the span search, then
    the recursion over the p + 1 entries s - p .. s that can be nonzero,
    with the kernels' operations in the kernels' order (each operation on
    two ``dtype`` scalars rounds to nearest in ``dtype``, as
    ``__dsub_rn``/``__fsub_rn`` and the rest do). Returns (s, windows):
    ``windows[d]`` is the window after degree d, entry s - p + a at index
    a, of which a >= p - d belong to degree d's row; s = -1 when no span
    holds u."""
    kn = [dtype(k) for k in knots]
    u, zero, one = dtype(u), dtype(0.0), dtype(1.0)
    last, n_knots = kn[-1], len(kn)
    s = -1
    for t in range(n_knots - 1):
        lo, hi = kn[t], kn[t + 1]
        in_span = u >= lo and (u < hi or (hi >= last and u <= hi))
        if hi - lo > zero and in_span:
            s = t
    b = [zero] * p + [one]
    windows = {0: list(b)}
    if s < 0:
        return -1, windows
    for d in range(1, p + 1):
        for a in range(p - d, p + 1):
            i = s - p + a
            v = zero
            if 0 <= i <= n_knots - 2 - d:
                if a > p - d:
                    dl = kn[i + d] - kn[i]
                    left = (u - kn[i]) / dl if dl > zero else zero
                    v = left * b[a]
                if a < p:
                    dr = kn[i + d + 1] - kn[i + 1]
                    right = (kn[i + d + 1] - u) / dr if dr > zero else zero
                    rt = right * b[a + 1]
                    v = v + rt if a > p - d else rt
            b[a] = v
        windows[d] = list(b)
    return s, windows


def _basis_window(u: float, knots, p: int):
    """(s, [b(s - p), .., b(s)]) of the degree-p row, float64: what
    ``basis_window`` in csrc/bspline_design.cu computes."""
    s, windows = _basis_windows(u, knots, p)
    return s, windows[p if s >= 0 else 0]


def _window_rows(us, knots, p: int, degree=None, dtype=float) -> np.ndarray:
    """The full basis rows of ``degree`` (default p) that the degree-p
    windows imply: zeros outside each window."""
    degree = p if degree is None else degree
    c = len(knots) - degree - 1
    rows = np.zeros((len(us), c), np.float64 if dtype is float else dtype)
    for n, u in enumerate(us):
        s, windows = _basis_windows(u, knots, p, dtype)
        if s < 0:
            continue
        for a in range(p - degree, p + 1):
            if 0 <= s - p + a < c:
                rows[n, s - p + a] = windows[degree][a]
    return rows


@pytest.mark.parametrize("c,p", [(16, 3), (8, 2)])
def test_windowed_basis_equals_the_full_recursion(c, p):
    """The kernel's windowed basis rows equal ``_basis_columns``'s value
    for value (np.array_equal: outside the window the full recursion may
    leave a -0.0 where the window has +0.0) at every knot, 0, 1, just
    below 1, outside [0, 1] and at 1000 seeded parameters."""
    knots = tbspline.clamped_uniform_knots(c, p)
    rng = np.random.default_rng(11)
    us = np.concatenate([knots, [0.0, 1.0, np.nextafter(1.0, 0.0), -0.5,
                                 1.5], rng.random(1000)])
    want = tbspline._basis_columns(
        torch.from_numpy(us)[:, None], torch.from_numpy(knots), p).numpy()
    got = _window_rows(us, knots, p)
    assert np.array_equal(got, want)
    # every parameter in [0, 1] lands in a span: p + 1 entries, at most
    # p + 1 of them nonzero
    inside = (us >= 0) & (us <= 1)
    assert all(_basis_window(float(u), knots, p)[0] >= 0 for u in us[inside])
    assert not np.any(got[~inside])


@pytest.mark.parametrize("c,p", [(16, 3), (8, 2)])
def test_banded_design_equals_the_plain_version(c, p):
    """The Gram matrix and right-hand side summed from the windows, block
    by block at each point's span (the kernel's banded accumulation),
    equal ``bspline_design_plain``'s within 1e-12 of the terms'
    magnitudes; Gram entries outside the band are exactly 0 in both."""
    knots = tbspline.clamped_uniform_knots(c, p)
    pts, wts, _ = _design_inputs(640, 5)
    pts, wts = pts.astype(np.float64), wts.astype(np.float64)
    u = tbspline.chord_length_params(torch.from_numpy(pts),
                                     torch.from_numpy(wts)).numpy()
    gram, rhs = np.zeros((c, c)), np.zeros((c, 3))
    for n in range(len(u)):
        s, b = _basis_window(float(u[n]), knots, p)
        if s < 0:
            continue
        b = np.asarray(b)
        bw = b * wts[n]
        gram[s - p:s + 1, s - p:s + 1] += np.outer(bw, b)
        rhs[s - p:s + 1] += np.outer(bw, pts[n])
    t64 = [torch.from_numpy(a) for a in (pts, wts, u)]
    want = gk.bspline_design_plain(*t64, knots, p)
    mag = gk.bspline_design_plain(t64[0].abs(), t64[1].abs(), t64[2], knots,
                                  p)
    for got, w, m in zip((gram, rhs), want, mag):
        assert np.all(np.abs(got - w.numpy()) <= 1e-12 * m.numpy())
    i, j = np.indices((c, c))
    off_band = np.abs(i - j) > p
    assert np.all(gram[off_band] == 0) and np.all(want[0].numpy()[off_band] == 0)


def test_fit_bspline_fused_path_matches_the_reference():
    """The fused fit (design through bspline_design) and the reference fit
    are the same float64 computation on the CPU."""
    knots = jbspline.clamped_uniform_knots(16, 3)
    pts, wts, _ = _design_inputs(640, 3)
    tp, tw = torch.from_numpy(pts), torch.from_numpy(wts)
    ref = tbspline.fit_bspline(tp, tw, knots, impl="xla")
    fused = tbspline.fit_bspline(tp, tw, knots, impl="fused")
    for a, b in zip(ref, fused):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown fit impl"):
        tbspline.fit_bspline(tp, tw, knots, impl="pallas")


@pytest.mark.parametrize("case", ["random", "scene", "degenerate"])
def test_bspline_curvature_matches_jax_interpret(case):
    c = 16
    knots = jbspline.clamped_uniform_knots(c, 3)
    rng = np.random.default_rng(21)
    if case == "random":
        ctrl = rng.normal(size=(c, 3)).astype(np.float32)
    elif case == "scene":  # a fitted top edge: small coordinates, in metres
        x = np.linspace(-0.1, 0.1, c)
        ctrl = np.stack([x, -0.05 + 0.4 * x ** 2, 0.8 + 0.01 * x],
                        axis=1).astype(np.float32)
    else:
        ctrl = np.zeros((c, 3), np.float32)
    u = np.linspace(0.0, 1.0, 100, dtype=np.float32)
    jk, jv, jr = pgeom.bspline_curvature(
        jnp.asarray(ctrl), jnp.asarray(u), pgeom.static_knots(knots), 3,
        interpret=True)
    tk, tv, tr = gk.bspline_curvature(torch.from_numpy(ctrl),
                                      torch.from_numpy(u), knots, 3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jk, jr = np.asarray(jk), np.asarray(jr)
    if case == "degenerate":
        assert not tv.any()
        np.testing.assert_array_equal(tk.numpy(), jk)
        return
    assert tv.all()
    np.testing.assert_allclose(tk.numpy(), jk, rtol=1e-3,
                               atol=1e-3 * np.abs(jk).max())
    np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-4,
                               atol=1e-5 * np.abs(jr).max())


@pytest.mark.parametrize("c,p", [(16, 3), (8, 2)])
def test_curvature_windows_equal_the_full_recursion(c, p):
    """The curvature kernel's float32 windows of degree p, and the degree
    p - 1 and p - 2 windows it keeps on the way, equal ``_basis_columns``'s
    float32 rows of those degrees value for value, at every knot, 0, 1,
    just below 1, outside [0, 1] and at 1000 seeded parameters."""
    knots = tbspline.clamped_uniform_knots(c, p)
    rng = np.random.default_rng(12)
    us = np.concatenate([knots, [0.0, 1.0, np.nextafter(1.0, 0.0), -0.5,
                                 1.5], rng.random(1000)]).astype(np.float32)
    for degree in (p, p - 1, p - 2):
        want = tbspline._basis_columns(
            torch.from_numpy(us)[:, None],
            torch.from_numpy(knots.astype(np.float32)), degree).numpy()
        got = _window_rows(us, knots, p, degree, np.float32)
        assert got.shape == want.shape
        assert np.array_equal(got, want), degree


def _fma32(a, b, c):
    """fmaf on float32 operands, through float64: the product is exact
    there, the sum rounds to float64 and then to float32 (one rounding
    but at a float32 tie)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _curvature_mirror(ctrl, us, knots, p: int):
    """A float32 mirror of csrc/bspline_curvature.cu: per sample the span
    and the windows (``_basis_windows``), then only the columns
    c = s - p .. s of (B_{p-1} m1) and (B_{p-2} m2), each over its band
    (``derivative_bands``) in ascending row order, r, r' and r'' by fmaf in
    ascending c, and the curvature formula in the kernel's roundings.
    Returns (kappa [N], valid [N], r [N, 3]) as numpy."""
    f32 = np.float32
    c = len(knots) - p - 1
    m1b, m2b = (b.astype(np.float32) for b in gk.derivative_bands(
        tuple(np.asarray(knots, np.float64).tolist()), p))
    n = len(us)
    kappa = np.zeros(n, np.float32)
    valid = np.zeros(n, bool)
    r = np.zeros((n, 3), np.float32)
    for i, u in enumerate(us):
        if not np.isfinite(u):
            r[i] = np.nan
            continue
        s, windows = _basis_windows(f32(u), knots, p, np.float32)
        r0, r1, r2 = ([f32(0.0)] * 3 for _ in range(3))
        if s >= 0:
            b, b1, b2 = windows[p], windows[p - 1][1:], windows[p - 2][2:]
            for a in range(p + 1):
                cc = s - p + a
                if not 0 <= cc < c:
                    continue
                d1 = d2 = f32(0.0)
                if a >= 1:
                    d1 = _fma32(b1[a - 1], m1b[cc, 0], d1)
                if a <= p - 1:
                    d1 = _fma32(b1[a], m1b[cc, 1], d1)
                for t in range(3):
                    if 0 <= a + t - 2 <= p - 2:
                        d2 = _fma32(b2[a + t - 2], m2b[cc, t], d2)
                for j in range(3):
                    cj = f32(ctrl[cc, j])
                    r0[j] = _fma32(b[a], cj, r0[j])
                    r1[j] = _fma32(d1, cj, r1[j])
                    r2[j] = _fma32(d2, cj, r2[j])
        cx = r1[1] * r2[2] - r1[2] * r2[1]
        cy = r1[2] * r2[0] - r1[0] * r2[2]
        cz = r1[0] * r2[1] - r1[1] * r2[0]
        num = np.sqrt(cx * cx + cy * cy + cz * cz)
        den = np.sqrt(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2])
        valid[i] = den > f32(1e-6)
        dd = max(den, f32(1e-6))
        kappa[i] = num / (dd * dd * dd) if valid[i] else f32(0.0)
        r[i] = r0
    return kappa, valid, r


def test_derivative_bands_hold_every_nonzero():
    """The bands the curvature kernel takes are the derivative matrices'
    entries (m1[c + t, c], m2[c + t, c]); everything else is 0."""
    knots = tbspline.clamped_uniform_knots(16, 3)
    key = tuple(knots.tolist())
    m1b, m2b = gk.derivative_bands(key, 3)
    for order, band in ((1, m1b), (2, m2b)):
        m = tbspline._deriv_matrix_product(key, 3, order)
        assert band.shape == (16, order + 1)
        rebuilt = np.zeros_like(m)
        for cc in range(16):
            rebuilt[cc:cc + order + 1, cc] = band[cc]
        assert np.array_equal(rebuilt, m)


@pytest.mark.parametrize("case", ["random", "scene", "degenerate"])
def test_banded_curvature_mirror_matches_jax_interpret(case):
    """The kernel's banded sums (its float32 mirror) against the JAX
    package's fused kernel in interpret mode, at the tolerances of
    ``test_bspline_curvature_matches_jax_interpret``."""
    c = 16
    knots = jbspline.clamped_uniform_knots(c, 3)
    rng = np.random.default_rng(21)
    if case == "random":
        ctrl = rng.normal(size=(c, 3)).astype(np.float32)
    elif case == "scene":
        x = np.linspace(-0.1, 0.1, c)
        ctrl = np.stack([x, -0.05 + 0.4 * x ** 2, 0.8 + 0.01 * x],
                        axis=1).astype(np.float32)
    else:
        ctrl = np.zeros((c, 3), np.float32)
    u = np.linspace(0.0, 1.0, 100, dtype=np.float32)
    jk, jv, jr = (np.asarray(a) for a in pgeom.bspline_curvature(
        jnp.asarray(ctrl), jnp.asarray(u), pgeom.static_knots(knots), 3,
        interpret=True))
    tk, tv, tr = _curvature_mirror(ctrl, u, knots, 3)
    np.testing.assert_array_equal(tv, jv)
    if case == "degenerate":
        assert not tv.any()
        np.testing.assert_array_equal(tk, jk)
        return
    assert tv.all()
    np.testing.assert_allclose(tk, jk, rtol=1e-3, atol=1e-3 * np.abs(jk).max())
    np.testing.assert_allclose(tr, jr, rtol=1e-4, atol=1e-5 * np.abs(jr).max())


@pytest.mark.parametrize("index", range(8))
def test_banded_curvature_mirror_holds_the_card_bars(index):
    """chip_smoke's curvature cases (more than one block, degree 2 and 5,
    C = 32, u at the knots, collinear and coincident control points, a NaN
    u), rehearsed on the CPU: the kernel's float32 mirror within the card's
    bars (``chip_smoke.curvature_within``) of the plain version; kappa 0 on
    the line with every sample valid, every coincident sample invalid."""
    label, ctrl, u, knots, deg = chip_smoke.curvature_case_inputs(
        tbspline)[index]
    want = [t.numpy() for t in gk.bspline_curvature_plain(
        torch.from_numpy(ctrl), torch.from_numpy(u), knots, deg)]
    got = _curvature_mirror(ctrl, u, knots, deg)
    ok, what = chip_smoke.curvature_within(got, want)
    assert ok, f"{label}: {what}"
    if label == "collinear":
        assert got[1].all() and not got[0].any()
    if label == "coincident":
        assert not got[1].any() and not got[0].any()
    if label == "NaN u":
        assert np.isnan(want[2][7]).all() and not want[1][7]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("seed", [0, 4, 9])
def test_curvature_profile_auto_matches_jax_interpret(seed, stride):
    h, w = 120, 160
    _, mask, depth = render_scene(np.random.default_rng(seed), h, w)
    mask = (mask > 0).astype(np.uint8)
    k = default_intrinsics(w, h).astype(np.float32)
    want = jgeom.compute_curvature_profile(
        jnp.asarray(mask), jnp.asarray(depth), jnp.asarray(k), 0.001,
        JaxGeometryConfig(kernel_impl="interpret", stride=stride))
    cfg = GeometryConfig(stride=stride)
    assert cfg.kernel_impl == "auto" and resolve_kernel_impl("auto") == "fused"
    got = tgeom.compute_curvature_profile(
        torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
        torch.from_numpy(k), 0.001, cfg)
    assert bool(got.valid)
    for field in ("valid", "num_cloud_points", "num_edge_points",
                  "truncated"):
        assert np.asarray(getattr(want, field)) == getattr(got, field).numpy()
    for field in ("mean_curvature", "max_curvature", "spline_points"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-3, atol=0.0, err_msg=field)
    # the fused path and the reference ops agree on the CPU as well
    ref = tgeom.compute_curvature_profile(
        torch.from_numpy(mask), torch.from_numpy(depth.astype(np.float32)),
        torch.from_numpy(k), 0.001, GeometryConfig(stride=stride,
                                                   kernel_impl="xla"))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl,want", [("auto", "fused"), ("pallas", "fused"),
                                       ("interpret", "fused"), ("xla", "xla")])
def test_kernel_impl_resolution(impl, want):
    assert resolve_kernel_impl(impl) == want
    with pytest.raises(ValueError, match="unknown kernel_impl"):
        resolve_kernel_impl("triton")
