#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``robotic_discovery_platform_tpu_
torch/csrc`` and drives the serving paths of the default model
(``ModelConfig()``: bilinear U-Net, 64 base features, 256x256 bf16 input)
on 480x640 frames under the default geometry path
(``GeometryConfig.kernel_impl = "auto"``), in phases; any mismatch raises
and the script exits non-zero:

1. environment: torch, the card's name and power limit, kernel build time;
2. every kernel against its plain PyTorch version on the card, at each
   shape the main path gives it (plus ragged and float32 cases, and the
   conv at the batched path's B = 8), with its time, the plain version's,
   one cuDNN call's where one computes the same function, and the bound:
   the two convs, then the geometry kernels (deprojection bitwise at
   480x640 stride 1 and 240x320 stride 2, the design contractions of 6400
   edge-point slots, the curvature at 100 samples) and the mask bitpack
   (bitwise, [8, 480, 640]);
3. the analyzer: the kernel forward against the plain forward, exact
   launch counts per frame (18 conv3x3_bn_relu + 1 conv1x1 + 1 each
   geometry kernel), the same frames against the reference geometry ops
   (``kernel_impl="xla"``), warm per-frame time and peak memory, and a
   profiler breakdown of one frame;
4. the servicer: a stream of raw requests in each mask format through
   ``analyze_stream`` (and through a real gRPC server where grpc is
   installed), checked against the analyzer; then 8 concurrent streams on
   the direct path, and batched (``batch_window_ms=2``, ``max_batch=8``):
   every batched response byte-equal to the direct path's, one bitpack
   and 18 conv3x3 launches per dispatch, dispatch sizes, frames/s and the
   device's busy share;
5. geometry on a rendered scene's true mask, card against CPU.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Imports only the port, never JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM
H100_F64_FLOPS = 67e12  # float64 peak (on the tensor cores), H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
FRAME_H, FRAME_W = 480, 640
SEED = 0

# (H = W, Cin, Cout) of the 18 conv3x3_bn_relu launches of one forward of
# the default model, in forward order
MAIN_PATH_3X3 = [
    (256, 3, 64), (256, 64, 64),
    (128, 64, 128), (128, 128, 128),
    (64, 128, 256), (64, 256, 256),
    (32, 256, 512), (32, 512, 512),
    (16, 512, 512), (16, 512, 512),
    (32, 1024, 512), (32, 512, 256),
    (64, 512, 256), (64, 256, 128),
    (128, 256, 128), (128, 128, 64),
    (256, 128, 64), (256, 64, 64),
]
HEAD = (256, 64, 1)  # the conv1x1 head: H = W, Cin, Cout

BF16_TOL = 1.6e-2  # two bf16 ulps, kernel vs plain from the same operands
F32_TOL = 1e-4  # float32 kernel vs plain, TF32 off
LOGITS_REL_L2 = 2e-2  # full-width bf16 forward, kernel vs plain
GEOM_RTOL = 1e-3  # curvature, card vs CPU, and the fused path vs "xla"
SPLINE_ATOL = 1e-6  # spline points (metres), beside GEOM_RTOL
# bspline_design (float64) vs its plain version: each entry within
# DESIGN_RTOL of the sum of its terms' magnitudes (|BW|^T|B|, |BW|^T|X|)
DESIGN_RTOL = 1e-12
# bspline_curvature (float32) vs its plain version: kappa within
# CURV_RTOL (relative) plus CURV_RTOL * max|kappa|, r within R_RTOL plus
# R_RTOL * max|r|; the validity flags equal
CURV_RTOL = 1e-4
R_RTOL = 1e-5
# conv3x3_bn_relu shapes (H = W, Cin, Cout) also checked at B = 8, the
# batched dispatch's first use of the kernel beyond one frame
BATCH_3X3 = [(256, 3, 64), (256, 64, 64), (64, 256, 256), (16, 512, 512)]
MAX_BATCH = 8
STREAMS = 8  # concurrent streams of the servicer phase's last two legs


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms (CUDA events over ``iters`` calls
    after a warm-up; inputs stay in L2 between calls, as they arrive from
    the previous layer in the forward)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(prof) -> list:
    """(device ms, count, name) of each kernel and copy the profiler saw on
    the card, largest first. Only device-side rows: a CPU op's row carries
    the device time of the kernels it launched, which their own rows
    carry as well."""
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` in ms: the kernels and copies
    it launched, from torch.profiler, over ``iters`` calls after a
    warm-up. For work far shorter than its launch cost, where CUDA events
    around back-to-back calls time the host."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in device_rows(prof)) / iters


def bound_ms(flops: float, nbytes: float,
             peak: float = H100_BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    at ``peak`` and the bytes at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bitwise_equal(torch, a, b) -> bool:
    """Equal bit for bit (float tensors compared as their int32 bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# -- phase 2: kernels against their plain versions ---------------------------


def kernel_phase(torch, conv) -> dict:
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def operands(b, h, w, cin, cout, dtype, taps):
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda")
        shape = (3, 3, cin, cout) if taps == 9 else (cin, cout)
        wt = torch.randn(*shape, generator=gen, device="cuda") / (taps * cin) ** 0.5
        scale = torch.rand(cout, generator=gen, device="cuda") + 0.5
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
        return x.to(dtype), wt.to(dtype), scale, bias

    results = {}
    shapes = sorted(set(MAIN_PATH_3X3), key=MAIN_PATH_3X3.index)
    cases = [(1, s, s, cin, cout, torch.bfloat16, True)
             for s, cin, cout in shapes]
    cases += [(MAX_BATCH, s, s, cin, cout, torch.bfloat16, False)
              for s, cin, cout in BATCH_3X3]
    cases += [(1, 37, 53, 3, 24, torch.bfloat16, False),
              (2, 37, 53, 40, 24, torch.float32, False)]
    for b, h, w, cin, cout, dtype, main in cases:
        x, wt, scale, bias = operands(b, h, w, cin, cout, dtype, 9)
        got = conv.conv3x3_bn_relu(x, wt, scale, bias)
        want = conv.conv3x3_bn_relu_plain(x, wt, scale, bias)
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"conv3x3_bn_relu {(b, h, w, cin, cout)} {dtype}: max |err| "
              f"{err} over tolerance {tol}")
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        sc, bc = scale.view(1, -1, 1, 1), bias.view(1, -1, 1, 1)
        t = {
            "ms": time_ms(torch, lambda: conv.conv3x3_bn_relu(
                x, wt, scale, bias)),
            "plain_ms": time_ms(torch, lambda: conv.conv3x3_bn_relu_plain(
                x, wt, scale, bias)),
            "library_ms": time_ms(torch, lambda: torch.clamp_min(
                F.conv2d(xc, wc, padding=1).float() * sc + bc, 0).to(dtype)),
        }
        nbytes = (x.numel() + wt.numel() + b * h * w * cout) * x.element_size() \
            + 8 * cout
        flops = 2.0 * b * h * w * 9 * cin * cout
        t["bound_ms"], t["bound_by"] = bound_ms(flops, nbytes)
        t["max_abs_err"] = err
        log(f"conv3x3_bn_relu [{b},{h},{w},{cin}]->{cout} {str(dtype)[6:]}: "
            f"max|err| {err:.3g} (tol {tol}) ms {t['ms']:.4f} plain "
            f"{t['plain_ms']:.4f} cudnn {t['library_ms']:.4f} bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']}) "
            f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
        if main:
            results[("conv3x3_bn_relu", h, cin, cout)] = t

    for b, h, w, cin, cout, dtype, odt, main in [
        (1, 256, 256, 64, 1, torch.bfloat16, torch.float32, True),
        (1, 64, 96, 48, 40, torch.bfloat16, torch.bfloat16, False),
        (1, 64, 96, 48, 40, torch.float32, torch.float32, False),
    ]:
        x, wt, scale, bias = operands(b, h, w, cin, cout, dtype, 1)
        got = conv.conv1x1(x, wt, scale, bias, out_dtype=odt)
        want = conv.conv1x1_plain(x, wt, scale, bias, out_dtype=odt)
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"conv1x1 {(b, h, w, cin, cout)} {dtype}: max |err| {err} over "
              f"tolerance {tol}")
        xc = x.permute(0, 3, 1, 2)
        wc = wt.t().reshape(cout, cin, 1, 1).contiguous(
            memory_format=torch.channels_last)
        sc, bc = scale.view(1, -1, 1, 1), bias.view(1, -1, 1, 1)
        t = {
            "ms": time_ms(torch, lambda: conv.conv1x1(
                x, wt, scale, bias, out_dtype=odt)),
            "plain_ms": time_ms(torch, lambda: conv.conv1x1_plain(
                x, wt, scale, bias, out_dtype=odt)),
            "library_ms": time_ms(torch, lambda: (
                F.conv2d(xc, wc).float() * sc + bc).to(odt)),
        }
        nbytes = (x.numel() + wt.numel()) * x.element_size() + 8 * cout \
            + b * h * w * cout * torch.empty((), dtype=odt).element_size()
        flops = 2.0 * b * h * w * cin * cout
        t["bound_ms"], t["bound_by"] = bound_ms(flops, nbytes)
        t["max_abs_err"] = err
        log(f"conv1x1 [{b},{h},{w},{cin}]->{cout} {str(dtype)[6:]}->"
            f"{str(odt)[6:]}: max|err| {err:.3g} (tol {tol}) ms "
            f"{t['ms']:.4f} plain {t['plain_ms']:.4f} cudnn "
            f"{t['library_ms']:.4f} bound {t['bound_ms']:.4f} "
            f"({t['bound_by']})")
        if main:
            results[("conv1x1", h, cin, cout)] = t
    return results


def timings(torch, kernel, plain) -> dict:
    """A small kernel's device time per call (the profiler's, as its launch
    costs more than its work) and its plain version's, beside the wall of
    one call in a back-to-back run (CUDA events; the host's wrapper cost
    bounds it). No single PyTorch call computes these functions, so there
    is no library time."""
    return {"ms": device_ms(torch, kernel), "plain_ms": device_ms(torch, plain),
            "call_ms": time_ms(torch, kernel),
            "plain_call_ms": time_ms(torch, plain), "library_ms": None}


def timing_text(t: dict) -> str:
    return (f"device ms {t['ms']:.4f} plain {t['plain_ms']:.4f}; ms per call "
            f"back to back {t['call_ms']:.4f} plain {t['plain_call_ms']:.4f}; "
            f"bound {t['bound_ms']:.6f} ({t['bound_by']})")


def geometry_kernel_phase(torch, port) -> dict:
    """The geometry kernels and the mask bitpack against their plain
    versions at the main path's shapes, on a rendered scene's true mask:
    deprojection at 480x640 (stride 1) and 240x320 (stride 2), the design
    contractions of that frame's 6400 edge-point slots, the curvature at
    its 100 samples, and the bitpack of a [8, 480, 640] batch (plus a
    ragged one)."""
    from robotic_discovery_platform_tpu_torch.ops import bspline, geometry
    from robotic_discovery_platform_tpu_torch.ops import geometry_kernels as gk
    from robotic_discovery_platform_tpu_torch.ops import pack

    F = torch.nn.functional
    results = {}
    rng = np.random.default_rng(SEED + 2)
    _, mask, depth = port.render_scene(rng, FRAME_H, FRAME_W)
    k = torch.from_numpy(
        port.default_intrinsics(FRAME_W, FRAME_H).astype(np.float32)).cuda()
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    ds = torch.tensor(0.001, dtype=torch.float32, device="cuda")
    mask_t = torch.from_numpy((mask > 0).astype(np.uint8)).cuda()
    depth_t = torch.from_numpy(depth.astype(np.float32)).cuda()
    pooled = F.max_pool2d(torch.where(mask_t > 0, depth_t, 0.0)[None, None],
                          2, 2)[0, 0]
    views = {1: (mask_t, depth_t), 2: ((pooled > 0).to(torch.uint8), pooled)}
    maps = None
    for stride, (m, d) in views.items():
        args = (m, d, fx, fy, cx, cy, ds)
        got = gk.deproject_edge_stats(*args, stride=stride)
        want = gk.deproject_edge_stats_plain(*args, stride=stride)
        torch.cuda.synchronize()
        got_l, want_l = [*got[:4], *got[4]], [*want[:4], *want[4]]
        for i, (a, b) in enumerate(zip(got_l, want_l)):
            check(bitwise_equal(torch, a, b),
                  f"deproject_edge_stats stride {stride}: output {i} differs "
                  "from the plain version")
        h, w = d.shape
        t = timings(torch, lambda: gk.deproject_edge_stats(
            *args, stride=stride), lambda: gk.deproject_edge_stats_plain(
            *args, stride=stride))
        t["max_abs_err"] = 0.0
        # mask u8 + depth f32 in, x/y/z f32 + valid u8 out, params and stats
        nbytes = h * w * (1 + 4 + 3 * 4 + 1) + 5 * 4 + 5 * 4
        t["bound_ms"], t["bound_by"] = bound_ms(10.0 * h * w, nbytes,
                                                H100_F32_FLOPS)
        log(f"deproject_edge_stats {h}x{w} stride {stride}: bitwise; "
            f"{timing_text(t)}; valid {int(got[4][4])}")
        results[("deproject_edge_stats", stride)] = t
        if stride == 1:
            maps = want

    cfg = port.GeometryConfig()
    e_pts, e_w, *_ = geometry._edge_points(*maps[:4], cfg, maps[4])
    s_pts, s_w = geometry._sort_by_x(e_pts, e_w)
    pts, wts = s_pts.double(), s_w.double()
    u = bspline.chord_length_params(pts, wts)
    knots = bspline.clamped_uniform_knots(cfg.num_ctrl, cfg.spline_degree)
    deg = cfg.spline_degree
    got = gk.bspline_design(pts, wts, u, knots, deg)
    want = gk.bspline_design_plain(pts, wts, u, knots, deg)
    mag = gk.bspline_design_plain(pts.abs(), wts.abs(), u, knots, deg)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b, m in zip(("gram", "rhs"), got, want, mag):
        check(bool(((a - b).abs() <= DESIGN_RTOL * m).all()),
              f"bspline_design {name}: beyond {DESIGN_RTOL} of the terms' "
              f"magnitudes (max |err| {float((a - b).abs().max())})")
        err = max(err, float((a - b).abs().max()))
    n, c = pts.shape[0], cfg.num_ctrl
    t = timings(torch, lambda: gk.bspline_design(pts, wts, u, knots, deg),
                lambda: gk.bspline_design_plain(pts, wts, u, knots, deg))
    t["max_abs_err"] = err
    nbytes = 8 * (n * 5 + len(knots) + c * c + 3 * c)
    # a basis row has deg + 1 nonzeros: (deg + 1)^2 Gram and (deg + 1) * 3
    # right-hand-side products per point, a multiply and an add each
    nz = deg + 1
    t["bound_ms"], t["bound_by"] = bound_ms(2.0 * n * (nz * nz + 3 * nz),
                                            nbytes, H100_F64_FLOPS)
    log(f"bspline_design N={n} C={c}: max|err| {err:.3g} (within "
        f"{DESIGN_RTOL} of |BW|^T|.|); {timing_text(t)}; "
        f"{int(s_w.sum())} weighted points")
    results[("bspline_design",)] = t

    ctrl, _ = bspline.fit_bspline(s_pts, s_w, knots, deg,
                                  cfg.spline_smoothing)
    u_fine = torch.linspace(0.0, 1.0, cfg.num_samples, dtype=torch.float32,
                            device="cuda")
    got = gk.bspline_curvature(ctrl, u_fine, knots, deg)
    want = gk.bspline_curvature_plain(ctrl, u_fine, knots, deg)
    torch.cuda.synchronize()
    check(torch.equal(got[1], want[1]),
          "bspline_curvature: validity flags differ from the plain version")
    kmax, rmax = float(want[0].abs().max()), float(want[2].abs().max())
    check(torch.allclose(got[0], want[0], rtol=CURV_RTOL,
                         atol=CURV_RTOL * kmax),
          f"bspline_curvature kappa: max |err| "
          f"{float((got[0] - want[0]).abs().max())} beyond rtol {CURV_RTOL}")
    check(torch.allclose(got[2], want[2], rtol=R_RTOL, atol=R_RTOL * rmax),
          f"bspline_curvature r: max |err| "
          f"{float((got[2] - want[2]).abs().max())} beyond rtol {R_RTOL}")
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[2] - want[2]).abs().max()))
    ns = cfg.num_samples
    t = timings(torch, lambda: gk.bspline_curvature(ctrl, u_fine, knots, deg),
                lambda: gk.bspline_curvature_plain(ctrl, u_fine, knots, deg))
    t["max_abs_err"] = err
    # in: ctrl, u, knots and the nonzero bands of m1 (2 per row, C + 1
    # rows) and m2 (3 per row, C + 2 rows); out: kappa, valid, r
    nbytes = (4 * (3 * c + ns + len(knots) + 2 * (c + 1) + 3 * (c + 2))
              + ns * (4 + 1 + 12))
    # the derivative control points m1 @ ctrl and m2 @ ctrl once; per
    # sample r, r', r'' from deg + 1, deg and deg - 1 basis nonzeros, and
    # about 40 operations of the curvature formula
    flops = (2 * 3 * (2 * (c + 1) + 3 * (c + 2))
             + ns * (2 * 3 * (3 * deg) + 40))
    t["bound_ms"], t["bound_by"] = bound_ms(flops, nbytes, H100_F32_FLOPS)
    log(f"bspline_curvature N={ns} C={c}: validity equal, max|err| "
        f"{err:.3g} (kappa max {kmax:.4g}); {timing_text(t)}")
    results[("bspline_curvature",)] = t

    gen = np.random.default_rng(SEED + 3)
    for shape, main in (((MAX_BATCH, FRAME_H, FRAME_W), True),
                        ((3, 37, 53), False)):
        m_np = (gen.random(shape) < 0.5).astype(np.uint8) * gen.choice(
            np.array([1, 7, 255], np.uint8), shape)
        m = torch.from_numpy(m_np).cuda()
        got = pack.bitpack_mask(m)
        want = pack.bitpack_mask_plain(m)
        torch.cuda.synchronize()
        check(torch.equal(got, want)
              and np.array_equal(got.cpu().numpy(),
                                 np.packbits(m_np != 0, axis=-1)),
              f"bitpack_mask {shape}: differs from the plain version or "
              "np.packbits")
        b, h, w = shape
        t = timings(torch, lambda: pack.bitpack_mask(m),
                    lambda: pack.bitpack_mask_plain(m))
        t["max_abs_err"] = 0.0
        nbytes = b * h * w + b * h * ((w + 7) // 8)
        t["bound_ms"], t["bound_by"] = bound_ms(16.0 * b * h * (w + 7) // 8,
                                                nbytes, H100_F32_FLOPS)
        log(f"bitpack_mask {list(shape)}: bitwise (and np.packbits); "
            f"{timing_text(t)}")
        if main:
            results[("bitpack_mask",)] = t
    return results


KERNELS = {
    # name: (source, the TPU kernel it replaces, results keys of one frame)
    "conv3x3_bn_relu": (
        "robotic_discovery_platform_tpu_torch/csrc/conv3x3_bn_relu.cu",
        "robotic_discovery_platform_tpu/ops/pallas/conv.py:178",
        [("conv3x3_bn_relu", *s) for s in MAIN_PATH_3X3]),
    "conv1x1": (
        "robotic_discovery_platform_tpu_torch/csrc/conv1x1.cu",
        "robotic_discovery_platform_tpu/ops/pallas/conv.py:301",
        [("conv1x1", *HEAD)]),
    "deproject_edge_stats": (
        "robotic_discovery_platform_tpu_torch/csrc/deproject_edge_stats.cu",
        "robotic_discovery_platform_tpu/ops/pallas/geometry.py:117",
        [("deproject_edge_stats", 1)]),
    "bspline_design": (
        "robotic_discovery_platform_tpu_torch/csrc/bspline_design.cu",
        "robotic_discovery_platform_tpu/ops/pallas/geometry.py:198",
        [("bspline_design",)]),
    "bspline_curvature": (
        "robotic_discovery_platform_tpu_torch/csrc/bspline_curvature.cu",
        "robotic_discovery_platform_tpu/ops/pallas/geometry.py:266",
        [("bspline_curvature",)]),
    "bitpack_mask": (
        "robotic_discovery_platform_tpu_torch/csrc/bitpack_mask.cu",
        "robotic_discovery_platform_tpu/ops/pallas/pack.py:117",
        [("bitpack_mask",)]),
}


def launch_counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from robotic_discovery_platform_tpu_torch.ops import conv
    from robotic_discovery_platform_tpu_torch.ops import geometry_kernels as gk
    from robotic_discovery_platform_tpu_torch.ops import pack

    return {"conv3x3_bn_relu": conv.conv3x3_bn_relu, "conv1x1": conv.conv1x1,
            "deproject_edge_stats": gk.deproject_edge_stats,
            "bspline_design": gk.bspline_design,
            "bspline_curvature": gk.bspline_curvature,
            "bitpack_mask": pack.bitpack_mask}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def kernel_record(results: dict, launches: dict) -> dict:
    """The kernels' JSON record: per kernel, the sums over one frame's
    launches of each per-launch time (so ``ms`` is the kernel's device
    time per frame; the bitpack's is one [8, 480, 640] dispatch), the
    worst error over its main-path shapes, and the launch count of the
    servicer phase's legs."""
    kernels = []
    for name, (source, replaces, keys) in KERNELS.items():
        rows = [results[k] for k in keys]
        ops_bound = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        byte_bound = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        library = [r["library_ms"] for r in rows]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if ops_bound >= byte_bound else "bytes",
            "library_ms": None if None in library else sum(library),
        })
    return {"kernels": kernels}


# -- phase 3: the analyzer ---------------------------------------------------


def seeded_model(torch, port, x0):
    """Full-width default model with conv weights from a seeded generator
    and BatchNorm statistics as a trained network keeps them: each
    layer's mean and variance measured on its input for frame 0 (a float32
    forward, layer by layer), perturbed from a numpy seed, with scale and
    bias drawn from the same seed, so folding matters. (Statistics drawn
    independently of the activations make a random network amplify
    rounding chaotically: two float32 summation orders then differ by
    2.6% in the bf16 logits, on the CPU as on the card.) The head's bias
    is set so that half of frame 0's logits are positive: a structured
    mask, not an all-or-nothing one."""
    cfg = port.ModelConfig()
    net = port.UNet(cfg).init_weights(
        torch.Generator().manual_seed(SEED)).eval()
    calib = port.UNet(port.ModelConfig(compute_dtype="float32")).eval()
    calib.load_state_dict(net.state_dict())
    calib = calib.to("cuda")
    rng = np.random.default_rng(SEED)

    def calibrate(bn, inputs):
        x = inputs[0].double().reshape(-1, inputs[0].shape[-1])
        c = x.shape[1]

        def draw(a):
            return torch.from_numpy(a).to(x)

        bn.mean.copy_(x.mean(0) + draw(rng.normal(0.0, 0.1, c)) * x.std(0))
        bn.var.copy_(x.var(0) * draw(rng.uniform(0.8, 1.25, c)))
        bn.scale.copy_(draw(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(draw(rng.normal(0.0, 0.1, c)))

    hooks = [m.register_forward_pre_hook(calibrate)
             for m in calib.modules() if isinstance(m, port.BatchNorm)]
    with torch.no_grad():
        calib(x0)
    for h in hooks:
        h.remove()
    net.load_state_dict({k: v.cpu() for k, v in calib.state_dict().items()})
    with torch.no_grad():
        median = float(port.FoldedUNet(net, device="cuda").forward_plain(
            x0).median())
        net.Conv_0.bias -= median
    return net


def analyzer_phase(torch, port, frames) -> tuple:
    rgb0, _ = frames[0]
    x0 = port.preprocess(torch.from_numpy(rgb0).cuda()[None], 256)
    folded = port.FoldedUNet(seeded_model(torch, port, x0), device="cuda")

    with torch.no_grad():
        got = folded(x0)
        want = folded.forward_plain(x0)
    torch.cuda.synchronize()
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    check(bool(torch.isfinite(got).all()) and got.shape == (1, 256, 256, 1),
          f"kernel logits not finite or of shape {tuple(got.shape)}")
    check(rel <= LOGITS_REL_L2,
          f"kernel forward vs plain forward: relative L2 {rel} > "
          f"{LOGITS_REL_L2}")
    log(f"forward: kernel vs plain logits relative L2 {rel:.3g} "
        f"(tol {LOGITS_REL_L2}); logits mean {float(want.mean()):.3g} std "
        f"{float(want.std()):.3g}")

    analyze = port.make_frame_analyzer(folded, img_size=256, device="cuda")
    check(port.GeometryConfig().kernel_impl == "auto",
          "the default geometry path is not kernel_impl='auto'")
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    analyze(*frames[0], k, 0.001)  # first-call costs out of the timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, wall = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev_ms = []
    for rgb, depth in frames:
        t0 = time.perf_counter()
        start.record()
        out = analyze(rgb, depth, k, 0.001)
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        outs.append(out)
    n = len(frames)
    counts = read_launches()
    want = {"conv3x3_bn_relu": 18 * n, "conv1x1": n,
            "deproject_edge_stats": n, "bspline_design": n,
            "bspline_curvature": n, "bitpack_mask": 0}
    check(counts == want,
          f"launch counts after {n} frames: {counts}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    for out in outs:
        check(out.mask.shape == (FRAME_H, FRAME_W)
              and 0.0 <= float(out.mask_coverage) <= 100.0
              and bool(torch.isfinite(out.profile.mean_curvature)),
              "analyzer output malformed")
    log(f"analyzer: {n} frames, launches {counts} (18 + 1 + 1 + 1 + 1 per "
        f"frame); warm ms/frame (CUDA "
        f"events) {' '.join(f'{v:.3f}' for v in dev_ms)}; host wall "
        f"ms/frame {' '.join(f'{v:.3f}' for v in wall)}; peak memory "
        f"{peak / 2**20:.1f} MiB; coverage "
        f"{' '.join(f'{float(o.mask_coverage):.1f}' for o in outs)}; valid "
        f"{[bool(o.profile.valid) for o in outs]}")

    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: folded(x0), iters=10)
        fwd_plain_ms = time_ms(torch, lambda: folded.forward_plain(x0),
                               iters=10)
    log(f"forward alone: kernels {fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms")

    # the same frames through the reference geometry ops
    xla = port.make_frame_analyzer(
        folded, img_size=256, geom_cfg=port.GeometryConfig(kernel_impl="xla"),
        device="cuda")
    refs = [xla(rgb, depth, k, 0.001) for rgb, depth in frames]
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(outs, refs)):
        check(torch.equal(a.mask, b.mask),
              f"frame {i}: masks differ between 'auto' and 'xla'")
        for field in ("valid", "num_cloud_points", "num_edge_points",
                      "truncated"):
            check(torch.equal(getattr(a.profile, field),
                              getattr(b.profile, field)),
                  f"frame {i} {field}: 'auto' "
                  f"{getattr(a.profile, field)} vs 'xla' "
                  f"{getattr(b.profile, field)}")
        for field in ("mean_curvature", "max_curvature",
                      "spline_points"):
            check(torch.allclose(getattr(a.profile, field),
                                 getattr(b.profile, field),
                                 rtol=GEOM_RTOL, atol=SPLINE_ATOL
                                 if field == "spline_points" else 0),
                  f"frame {i} {field}: 'auto' vs 'xla' beyond rtol "
                  f"{GEOM_RTOL}")
    log("analyzer 'auto' vs 'xla' on the same frames: masks, validity "
        "and counts equal, curvature and spline within "
        f"rtol {GEOM_RTOL} (spline atol {SPLINE_ATOL} m); mean "
        f"curvature {[round(float(o.profile.mean_curvature), 6) for o in outs]}"
        f" vs {[round(float(o.profile.mean_curvature), 6) for o in refs]}")
    # the geometry of one frame alone, on its analyzer's mask
    m0 = outs[0].mask
    d0 = torch.from_numpy(frames[0][1].astype(np.float32)).cuda()
    k0 = torch.from_numpy(k.astype(np.float32)).cuda()
    geom = {impl: (lambda c=port.GeometryConfig(kernel_impl=impl):
                   port.compute_curvature_profile(m0, d0, k0, 0.001, c))
            for impl in ("auto", "xla")}
    log("geometry of one frame: " + "; ".join(
        f"'{impl}' {time_ms(torch, fn, iters=10):.3f} ms per call back to "
        f"back (CUDA events), {device_ms(torch, fn, iters=10):.3f} ms of "
        "device time (profiler)" for impl, fn in geom.items()))
    profile_frame(torch, analyze, frames[0], k)
    return folded, outs


def profile_frame(torch, analyze, frame, k) -> None:
    """Device time by kernel over one frame, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        analyze(*frame, k, 0.001)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    total = sum(r[0] for r in rows)
    if not rows:
        log("profiler: no device time recorded")
        return
    log(f"profiler: one frame, host wall {wall:.3f} ms, device kernel time "
        f"{total:.3f} ms (device busy {100 * total / wall:.1f}% of the wall)")
    for ms, count, key in rows[:12]:
        log(f"  {ms:8.3f} ms {count:4d}x {key[:90]}")


# -- phase 4: the servicer ---------------------------------------------------


def decode_png(data: bytes) -> np.ndarray:
    """8-bit grayscale PNG -> array: cv2 where installed, else the
    filter-0 form that the port's stdlib writer emits."""
    try:
        import cv2
    except ImportError:
        import struct
        import zlib

        pos, idat, (w, h) = 8, b"", (0, 0)
        while pos < len(data):
            n, tag = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + n]
            if tag == b"IHDR":
                w, h = struct.unpack(">II", body[:8])
            elif tag == b"IDAT":
                idat += body
            pos += 12 + n
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
        check(not rows[:, 0].any(), "PNG rows use a filter other than 0")
        return rows[:, 1:]
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


def concurrent_streams(service, streams: list) -> tuple[list, float]:
    """Each request list through ``service.analyze_stream`` on its own
    thread; returns (responses per stream, wall seconds)."""
    import threading

    out: list = [None] * len(streams)
    errors: list = []

    def run(i):
        try:
            out[i] = list(service.analyze_stream(iter(streams[i])))
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(streams))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    check(all(o is not None for o in out), "a stream did not finish")
    return out, wall


def device_busy(torch, fn) -> str:
    """Device kernel time over the host wall of ``fn``, from torch.profiler
    (CUPTI traces every thread's launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sum(r[0] for r in device_rows(prof))
    return (f"host wall {wall:.1f} ms, device kernel time {dev:.1f} ms "
            f"(device busy {100 * dev / wall:.1f}%)")


def servicer_phase(torch, port, folded, frames, want_masks) -> dict:
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    cfg = port.ServerConfig(address="localhost:0",
                            metrics_csv=str(tmp / "metrics.csv"),
                            metrics_flush_every=1,
                            calibration_path=str(tmp / "none.npz"))
    service = port.VisionAnalysisService(folded, cfg=cfg, device="cuda")
    service.warmup(FRAME_W, FRAME_H)
    requests = [port.raw_request(rgb, depth, mask_format=i % 3)
                for i, (rgb, depth) in enumerate(frames)]

    def verify(responses, leg: str, order=None) -> None:
        order = range(len(requests)) if order is None else order
        check(len(responses) == len(order), f"{leg}: response count")
        for i, resp in zip(order, responses):
            check(resp.status.startswith(("OK", "DEGRADED")),
                  f"{leg} frame {i}: status {resp.status!r}")
            mask = port.decode_mask_wire(resp.mask)
            if mask is None:
                mask = (decode_png(resp.mask) > 0).astype(np.uint8)
            check(np.array_equal(mask, want_masks[i]),
                  f"{leg} frame {i}: served mask differs from the analyzer's")
            check(0.0 <= resp.mask_coverage <= 100.0 and resp.proc_time_ms > 0,
                  f"{leg} frame {i}: coverage {resp.mask_coverage} / "
                  f"proc_time_ms {resp.proc_time_ms}")

    reset_launches()
    t0 = time.perf_counter()
    responses = list(service.analyze_stream(iter(requests)))
    stream_s = time.perf_counter() - t0
    launches = read_launches()
    n = len(requests)
    want = {"conv3x3_bn_relu": 18 * n, "conv1x1": n,
            "deproject_edge_stats": n, "bspline_design": n,
            "bspline_curvature": n, "bitpack_mask": 0}
    check(launches == want, f"servicer launch counts {launches} for {n} "
          f"frames, want {want}")
    verify(responses, "in-process")
    rows = (tmp / "metrics.csv").read_text().strip().splitlines()[1:]
    check(len(rows) == n, f"metrics CSV has {len(rows)} rows for {n} frames")
    log(f"servicer: {n} frames, statuses {[r.status for r in responses]}, "
        f"proc_time_ms {' '.join(f'{r.proc_time_ms:.2f}' for r in responses)}"
        f", {n / stream_s:.1f} frames/s over the stream, {len(rows)} "
        f"metrics rows; launches {launches}")

    try:
        import grpc

        from robotic_discovery_platform_tpu_torch.serving import grpc_service
        from robotic_discovery_platform_tpu_torch.serving.proto import (
            vision_grpc,
            vision_pb2,
        )
    except ImportError as exc:
        log(f"gRPC leg did not run: {exc}")
    else:
        server, servicer = grpc_service.build_server(cfg, folded,
                                                     device="cuda")
        server.start()
        try:
            with grpc.insecure_channel(
                    f"localhost:{servicer.bound_port}") as channel:
                stub = vision_grpc.VisionAnalysisServiceStub(channel)
                pb = [vision_pb2.AnalysisRequest(
                    color_image=vision_pb2.Image(
                        data=r.color_image.data, width=FRAME_W,
                        height=FRAME_H, format=1),
                    depth_image=vision_pb2.Image(
                        data=r.depth_image.data, width=FRAME_W,
                        height=FRAME_H, format=1),
                    mask_format=r.mask_format) for r in requests]
                over_grpc = list(stub.AnalyzeActuatorPerformance(iter(pb)))
        finally:
            server.stop(grace=None).wait()
            servicer.close()
        verify(over_grpc, "gRPC")
        for i, (a, b) in enumerate(zip(responses, over_grpc)):
            check(a.status == b.status and a.mask == b.mask,
                  f"gRPC frame {i} differs from the in-process response")
        log(f"gRPC leg: {len(over_grpc)} responses over a real server, "
            "statuses and masks equal to the in-process ones")

    # STREAMS concurrent streams, each the frames in its own rotation, on
    # the direct path and then batched
    orders = [[(s * 2 + j) % n for j in range(n)] for s in range(STREAMS)]
    streams = [[requests[i] for i in order] for order in orders]
    direct_out, direct_s = concurrent_streams(service, streams)
    for order, out in zip(orders, direct_out):
        verify(out, "direct, concurrent streams", order)
    log(f"direct path, {STREAMS} concurrent streams x {n} frames: "
        f"{STREAMS * n / direct_s:.1f} frames/s aggregate; proc_time_ms "
        f"median {np.median([r.proc_time_ms for o in direct_out for r in o]):.2f}"
        f"; {device_busy(torch, lambda: concurrent_streams(service, streams))}")
    service.close()

    bcfg = port.ServerConfig(address="localhost:0",
                             metrics_csv=str(tmp / "batched.csv"),
                             metrics_flush_every=1,
                             calibration_path=str(tmp / "none.npz"),
                             batch_window_ms=2.0, max_batch=MAX_BATCH)
    batched = port.VisionAnalysisService(folded, cfg=bcfg, device="cuda")
    t0 = time.perf_counter()
    batched.warmup(FRAME_W, FRAME_H)
    warm_s = time.perf_counter() - t0
    dispatcher = batched.dispatcher
    dispatcher.dispatch_sizes.clear()
    reset_launches()
    out, batched_s = concurrent_streams(batched, streams)
    blaunches = read_launches()
    sizes = dict(sorted(dispatcher.dispatch_sizes.items()))
    dispatches = sum(sizes.values())
    check(sum(k * v for k, v in sizes.items()) == STREAMS * n,
          f"batched leg: dispatch sizes {sizes} do not add up to "
          f"{STREAMS * n} frames")
    ones = sizes.get(1, 0)
    bwant = {"conv3x3_bn_relu": 18 * dispatches, "conv1x1": dispatches,
             "deproject_edge_stats": ones, "bspline_design": ones,
             "bspline_curvature": ones, "bitpack_mask": dispatches}
    check(blaunches == bwant, f"batched leg launch counts {blaunches}, want "
          f"{bwant} for dispatch sizes {sizes}")
    for order, responses_s in zip(orders, out):
        verify(responses_s, "batched", order)
        for i, resp in zip(order, responses_s):
            ref = responses[i]
            check(resp.status == ref.status and resp.mask == ref.mask
                  and resp.mask_coverage == ref.mask_coverage,
                  f"batched frame {i}: status, mask bytes or coverage differ "
                  "from the direct path's")
            check(np.allclose([resp.mean_curvature, resp.max_curvature],
                              [ref.mean_curvature, ref.max_curvature],
                              rtol=GEOM_RTOL, atol=0),
                  f"batched frame {i}: curvature {resp.mean_curvature} vs "
                  f"direct {ref.mean_curvature} beyond rtol {GEOM_RTOL}")
    proc = [r.proc_time_ms for o in out for r in o]
    log(f"batched leg (batch_window_ms=2, max_batch={MAX_BATCH}), {STREAMS} "
        f"concurrent streams x {n} frames: warm-up of buckets "
        f"{sorted({dispatcher.bucket_for(b) for b in range(1, MAX_BATCH + 1)})}"
        f" {warm_s:.1f} s; dispatch sizes {sizes} ({dispatches} dispatches); "
        f"{STREAMS * n / batched_s:.1f} frames/s aggregate; proc_time_ms "
        f"median {np.median(proc):.2f} p90 {np.percentile(proc, 90):.2f} max "
        f"{max(proc):.2f}; launches {blaunches}; masks byte-equal to the "
        f"direct path's, curvature within rtol {GEOM_RTOL}")
    log(f"batched leg under the profiler: "
        f"{device_busy(torch, lambda: concurrent_streams(batched, streams))}")
    batched.close()
    return {k: launches[k] + blaunches[k] for k in launches}


# -- phase 5: geometry -------------------------------------------------------


def geometry_phase(torch, port) -> None:
    rng = np.random.default_rng(SEED + 1)
    _, mask, depth = port.render_scene(rng, FRAME_H, FRAME_W)
    k = torch.from_numpy(port.default_intrinsics(FRAME_W, FRAME_H)).float()
    mask_t = torch.from_numpy((mask > 0).astype(np.uint8))
    depth_t = torch.from_numpy(depth.astype(np.float32))
    cfg = port.GeometryConfig()
    gpu = port.compute_curvature_profile(mask_t.cuda(), depth_t.cuda(),
                                         k.cuda(), 0.001, cfg)
    cpu = port.compute_curvature_profile(mask_t, depth_t, k, 0.001, cfg)
    check(bool(gpu.valid) and bool(torch.isfinite(gpu.mean_curvature))
          and bool(torch.isfinite(gpu.max_curvature)),
          f"geometry on the true mask: valid {bool(gpu.valid)}")
    for field in ("valid", "num_cloud_points", "num_edge_points", "truncated"):
        check(bool(getattr(gpu, field).cpu() == getattr(cpu, field)),
              f"geometry {field}: card {getattr(gpu, field)} vs CPU "
              f"{getattr(cpu, field)}")
    for field in ("mean_curvature", "max_curvature", "spline_points"):
        a, b = getattr(gpu, field).cpu(), getattr(cpu, field)
        check(torch.allclose(a, b, rtol=GEOM_RTOL, atol=0.0),
              f"geometry {field}: card vs CPU differ beyond rtol {GEOM_RTOL}")
    log(f"geometry ('auto'): true mask, card vs CPU: valid {bool(gpu.valid)}, mean "
        f"{float(gpu.mean_curvature):.6g} vs {float(cpu.mean_curvature):.6g}"
        f", max {float(gpu.max_curvature):.6g} vs "
        f"{float(cpu.max_curvature):.6g} 1/m, {int(gpu.num_edge_points)} "
        "edge points")


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not installed ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        import robotic_discovery_platform_tpu_torch as port
        from robotic_discovery_platform_tpu_torch.ops import build, conv
    except ImportError as exc:
        print(f"chip_smoke: run it from the root of a checkout ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = nvidia_smi_line()
    build_s = build.build()
    log(f"env: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)} [{card}], kernel build "
        f"{build_s:.1f} s")

    results = kernel_phase(torch, conv)
    rng = np.random.default_rng(SEED)
    frames = []
    for _ in range(8):
        rgb, _, depth = port.render_scene(rng, FRAME_H, FRAME_W)
        frames.append((rgb, depth))
    results.update(geometry_kernel_phase(torch, port))
    folded, outs = analyzer_phase(torch, port, frames[:4])
    analyze = port.make_frame_analyzer(folded, img_size=256, device="cuda")
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    want_masks = [analyze(rgb, depth, k, 0.001).mask.cpu().numpy()
                  for rgb, depth in frames]
    launches = servicer_phase(torch, port, folded, frames, want_masks)
    geometry_phase(torch, port)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps(kernel_record(results, launches)))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
