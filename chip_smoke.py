#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``robotic_discovery_platform_tpu_
torch/csrc`` and drives the single-frame serving path of the default
model (``ModelConfig()``: bilinear U-Net, 64 base features, 256x256 bf16
input) on 480x640 frames, in phases; any mismatch raises and the script
exits non-zero:

1. environment: torch, the card's name and power limit, kernel build time;
2. every kernel against its plain PyTorch version on the card, at each
   shape the main path gives it (plus ragged and float32 cases), with its
   time, the plain version's, one cuDNN call's and the bound;
3. the analyzer: the kernel forward against the plain forward, exact
   launch counts per frame, warm per-frame time and peak memory, and a
   profiler breakdown of one frame;
4. the servicer: a stream of raw requests in each mask format through
   ``analyze_stream`` (and through a real gRPC server where grpc is
   installed), checked against the analyzer;
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
GEOM_RTOL = 1e-3  # curvature, card vs CPU


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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


def kernel_record(results: dict, launches: dict) -> dict:
    """The kernels' JSON record: per kernel, the sums over one forward's
    launches of each per-launch time (so ``ms`` is the kernel's device
    time per frame), the worst error over its main-path shapes, and the
    launch count of the servicer phase."""
    per_frame = {
        "conv3x3_bn_relu": [("conv3x3_bn_relu", *s) for s in MAIN_PATH_3X3],
        "conv1x1": [("conv1x1", *HEAD)],
    }
    meta = {
        "conv3x3_bn_relu": (
            "robotic_discovery_platform_tpu_torch/csrc/conv3x3_bn_relu.cu",
            "robotic_discovery_platform_tpu/ops/pallas/conv.py:178"),
        "conv1x1": (
            "robotic_discovery_platform_tpu_torch/csrc/conv1x1.cu",
            "robotic_discovery_platform_tpu/ops/pallas/conv.py:301"),
    }
    kernels = []
    for name, keys in per_frame.items():
        rows = [results[k] for k in keys]
        ops_bound = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        byte_bound = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if ops_bound >= byte_bound else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
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


def analyzer_phase(torch, port, conv, frames) -> tuple:
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
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    analyze(*frames[0], k, 0.001)  # first-call costs out of the timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv.conv3x3_bn_relu.launches = 0
    conv.conv1x1.launches = 0
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
    counts = (conv.conv3x3_bn_relu.launches, conv.conv1x1.launches)
    check(counts == (18 * n, n),
          f"launch counts after {n} frames: {counts}, want {(18 * n, n)}")
    peak = torch.cuda.max_memory_allocated()
    for out in outs:
        check(out.mask.shape == (FRAME_H, FRAME_W)
              and 0.0 <= float(out.mask_coverage) <= 100.0
              and bool(torch.isfinite(out.profile.mean_curvature)),
              "analyzer output malformed")
    log(f"analyzer: {n} frames, launches conv3x3_bn_relu {counts[0]} "
        f"conv1x1 {counts[1]} (18 and 1 per frame); warm ms/frame (CUDA "
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
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
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


def servicer_phase(torch, port, conv, folded, frames, want_masks) -> dict:
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    cfg = port.ServerConfig(address="localhost:0",
                            metrics_csv=str(tmp / "metrics.csv"),
                            metrics_flush_every=1,
                            calibration_path=str(tmp / "none.npz"))
    service = port.VisionAnalysisService(folded, cfg=cfg, device="cuda")
    service.warmup(FRAME_W, FRAME_H)
    requests = [port.raw_request(rgb, depth, mask_format=i % 3)
                for i, (rgb, depth) in enumerate(frames)]

    def verify(responses, leg: str) -> None:
        check(len(responses) == len(requests), f"{leg}: response count")
        for i, (req, resp) in enumerate(zip(requests, responses)):
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

    conv.conv3x3_bn_relu.launches = 0
    conv.conv1x1.launches = 0
    t0 = time.perf_counter()
    responses = list(service.analyze_stream(iter(requests)))
    stream_s = time.perf_counter() - t0
    launches = {"conv3x3_bn_relu": conv.conv3x3_bn_relu.launches,
                "conv1x1": conv.conv1x1.launches}
    n = len(requests)
    check(launches == {"conv3x3_bn_relu": 18 * n, "conv1x1": n},
          f"servicer launch counts {launches} for {n} frames")
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
    service.close()
    return launches


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
    log(f"geometry: true mask, card vs CPU: valid {bool(gpu.valid)}, mean "
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
    folded, outs = analyzer_phase(torch, port, conv, frames[:4])
    analyze = port.make_frame_analyzer(folded, img_size=256, device="cuda")
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    want_masks = [analyze(rgb, depth, k, 0.001).mask.cpu().numpy()
                  for rgb, depth in frames]
    launches = servicer_phase(torch, port, conv, folded, frames, want_masks)
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
