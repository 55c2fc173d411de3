#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``robotic_discovery_platform_tpu_
torch/csrc`` and drives the serving paths of the default model
(``ModelConfig()``: bilinear U-Net, 64 base features, 256x256 bf16 input)
on 480x640 frames under the default geometry path
(``GeometryConfig.kernel_impl = "auto"``), its coefficient lane, and the
non-bilinear model (``ModelConfig(bilinear=False)``), in phases; any
mismatch raises and the script exits non-zero:

1. environment: torch, the card's name and power limit, kernel build time;
2. every kernel against its plain PyTorch version on the card, at each
   shape the main path gives it (plus ragged and float32 cases, and the
   conv at the batched path's B = 8), with its time, the plain version's,
   one cuDNN call's where one computes the same function, and the bound
   (the convs' lines also give TFLOP/s and the share of the bound): the
   3x3 conv (called twice on the same operands, equal bit for bit; at
   B = 8, for the four BATCH_3X3 shapes and every shape whose K is split,
   each frame of the stack equal bit for bit to the frame alone); the 1x1
   conv at CONV1X1_SHAPES (the head at B = 1 and 8, the general body in
   bf16 and float32), CONV1X1_EDGES and two misaligned views (each shape's
   path, head or FMA, logged and checked against the C entry's; each call
   repeated, equal bit for bit; every frame of a stack equal bit for bit
   to the frame alone; the profiler's device time beside the back-to-back
   time, each beside cuDNN's, and the host's cost per call); then the geometry
   kernels (deprojection bitwise at 480x640 stride 1 and 240x320 stride
   2, one kernel and no copy per call in the profiler, ragged views,
   frames with no and one valid pixel and a misaligned depth map each
   called twice, two streams at once, no stack frame in ``ptxas -v``;
   the design contractions of 6400 edge-point slots -- called twice,
   equal bit for bit, 0 outside the Gram matrix's band --, the curvature
   at 100 samples, called twice, equal bit for bit, no stack frame in
   ``ptxas -v``, and at ``curvature_case_inputs``' edge cases) and the
   mask bitpack (``bitpack_phase``: bitwise at [8, 480, 640], [1, 480,
   640] and ragged widths, into a fresh tensor, into the mask bytes of
   payload rows and from or to misaligned addresses; ``pack_analysis``
   rows byte-equal to the former assembly and the CPU's; device time at
   both main shapes); the transposed conv at the
   non-bilinear ladder's four shapes (B = 1 and 8; each shape's path,
   tensor cores or FMA, logged and the C entry's rule checked against
   ``conv.convt_path``; each call repeated, equal bit for bit; at B = 8
   every frame equal bit for bit to the frame alone; ragged shapes on
   both paths, and bfloat16 in with float32 out), with the profiler's
   device time beside the back-to-back time; and the dequant + IDCT
   (bitwise, one 480x640 4:2:0 frame's planes at B = 1 and 8, a ragged
   N, every coefficient at +-2047 with q = 255, a misaligned address; the
   per-frame sum of the three planes' device times);
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
   device's busy share; then the precision tiers (``precision_phase``):
   the calibrated model's bf16 and int8 weights made on the card bitwise
   equal to the CPU's, their kernel logits within LOGITS_REL_L2 of their
   plain forward, and its int8 servicer refused by the parity gate at
   the default bars; its projection onto the int8 grid from a temporary
   registry through ``build_service`` and ``warmup`` at "f32", "bf16" and
   "int8" (identity legs: one function at every tier; each gate's
   report, launches per frame those of f32, frames/s over one stream),
   and that int8 servicer refused with ``quant_parity_min_iou = 1.01``;
   then int8 of the calibrated net and bf16 of it computing in float32,
   tiers that serve another function, up past gates whose bars sit at
   the report of the same comparison made apart (the servicer's report
   equal to it, its masks the tier net's), and refused with the IoU
   floor 1e-9 above it;
   then the serving host path (``host_path_phase``): a bucket-8 scan
   dispatch (``batch_impl="scan"``) whose rows equal the frame analyzer's
   bit for bit, with 144 / 8 / 8 / 8 / 8 / 1 launches per replay, its
   device time and peak memory beside the dense bucket's; servicers with
   the decode pool, the encode pool (direct and batched), scan,
   ``egress_pack=False`` and format-2 frames through the decode pool
   under 8 streams in rounds, every response equal to the inline direct
   servicer's; the port's client over gRPC (``fmt="raw"``), the first
   started before its server; ``/metrics`` sums over the legs;
5. geometry on a rendered scene's true mask, card against CPU;
6. training at the reference configuration (``ModelConfig()``,
   ``TrainConfig`` batch 4 at 256x256, lr 1e-4, loss "bce"): the weight
   gradient kernel against its plain version and the training conv's
   forward and dx (the conv kernel, unit epilogue) against theirs at the
   18 training shapes at B = 4, each called twice (equal bit for bit),
   with their times, bounds and cuDNN's (the plain forward at
   SLOW_PLAIN_FWD on a line of its own, apart from the per-step sums);
   one step's gradients on the kernels against plain torch convs; exact
   launches per train step (18 + 17 conv3x3_bn_relu, 18
   conv3x3_grad_weights; none per eval step); ``train_model`` on 20
   synthetic samples for two epochs into a temporary registry (losses
   finite and falling, version 1 registered), with the step's time, its
   device-time split and busy share, and peak memory; then a server
   built from the registry (``models:/Actuator-Segmenter@staging``)
   serving 4 frames, its masks equal to a ``FoldedUNet`` built from the
   checkpoint's best variables;
7. the coefficient lane: the 8 frames through a numpy JPEG forward half
   (``encode_coefficients``, quality 75, 4:2:0; no cv2 on the card's
   machine) and the ``format = 2`` wire payload, the card's decode
   bitwise against the CPU plain decode, exact launches (3 dequant_idct
   + 18 + 1 + 3 per direct frame), and format-2 requests served
   directly, over gRPC and batched under 8 streams, against the format-1
   responses of the decoded pixels (ms per frame of both lanes);
8. the non-bilinear model at full width: kernel vs plain forward, exact
   launches (18 + 4 conv_transpose2x2 + 1 + 3 per frame), 8 frames served
   directly and batched, the training conv at the ladder's new shapes,
   one train step (no conv_transpose2x2 launch: training runs the plain
   transposed conv), and ``train_model`` for one epoch into a temporary
   registry with a server built from it (phase 6's last leg);
9. a server that can be deployed (``deploy_phase``): two registered
   versions of ``ModelConfig()`` served by ``grpc_service.build_server``
   with a metrics endpoint, directly and batched, each leg under 8 live
   streams while the ``staging`` alias moves 40 times: health over gRPC,
   every response one version's answer, each new generation on streams
   no live generation held (and few streams in all: they are handed on),
   every swapped-out generation collected, ``memory_allocated`` and
   ``memory_reserved`` back within DEPLOY_SLACK and
   DEPLOY_RESERVED_SLACK, each graph pool holding only its graphs'
   outputs,
   ``/metrics``, ``/debug/events``, ``/debug/profile`` during traffic,
   drain with a stream in flight and the shutdown order; with the
   seconds from an alias move to the swap, ``proc_time_ms`` in reload
   windows and steady, frames/s and memory;
10. the drift loop (``drift_phase``): ``run_retraining_pipeline`` at
   phase 6's training setting registers version 1, moves ``staging`` and
   writes its drift profile (16 scenes at 120x160), exact launches and
   memory back around the cycle, every frame's signals against a CPU
   capture of the same weights (the DRIFT_* bars, PSI at or below the
   noise floor); that 16-frame profile behind a server on 256
   in-distribution scenes, printed (the reference's PSI of unequal
   samples, ROADMAP queue 3); version 1's profile captured again over
   256 scenes; servers from ``@staging`` (``build_server``, the
   default ``drift_enabled``) over gRPC, directly and batched: 256
   in-distribution scenes fire no recommendation, depth-shifted scenes
   exactly one naming depth_valid_fraction, ``/metrics``, the journal
   and ``/debug/drift``; on the direct leg a second cycle under a live
   stream, after whose swap ``/debug/drift`` holds version 2's reference
   beside engine version 2, every response one version's answer and
   memory within deploy_phase's slacks; ``run_supervised`` killed after
   epoch 1 and restarted, against an unbroken run (the SUPERVISED_*
   bars), and which ops of a train step are not deterministic; the monitor's host cost (frames/s on and off in
   turns, its microseconds per frame).
11. the zoo, the controller and the rollout (``zoo_phase``,
   ``controller_phase``, ``rollout_phase``);
12. the lab's loop around the server (``lab_phase``): (a) the registry
   over HTTP against ``tests/fake_mlflow_server.py`` in process --
   ``train_model`` logging and registering over REST, a servicer loaded
   over REST answering as one from a ``file:`` store bit for bit, an
   alias moved over REST swapping it under a live stream, a retraining
   cycle promoting over REST; (b) ``ModelConfig(norm="group")``: train
   steps (35 / 18 launches), ``model_forward="auto"`` refused with the
   JAX ``PallasUNet`` error, ``"flax"`` serving over gRPC (18 / 1 / 1 / 1
   / 1 launches a frame) and through a reload, logits against the CPU
   plain forward, device ms beside the batch-norm frame's; (c) a
   reference ``.pth`` of the SURVEY's torch U-Net imported with
   ``tools/import_torch_weights`` at float32 compute and served, logits
   against the torch module's own (bf16 compute: the kernels against
   their plain versions); (d) ``tools/geometry_parity.run_corpus`` over LAB_SCENES
   scenes on card and CPU; (e) ``RDP_TRANSFER_GUARD=strict`` on the
   direct, batched and scan servicers and a scan-epoch ``train_model``,
   and an injected ``.item()``; (f) every bound from ``utils/flops``
   against the figures printed before;
13. the tuning table (``tuning_phase``): ``tools/tune_kernels.py``'s
   sweep of every K split of the 3x3 conv at the serving forward's
   shapes at B = 1 (fwd_plan's split and the best, with their ms) and at
   the training forward's at B = 4 (printed only); a servicer under a
   temporary table (18/1/1/1/1/1 launches a frame, each tuned shape at
   the table's split, an invalid entry ignored, logits within BF16_TOL
   of the untuned forward, batched equal to direct bit for bit), the
   table removed after;
14. the serving fleet (``fleet_phase``): two replica processes of
   ``ModelConfig()`` on the card behind an elastic front-end process
   (spawn seconds, pids and memory, the front-end holding no context),
   the one-replica relay bit for bit the replica, an in-process servicer
   from the replica's registry entry and settings bit for bit the
   replica too, with its launches counted, ``/debug/trace``,
   failover of a pinned frame with no frame dropped, ``/federate`` up
   then down with the last good scrape kept, the rejoin through the
   lease, frames/s over two replicas, one and direct (5 rounds a leg:
   median and range), and an autoscaler
   front-end scaling up under load and down after it, every process
   stopped at the end;
15. the simulated twin (``sim_phase``): the zoo's models behind one
   server, closed- and open-loop legs the twin is calibrated against;
16. shape contracts and the data axis (``mesh_phase``): (a) answers bit
   for bit with the contracts on and off, the host µs they add, a
   misshaped ``submit`` refused before any launch; (b) one card with
   ``serving_mesh=-1`` builds no router; (c) a two-position ring on the
   one card, both modes bit for bit, quarantine, failover and probe,
   the controller's mode switch both ways; (d) an NCCL group of world
   size 1: both data-axis steps against the single-device step, their
   median times, a profile of one step, ``train_model`` over the mesh
   and a servicer from its checkpoint.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Imports only the port, never JAX.

    python3 chip_smoke.py --phase NAME

runs one phase alone (any of ``PHASES``: ``kernel_phase``,
``conv1x1_kernel_phase``, ``convt_kernel_phase``, ``decode_kernel_phase``,
``geometry_kernel_phase``, ``train_kernel_phase``, ``graph_phase``,
``bitpack_phase``, ``bitpack_timing_phase``, ``precision_phase``,
``deploy_phase``, ``drift_phase``, ``host_path_phase``, ``zoo_phase``,
``controller_phase``, ``rollout_phase``, ``lab_phase``,
``tuning_phase``, ``fleet_phase``, ``sim_phase``, ``mesh_phase`` or
``trained_tier_phase``, which
``main`` does not run): its
log lines, then its results as one JSON line. To compare a change with
its parent on one card, unpack the parent (``git archive``) into a
git-ignored directory and run the phase in each root in turns: parent,
change, change, parent.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from pathlib import Path

import numpy as np

# every bound below comes from the port's utils/flops.py (its H100 SXM
# peaks and each kernel's least operations and bytes), imported after the
# card is found: see flops_lib
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
# conv1x1 shapes timed (B, H, W, Cin, Cout, dtype, out dtype): the head at
# B = 1 (the main path) and at the batched dispatch's B = 8, and the
# general body (ModelConfig.num_classes > 1) in both dtypes, and at the
# four classes of the JAX package's "multi" model
CONV1X1_SHAPES = [
    (1, 256, 256, 64, 1, "bfloat16", "float32"),
    (8, 256, 256, 64, 1, "bfloat16", "float32"),
    (1, 64, 96, 48, 40, "bfloat16", "bfloat16"),
    (1, 64, 96, 48, 40, "float32", "float32"),
    (1, 64, 96, 48, 4, "bfloat16", "bfloat16"),
]
# and checked only (..., relu): the head with ReLU and a ragged last run
# of pixels, a float32 head whose Cin fills no 16-byte vector, two classes
CONV1X1_EDGES = [
    (3, 37, 53, 64, 1, "bfloat16", "float32", True),
    (2, 9, 13, 6, 1, "float32", "float32", False),
    (1, 64, 96, 48, 2, "bfloat16", "bfloat16", False),
]
# the non-bilinear model (ModelConfig(bilinear=False)): its 18
# conv3x3_bn_relu launches, those shapes the default model does not have,
# and its 4 conv_transpose2x2 launches (input H = W, Cin, Cout)
NB_MAIN_PATH_3X3 = [
    (256, 3, 64), (256, 64, 64),
    (128, 64, 128), (128, 128, 128),
    (64, 128, 256), (64, 256, 256),
    (32, 256, 512), (32, 512, 512),
    (16, 512, 1024), (16, 1024, 1024),
    (32, 1024, 512), (32, 512, 512),
    (64, 512, 256), (64, 256, 256),
    (128, 256, 128), (128, 128, 128),
    (256, 128, 64), (256, 64, 64),
]
NB_NEW_3X3 = [s for s in NB_MAIN_PATH_3X3 if s not in MAIN_PATH_3X3]
CONVT_SHAPES = [(16, 1024, 512), (32, 512, 256), (64, 256, 128),
                (128, 128, 64)]
# the coefficient lane: 8x8 blocks of the Y, Cb and Cr planes of one
# 480x640 4:2:0 frame (one dequant_idct launch each), and the IJG quality
# of chip_smoke's own encoder
IDCT_PLANES = (4800, 1200, 1200)
COEF_QUALITY = 75
# the encoder's sanity bar: the CPU decode's luma against the source's.
# (RGB PSNR is logged: on these synthetic frames 4:2:0 chroma caps it near
# 30 dB, 29.78-30.74 dB for the 8 frames, as libjpeg's own encoder at the
# same quality gives within 0.02 dB)
COEF_PSNR_DB = 30.0
# the kernel's separable passes: A on 8 columns, then on 8 rows
SEPARABLE_IDCT_MACS_PER_BLOCK = 2 * 8 * 64
CONVT_F32_REL = 1e-5  # float32 transposed conv, kernel vs plain

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
# training: the reference batch, and the bars of phase 6
TRAIN_BATCH = 4
DW_REL_L2 = 1e-4  # dw kernel vs plain: float32 sums of the same products
# one step's gradients, kernels vs plain torch convs, in float32 compute
GRAD_REL_L2 = 2e-2
LOSS_RTOL = 1e-2
# in bfloat16 compute the plain step itself lies about 5% (relative L2)
# from the same step with float64 conv sums, so no two summation orders
# meet GRAD_REL_L2 there; the kernel step must lie no farther from the
# float64-sum step than this factor times the plain step's distance
BF16_GRAD_RATIO = 1.25
TRAIN_SAMPLES = 20  # 16 train + 4 validation: 4 steps per epoch
# the training shape (H = W, Cin, Cout) at which the float32 plain forward,
# F.conv2d with TF32 off, takes hundreds of times its time at the others
# (with cuDNN's autotuner on as well): a yardstick artefact, so phase 6
# reports it on a line of its own, apart from the per-step sums
SLOW_PLAIN_FWD = (128, 256, 128)
# the mask bitpack's main-path shapes (a full dispatch, a direct servicer
# frame; each goes into its packed payload rows), and ragged or small ones
BITPACK_MAIN = ((MAX_BATCH, FRAME_H, FRAME_W), (1, FRAME_H, FRAME_W))
BITPACK_EDGES = ((3, 37, 53), (2, 6, 641), (2, 6, 33), (2, 6, 7))
PAYLOAD_PTS = 100  # GeometryConfig.num_samples: the payload's spline block
# the precision tiers' served streams: passes over the 8 frames
TIER_PASSES = 2
# the tuning phase: launches timed per split (tools/tune_kernels.py)
TUNE_LAUNCHES = 20
# the fleet phase: frames per stream, the rounds of each frames/s leg,
# the leases' TTL, how long replica B's first served frame sleeps (the
# frame the kill strands), the longest wait for a fleet state, and where
# its replicas serve at what input size
FLEET_FRAMES = 16
FLEET_RATE_ROUNDS = 5
FLEET_LEASE_TTL_S = 2.0
FLEET_PIN_S = 3.0
FLEET_WAIT_S = 90.0
FLEET_DEVICE, FLEET_IMG = "cuda", 256


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def int32_ops_per_s(torch) -> float:
    """The card's int32 multiply-add rate: SMs x 64 per clock x the
    maximum SM clock nvidia-smi reports."""
    mhz = float(nvidia_smi_line("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return flops_lib().int32_ops_per_s(sms, mhz)


def time_ms(torch, fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events over ``iters`` calls
    after ``warm`` calls; inputs stay in L2 between calls, as they arrive
    from the previous layer in the forward)."""
    for _ in range(warm):
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


def host_ms(torch, fn, iters: int = 200) -> float:
    """The host's time per call of ``fn`` in ms: ``iters`` calls enqueued
    back to back after a warm-up, with no synchronisation between them
    (the wrapper and the launch, not the device)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


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


def profiled_rows(torch, fn, iters: int) -> list:
    """:func:`device_rows` of ``iters`` calls of ``fn`` after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_rows(prof)


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` in ms: the kernels and copies
    it launched, from torch.profiler, over ``iters`` calls after a
    warm-up. For work far shorter than its launch cost, where CUDA events
    around back-to-back calls time the host."""
    total = sum(r[0] for r in profiled_rows(torch, fn, iters)) / iters
    # the profiler can record no device activity for a launch (seen once
    # for the 2 us bitpack); CUDA events around back-to-back calls then
    # give an upper bound (they include the host's cost per call)
    return total if total > 0 else time_ms(torch, fn, iters)


def flops_lib():
    """The port's ``utils/flops`` (the peaks and each kernel's operations
    and bytes): the one source of every bound this script prints."""
    from robotic_discovery_platform_tpu_torch.utils import flops

    return flops


def bound_ms(flops: float, nbytes: float,
             peak: float | None = None) -> tuple[float, str]:
    """The least time the card could take (``utils/flops.bound_ms``): the
    larger of the operations at ``peak`` (default the bf16 peak) and the
    bytes at the HBM rate."""
    lib = flops_lib()
    return lib.bound_ms(flops, nbytes,
                        lib.H100_BF16_FLOPS if peak is None else peak)


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
    cases += [(1, s, s, cin, cout, torch.bfloat16, False)
              for s, cin, cout in NB_NEW_3X3]
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
        check(torch.equal(conv.conv3x3_bn_relu(x, wt, scale, bias), got),
              f"conv3x3_bn_relu {(b, h, w, cin, cout)} {dtype}: two calls "
              "on the same operands differ")
        splits = (conv.fwd_plan(b, h, w, cin, cout)[0]
                  if dtype == torch.bfloat16 else 1)
        if dtype == torch.bfloat16 and (b == MAX_BATCH or splits > 1):
            # a frame's bits alone and inside the batched path's stack
            x8 = x if b == MAX_BATCH else operands(
                MAX_BATCH, h, w, cin, cout, dtype, 9)[0]
            check(batch_invariant(torch, conv, x8, wt, scale, bias),
                  f"conv3x3_bn_relu {(h, w, cin, cout)}: a frame of a B = "
                  f"{MAX_BATCH} stack differs from the frame alone")
            log(f"conv3x3_bn_relu [{MAX_BATCH},{h},{w},{cin}]->{cout}: "
                f"every frame equal bit for bit to the frame alone "
                f"({splits} K splits)")
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
        flops, nbytes = flops_lib().conv3x3_bn_relu_cost(
            b, h, w, cin, cout, x.element_size())
        t["bound_ms"], t["bound_by"] = bound_ms(flops, nbytes)
        t["max_abs_err"] = err
        device = ""
        if main:
            # at B = 1 a launch costs the host about as much as the card:
            # the profiler's device time beside the back-to-back time
            t["device_ms"] = device_ms(torch, lambda: conv.conv3x3_bn_relu(
                x, wt, scale, bias))
            t["library_device_ms"] = device_ms(torch, lambda: torch.clamp_min(
                F.conv2d(xc, wc, padding=1).float() * sc + bc, 0).to(dtype))
            device = (f"; device ms {t['device_ms']:.4f} cudnn "
                      f"{t['library_device_ms']:.4f} (profiler), "
                      f"{flops / t['device_ms'] / 1e9:.1f} TFLOP/s, "
                      f"{t['bound_ms'] / t['device_ms']:.1%} of the bound")
        log(f"conv3x3_bn_relu [{b},{h},{w},{cin}]->{cout} {str(dtype)[6:]}: "
            f"max|err| {err:.3g} (tol {tol}), deterministic; ms "
            f"{t['ms']:.4f} plain {t['plain_ms']:.4f} cudnn "
            f"{t['library_ms']:.4f} bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}); {rate_text(flops, t)}; {splits} K "
            f"splits{device}")
        if main:
            results[("conv3x3_bn_relu", h, cin, cout)] = t
    rows = [results[("conv3x3_bn_relu", *s)] for s in MAIN_PATH_3X3]
    log("conv3x3_bn_relu, the 18 launches of one frame at B = 1: " + ", ".join(
        f"{f} {sum(r[f] for r in rows):.4f}" for f in (
            "ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")))

    results.update(conv1x1_kernel_phase(torch, conv))
    return results


def conv1x1_kernel_phase(torch, conv) -> dict:
    """conv1x1 against its plain version (within BF16_TOL or F32_TOL) at
    CONV1X1_SHAPES and CONV1X1_EDGES, and on two misaligned views (x one
    element past a 16-byte address, at the head's widths, which the FMA
    path then takes, and at Cout = 16). Every call is repeated on the
    same operands (equal bit for bit); at B = 8 every frame of the stack
    equals the frame alone bit for bit; each shape's path
    (``conv.conv1x1_path``) is logged and checked against the C entry's,
    and the build's ``ptxas -v`` summary is logged. The timed
    shapes give CUDA events over back-to-back calls and the profiler's
    device time, each beside cuDNN's ``F.conv2d`` plus the epilogue on the
    same operands, the host's cost per call, and the bound. Returns every
    timed shape's timings, the B = 1 head's also under its record key."""
    from robotic_discovery_platform_tpu_torch.ops import build

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    results = {}
    # (..., relu, timed, skip): x a contiguous view ``skip`` elements past
    # an aligned start
    cases = [(*c, False, True, 0) for c in CONV1X1_SHAPES]
    cases += [(*c, False, 0) for c in CONV1X1_EDGES]
    cases += [(1, 16, 24, 64, 1, "bfloat16", "float32", False, False, 1),
              (1, 16, 24, 64, 16, "bfloat16", "bfloat16", False, False, 1)]
    for b, h, w, cin, cout, dtype, odt, relu, timed, skip in cases:
        dtype, odt = getattr(torch, dtype), getattr(torch, odt)
        n = b * h * w * cin
        x = torch.randn(n + skip, generator=gen, device="cuda").to(dtype)[
            skip:].view(b, h, w, cin)
        wt = (torch.randn(cin, cout, generator=gen, device="cuda")
              / cin ** 0.5).to(dtype)
        scale = torch.rand(cout, generator=gen, device="cuda") + 0.5
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
        shape = (f"[{b},{h},{w},{cin}]->{cout} "
                 f"{str(dtype)[6:]}->{str(odt)[6:]}")
        path = conv.conv1x1_path(dtype, cin, cout,
                                 x_aligned=x.data_ptr() % 16 == 0)
        check(conv.conv1x1_path_of_kernel(x, cout, odt) == path,
              f"conv1x1 {shape}: the C entry's path differs from "
              f"conv1x1_path's {path}")
        check(not skip or path == "fma",
              f"conv1x1 {shape}: a misaligned view takes path {path}")

        def kernel():
            return conv.conv1x1(x, wt, scale, bias, relu=relu, out_dtype=odt)

        got = kernel()
        want = conv.conv1x1_plain(x, wt, scale, bias, relu=relu,
                                  out_dtype=odt)
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"conv1x1 {shape}: max |err| {err} over tolerance {tol}")
        check(bitwise_equal(torch, kernel(), got),
              f"conv1x1 {shape}: two calls on the same operands differ")
        bar = f"max|err| {err:.3g} (tol {tol}), deterministic"
        if b > 1:
            check(all(bitwise_equal(torch, got[i:i + 1], conv.conv1x1(
                x[i:i + 1], wt, scale, bias, relu=relu, out_dtype=odt))
                for i in range(b)),
                f"conv1x1 {shape}: a frame of the stack differs from the "
                "frame alone")
            bar += ", every frame equal bit for bit to the frame alone"
        if not timed:
            note = " relu" if relu else " misaligned" if skip else ""
            log(f"conv1x1 {shape}{note}, path {path}: {bar}")
            continue
        xc = x.permute(0, 3, 1, 2)
        wc = wt.t().reshape(cout, cin, 1, 1).contiguous(
            memory_format=torch.channels_last)
        sc, bc = scale.view(1, -1, 1, 1), bias.view(1, -1, 1, 1)

        def library():
            return (F.conv2d(xc, wc).float() * sc + bc).to(odt)

        t = {
            "ms": time_ms(torch, kernel),
            "plain_ms": time_ms(torch, lambda: conv.conv1x1_plain(
                x, wt, scale, bias, relu=relu, out_dtype=odt)),
            "library_ms": time_ms(torch, library),
            "device_ms": device_ms(torch, kernel),
            "library_device_ms": device_ms(torch, library),
            "host_ms": host_ms(torch, kernel),
            "max_abs_err": err,
        }
        flops, nbytes = flops_lib().conv1x1_cost(
            b, h, w, cin, cout, x.element_size(),
            torch.empty((), dtype=odt).element_size())
        t["bound_ms"], t["bound_by"] = bound_ms(flops, nbytes)
        log(f"conv1x1 {shape}, path {path}: {bar}; ms {t['ms']:.4f} plain "
            f"{t['plain_ms']:.4f} cudnn {t['library_ms']:.4f} bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']}); device ms "
            f"{t['device_ms']:.4f} cudnn {t['library_device_ms']:.4f} "
            f"(profiler), {nbytes / t['device_ms'] / 1e9:.2f} TB/s, "
            f"{t['bound_ms'] / t['device_ms']:.1%} of the bound; host ms "
            f"per call {t['host_ms']:.4f}")
        results[("conv1x1", b, h, w, cin, cout, str(dtype)[6:])] = t
        if (b, h, cin, cout) == (1, *HEAD):
            results[("conv1x1", *HEAD)] = t
    log(ptxas_summary(build, "conv1x1")[0])
    return results


def batch_invariant(torch, conv, x8, wt, scale, bias) -> bool:
    """conv3x3_bn_relu on a stack of frames equals, frame by frame and bit
    for bit, the call on each frame alone."""
    stack = conv.conv3x3_bn_relu(x8, wt, scale, bias)
    return all(torch.equal(stack[i:i + 1], conv.conv3x3_bn_relu(
        x8[i:i + 1], wt, scale, bias)) for i in range(x8.shape[0]))


def rate_text(flops: float, t: dict) -> str:
    """A conv's rate and its share of the bf16 tensor-core bound."""
    return (f"{flops / t['ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['bound_ms'] / t['ms']:.1%} of the bound")


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
    its 100 samples (on the fit's column-major control points; called
    twice, equal bit for bit; ``ptxas -v`` reporting no stack frame; then
    :func:`curvature_cases`), and the bitpack (:func:`bitpack_phase`)."""
    from robotic_discovery_platform_tpu_torch.ops import (
        bspline, build, geometry)
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
        t["bound_ms"], t["bound_by"] = bound_ms(
            *flops_lib().deproject_edge_stats_cost(h, w),
            flops_lib().H100_F32_FLOPS)
        log(f"deproject_edge_stats {h}x{w} stride {stride}: bitwise; "
            f"{timing_text(t)}; valid {int(got[4][4])}")
        results[("deproject_edge_stats", stride)] = t
        if stride == 1:
            maps = want
    deproject_cases(torch, port, gk, build, views, (fx, fy, cx, cy, ds))

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
    check(design_band_zero(torch, got[0], deg),
          "bspline_design: a Gram entry outside the band is not 0")
    again = gk.bspline_design(pts, wts, u, knots, deg)
    check(all(bitwise_equal(torch, a.view(torch.int64), b.view(torch.int64))
              for a, b in zip(again, got)),
          "bspline_design: two calls on the same operands differ")
    t = timings(torch, lambda: gk.bspline_design(pts, wts, u, knots, deg),
                lambda: gk.bspline_design_plain(pts, wts, u, knots, deg))
    t["max_abs_err"] = err
    t["bound_ms"], t["bound_by"] = bound_ms(
        *flops_lib().bspline_design_cost(n, c, len(knots), deg),
        flops_lib().H100_F64_FLOPS)
    log(f"bspline_design N={n} C={c}: max|err| {err:.3g} (within "
        f"{DESIGN_RTOL} of |BW|^T|.|), 0 outside the band, deterministic; "
        f"{timing_text(t)}; {int(s_w.sum())} weighted points")
    results[("bspline_design",)] = t
    design_cases(torch, gk, bspline)

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
    again = gk.bspline_curvature(ctrl, u_fine, knots, deg)
    check(all(bitwise_equal(torch, a, b) for a, b in zip(again, got)),
          "bspline_curvature: two calls on the same operands differ")
    report, stack = ptxas_summary(build, "bspline_curvature")
    log(report)
    check(not any(stack), "bspline_curvature: ptxas reports a stack frame "
          "(a per-sample array fell to local memory)")
    ns = cfg.num_samples
    t = timings(torch, lambda: gk.bspline_curvature(ctrl, u_fine, knots, deg),
                lambda: gk.bspline_curvature_plain(ctrl, u_fine, knots, deg))
    t["host_ms"] = host_ms(
        torch, lambda: gk.bspline_curvature(ctrl, u_fine, knots, deg))
    t["max_abs_err"] = err
    t["bound_ms"], t["bound_by"] = bound_ms(
        *flops_lib().bspline_curvature_cost(ns, c, len(knots), deg),
        flops_lib().H100_F32_FLOPS)
    log(f"bspline_curvature N={ns} C={c}: validity equal, max|err| "
        f"{err:.3g} (kappa max {kmax:.4g}), deterministic; {timing_text(t)}; "
        f"host ms per call {t['host_ms']:.4f}")
    results[("bspline_curvature",)] = t
    curvature_cases(torch, gk, bspline)

    results.update(bitpack_phase(torch))
    return results


def bitpack_values(shape, seed: int) -> np.ndarray:
    """A [B, H, W] mask of values drawn from {0, 1, 7, 255}."""
    values = np.array([0, 1, 7, 255], np.uint8)
    return values[np.random.default_rng(seed).integers(0, 4, shape)]


def payload_rows(torch, b: int, h: int, w: int, shift: int = 0):
    """[B, P + 64] rows on the card filled with 0xA5, P the packed payload
    row's bytes, and the column range [lo, hi) of their mask bytes
    (``shift`` bytes past the payload's own: a misaligned destination)."""
    from robotic_discovery_platform_tpu_torch.ops import pack

    p = pack.frame_payload_bytes(h, w, PAYLOAD_PTS) + 64
    rows = torch.full((b, p), 0xA5, dtype=torch.uint8, device="cuda")
    lo = pack.HEADER_BYTES + 4 * pack.sidecar_floats(PAYLOAD_PTS) + shift
    return rows, lo, lo + h * pack.packed_row_bytes(w)


def bitpack_phase(torch) -> dict:
    """The mask bitpack (csrc/bitpack_mask.cu) against its plain version
    and np.packbits, bit for bit, at BITPACK_MAIN and BITPACK_EDGES: into
    a fresh tensor; into the mask bytes of payload rows (``out=``, the
    main path's form: 4-byte aligned, frames a row pitch apart) and 1 byte
    past them (misaligned: the per-byte path), every other byte untouched;
    and from a mask 1 byte past 16-byte alignment. One launch per call.
    Then :func:`pack_rows_case`, the timings of the fresh-tensor form
    (:func:`bitpack_timing_phase`) and those of the ``out=`` form, whose
    time at [8, 480, 640] the kernels' line reports."""
    from robotic_discovery_platform_tpu_torch.ops import pack

    masks = {}
    for i, shape in enumerate(BITPACK_MAIN + BITPACK_EDGES):
        b, h, w = shape
        m_np = bitpack_values(shape, SEED + 3 + i)
        m = masks[shape] = torch.from_numpy(m_np).cuda()
        before = pack.bitpack_mask.launches
        got = pack.bitpack_mask(m)
        check(pack.bitpack_mask.launches == before + 1,
              f"bitpack_mask {list(shape)}: not one launch per call")
        plain = pack.bitpack_mask_plain(m)
        check(torch.equal(got, plain)
              and np.array_equal(got.cpu().numpy(),
                                 np.packbits(m_np != 0, axis=-1)),
              f"bitpack_mask {list(shape)}: differs from the plain version "
              "or np.packbits")
        n = h * pack.packed_row_bytes(w)
        for shift in (0, 1):
            rows, lo, hi = payload_rows(torch, b, h, w, shift)
            want = rows.clone()
            want[:, lo:hi] = plain.reshape(b, n)
            out = pack.bitpack_mask(m, out=rows[:, lo:hi])
            check(out.data_ptr() == rows[:, lo:hi].data_ptr()
                  and torch.equal(rows, want),
                  f"bitpack_mask {list(shape)} into payload rows at byte "
                  f"{lo}: bits or the bytes around them differ")
        buf = torch.empty(m.numel() + 16, dtype=torch.uint8, device="cuda")
        off = buf[1:1 + m.numel()].view(shape)
        off.copy_(m)
        check(torch.equal(pack.bitpack_mask(off), plain),
              f"bitpack_mask {list(shape)} from a misaligned mask: differs")
    torch.cuda.synchronize()
    log(f"bitpack_mask at {[list(s) for s in masks]}: bitwise against its "
        "plain version and np.packbits, into a fresh tensor, into payload "
        "rows (aligned and 1 byte off; the bytes around untouched) and from "
        "a misaligned mask; one launch per call")
    pack_rows_case(torch)
    results = bitpack_timing_phase(torch)
    for shape in BITPACK_MAIN:
        b, h, w = shape
        rows, lo, hi = payload_rows(torch, b, h, w)
        view, m = rows[:, lo:hi], masks[shape]
        t = device_ms(torch, lambda: pack.bitpack_mask(m, out=view))
        log(f"bitpack_mask {list(shape)} into its payload rows: device ms "
            f"{t:.4f}")
        results[("bitpack_mask", "rows", *shape)] = {"ms": t}
    # the kernels' line: the form the main path runs, into the rows
    results[("bitpack_mask",)] = dict(
        results[("bitpack_mask", *BITPACK_MAIN[0])],
        ms=results[("bitpack_mask", "rows", *BITPACK_MAIN[0])]["ms"])
    return results


def bitpack_timing_phase(torch) -> dict:
    """The bitpack's device time into a fresh tensor (the form every
    version of its wrapper has) at BITPACK_MAIN, and at [3, 37, 53] (the
    floor of one launch), beside its plain version's and the byte bound.
    It times the package beside this file: to time another version on
    the same card, copy this file into that version's root under another
    name and run it there with ``--phase bitpack_timing_phase``."""
    from robotic_discovery_platform_tpu_torch.ops import pack

    results = {}
    for shape in BITPACK_MAIN + BITPACK_EDGES[:1]:
        b, h, w = shape
        m = torch.from_numpy(bitpack_values(shape, SEED + 4)).cuda()
        t = timings(torch, lambda: pack.bitpack_mask(m),
                    lambda: pack.bitpack_mask_plain(m))
        t["max_abs_err"] = 0.0
        t["bound_ms"], t["bound_by"] = bound_ms(
            *flops_lib().bitpack_mask_cost(b, h, w),
            flops_lib().H100_F32_FLOPS)
        log(f"bitpack_mask {list(shape)}: {timing_text(t)}")
        results[("bitpack_mask", *shape)] = t
    return results


def pack_rows_case(torch) -> None:
    """``pipeline.pack_analysis`` of a batch at each BITPACK_MAIN shape on
    the card, byte-equal to the rows assembled as before the bits went
    straight into the row (packed into a tensor of their own, then copied
    in) and to the CPU's rows of the same leaves."""
    from robotic_discovery_platform_tpu_torch.ops import geometry, pack
    from robotic_discovery_platform_tpu_torch.ops import pipeline

    for b, h, w in BITPACK_MAIN:
        rng = np.random.default_rng(SEED + 5 + b)
        valid = rng.random(b) < 0.7
        leaves = [(rng.random((b, h, w)) < 0.3).astype(np.uint8),
                  (rng.random(b) * 100).astype(np.float32),
                  np.where(valid, rng.random(b), np.nan).astype(np.float32),
                  rng.random(b).astype(np.float32) + 1, valid,
                  rng.normal(size=(b, PAYLOAD_PTS, 3)).astype(np.float32),
                  rng.random(b).astype(np.float32)]

        def analysis(device):
            mask, cov, mean, maxk, ok, spline, margin = (
                torch.from_numpy(np.asarray(a)).to(device) for a in leaves)
            count = torch.full((b,), 7, dtype=torch.int32, device=device)
            prof = geometry.CurvatureProfile(mean, maxk, spline, ok, count,
                                             count, ~ok)
            return pipeline.FrameAnalysis(mask, cov, prof, margin)

        card = analysis("cuda")
        row = pipeline.pack_analysis(card, n_pts=PAYLOAD_PTS)
        former = row.clone()
        lo = pack.HEADER_BYTES + 4 * pack.sidecar_floats(PAYLOAD_PTS)
        former[:, lo:lo + h * pack.packed_row_bytes(w)] = pack.bitpack_mask(
            card.mask).reshape(b, -1)
        cpu = pipeline.pack_analysis(analysis("cpu"), n_pts=PAYLOAD_PTS)
        check(torch.equal(row, former)
              and np.array_equal(row.cpu().numpy(), cpu.numpy()),
              f"pack_analysis [{b}, {h}, {w}]: rows differ from the former "
              "assembly or the CPU's")
    log(f"pack_analysis at {[list(s) for s in BITPACK_MAIN]}: rows "
        "byte-equal to the former assembly and to the CPU's")


def deproject_cases(torch, port, gk, build, views, params) -> None:
    """deproject_edge_stats beside the main path's calls (``views``: the
    480x640 frame at stride 1 and its pooled 240x320 view at stride 2;
    ``params``: fx, fy, cx, cy, depth_scale as 0-d tensors on the card,
    the first four views of the intrinsics): the profiler sees one kernel
    and no copy per call; ragged views (37x53 and 481x643, and their
    pooled views at stride 2), a frame with no valid pixel, one with a
    single valid pixel in a row's ragged tail and a depth map at a
    misaligned address (the scalar path), each called twice, equal bit for
    bit to each other and to the plain version; two streams calling at
    once, each equal to the plain version, each on its own ticket counter,
    every counter back at 0; and no stack frame in ``ptxas -v`` for this
    kernel or dequant_idct."""
    F = torch.nn.functional

    def same(got, want) -> bool:
        return all(bitwise_equal(torch, a, b) for a, b in
                   zip([*got[:4], *got[4]], [*want[:4], *want[4]]))

    def one_kernel_per_call(rows) -> bool:
        return (len(rows) == 1 and rows[0][1] == iters
                and "deproject" in rows[0][2])

    m1, d1 = views[1]
    iters = 10
    rows = []
    # the profiler now and then drops a short launch's record (seen with
    # none and with 9 of 10 kept), so up to three profiles, one of which
    # must see exactly one kernel per call
    for _ in range(3):
        rows = profiled_rows(torch, lambda: gk.deproject_edge_stats(
            m1, d1, *params), iters)
        if one_kernel_per_call(rows):
            break
    check(one_kernel_per_call(rows),
          f"deproject_edge_stats: want one kernel per call and no copy; "
          f"the profiler saw {[(r[1], r[2]) for r in rows]} over {iters} "
          "calls")
    log(f"deproject_edge_stats: one kernel per call, no copy "
        f"({rows[0][2][:60]}...)")

    gen = np.random.default_rng(SEED + 6)
    _, mask, depth = port.render_scene(gen, 512, 704)
    big_m = torch.from_numpy((mask > 0).astype(np.uint8)).cuda()
    big_d = torch.from_numpy(depth.astype(np.float32)).cuda()
    cases = []
    for label, (r0, c0, h, w) in (("37x53", (5, 7, 37, 53)),
                                  ("481x643", (0, 0, 481, 643))):
        m, d = big_m[r0:r0 + h, c0:c0 + w], big_d[r0:r0 + h, c0:c0 + w]
        cases.append((f"{label} view", m, d, 1))
        pooled = F.max_pool2d(torch.where(m > 0, d, 0.0)[None, None],
                              2, 2)[0, 0]
        cases.append((f"{label} pooled", (pooled > 0).to(torch.uint8),
                      pooled, 2))
    none_m = torch.zeros_like(m1)
    cases.append(("no valid pixel", none_m, d1, 1))
    one_m = torch.zeros((37, 53), dtype=torch.uint8, device="cuda")
    one_m[36, 52] = 1
    cases.append(("one valid pixel", one_m, big_d[:37, :53] + 1.0, 2))
    buf = torch.empty(d1.numel() + 1, dtype=torch.float32, device="cuda")
    shifted = buf[1:].view(d1.shape)
    shifted.copy_(d1)
    cases.append(("misaligned depth", m1, shifted, 1))
    for label, m, d, stride in cases:
        got = gk.deproject_edge_stats(m, d, *params, stride=stride)
        again = gk.deproject_edge_stats(m, d, *params, stride=stride)
        want = gk.deproject_edge_stats_plain(m, d, *params, stride=stride)
        torch.cuda.synchronize()
        check(same(got, again) and same(got, want),
              f"deproject_edge_stats {label} {tuple(d.shape)} stride "
              f"{stride}: two calls differ or differ from the plain version")
        n = int(got[4][4])
        check(n == {"no valid pixel": 0, "one valid pixel": 1}.get(label, n),
              f"deproject_edge_stats {label}: count {n}")
    log("deproject_edge_stats: 37x53 and 481x643 views and their pooled "
        "views at stride 2, no valid pixel (sentinels, 0), one valid pixel "
        "in a ragged tail, a misaligned depth map: each twice, bitwise, "
        "equal to the plain version")

    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    work = [(views[1], 1), (views[2], 2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(50):
        for j, (st, ((m, d), stride)) in enumerate(zip(streams, work)):
            with torch.cuda.stream(st):
                outs[j].append(gk.deproject_edge_stats(m, d, *params,
                                                       stride=stride))
    torch.cuda.synchronize()
    for j, ((m, d), stride) in enumerate(work):
        want = gk.deproject_edge_stats_plain(m, d, *params, stride=stride)
        check(all(same(got, want) for got in outs[j]),
              f"deproject_edge_stats on stream {j} of 2: differs from the "
              "plain version")
    keys = {(torch.cuda.current_device(), st.cuda_stream) for st in streams}
    check(keys <= set(gk._tickets), "deproject_edge_stats: a stream without "
          "its own ticket counter")
    check(all(int(t) == 0 for t in gk._tickets.values()),
          "deproject_edge_stats: a ticket counter not back at 0")
    log("deproject_edge_stats: two streams at once, 50 calls each (480x640 "
        "stride 1, 240x320 stride 2), bitwise equal to the plain version; "
        f"{len(gk._tickets)} ticket counters, each back at 0")

    build.build(["deproject_edge_stats", "dequant_idct"])
    for name in ("deproject_edge_stats", "dequant_idct"):
        report, stack = ptxas_summary(build, name)
        log(report)
        check(not any(stack), f"{name}: ptxas reports a stack frame")


def curvature_case_inputs(bspline) -> list:
    """bspline_curvature's cases beside the main path's call, as numpy:
    (label, ctrl [C, 3] float32, u [N] float32, knots, degree). A helix of
    control points (a tangent bounded away from 0) at N = 1000 (more than
    one block), as a quadratic, at degree 5, at C = 32 (the kernel's
    limit) and with u at every knot, 0 and 1; control points on a line
    (kappa 0, every sample valid); coincident control points (their
    tangent is zero but for rounding, which their millimetre coordinates
    keep far below the 1e-6 guard: every sample invalid); a
    NaN u (the plain version's flags and values: invalid, kappa 0, r
    NaN)."""
    rng = np.random.default_rng(SEED + 9)

    def helix(c):
        t = np.linspace(0.0, 3.0, c)
        pts = np.stack([0.1 * np.cos(t), 0.1 * np.sin(t), 0.05 * t], axis=1)
        return (pts + rng.normal(0.0, 0.005, pts.shape)).astype(np.float32)

    def line(n):
        return np.linspace(0.0, 1.0, n, dtype=np.float32)

    cases = []
    for label, c, deg, u in (("N=1000", 16, 3, line(1000)),
                             ("degree 2", 8, 2, line(100)),
                             ("degree 5", 16, 5, line(100)),
                             ("C=32", 32, 3, line(100))):
        cases.append((label, helix(c), u, bspline.clamped_uniform_knots(
            c, deg), deg))
    knots = bspline.clamped_uniform_knots(16, 3)
    cases.append(("u at every knot, 0 and 1", helix(16), np.concatenate(
        [knots, [0.0, 1.0]]).astype(np.float32), knots, 3))
    x = np.cumsum(rng.uniform(0.5, 1.5, 16)) * 0.01
    collinear = np.stack([x, np.zeros(16), np.zeros(16)], axis=1)
    cases.append(("collinear", collinear.astype(np.float32), line(100),
                  knots, 3))
    coincident = np.tile(np.float32([1e-3, -2e-3, 5e-4]), (16, 1))
    cases.append(("coincident", coincident, line(100), knots, 3))
    u = line(100)
    u[7] = np.nan
    cases.append(("NaN u", helix(16), u, knots, 3))
    return cases


def curvature_within(got, want) -> tuple[bool, str]:
    """A curvature profile against the plain version's, as numpy (kappa,
    valid, r): validity equal; kappa within CURV_RTOL (relative) plus
    CURV_RTOL * max|kappa|; r within R_RTOL plus R_RTOL * max|r| (the
    largest finite), NaN where the plain version has NaN. Returns (within,
    what differs)."""
    (gk, gv, gr), (wk, wv, wr) = got, want
    if not np.array_equal(gv, wv):
        return False, f"validity differs at {np.flatnonzero(gv != wv)[:8]}"
    kmax = float(np.abs(wk).max())
    rmax = float(np.abs(np.nan_to_num(wr)).max())
    if not np.allclose(gk, wk, rtol=CURV_RTOL, atol=CURV_RTOL * kmax,
                       equal_nan=True):
        return False, f"kappa max |err| {np.nanmax(np.abs(gk - wk))}"
    if not np.allclose(gr, wr, rtol=R_RTOL, atol=R_RTOL * rmax,
                       equal_nan=True):
        return False, f"r max |err| {np.nanmax(np.abs(gr - wr))}"
    return True, ""


def curvature_cases(torch, gk, bspline) -> None:
    """bspline_curvature at :func:`curvature_case_inputs`' cases against
    its plain version (:func:`curvature_within`), each called twice (equal
    bit for bit); the line's kappa is 0 and every sample valid, the
    coincident points' every sample invalid."""
    for label, ctrl, u, knots, deg in curvature_case_inputs(bspline):
        args = (torch.from_numpy(ctrl).cuda(), torch.from_numpy(u).cuda())
        got = gk.bspline_curvature(*args, knots, deg)
        want = gk.bspline_curvature_plain(*args, knots, deg)
        again = gk.bspline_curvature(*args, knots, deg)
        torch.cuda.synchronize()
        got_np, want_np = ([t.cpu().numpy() for t in x] for x in (got, want))
        ok, what = curvature_within(got_np, want_np)
        check(ok, f"bspline_curvature {label}: {what}")
        check(all(bitwise_equal(torch, a, b) for a, b in zip(again, got)),
              f"bspline_curvature {label}: two calls on the same operands "
              "differ")
        kappa, valid = got_np[0], got_np[1]
        if label == "collinear":
            check(bool(valid.all()) and not kappa.any(),
                  "bspline_curvature collinear: kappa not 0 or a sample "
                  "invalid")
        if label == "coincident":
            check(not valid.any() and not kappa.any(),
                  "bspline_curvature coincident: a sample valid")
    log("bspline_curvature N=1000, degree 2 (C=8), degree 5, C=32, u at "
        "every knot, 0 and 1, collinear (kappa 0, all valid), coincident "
        "(all invalid), a NaN u (invalid, kappa 0, r NaN): within "
        f"CURV_RTOL {CURV_RTOL} / R_RTOL {R_RTOL} of the plain version, "
        "validity equal, two calls equal bit for bit")


def ptxas_summary(build, name: str) -> tuple[str, list]:
    """What ``ptxas -v`` reported for kernel ``name``'s entry functions in
    the build that made its library (the log kept beside it, whether this
    process built it or loaded it): a line of registers, stack frames and
    spills, and the stack frame sizes. Fails when there is no report."""
    import re

    text = build.build_log(name)
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", text or "")]
    check(bool(regs), f"{name}: no ptxas -v report beside its library")
    stack = [int(v) for v in re.findall(r"(\d+) bytes stack frame", text)]
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", text)]
    return (f"{name}: ptxas -v over {len(regs)} entry functions: registers "
            f"{regs}, stack frames {stack} bytes, spill stores {spills} "
            "bytes"), stack


def design_band_zero(torch, gram, degree: int) -> bool:
    """Every Gram entry more than ``degree`` off the diagonal is 0."""
    i = torch.arange(gram.shape[0], device=gram.device)
    return bool((gram[(i[:, None] - i[None, :]).abs() > degree] == 0).all())


def design_cases(torch, gk, bspline) -> None:
    """bspline_design beside the main path's call: more points than one
    pass of the cluster takes, a quadratic on 8 control points in 2-D, a
    single point, parameters at every knot and outside [0, 1] -- each
    within DESIGN_RTOL of its plain version's terms' magnitudes, 0 outside
    the band -- and a NaN parameter (every output NaN, as the plain
    version's)."""
    rng = np.random.default_rng(SEED + 8)
    for n, c, deg, d in ((20000, 16, 3, 3), (777, 8, 2, 2), (1, 16, 3, 3)):
        knots = bspline.clamped_uniform_knots(c, deg)
        edges = np.concatenate([knots, [-0.5, 1.5, np.nextafter(1.0, 0.0)]])
        # sorted, as chord-length parameters are
        u = rng.random(n) if n < len(edges) else np.sort(
            np.concatenate([edges, rng.random(n - len(edges))]))
        args = [torch.from_numpy(a).cuda() for a in (
            rng.normal(size=(n, d)), rng.random(n) * (rng.random(n) > 0.2),
            u)]
        got = gk.bspline_design(*args, knots, deg)
        want = gk.bspline_design_plain(*args, knots, deg)
        mag = gk.bspline_design_plain(args[0].abs(), args[1].abs(), args[2],
                                      knots, deg)
        torch.cuda.synchronize()
        check(all(bool(((a - b).abs() <= DESIGN_RTOL * m).all())
                  for a, b, m in zip(got, want, mag))
              and design_band_zero(torch, got[0], deg),
              f"bspline_design N={n} C={c} degree {deg} D={d}: beyond "
              f"{DESIGN_RTOL} of the terms' magnitudes, or nonzero outside "
              "the band")
        if n == 777:
            args[2][5] = float("nan")
            got = gk.bspline_design(*args, knots, deg)
            want = gk.bspline_design_plain(*args, knots, deg)
            check(all(bool(t.isnan().all()) for t in (*got, *want)),
                  "bspline_design: a NaN parameter does not make every "
                  "output NaN")
    log("bspline_design N=20000 (C=16, cubic), N=777 (C=8, quadratic, "
        "D=2) and N=1, parameters at every knot and outside [0, 1]: within "
        f"{DESIGN_RTOL} of |BW|^T|.|, 0 outside the band; a NaN parameter "
        "makes every output NaN, as in the plain version")


def bf16_ulp_check(torch, got, want, mag, n: int) -> tuple[bool, int]:
    """Two bfloat16 roundings of float32 sums of the same ``n`` products
    (plus a bias) taken in different orders: every element within one
    bfloat16 ulp (of the larger of the two) plus the float32 summation
    bound of the two orders, ``2 n 2^-24`` times the sum of the terms'
    magnitudes ``mag`` (which matters only where the sum cancels to near
    zero, where a bfloat16 ulp is tiny). Returns (all within, how many
    elements are more than one representable step apart)."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    ok = bool(((g - w).abs() <= ulp + 2 * n * 2.0 ** -24 * mag).all())

    def line(t):  # sign-magnitude bits on a monotone integer line
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return ok, int(((line(got) - line(want)).abs() > 1).sum())


def convt_kernel_phase(torch, conv) -> dict:
    """conv_transpose2x2 against its plain version at the non-bilinear
    ladder's four shapes at B = 1 and B = 8 in bfloat16 (both round
    float32 sums of the same products, in another order: every element
    within one bfloat16 ulp, plus the two orders' float32 summation bound
    where a sum cancels to near zero, :func:`bf16_ulp_check`), at ragged
    shapes in bfloat16 on both paths (the same bar), in float32 and with
    bfloat16 in and float32 out (relative L2 within CONVT_F32_REL). Each
    shape's path (tensor cores or FMA) is logged, and
    the C entry's rule must agree with ``conv.convt_path``; each call is
    repeated on the same operands (equal bit for bit), and at B = 8 every
    frame of the stack must equal the frame alone bit for bit. Times per
    launch: CUDA events over back-to-back calls, and the profiler's device
    time, against the plain version, cuDNN's ``F.conv_transpose2d`` on the
    same operands in torch's layout (``w.flip(0, 1).permute(2, 3, 0, 1)``)
    and the bound."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    results = {}
    sums = {b: {} for b in (1, MAX_BATCH)}
    cases = [(b, s, s, cin, cout, torch.bfloat16)
             for b in (1, MAX_BATCH) for s, cin, cout in CONVT_SHAPES]
    # ragged: a pixel count no tile divides and a half-filled K chunk on
    # the tensor cores; widths the tensor cores do not take, in both dtypes
    cases += [(2, 9, 13, 48, 128, torch.bfloat16),
              (2, 9, 13, 40, 24, torch.bfloat16),
              (2, 9, 13, 40, 24, torch.float32)]
    for b, h, w, cin, cout, dtype in cases:
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda").to(dtype)
        wt = (torch.randn(2, 2, cin, cout, generator=gen, device="cuda")
              / cin ** 0.5).to(dtype)
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
        path = conv.convt_path(dtype, cin, cout)
        check(conv.convt_path_of_kernel(dtype, cin, cout) == path,
              f"conv_transpose2x2 {(cin, cout)} {dtype}: the C entry's path "
              f"differs from convt_path's {path}")
        got = conv.conv_transpose2x2(x, wt, bias)
        want = conv.conv_transpose2x2_plain(x, wt, bias)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.bfloat16:
            mag = conv.conv_transpose2x2_plain(x.abs(), wt.abs(), bias.abs(),
                                               out_dtype=torch.float32)
            ok, steps = bf16_ulp_check(torch, got, want, mag, cin)
            check(ok, f"conv_transpose2x2 {(b, h, w, cin, cout)}: an element "
                  f"beyond one bfloat16 ulp plus the float32 summation bound "
                  f"of the plain version (max |err| {err})")
            bar = (f"within one bf16 ulp + the f32 order bound; {steps} of "
                   f"{got.numel()} elements more than one step apart")
        else:
            rel = rel_l2(torch, got, want)
            check(rel <= CONVT_F32_REL, f"conv_transpose2x2 "
                  f"{(b, h, w, cin, cout)} float32: relative L2 {rel} > "
                  f"{CONVT_F32_REL}")
            bar = f"relative L2 {rel:.3g} (bar {CONVT_F32_REL})"
        check(bitwise_equal(torch, conv.conv_transpose2x2(x, wt, bias), got),
              f"conv_transpose2x2 {(b, h, w, cin, cout)} {dtype}: two calls "
              "on the same operands differ")
        if b == MAX_BATCH:
            check(all(bitwise_equal(torch, got[i:i + 1], conv.conv_transpose2x2(
                x[i:i + 1], wt, bias)) for i in range(b)),
                f"conv_transpose2x2 {(h, w, cin, cout)}: a frame of a B = "
                f"{b} stack differs from the frame alone")
            bar += "; every frame equal bit for bit to the frame alone"
        xc = x.permute(0, 3, 1, 2)
        wc = wt.flip(0, 1).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = bias.view(1, -1, 1, 1)

        def library():
            return (F.conv_transpose2d(xc, wc, stride=2).float() + bc).to(dtype)

        def kernel():
            return conv.conv_transpose2x2(x, wt, bias)

        t = {
            "ms": time_ms(torch, kernel),
            "plain_ms": time_ms(torch, lambda: conv.conv_transpose2x2_plain(
                x, wt, bias)),
            "library_ms": time_ms(torch, library),
            "device_ms": device_ms(torch, kernel),
            "library_device_ms": device_ms(torch, library),
            "max_abs_err": err,
        }
        flops, nbytes = flops_lib().conv_transpose2x2_cost(
            b, h, w, cin, cout, x.element_size())
        t["bound_ms"], t["bound_by"] = bound_ms(flops, nbytes)
        log(f"conv_transpose2x2 [{b},{h},{w},{cin}]->{cout} "
            f"{str(dtype)[6:]}, path {path}: {bar}, "
            f"deterministic, max|err| {err:.3g}; ms {t['ms']:.4f} plain "
            f"{t['plain_ms']:.4f} cudnn {t['library_ms']:.4f} bound "
            f"{t['bound_ms']:.5f} ({t['bound_by']}); device ms "
            f"{t['device_ms']:.4f} cudnn {t['library_device_ms']:.4f} "
            f"(profiler), {flops / t['device_ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['bound_ms'] / t['device_ms']:.1%} of the bound")
        if h == w and (h, cin, cout) in CONVT_SHAPES:
            for f in ("ms", "device_ms", "library_ms", "library_device_ms",
                      "plain_ms", "bound_ms"):
                sums[b][f] = sums[b].get(f, 0.0) + t[f]
            if b == 1:
                results[("conv_transpose2x2", h, cin, cout)] = t
    # bf16 in, float32 out on the tensor cores: float32 sums of the same
    # exact products in another order
    x = torch.randn(2, 9, 13, 48, generator=gen, device="cuda").bfloat16()
    wt = (torch.randn(2, 2, 48, 64, generator=gen, device="cuda")
          / 48 ** 0.5).bfloat16()
    bias = torch.randn(64, generator=gen, device="cuda") * 0.1
    got = conv.conv_transpose2x2(x, wt, bias, out_dtype=torch.float32)
    rel = rel_l2(torch, got, conv.conv_transpose2x2_plain(
        x, wt, bias, out_dtype=torch.float32))
    check(conv.convt_path_of_kernel(torch.bfloat16, 48, 64, torch.float32)
          == "tensor_cores" and rel <= CONVT_F32_REL,
          f"conv_transpose2x2 bf16 -> float32: relative L2 {rel} > "
          f"{CONVT_F32_REL}, or not on the tensor cores")
    log(f"conv_transpose2x2 [2,9,13,48]->64 bfloat16 -> float32, path "
        f"tensor_cores: relative L2 {rel:.3g} (bar {CONVT_F32_REL})")
    for b, row in sums.items():
        log(f"conv_transpose2x2, the 4 launches of one non-bilinear "
            f"{'frame' if b == 1 else 'dispatch'} at B = {b}: " + ", ".join(
                f"{f} {v:.4f}" for f, v in row.items()))
    return results


def decode_kernel_phase(torch) -> dict:
    """dequant_idct against its plain version, bitwise, on coefficients
    spanning the full baseline range (|coef| <= 2047, q <= 255): one
    480x640 4:2:0 frame's planes (N = 4800 and 1200) at B = 1 and B = 8,
    and a ragged N that no tile divides; then every coefficient at +2047,
    at -2047 and at random signs of 2047 with q = 255 (the int32 sums
    wrap), and coefficients at a misaligned address (the scalar path).
    Device time per launch (the profiler) against the plain version, and
    per coefficient frame the sum of its three planes' launches; no single
    PyTorch call computes the islow IDCT (and torch has no int32 matrix
    product on CUDA), so there is no library time. The bound counts
    libjpeg's butterfly, the least work (``utils/flops.
    ISLOW_OPS_PER_BLOCK``), at the
    card's int32 rate; the kernel's separable form does
    SEPARABLE_IDCT_MACS_PER_BLOCK."""
    from robotic_discovery_platform_tpu_torch.ops import decode

    rng = np.random.default_rng(SEED + 5)
    rate = int32_ops_per_s(torch)
    results, per_launch = {}, {}
    cases = [(b, n) for b in (1, MAX_BATCH) for n in sorted(set(IDCT_PLANES))]
    cases.append((3, 1237))
    for b, n in cases:
        c = torch.from_numpy(rng.integers(-2047, 2048, (b, n, 64))
                             .astype(np.int16)).cuda()
        q = torch.from_numpy(rng.integers(1, 256, (b, 64))
                             .astype(np.int32)).cuda()
        got = decode.dequant_idct(c, q)
        want = decode.dequant_idct_plain(c, q)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"dequant_idct [{b},{n},64]: differs from the plain version")
        t = timings(torch, lambda: decode.dequant_idct(c, q),
                    lambda: decode.dequant_idct_plain(c, q))
        t["max_abs_err"] = 0.0
        blocks = b * n
        t["bound_ms"], t["bound_by"] = bound_ms(
            *flops_lib().dequant_idct_cost(b, n), rate)
        t["separable_ops_ms"] = (blocks * SEPARABLE_IDCT_MACS_PER_BLOCK
                                 / rate * 1e3)
        log(f"dequant_idct [{b},{n},64]: bitwise; {timing_text(t)}; the "
            f"separable form's operations alone {t['separable_ops_ms']:.6f} "
            f"ms at {rate / 1e12:.2f} T int32 ops/s")
        per_launch[(b, n)] = t
        if b == 1:
            results[("dequant_idct", n)] = t
    for b in (1, MAX_BATCH):
        rows = [per_launch[(b, n)] for n in IDCT_PLANES]
        unit = "one coefficient frame" if b == 1 else f"a B = {b} dispatch"
        log(f"dequant_idct, the {len(rows)} launches of {unit} "
            f"({'+'.join(map(str, IDCT_PLANES))} blocks a frame): device "
            f"ms {sum(r['ms'] for r in rows):.4f}, "
            f"plain {sum(r['plain_ms'] for r in rows):.4f}, bound "
            f"{sum(r['bound_ms'] for r in rows):.6f}")

    n = IDCT_PLANES[0]
    q = torch.full((1, 64), 255, dtype=torch.int32, device="cuda")
    signs = torch.from_numpy(rng.choice(np.array([-1, 1], np.int16),
                                        (1, n, 64))).cuda()
    buf = torch.empty(n * 64 + 1, dtype=torch.int16, device="cuda")
    shifted = buf[1:].view(1, n, 64)
    shifted.copy_(signs * 2047)
    for label, c in (("+2047", torch.full_like(signs, 2047)),
                     ("-2047", torch.full_like(signs, -2047)),
                     ("+-2047", signs * 2047), ("misaligned +-2047", shifted)):
        got = decode.dequant_idct(c, q)
        want = decode.dequant_idct_plain(c, q)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"dequant_idct {label} [1,{n},64], q = 255: differs from the "
              "plain version")
    log(f"dequant_idct [1,{n},64] at +2047, -2047, random signs of 2047 "
        "(q = 255: the int32 sums wrap) and at a misaligned address: "
        "bitwise")
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
    "conv3x3_grad_weights": (
        "robotic_discovery_platform_tpu_torch/csrc/conv3x3_grad_weights.cu",
        "robotic_discovery_platform_tpu/ops/pallas/conv.py:519",
        [("conv3x3_grad_weights", *s) for s in MAIN_PATH_3X3]),
    "dequant_idct": (
        "robotic_discovery_platform_tpu_torch/csrc/dequant_idct.cu",
        "robotic_discovery_platform_tpu/ops/pallas/decode.py:149",
        [("dequant_idct", n) for n in IDCT_PLANES]),
    "conv_transpose2x2": (
        "robotic_discovery_platform_tpu_torch/csrc/conv_transpose2x2.cu",
        "robotic_discovery_platform_tpu/ops/pallas/conv.py:412",
        [("conv_transpose2x2", *s) for s in CONVT_SHAPES]),
}


def launch_counters() -> dict:
    """Each kernel's wrapper by name, whose ``launches`` counts its
    launches."""
    from robotic_discovery_platform_tpu_torch.ops import graphs

    return {fn.__name__: fn for fn in graphs.launch_counters()}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def launches_of(**counts) -> dict:
    """Every kernel's expected launch count: those named, 0 for the rest."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(counts)
    return want


def frame_launches(n: int, *, coef: bool = False, convt: bool = False,
                   dispatches: int = 0, ones: int = 0,
                   served: bool = False) -> dict:
    """Launches of ``n`` direct frames (18 conv3x3_bn_relu, 1 conv1x1, 1
    each geometry kernel; 3 dequant_idct for a coefficient frame and 4
    conv_transpose2x2 for the non-bilinear model; with ``served``, the
    servicer's direct path, one bitpack for the frame's packed row), or
    of ``dispatches`` batched dispatches, ``ones`` of them of one frame
    (those take the geometry kernels; every dispatch one bitpack)."""
    units = dispatches if dispatches else n
    geom = ones if dispatches else n
    return launches_of(
        conv3x3_bn_relu=18 * units, conv1x1=units, deproject_edge_stats=geom,
        bspline_design=geom, bspline_curvature=geom,
        bitpack_mask=dispatches if dispatches else n * served,
        dequant_idct=3 * units if coef else 0,
        conv_transpose2x2=4 * units if convt else 0)


def kernel_record(results: dict, launches: dict) -> dict:
    """The kernels' JSON record: per kernel, the sums over one frame's
    launches of each per-launch time (so ``ms`` is the kernel's device
    time per frame; the bitpack's is one [8, 480, 640] dispatch; the
    weight gradient's is one train step's 18 launches at B = 4), the
    worst error over its main-path shapes, and the launch count of the
    servicer phase's legs and the training phase's train_model and
    registry-served legs."""
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


def seeded_model(torch, port, x0, cfg=None, seed: int = SEED):
    """Full-width model (default: the default model; ``cfg`` for another)
    with conv weights from a generator seeded with ``seed``
    and BatchNorm statistics as a trained network keeps them: each
    layer's mean and variance measured on its input for frame 0 (a float32
    forward, layer by layer), perturbed from a numpy seed, with scale and
    bias drawn from the same seed, so folding matters. (Statistics drawn
    independently of the activations make a random network amplify
    rounding chaotically: two float32 summation orders then differ by
    2.6% in the bf16 logits, on the CPU as on the card.) The head's bias
    is set so that half of frame 0's logits are positive: a structured
    mask, not an all-or-nothing one."""
    cfg = port.ModelConfig() if cfg is None else cfg
    net = port.UNet(cfg).init_weights(
        torch.Generator().manual_seed(seed)).eval()
    calib = port.UNet(dataclasses.replace(cfg, compute_dtype="float32")).eval()
    calib.load_state_dict(net.state_dict())
    calib = calib.to("cuda")
    rng = np.random.default_rng(seed)

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
    want = frame_launches(n)
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
    want = frame_launches(n, served=True)
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
        # each stream's responses byte-equal to the one stream's: the
        # graph's lock keeps concurrent frames from sharing its buffers
        same_responses(out, [responses[i] for i in order],
                       "direct, concurrent streams")
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
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    batched.warmup(FRAME_W, FRAME_H)
    warm_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved() - reserved
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
    bwant = frame_launches(0, dispatches=dispatches, ones=sizes.get(1, 0))
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
        f" {warm_s:.1f} s (the captures; reserved memory +"
        f"{reserved / 2**20:.0f} MiB); dispatch sizes {sizes} ({dispatches} "
        "dispatches); "
        f"{STREAMS * n / batched_s:.1f} frames/s aggregate; proc_time_ms "
        f"median {np.median(proc):.2f} p90 {np.percentile(proc, 90):.2f} max "
        f"{max(proc):.2f}; launches {blaunches}; masks byte-equal to the "
        f"direct path's, curvature within rtol {GEOM_RTOL}")
    log(f"batched leg under the profiler: "
        f"{device_busy(torch, lambda: concurrent_streams(batched, streams))}")
    batched.close()
    return {k: launches[k] + blaunches[k] for k in launches}


# -- phase 4c: the serving host path -------------------------------------------

#: client leg: frames per mask format, and how long a client started before
#: its server may retry through UNAVAILABLE
CLIENT_FRAMES = 64
CLIENT_SETUP_S = 120.0
#: rounds of each servicer leg's 8 x 8 frames (frames/s: their median)
HOST_ROUNDS = 5


def phase_model(torch, port) -> tuple:
    """The 8 rendered frames and the calibrated default model, folded, as
    ``main`` makes them (for a phase run alone)."""
    rng = np.random.default_rng(SEED)
    frames = []
    for _ in range(8):
        rgb, _, depth = port.render_scene(rng, FRAME_H, FRAME_W)
        frames.append((rgb, depth))
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    return port.FoldedUNet(seeded_model(torch, port, x0), device="cuda"), frames


class FrameList:
    """A :class:`FrameSource` over frames rendered once, replayed as a
    camera delivers them (rendering a 480x640 scene takes longer than
    serving it)."""

    depth_scale = 0.001

    def __init__(self, pairs: list):
        self.pairs, self._i = pairs, 0

    def start(self) -> None:
        self._i = 0

    def stop(self) -> None:
        pass

    def get_frames(self):
        if self._i >= len(self.pairs):
            return None, None
        self._i += 1
        return self.pairs[self._i - 1]


def scrape(port_no: int) -> dict:
    """The host path's counters on /metrics, by name."""
    text = http_get(port_no, "/metrics").decode()
    out = {
        "batch_frames": metric_value(text, "rdp_batch_size_frames_sum"),
        "batch_dispatches": metric_value(text, "rdp_batch_size_frames_count"),
        "geometry": metric_value(text, "rdp_geometry_cache_hits_total")
        + metric_value(text, "rdp_geometry_cache_misses_total"),
        "decoded": sum(metric_value(text, "rdp_decode_seconds_count",
                                    format=f)
                       for f in ("raw", "coef", "encoded", "mixed")),
        "encoded": sum(metric_value(text, "rdp_encode_seconds_count",
                                    format=f) for f in ("png", "bits", "rle")),
        "restarts": metric_value(text, "rdp_batch_watchdog_restarts_total"),
    }
    return out


def host_path_phase(torch, port, folded=None, frames=None) -> dict:
    """The serving host path at full width (``ModelConfig()``, 480x640):

    (a) a bucket-8 scan dispatch (``make_scan_batch_analyzer(pack=True)``):
    its rows equal the frame analyzer's bit for bit, its launches per replay
    exactly 144 / 8 / 8 / 8 / 8 / 1 (3x3 conv, head, the three geometry
    kernels, bitpack; the profiler's rows too), every deprojection ticket
    counter at 0 after two replays; its device ms (CUDA events) beside the
    frame analyzer's times 8 and the dense bucket's, and the peak memory of
    each first call (warm-up and capture) and replay;
    (b) servicers under STREAMS closed-loop streams, one leg per setting
    (inline direct; ``decode_workers=2, ingest_prefetch=2``;
    ``egress_workers=2`` direct and batched; ``batch_impl="scan"``;
    ``egress_pack=False``; format-2 frames through the decode pool), every
    response equal to the inline direct servicer's (bit for bit, or for
    dense batches within phase 4's bars), exact launches, frames/s per leg;
    (c) the port's ``run_client(fmt="raw")`` over gRPC for CLIENT_FRAMES
    frames in each mask format, the first started before its server
    listens, against the servicer's own answers;
    (d) ``/metrics`` over (b)'s legs: batch sizes sum to the frames
    batched, geometry lookups, decodes and encodes each equal the frames
    served, no watchdog restart.

    Returns the launches of the serving legs."""
    import threading

    import grpc

    from robotic_discovery_platform_tpu_torch.observability import (
        exposition,
    )
    from robotic_discovery_platform_tpu_torch.ops import (
        geometry_kernels as gk,
        pipeline,
    )
    from robotic_discovery_platform_tpu_torch.resilience import (
        RetryPolicy,
        default_retryable,
    )
    from robotic_discovery_platform_tpu_torch.serving import (
        client as client_lib,
        entropy,
        grpc_service,
        ingest,
    )
    from robotic_discovery_platform_tpu_torch.utils.config import (
        ClientConfig,
    )

    t_phase = time.perf_counter()
    if folded is None:
        folded, frames = phase_model(torch, port)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_host_"))
    k = port.default_intrinsics(FRAME_W, FRAME_H).astype(np.float32)
    b = MAX_BATCH

    # (a) the scan dispatch
    args = (np.stack([f[0] for f in frames[:b]]),
            np.stack([f[1] for f in frames[:b]]),
            np.repeat(k[None], b, axis=0), np.full((b,), 0.001, np.float32))
    frame_an = pipeline.make_frame_analyzer(folded, img_size=256,
                                            device="cuda", pack=True)
    dense = pipeline.make_batch_analyzer(folded, img_size=256, device="cuda",
                                         pack=True)
    scan = pipeline.make_scan_batch_analyzer(folded, img_size=256,
                                             device="cuda", pack=True)
    peaks = {}
    for name, analyzer, a in (
            ("frame", frame_an, (frames[0][0], frames[0][1], k, 0.001)),
            ("dense", dense, args), ("scan", scan, args)):
        mib = []
        for _ in range(2):  # the first call (warm-up and capture), a replay
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            analyzer(*a)
            torch.cuda.synchronize()
            mib.append((torch.cuda.max_memory_allocated() - base) / 2**20)
        peaks[name] = mib
    rows = scan(*args).cpu().numpy()
    for i in range(b):
        want = frame_an(frames[i][0], frames[i][1], k, 0.001)
        check(np.array_equal(rows[i], want), f"scan row {i} differs from the "
              "frame analyzer's row bit for bit")
    delta, = capture_deltas(scan)
    want_delta = launches_of(conv3x3_bn_relu=18 * b, conv1x1=b,
                             deproject_edge_stats=b, bspline_design=b,
                             bspline_curvature=b, bitpack_mask=1)
    check(delta == want_delta, f"scan capture delta {delta}, want "
          f"{want_delta}")
    reset_launches()
    scan(*args)
    scan(*args)
    torch.cuda.synchronize()
    check(read_launches() == scaled(delta, 2), f"two scan replays launched "
          f"{read_launches()}, want 2 x {delta}")
    tickets = {key: int(t.item()) for key, t in gk._tickets.items()}
    check(tickets and all(v == 0 for v in tickets.values()),
          f"ticket counters after the scan replays: {tickets}")
    check_replay_kernels(torch, lambda: scan(*args), delta,
                         "scan analyzer, bucket 8")
    times = {"scan": time_ms(torch, lambda: scan(*args), iters=10),
             "dense": time_ms(torch, lambda: dense(*args), iters=10),
             "frame": time_ms(torch, lambda: frame_an(
                 frames[0][0], frames[0][1], k, 0.001), iters=10)}
    check(scan.graphs.guard.name == "pipeline.scan_batch_analyzer"
          and scan.graphs.guard.stats.budget == 8,
          "scan analyzer's capture guard")
    log(f"host path, scan: bucket-8 rows equal the frame analyzer's bit for "
        f"bit; launches per replay {delta}; {len(tickets)} ticket counters "
        f"at 0; device ms (CUDA events, back to back) scan "
        f"{times['scan']:.3f}, dense {times['dense']:.3f}, frame "
        f"{times['frame']:.3f} (x 8 = {8 * times['frame']:.3f}); peak "
        f"allocated MiB over the call's start, first call / replay: scan "
        f"{peaks['scan'][0]:.1f} / {peaks['scan'][1]:.1f}, dense "
        f"{peaks['dense'][0]:.1f} / {peaks['dense'][1]:.1f}, frame "
        f"{peaks['frame'][0]:.1f} / {peaks['frame'][1]:.1f}")
    del frame_an, dense, scan
    t_scan = time.perf_counter()

    # (b) the servicer legs
    metrics = exposition.maybe_start_metrics_server(-1)
    n = len(frames)
    orders = [[(s * 2 + j) % n for j in range(n)] for s in range(STREAMS)]
    raw = [port.raw_request(rgb, depth, mask_format=i % 3)
           for i, (rgb, depth) in enumerate(frames)]
    qy, qc = ingest.quant_tables(COEF_QUALITY)
    coef = [ingest.coef_request(encode_coefficients(entropy, rgb, qy, qc),
                                depth, mask_format=i % 3)
            for i, (rgb, depth) in enumerate(frames)]
    launches = dict.fromkeys(KERNELS, 0)
    totals = dict.fromkeys(("frames", "batched", "batch_dispatches"), 0)
    moved = collections.Counter()
    fps = {}

    def serve(name, requests, want=None, exact=True, coef_lane=False, **kw):
        cfg = port.ServerConfig(address="localhost:0",
                                metrics_csv=str(tmp / f"{name}.csv"),
                                calibration_path=str(tmp / "none.npz"), **kw)
        service = port.VisionAnalysisService(folded, cfg=cfg, device="cuda")
        try:
            service.warmup(FRAME_W, FRAME_H)
            if coef_lane:
                service.warmup_coef(FRAME_W, FRAME_H)
            one = None
            if want is None:  # the reference: one stream first
                one = list(service.analyze_stream(iter(requests)))
            before = scrape(metrics.port)
            if service.dispatcher is not None:
                service.dispatcher.dispatch_sizes.clear()
            reset_launches()
            rounds = [concurrent_streams(
                service, [[requests[i] for i in o] for o in orders])
                for _ in range(HOST_ROUNDS)]
            counts = read_launches()
            after = scrape(metrics.port)
            sizes = (dict(service.dispatcher.dispatch_sizes)
                     if service.dispatcher is not None else {})
        finally:
            service.close()
        want = one if want is None else want
        for out, _ in rounds:
            for order, got in zip(orders, out):
                same_responses(got, [want[i] for i in order], name,
                               exact=exact)
        served = STREAMS * n * HOST_ROUNDS
        if sizes:
            check(sum(s * c for s, c in sizes.items()) == served,
                  f"{name}: dispatch sizes {sizes}")
            buckets = collections.Counter()
            for s, c in sizes.items():
                buckets[service.dispatcher.bucket_for(s)] += c
            dispatches = sum(sizes.values())
            if kw.get("batch_impl") == "scan":
                frames_run = sum(bk * c for bk, c in buckets.items())
                expect = launches_of(
                    conv3x3_bn_relu=18 * frames_run, conv1x1=frames_run,
                    deproject_edge_stats=frames_run,
                    bspline_design=frames_run, bspline_curvature=frames_run,
                    bitpack_mask=dispatches)
            else:
                expect = frame_launches(0, dispatches=dispatches,
                                        ones=sizes.get(1, 0), coef=coef_lane)
                if not kw.get("egress_pack", True):
                    expect["bitpack_mask"] = 0
            totals["batched"] += served
            totals["batch_dispatches"] += dispatches
        else:
            expect = frame_launches(served, coef=coef_lane, served=True)
        check(counts == expect, f"{name}: launches {counts}, want {expect} "
              f"(dispatch sizes {sizes})")
        for key in launches:
            launches[key] += counts[key]
        for key in after:
            moved[key] += after[key] - before[key]
        totals["frames"] += served
        per_round = sorted(STREAMS * n / wall for _, wall in rounds)
        fps[name] = float(np.median(per_round))
        log(f"host path leg {name}: {fps[name]:.1f} frames/s (median of "
            f"{HOST_ROUNDS} rounds of {STREAMS} streams x {n} frames, "
            f"{per_round[0]:.1f}-{per_round[-1]:.1f}; inline direct "
            f"{fps.get('inline', fps[name]):.1f}); dispatch sizes {sizes}; "
            f"responses equal to the inline direct servicer's"
            f"{' bit for bit' if exact else ' within phase 4 bars'}")
        return one

    want_raw = serve("inline", raw)
    serve("decode_workers=2", raw, want_raw, decode_workers=2,
          ingest_prefetch=2)
    serve("egress_workers=2 direct", raw, want_raw, egress_workers=2)
    batched = dict(batch_window_ms=2.0, max_batch=MAX_BATCH)
    serve("egress_workers=2 batched", raw, want_raw, exact=False,
          egress_workers=2, **batched)
    serve("batch_impl=scan", raw, want_raw, batch_impl="scan", **batched)
    serve("egress_pack=False", raw, want_raw, exact=False, egress_pack=False,
          **batched)
    want_coef = serve("inline format 2", coef, coef_lane=True)
    serve("format 2, decode_workers=2", coef, want_coef, coef_lane=True,
          decode_workers=2, ingest_prefetch=2)

    # (d) /metrics over the legs
    check(moved["batch_frames"] == totals["batched"]
          and moved["batch_dispatches"] == totals["batch_dispatches"],
          f"rdp_batch_size_frames moved {moved['batch_frames']} frames in "
          f"{moved['batch_dispatches']} dispatches; the legs batched "
          f"{totals['batched']} in {totals['batch_dispatches']}")
    for key in ("geometry", "decoded", "encoded"):
        check(moved[key] == totals["frames"], f"/metrics: {key} moved "
              f"{moved[key]} for {totals['frames']} frames served")
    final = scrape(metrics.port)
    check(moved["restarts"] == 0 and final["restarts"] == 0,
          f"watchdog restarts: {final['restarts']}")
    metrics.stop()
    log(f"host path /metrics over the legs: {totals['frames']} frames served "
        f"({totals['batched']} batched in {totals['batch_dispatches']} "
        f"dispatches): batch size sum, geometry lookups, decodes and encodes "
        f"each equal to them; watchdog restarts 0")

    t_legs = time.perf_counter()

    # (c) the client over gRPC, the first one started before the server
    source = port.SyntheticSource(FRAME_W, FRAME_H, seed=SEED + 1,
                                  n_frames=CLIENT_FRAMES)
    source.start()
    pairs = list(port.iter_frames(source))
    port_no = free_port()
    address = f"localhost:{port_no}"
    ccfg = ClientConfig(server_address=address,
                        calibration_path=str(tmp / "none.npz"))
    setup_deadline = time.monotonic() + CLIENT_SETUP_S
    refused: list = []

    def retryable(exc):
        refused.append(exc)
        return time.monotonic() < setup_deadline and default_retryable(exc)

    results: dict = {}
    client_fps: dict = {}
    errors: list = []

    def run(mask_format):
        try:
            with grpc.insecure_channel(address, options=[
                    ("grpc.initial_reconnect_backoff_ms", 100),
                    ("grpc.max_reconnect_backoff_ms", 500)]) as channel:
                t0 = time.perf_counter()
                results[mask_format] = client_lib.run_client(
                    ccfg, source=FrameList(pairs), channel=channel,
                    mask_format=mask_format, fmt="raw",
                    retry=RetryPolicy(max_attempts=None, base_delay_s=0.05,
                                      max_delay_s=0.5, retryable=retryable))
                client_fps[mask_format] = CLIENT_FRAMES / (
                    time.perf_counter() - t0)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    early = threading.Thread(target=run, args=(0,))
    early.start()
    deadline = time.monotonic() + 30.0
    while not refused and time.monotonic() < deadline:
        time.sleep(0.01)
    check(bool(refused), "the early client never reached the server's port")
    scfg = port.ServerConfig(address=address,
                             metrics_csv=str(tmp / "client.csv"),
                             calibration_path=str(tmp / "none.npz"))
    server, servicer = grpc_service.build_server(
        scfg, folded, warmup_shape=(FRAME_W, FRAME_H), device="cuda")
    server.start()
    t_up = time.perf_counter()
    try:
        early.join(timeout=CLIENT_SETUP_S)
        early_s = time.perf_counter() - t_up
        check(not early.is_alive() and not errors, f"early client: {errors}")
        codes = {e.code() for e in refused if hasattr(e, "code")}
        check(codes == {grpc.StatusCode.UNAVAILABLE}, f"setup failures {codes}")
        for mask_format in (1, 2):
            run(mask_format)
        check(not errors, f"client: {errors}")
        for mask_format, got in results.items():
            want = list(servicer.analyze_stream(iter(
                port.raw_request(bgr[..., ::-1], depth,
                                 mask_format=mask_format)
                for bgr, depth in pairs)))
            check(len(got) == len(want) == CLIENT_FRAMES,
                  f"client, mask_format {mask_format}: {len(got)} results")
            for i, (g, w) in enumerate(zip(got, want)):
                spline = (port.decode_spline_wire(w.packed_spline)
                          if mask_format else np.array(
                              [[p.x, p.y, p.z] for p in w.spline_points]
                          ).reshape(-1, 3))
                check((g.status, g.mean_curvature, g.max_curvature,
                       g.mask_coverage, g.mask_png) == (
                           w.status, w.mean_curvature, w.max_curvature,
                           w.mask_coverage, w.mask)
                      and np.array_equal(g.spline_points, spline)
                      and np.array_equal(g.frame_bgr, pairs[i][0]),
                      f"client, mask_format {mask_format}, frame {i}: result "
                      "differs from the servicer's answer")
                mask = (port.decode_mask_wire(w.mask) if mask_format
                        else None)
                check((g.mask is None) == (mask_format == 0) and (
                    mask is None or np.array_equal(g.mask, mask)),
                      f"client frame {i}: decoded mask")
    finally:
        server.stop(grace=None).wait()
        servicer.close()
    log(f"host path client: run_client(fmt=\"raw\") over gRPC, "
        f"{CLIENT_FRAMES} frames in each of mask formats 0, 1, 2, every "
        f"result the servicer's answer; the first started before its server "
        f"and retried through {len(refused)} UNAVAILABLE setup failure(s), "
        f"done {early_s:.2f} s after the server started; frames/s over one "
        f"stream, mask formats 1 and 2: {client_fps[1]:.1f}, "
        f"{client_fps[2]:.1f}")
    t_end = time.perf_counter()
    log(f"host path phase: {t_end - t_phase:.1f} s (scan {t_scan - t_phase:.1f}, "
        f"servicer legs {t_legs - t_scan:.1f}, client {t_end - t_legs:.1f}); "
        "frames/s " + ", ".join(f"{k} {v:.1f}" for k, v in fps.items()))
    return launches


# -- phase 4b: the precision tiers -------------------------------------------


def register_models(port, nets: dict, uri: str) -> None:
    """Each of ``nets`` (alias -> UNet) as the next version of the served
    model name in the registry at ``uri``, under its alias."""
    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models import weights

    name = port.ServerConfig().model_name
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    store = tracking.store_for(uri)
    with tracking.start_run():
        for alias, net in nets.items():
            version = tracking.log_model(weights.to_flax_variables(net),
                                         net.cfg, registered_model_name=name)
            store.set_alias(name, alias, version)


def precision_phase(torch, port, frames=None) -> dict:
    """The precision tiers at full width, on the calibrated
    ``ModelConfig()`` net (:func:`seeded_model`) in a temporary registry.

    That net is random, with its head bias at frame 0's median logit: an
    int8 grid moves its masks and their curvature far past the gate's
    bars (as it moves the JAX package's own fixture's), so registered as
    it is (alias "raw") its int8 servicer must refuse to come up at the
    default bars. For bf16 and int8 on it: the tier's weights made on the
    card bitwise equal to the CPU's (and the same report), and the tier's
    kernel logits within LOGITS_REL_L2 of the plain forward of the same
    net.

    Identity legs, at the default bars: the net projected onto the int8
    grid (a fixed point of the projection; alias "staging": what a model
    trained on that grid registers). ``ModelConfig()`` computes in bf16
    already and the grid net's int8 tier is the grid net, so at f32, bf16
    and int8 the servicer serves one and the same function: for each,
    ``build_service`` and ``warmup`` at 480x640 (the gate's report
    logged), then the 8 frames served TIER_PASSES times over one raw
    stream (launches per frame those of f32, statuses OK or DEGRADED,
    frames/s); then that int8 servicer with ``quant_parity_min_iou =
    1.01`` must refuse to come up.

    Legs whose tier serves another function than its reference
    (:func:`tier_leg`): int8 of the raw net, and bf16 of the raw net
    computing in float32 (alias "float32"). The default bars refuse both
    (a moved edge pixel moves a 480x640 top edge's curvature by far more
    than 0.5 1/m, in the JAX package too), so their bars sit at the
    report of the gate's comparison made apart. Returns the served legs'
    launches."""
    import copy

    from robotic_discovery_platform_tpu_torch.models.unet import (
        with_compute_dtype,
    )
    from robotic_discovery_platform_tpu_torch.ops import quant

    if frames is None:
        rng = np.random.default_rng(SEED)
        frames = [port.render_scene(rng, FRAME_H, FRAME_W)[::2]
                  for _ in range(8)]
    rgb0, _ = frames[0]
    x0 = port.preprocess(torch.from_numpy(rgb0).cuda()[None], 256)
    net = seeded_model(torch, port, x0)
    # a fixed point of the int8 projection (a second pass can move a scale
    # by one ulp), so the grid net's int8 tier is the grid net itself
    on_grid = net.state_dict()
    for _ in range(4):
        again = quant.quantize_unet_variables(on_grid)[0]
        if all(bitwise_equal(torch, again[k], v) for k, v in on_grid.items()):
            break
        on_grid = again
    else:
        raise AssertionError("the int8 projection found no fixed point")
    grid = with_compute_dtype(net, net.cfg.compute_dtype, on_grid)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_precision_"))
    uri = f"file:{tmp}/mlruns"
    register_models(port, {"raw": net, "staging": grid,
                           "float32": with_compute_dtype(net, "float32")},
                    uri)
    base = port.ServerConfig(tracking_uri=uri,
                             metrics_csv=str(tmp / "metrics.csv"),
                             calibration_path=str(tmp / "none.npz"))

    def refused(cfg, what: str) -> None:
        try:
            port.build_service(cfg, warmup_shape=(FRAME_W, FRAME_H),
                               device="cuda")
        except RuntimeError as exc:
            check("parity gate" in str(exc), f"{what}: raised {exc!r}")
            log(f"precision: {what}: refused ({exc})")
        else:
            raise AssertionError(f"{what}: the servicer came up")

    raw_card = copy.deepcopy(net).cuda()
    for tier in ("bf16", "int8"):
        tier_net, report = quant.apply_precision(raw_card, tier)
        cpu_net, cpu_report = quant.apply_precision(net, tier)
        check(report == cpu_report,
              f"{tier}: card report {report} != CPU {cpu_report}")
        state = tier_net.state_dict()
        for key, want in cpu_net.state_dict().items():
            check(bitwise_equal(torch, state[key].cpu(), want),
                  f"{tier}: {key} made on the card differs from the CPU's")
        folded = port.FoldedUNet(tier_net, device="cuda")
        with torch.no_grad():
            got, want = folded(x0), folded.forward_plain(x0)
        rel = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        check(bool(torch.isfinite(got).all()) and rel <= LOGITS_REL_L2,
              f"{tier}: kernel vs plain logits relative L2 {rel} > "
              f"{LOGITS_REL_L2}")
        log(f"precision {tier} of the calibrated net: weights made on the "
            f"card bitwise equal to the CPU's, report {report}; kernel vs "
            f"plain logits relative L2 {rel:.3g} (tol {LOGITS_REL_L2})")
    refused(dataclasses.replace(base, precision="int8", model_alias="raw"),
            "int8 of the calibrated net at the default bars")

    requests = [port.raw_request(rgb, depth, mask_format=1)
                for rgb, depth in frames] * TIER_PASSES
    n = len(requests)
    launches = dict.fromkeys(KERNELS, 0)
    rates = {}
    for tier in ("f32", "bf16", "int8"):
        t0 = time.perf_counter()
        service = port.build_service(dataclasses.replace(base, precision=tier),
                                     warmup_shape=(FRAME_W, FRAME_H),
                                     device="cuda")
        warm_s = time.perf_counter() - t0
        try:
            check(service.precision == tier,
                  f"{tier}: the servicer serves {service.precision!r}")
            check((service.parity is None) == (tier == "f32"),
                  f"{tier}: parity report {service.parity}")
            reset_launches()
            t0 = time.perf_counter()
            responses = list(service.analyze_stream(iter(requests)))
            torch.cuda.synchronize()
            stream_s = time.perf_counter() - t0
            counts = read_launches()
        finally:
            service.close()
        want = frame_launches(n, served=True)
        check(counts == want, f"{tier}: launches {counts} for {n} frames, "
              f"want {want}")
        check(all(r.status.startswith(("OK", "DEGRADED")) for r in responses),
              f"{tier}: statuses {[r.status for r in responses]}")
        launches = {k: launches[k] + counts[k] for k in launches}
        rates[tier] = n / stream_s
        log(f"precision {tier} (the grid net; identity: every tier the same "
            f"function): build_service + warmup "
            f"{warm_s:.2f} s, gate {json.dumps(service.parity)}; {n} frames "
            f"over one stream at {rates[tier]:.1f} frames/s; statuses "
            f"{sorted({r.status for r in responses})}; launches per frame "
            "as f32's")
    refused(dataclasses.replace(base, precision="int8",
                                quant_parity_min_iou=1.01),
            "int8 of the grid net with quant_parity_min_iou=1.01")
    for tier, alias in (("int8", "raw"), ("bf16", "float32")):
        counts, rates[f"{tier} of {alias}"] = tier_leg(
            torch, port, dataclasses.replace(base, precision=tier,
                                             model_alias=alias),
            frames, requests, refused)
        launches = {k: launches[k] + counts[k] for k in launches}
    log("precision tiers, frames/s over one stream (same run): "
        + ", ".join(f"{t} {r:.1f}" for t, r in rates.items()))
    return launches


def apart_report(torch, port, pristine, tier: str, n: int, camera,
                 geom_cfg=None, img_size: int = 256) -> tuple:
    """The warm-up gate's comparison made apart from a servicer: ``n``
    golden frames at 480x640 through eager analyzers of ``pristine`` and
    of its ``tier`` (``camera`` = (intrinsics, depth scale)). Returns the
    parity report, the reference's coverage per frame and the tier's
    analyzer."""
    from robotic_discovery_platform_tpu_torch.ops import quant

    k, scale = camera
    tier_net, _ = quant.apply_precision(pristine, tier)
    kw = {} if geom_cfg is None else {"geom_cfg": geom_cfg}
    analyzers = [port.make_frame_analyzer(
        port.FoldedUNet(m, device="cuda"), img_size=img_size,
        device="cuda", **kw) for m in (pristine, tier_net)]
    ref, got = ([a.eager(rgb, depth, k, scale) for rgb, depth in
                 quant.golden_frames(n, FRAME_H, FRAME_W)]
                for a in analyzers)
    coverage = [round(float(o.mask_coverage), 2) for o in ref]
    return quant.parity_report(ref, got), coverage, analyzers[1]


def trained_tier_phase(torch, port) -> dict:
    """The gate's figures for trained nets at full width: ``ModelConfig()``
    trained from a seeded init for 25 and then 50 Adam steps (lr 1e-3,
    batches of TRAIN_BATCH at 256x256, bce) on synthetic scenes; after
    each, the gate's comparison made apart (:func:`apart_report`, 8
    golden frames at 480x640, focal-length default intrinsics, depth
    scale 0.001) for int8 of the net and for bf16 of the net computing in
    float32 (``ModelConfig()`` computes in bf16: its own bf16 tier is
    itself), with the verdict at the default bars. Not run by ``main``:
    ``--phase trained_tier_phase``."""
    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.models.unet import (
        with_compute_dtype,
    )
    from robotic_discovery_platform_tpu_torch.ops import quant
    from robotic_discovery_platform_tpu_torch.training import (
        synthetic,
        trainer,
    )

    bars = port.ServerConfig()
    bars = (bars.quant_parity_min_iou, bars.quant_parity_max_curv_err)
    camera = (port.default_intrinsics(FRAME_W, FRAME_H).astype(np.float32),
              np.float32(0.001))
    xs, ys = trainer.normalize_arrays(
        *synthetic.generate_arrays(32, 256, 256, seed=SEED))
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    net = trainer.init_model(port.ModelConfig(), SEED, torch.device("cuda"))
    optimizer = trainer.make_optimizer(net, 1e-3)
    loss_fn = losses.make_loss_fn("bce")
    order = np.random.default_rng(SEED)
    results, steps = {}, 0
    for until in (25, 50):
        net.train()
        while steps < until:
            idx = torch.from_numpy(
                order.choice(len(xs), TRAIN_BATCH, replace=False)).cuda()
            loss = trainer.train_step(net, optimizer, loss_fn, xs[idx],
                                      ys[idx])
            steps += 1
        net.eval()
        check(bool(torch.isfinite(loss)), f"{steps} steps: loss {loss}")
        for tier, pristine in (("int8", net),
                               ("bf16", with_compute_dtype(net, "float32"))):
            with torch.no_grad():
                report, coverage, _ = apart_report(torch, port, pristine,
                                                   tier, 8, camera)
            passes = quant.parity_gates_pass(report, *bars)
            results[(f"trained{steps}", tier)] = dict(
                report, coverage=coverage, passes_default_bars=passes)
            log(f"trained {steps} steps (loss {float(loss):.4f}), {tier} of "
                f"the net computing in {pristine.cfg.compute_dtype}: "
                f"{json.dumps(report)}; coverage {coverage}; at the default "
                f"bars {'passes' if passes else 'refused'}")
    return results


def tier_leg(torch, port, cfg, frames, requests, refused) -> tuple:
    """A tier that serves another function than its reference, from the
    registry under ``cfg`` (a bf16 or int8 tier and a model alias).

    The gate's comparison made apart first: the golden frames at 480x640
    through eager analyzers of the registered net and of its tier (the
    servicer's camera, depth scale and geometry settings), whose report
    must show moved masks (worst IoU below 1) on non-trivial ones (0 <
    coverage < 100 on at least two frames). Then ``build_service`` and
    ``warmup`` with the bars at that report: the servicer must come up,
    keep that very report, serve ``requests`` with f32's launches per
    frame and, for ``frames``, the tier net's masks byte for byte. Last,
    a floor a hair above that mean IoU must refuse to come up. Returns
    (launches, frames/s over one stream)."""
    from robotic_discovery_platform_tpu_torch.ops import quant

    probe = port.build_service(cfg, device="cuda")
    try:
        k = probe._camera(FRAME_W, FRAME_H)
        scale = np.float32(probe.depth_scale)
        geom_cfg, pristine = probe.geom_cfg, probe._pristine
    finally:
        probe.close()
    want, coverage, tier_analyze = apart_report(
        torch, port, pristine, cfg.precision, cfg.quant_parity_frames,
        (k, scale), geom_cfg, cfg.model_img_size)
    what = f"{cfg.precision} of {cfg.model_alias!r}"
    check(want["mask_iou_min"] < 1.0
          and sum(0 < c < 100 for c in coverage) >= 2,
          f"{what}: the tier does not move non-trivial masks: {want}, "
          f"coverage {coverage}")
    bars = dict(quant_parity_min_iou=want["mask_iou_mean"],
                quant_parity_max_curv_err=want["curvature_err_max"])
    t0 = time.perf_counter()
    service = port.build_service(dataclasses.replace(cfg, **bars),
                                 warmup_shape=(FRAME_W, FRAME_H),
                                 device="cuda")
    warm_s = time.perf_counter() - t0
    try:
        check(service.precision == cfg.precision and service.parity == want,
              f"{what}: serves {service.precision!r} with gate report "
              f"{service.parity}, want {want}")
        reset_launches()
        t0 = time.perf_counter()
        responses = list(service.analyze_stream(iter(requests)))
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        counts = read_launches()
    finally:
        service.close()
    n = len(requests)
    want_launches = frame_launches(n, served=True)
    check(counts == want_launches, f"{what}: launches {counts} for {n} "
          f"frames, want {want_launches}")
    check(all(r.status.startswith(("OK", "DEGRADED")) for r in responses),
          f"{what}: statuses {[r.status for r in responses]}")
    for i, ((rgb, depth), r) in enumerate(zip(frames, responses)):
        mask = tier_analyze.eager(rgb, depth, k, scale).mask.cpu().numpy()
        check(np.array_equal(port.decode_mask_wire(r.mask), mask),
              f"{what}: frame {i}'s served mask is not the tier net's")
    rate = n / stream_s
    log(f"precision {what} (another function than its reference): gate "
        f"made apart {json.dumps(want)}, golden coverage {coverage}; "
        f"build_service + warmup {warm_s:.2f} s with the bars at that "
        f"report, the servicer's report equal to it; {n} frames over one "
        f"stream at {rate:.1f} frames/s, the tier net's masks, launches per "
        "frame as f32's")
    bars["quant_parity_min_iou"] += 1e-9
    refused(dataclasses.replace(cfg, **bars),
            f"{what} with the IoU floor 1e-9 above its report")
    return counts, rate


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


# -- phase 6: training ------------------------------------------------------


def rel_l2(torch, got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def timed(torch, kernel, plain, library, flops: float, nbytes: float,
          err: float, plain_iters: int = 20) -> dict:
    t = {"ms": time_ms(torch, kernel),
         "plain_ms": time_ms(torch, plain, iters=plain_iters),
         "library_ms": time_ms(torch, library), "max_abs_err": err}
    t["bound_ms"], t["bound_by"] = bound_ms(flops, nbytes)
    return t


def train_kernel_phase(torch, conv) -> dict:
    """The training conv's kernels against their plain versions at the 18
    training shapes at B = 4 in bfloat16, as the default model trains:
    the weight gradient (relative L2 within DW_REL_L2, also in float32 at
    two small ragged shapes), and ``conv3x3``'s forward and dx (the conv
    kernel with a unit epilogue; dx on the flipped, transposed kernel)
    within BF16_TOL, its dw the weight-gradient kernel's, rounded to
    bfloat16. Times per launch: the kernel, its plain version and one
    cuDNN call on the same operands (``F.conv2d``; the weight gradient's
    ``torch.nn.grad.conv2d_weight``), TF32 off."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    results = {}
    for b, h, w, cin, cout in [(2, 37, 53, 40, 24), (1, 9, 11, 3, 5)]:
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda")
        g = torch.randn(b, h, w, cout, generator=gen, device="cuda")
        err = rel_l2(torch, conv.conv3x3_grad_weights(x, g),
                     conv.conv3x3_grad_weights_plain(x, g))
        check(err <= DW_REL_L2, f"conv3x3_grad_weights {(b, h, w, cin, cout)}"
              f" float32: relative L2 {err} > {DW_REL_L2}")
        log(f"conv3x3_grad_weights [{b},{h},{w},{cin}]x[..,{cout}] float32: "
            f"relative L2 {err:.3g} (bar {DW_REL_L2})")

    measured = train_conv_shapes(
        torch, conv, sorted(set(MAIN_PATH_3X3), key=MAIN_PATH_3X3.index), gen)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    sums = {k: dict.fromkeys(keys, 0.0) for k in ("dw", "fwd", "dx")}
    for i, shape in enumerate(MAIN_PATH_3X3):
        results[("conv3x3_grad_weights", *shape)] = measured[shape]["dw"]
        for k, t in measured[shape].items():
            if k == "dx" and i == 0:
                continue  # the image input takes no gradient
            for f in keys:
                if not (k == "fwd" and f == "plain_ms"
                        and shape == SLOW_PLAIN_FWD):
                    sums[k][f] += t[f]
    n_slow = MAIN_PATH_3X3.count(SLOW_PLAIN_FWD)
    for k, n in (("dw", 18), ("fwd", 18), ("dx", 17)):
        apart = f" (plain_ms over the other {n - n_slow})" if k == "fwd" else ""
        log(f"train conv {k}, the {n} launches of one step at B = "
            f"{TRAIN_BATCH}{apart}: " + ", ".join(
                f"{f} {v:.3f}" for f, v in sums[k].items()))
    h, cin, cout = SLOW_PLAIN_FWD
    slow = measured[SLOW_PLAIN_FWD]["fwd"]["plain_ms"]
    log(f"train conv fwd plain at [{TRAIN_BATCH},{h},{h},{cin}]->{cout}, "
        f"apart from the sum: {slow:.3f} ms x {n_slow} per step (F.conv2d in "
        "float32, TF32 off)")
    return results


def train_conv_shapes(torch, conv, shapes, gen) -> dict:
    """The training conv's kernels at each (H = W, Cin, Cout) of
    ``shapes`` at B = TRAIN_BATCH in bfloat16 (train_kernel_phase's bars
    and times); returns {shape: {"dw", "fwd", "dx": times}}."""
    F = torch.nn.functional
    b, bf = TRAIN_BATCH, torch.bfloat16
    measured = {}
    for s, cin, cout in shapes:
        x = torch.randn(b, s, s, cin, generator=gen, device="cuda").to(bf)
        g = torch.randn(b, s, s, cout, generator=gen, device="cuda").to(bf)
        w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda")
             / (9 * cin) ** 0.5).to(bf)
        dw = conv.conv3x3_grad_weights(x, g)
        dw_plain = conv.conv3x3_grad_weights_plain(x, g)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = conv.conv3x3(xg, wg, "auto")
        y.backward(g)
        unit_o = (torch.ones(cout, device="cuda"),
                  torch.zeros(cout, device="cuda"))
        unit_i = (torch.ones(cin, device="cuda"),
                  torch.zeros(cin, device="cuda"))
        w_flip = w.flip(0, 1).transpose(2, 3).contiguous()
        y_plain = conv.conv3x3_bn_relu_plain(x, w, *unit_o, relu=False)
        dx_plain = conv.conv3x3_bn_relu_plain(g, w_flip, *unit_i, relu=False)
        torch.cuda.synchronize()
        err = rel_l2(torch, dw, dw_plain)
        check(err <= DW_REL_L2, f"conv3x3_grad_weights {(b, s, s, cin, cout)}:"
              f" relative L2 {err} > {DW_REL_L2}")
        check(torch.equal(wg.grad, dw.to(bf)),
              f"conv3x3 {(s, cin, cout)}: dw is not the kernel's, rounded")
        again = {
            "dw": conv.conv3x3_grad_weights(x, g),
            "y": conv.conv3x3_bn_relu(x, w, *unit_o, relu=False),
            "dx": conv.conv3x3_bn_relu(g, w_flip, *unit_i, relu=False),
        }
        for name, first in (("dw", dw), ("y", y.detach()), ("dx", xg.grad)):
            check(torch.equal(again[name], first),
                  f"conv3x3 {(b, s, s, cin, cout)} {name}: two calls on the "
                  "same operands differ")
        errs = {}
        for name, got, want in (("y", y.detach(), y_plain),
                                ("dx", xg.grad, dx_plain)):
            errs[name] = float((got.float() - want.float()).abs().max())
            check(torch.allclose(got.float(), want.float(), atol=BF16_TOL,
                                 rtol=BF16_TOL),
                  f"conv3x3 {(b, s, s, cin, cout)} {name}: max |err| "
                  f"{errs[name]} over tolerance {BF16_TOL}")
        costs = flops_lib().train_conv_costs(b, s, cin, cout)
        flops = costs["fwd"][0]
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        wc, wfc = (t.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for t in (w, w_flip))
        m = measured[(s, cin, cout)] = {
            "dw": timed(
                torch, lambda: conv.conv3x3_grad_weights(x, g),
                lambda: conv.conv3x3_grad_weights_plain(x, g),
                lambda: torch.nn.grad.conv2d_weight(xc, (cout, cin, 3, 3), gc,
                                                    padding=1),
                *costs["dw"], float((dw - dw_plain).abs().max()),
                plain_iters=5),
            "fwd": timed(
                torch, lambda: conv.conv3x3_bn_relu(x, w, *unit_o,
                                                    relu=False),
                lambda: conv.conv3x3_bn_relu_plain(x, w, *unit_o, relu=False),
                lambda: F.conv2d(xc, wc, padding=1), *costs["fwd"],
                errs["y"]),
            "dx": timed(
                torch, lambda: conv.conv3x3_bn_relu(g, w_flip, *unit_i,
                                                    relu=False),
                lambda: conv.conv3x3_bn_relu_plain(g, w_flip, *unit_i,
                                                   relu=False),
                lambda: F.conv2d(gc, wfc, padding=1), *costs["dx"],
                errs["dx"]),
        }
        m["dw"]["rel_l2"] = err
        log(f"train conv [{b},{s},{s},{cin}]->{cout} bf16: " + "; ".join(
            f"{k} ms {t['ms']:.4f} plain {t['plain_ms']:.4f} cudnn "
            f"{t['library_ms']:.4f} bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}) {rate_text(flops, t)}"
            for k, t in m.items())
            + f"; dw rel L2 {err:.3g} (bar {DW_REL_L2}), y max|err| "
            f"{errs['y']:.3g}, dx max|err| {errs['dx']:.3g} (tol {BF16_TOL});"
            f" each deterministic; K splits dw "
            f"{conv.dw_splits(b, s, s, cin, cout)}, forward "
            f"{conv.fwd_plan(b, s, s, cin, cout)[0]}, dx "
            f"{conv.fwd_plan(b, s, s, cout, cin)[0]}")
        del x, g, w, xg, wg, y, dw, dw_plain, y_plain, dx_plain, again
    return measured


def conv3x3_f64(x, w):
    """The plain training conv with float64 sums (one rounding to x's
    dtype): the most exact reference of a step's gradients."""
    import torch

    wf = w.to(x.dtype).to(torch.float64).permute(3, 2, 0, 1)
    y = torch.nn.functional.conv2d(x.to(torch.float64).permute(0, 3, 1, 2),
                                   wf, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def step_grads(torch, cfg, impl, x, y, loss_fn, f64_sums=False):
    """(loss, gradients, launches) of one training forward and backward
    from the seeded initial weights; ``f64_sums`` swaps the plain conv
    for :func:`conv3x3_f64`."""
    from robotic_discovery_platform_tpu_torch.models import unet
    from robotic_discovery_platform_tpu_torch.training import trainer

    net = trainer.init_model(dataclasses.replace(cfg, conv_impl=impl), SEED,
                             torch.device("cuda"))
    plain = unet.conv3x3_plain
    if f64_sums:
        unet.conv3x3_plain = conv3x3_f64
    try:
        reset_launches()
        loss = loss_fn(net(x, train=True), y)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        unet.conv3x3_plain = plain
    grads = torch.cat([p.grad.flatten() for p in net.parameters()])
    per = {k: p.grad for k, p in net.named_parameters()}
    return float(loss.detach()), grads, per, read_launches(), net


def step_phase(torch, port) -> dict:
    """One reference train step (B = 4 at 256x256, bce) on the kernels
    (conv_impl="auto") against plain torch convs (conv_impl="flax") from
    the same weights and batch: in float32 compute within GRAD_REL_L2;
    in bfloat16 (the reference configuration) beside the float64-sum
    step, within BF16_GRAD_RATIO of the plain step's distance to it.
    Then exact launches per train step and per eval step, the step's
    time, device-time split and busy share, and peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.training import (
        synthetic,
        trainer,
    )

    cfg = port.ModelConfig()
    check(cfg.conv_impl == "auto" and cfg.base_features == 64
          and cfg.compute_dtype == "bfloat16",
          f"the reference configuration changed: {cfg}")
    imgs, masks = synthetic.generate_arrays(TRAIN_BATCH, 256, 256, seed=SEED)
    xs, ys = trainer.normalize_arrays(imgs, masks)
    x, y = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    loss_fn = losses.make_loss_fn("bce")
    zero = {k: 0 for k in read_launches()}
    step_want = dict(zero, conv3x3_bn_relu=18 + 17, conv3x3_grad_weights=18)

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    loss_k, g_k, _, counts, _ = step_grads(torch, f32, "auto", x, y, loss_fn)
    check(counts == step_want, f"float32 step launches {counts}")
    loss_p, g_p, _, counts, _ = step_grads(torch, f32, "flax", x, y, loss_fn)
    check(counts == zero, f"plain step launched {counts}")
    total = rel_l2(torch, g_k, g_p)
    check(abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p),
          f"float32 step loss kernels {loss_k} vs plain {loss_p}")
    check(total <= GRAD_REL_L2, f"float32 step gradients, kernels vs plain: "
          f"relative L2 {total} > {GRAD_REL_L2}")
    log(f"train step in float32, kernels vs plain convs: loss {loss_k:.7f} vs "
        f"{loss_p:.7f}; gradients relative L2 {total:.3g} (bar {GRAD_REL_L2})")

    loss_k, g_k, per_k, counts, net = step_grads(torch, cfg, "auto", x, y,
                                                 loss_fn)
    check(counts == step_want, f"bfloat16 step launches {counts}, want "
          f"{step_want}")
    loss_p, g_p, per_p, _, _ = step_grads(torch, cfg, "flax", x, y, loss_fn)
    loss_e, g_e, _, _, _ = step_grads(torch, cfg, "flax", x, y, loss_fn,
                                      f64_sums=True)
    kp, ke, pe = (rel_l2(torch, g_k, g_p), rel_l2(torch, g_k, g_e),
                  rel_l2(torch, g_p, g_e))
    check(abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p),
          f"bfloat16 step loss kernels {loss_k} vs plain {loss_p}")
    check(ke <= BF16_GRAD_RATIO * pe, f"bfloat16 step: the kernels' gradients "
          f"lie {ke} from the float64-sum step's, beyond {BF16_GRAD_RATIO} x "
          f"the plain step's {pe}")
    log(f"train step in bfloat16 (the reference): loss kernels {loss_k:.6f}, "
        f"plain {loss_p:.6f}, float64 sums {loss_e:.6f}; gradients relative "
        f"L2 kernels-plain {kp:.3g}, kernels-float64 {ke:.3g}, plain-float64 "
        f"{pe:.3g} (bar: kernels-float64 <= {BF16_GRAD_RATIO} x "
        f"plain-float64); per tensor, kernels vs plain: " + ", ".join(
            f"{k} {rel_l2(torch, per_k[k], per_p[k]):.3g}" for k in per_p
            if per_p[k].abs().max() > 0))
    del g_k, g_p, g_e, per_k, per_p, _
    torch.cuda.empty_cache()

    opt = trainer.make_optimizer(net, 1e-4)
    reset_launches()
    trainer.train_step(net, opt, loss_fn, x, y)
    torch.cuda.synchronize()
    counts = read_launches()
    check(counts == step_want, f"train_step launches {counts}, want "
          f"{step_want}")
    reset_launches()
    trainer.eval_step(net, loss_fn, x, y)
    torch.cuda.synchronize()
    check(read_launches() == zero, f"eval_step launched {read_launches()}")

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    step_ms = []
    for _ in range(5):
        start.record()
        trainer.train_step(net, opt, loss_fn, x, y)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()

    def device_ms_of(fn) -> tuple:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return sum(r[0] for r in device_rows(prof)), wall, result

    opt.zero_grad(set_to_none=True)
    fwd, _, loss = device_ms_of(lambda: loss_fn(net(x, train=True), y))
    bwd, _, _ = device_ms_of(loss.backward)
    upd, _, _ = device_ms_of(opt.step)
    dev, wall, _ = device_ms_of(
        lambda: trainer.train_step(net, opt, loss_fn, x, y))
    log(f"train step (B = {TRAIN_BATCH}, 256x256, bf16): ms per step (CUDA "
        f"events) {' '.join(f'{v:.2f}' for v in step_ms)}; device time "
        f"forward+loss {fwd:.2f} ms, backward {bwd:.2f} ms, optimizer "
        f"{upd:.2f} ms (profiler, one step each); one step under the "
        f"profiler: host wall {wall:.2f} ms, device {dev:.2f} ms (device "
        f"busy {100 * dev / wall:.1f}%); peak memory {peak / 2**20:.0f} MiB")
    return {"step_ms": step_ms, "split": (fwd, bwd, upd), "busy": dev / wall}


def train_serve_phase(torch, port, frames, model_cfg=None,
                      epochs: int = 2) -> dict:
    """``train_model`` on synthetic data for ``epochs`` epochs into a
    temporary registry (at the reference configuration, or ``model_cfg``
    with the reference's training settings; over two or more epochs the
    train loss must fall), then a server built from the registry's staging
    version serving 4 frames; returns the launches of the two legs."""
    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.analysis import recompile
    from robotic_discovery_platform_tpu_torch.training import (
        checkpoint,
        synthetic,
        trainer,
    )

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    cfg = port.TrainConfig(epochs=epochs, batch_size=TRAIN_BATCH,
                           img_size=256, learning_rate=1e-4, loss="bce",
                           seed=SEED, tracking_uri=f"file:{tmp}/mlruns",
                           checkpoint_dir=str(tmp / "ckpt"))
    model_cfg = port.ModelConfig() if model_cfg is None else model_cfg
    arrays = synthetic.generate_arrays(TRAIN_SAMPLES, 256, 256, seed=SEED)
    guards = {name: len(recompile.stats_for(name))
              for name in ("trainer.train_epoch", "trainer.eval_epoch")}
    reset_launches()
    t0 = time.perf_counter()
    res = trainer.train_model(cfg, model_cfg, arrays=arrays, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    captures = {name: [s.traces for s in recompile.stats_for(name)[n:]]
                for name, n in guards.items()}
    check(cfg.epoch_mode == "auto" and captures["trainer.train_epoch"] == [1],
          f"train_model did not take the scan epoch's one captured step: "
          f"captures {captures}")
    steps = cfg.epochs * 4
    want = {k: 0 for k in train_launches}
    want.update(conv3x3_bn_relu=35 * steps, conv3x3_grad_weights=18 * steps)
    check(train_launches == want, f"train_model launches {train_launches}, "
          f"want {want} for {steps} steps")
    store = tracking.store_for(cfg.tracking_uri)
    hist = {k: [h["value"] for h in store.get_metric_history(res.run_id, k)]
            for k in ("train_loss", "val_loss", "val_miou")}
    check(all(np.isfinite(v) for vs in hist.values() for v in vs)
          and len(hist["train_loss"]) == epochs,
          f"train_model metrics not finite: {hist}")
    check(epochs < 2 or hist["train_loss"][-1] < hist["train_loss"][0],
          f"train loss did not fall: {hist['train_loss']}")
    check(res.registry_version == 1,
          f"registered version {res.registry_version}, want 1")
    log(f"train_model ({'bilinear' if model_cfg.bilinear else 'non-bilinear'}"
        f"): {TRAIN_SAMPLES} samples, {epochs} epochs x 4 steps in "
        f"{train_s:.1f} s (epochs {' '.join(f'{v:.2f}' for v in res.epoch_seconds)}"
        f" s, checkpoint IO excluded); train loss {hist['train_loss']}, val "
        f"loss {hist['val_loss']}, val mIoU {hist['val_miou']}; launches "
        f"{train_launches}; scan epoch captures {captures} (train, eval); "
        f"registered version {res.registry_version}")

    store.set_alias(cfg.registered_model_name, "staging", 1)
    best = checkpoint.CheckpointManager(cfg.checkpoint_dir).restore()["best"]
    net = port.UNet(model_cfg)
    net.load_state_dict(best)
    folded = port.FoldedUNet(net, device="cuda")
    direct = port.make_frame_analyzer(folded, img_size=256, device="cuda")
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    frames = frames[:4]
    want_masks = [direct(rgb, depth, k, 0.001).mask.cpu().numpy()
                  for rgb, depth in frames]
    scfg = port.ServerConfig(address="localhost:0",
                             tracking_uri=cfg.tracking_uri,
                             metrics_csv=str(tmp / "metrics.csv"),
                             calibration_path=str(tmp / "none.npz"))
    # the registered artifact carries the best variables exactly
    from robotic_discovery_platform_tpu_torch.serving import server

    _, registered, version = server.resolve_serving_model(scfg,
                                                          device="cuda")
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    with torch.no_grad():
        same = torch.equal(port.FoldedUNet(registered, device="cuda")(x0),
                           folded(x0))
    check(version == 1 and same, f"registry version {version}: logits "
          "differ from the FoldedUNet of the best variables")
    requests = [port.raw_request(rgb, depth) for rgb, depth in frames]
    reset_launches()
    try:
        import grpc

        from robotic_discovery_platform_tpu_torch.serving import grpc_service
        from robotic_discovery_platform_tpu_torch.serving.proto import (
            vision_grpc,
            vision_pb2,
        )
    except ImportError as exc:
        service = server.build_service(scfg, device="cuda")
        responses = list(service.analyze_stream(iter(requests)))
        leg = f"in process (no grpc: {exc})"
    else:
        srv, service = grpc_service.build_server(scfg, device="cuda")
        srv.start()
        try:
            with grpc.insecure_channel(
                    f"localhost:{service.bound_port}") as channel:
                stub = vision_grpc.VisionAnalysisServiceStub(channel)
                responses = list(stub.AnalyzeActuatorPerformance(iter([
                    vision_pb2.AnalysisRequest(
                        color_image=vision_pb2.Image(
                            data=r.color_image.data, width=FRAME_W,
                            height=FRAME_H, format=1),
                        depth_image=vision_pb2.Image(
                            data=r.depth_image.data, width=FRAME_W,
                            height=FRAME_H, format=1))
                    for r in requests])))
        finally:
            srv.stop(grace=None).wait()
        leg = "over gRPC"
    torch.cuda.synchronize()
    serve_launches = read_launches()
    service.close()
    n = len(frames)
    # the server is not warmed: its first frame is answered by the
    # graph's warm-up run, captured right after, so it launches one
    # frame's kernels like every later, replayed frame
    want = frame_launches(n, convt=not model_cfg.bilinear, served=True)
    check(serve_launches == want, f"registry-served launches "
          f"{serve_launches}, want {want}")
    check(service.model_version == 1,
          f"server runs version {service.model_version}, want 1 (staging)")
    for i, (resp, mask) in enumerate(zip(responses, want_masks)):
        check(resp.status.startswith(("OK", "DEGRADED")),
              f"registry-served frame {i}: status {resp.status!r}")
        got = (decode_png(resp.mask) > 0).astype(np.uint8)
        check(np.array_equal(got, mask), f"registry-served frame {i}: mask "
              "differs from the FoldedUNet of the best variables")
    log(f"registry-served leg ({leg}): models:/{scfg.model_name}@"
        f"{scfg.model_alias} -> version {service.model_version}; {n} frames,"
        f" statuses {[r.status for r in responses]}, masks equal to the "
        f"direct FoldedUNet's (coverage "
        f"{[round(float(r.mask_coverage), 2) for r in responses]}); "
        f"launches {serve_launches} (the first frame the warm-up run, "
        "the rest replays)")
    return {k: train_launches[k] + serve_launches[k] for k in want}


# -- phase 7: the coefficient lane -------------------------------------------


def dct_matrix() -> np.ndarray:
    """[8, 8] orthonormal DCT-II (rows are frequencies): ``D @ B @ D.T`` is
    the JPEG forward DCT of an 8x8 block B (ITU-T T.81 A.3.3)."""
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    d[0] /= np.sqrt(2.0)
    return d


def encode_coefficients(entropy, rgb: np.ndarray, qy: np.ndarray,
                        qc: np.ndarray):
    """A JPEG encoder's forward half in numpy (the card's machine has no
    cv2): RGB -> JFIF YCbCr, 4:2:0 chroma by 2x2 averaging, each plane
    padded to the MCU grid by edge replication, level-shifted by -128,
    a float DCT-II per 8x8 block, quantized by rounding against ``qy`` /
    ``qc`` (natural order) -> a 4:2:0 ``CoefficientFrame``."""
    h, w, _ = rgb.shape
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def halve(p):
        p = np.pad(p, ((0, p.shape[0] % 2), (0, p.shape[1] % 2)), mode="edge")
        return p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean((1, 3))

    d = dct_matrix()
    (ybh, ybw), (cbh, cbw) = entropy.block_grids(h, w, "420")

    def blocks(p, bh, bw, q):
        p = np.pad(p, ((0, 8 * bh - p.shape[0]), (0, 8 * bw - p.shape[1])),
                   mode="edge")
        t = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
        c = np.einsum("uy,nmyx,vx->nmuv", d, t, d).reshape(bh * bw, 64)
        return np.clip(np.round(c / q.astype(np.float64)), -2047,
                       2047).astype(np.int16)

    return entropy.CoefficientFrame(
        height=h, width=w, subsampling="420",
        y=blocks(y, ybh, ybw, qy), cb=blocks(halve(cb), cbh, cbw, qc),
        cr=blocks(halve(cr), cbh, cbw, qc), qy=qy, qc=qc)


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse)) if mse else float("inf")


def luma(rgb: np.ndarray) -> np.ndarray:
    """JFIF Y of an RGB frame, float64."""
    return rgb.astype(np.float64) @ np.array([0.299, 0.587, 0.114])


def same_responses(got, want, leg: str, exact: bool = True) -> None:
    """Two response lists: status, mask bytes and coverage byte-equal, and
    the curvature and spline byte-equal (``exact``) or the curvature
    within GEOM_RTOL."""
    check(len(got) == len(want), f"{leg}: {len(got)} responses for "
          f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.status == b.status and a.mask == b.mask
              and a.mask_coverage == b.mask_coverage,
              f"{leg} frame {i}: status, mask bytes or coverage differ "
              f"({a.status!r} vs {b.status!r})")
        if exact:
            check((a.mean_curvature, a.max_curvature, a.packed_spline,
                   [(p.x, p.y, p.z) for p in a.spline_points]) == (
                       b.mean_curvature, b.max_curvature, b.packed_spline,
                       [(p.x, p.y, p.z) for p in b.spline_points]),
                  f"{leg} frame {i}: curvature or spline differ")
        else:
            check(np.allclose([a.mean_curvature, a.max_curvature],
                              [b.mean_curvature, b.max_curvature],
                              rtol=GEOM_RTOL, atol=0),
                  f"{leg} frame {i}: curvature {a.mean_curvature} vs "
                  f"{b.mean_curvature} beyond rtol {GEOM_RTOL}")


def wire_requests(requests: list) -> list:
    """The port's request messages as the protobuf the gRPC stub sends."""
    from robotic_discovery_platform_tpu_torch.serving.proto import vision_pb2

    def image(img):
        return vision_pb2.Image(data=img.data, width=img.width,
                                height=img.height, format=img.format)

    return [vision_pb2.AnalysisRequest(color_image=image(r.color_image),
                                       depth_image=image(r.depth_image),
                                       mask_format=r.mask_format)
            for r in requests]


def grpc_responses(cfg, folded, requests) -> list | None:
    """``requests`` through a real gRPC server of the port (None where
    grpc is not installed)."""
    try:
        import grpc

        from robotic_discovery_platform_tpu_torch.serving import grpc_service
        from robotic_discovery_platform_tpu_torch.serving.proto import (
            vision_grpc,
        )
    except ImportError as exc:
        log(f"gRPC leg did not run: {exc}")
        return None

    server, servicer = grpc_service.build_server(cfg, folded, device="cuda")
    server.start()
    try:
        with grpc.insecure_channel(
                f"localhost:{servicer.bound_port}") as channel:
            stub = vision_grpc.VisionAnalysisServiceStub(channel)
            return list(stub.AnalyzeActuatorPerformance(iter(
                wire_requests(requests))))
    finally:
        server.stop(grace=None).wait()
        servicer.close()


def coef_phase(torch, port, folded, frames) -> dict:
    """The coefficient lane on the default model: frames encoded by
    :func:`encode_coefficients` at COEF_QUALITY (its CPU plain decode within
    COEF_PSNR_DB of the source) and sent through the wire payload; the
    card's decode against the CPU plain decode, bitwise; the direct
    coefficient analyzer's exact launches (3 dequant_idct + 18 + 1 + 3
    geometry per frame); then format-2 requests served directly, over
    gRPC and under STREAMS concurrent streams batched, against the
    format-1 responses of the CPU-decoded pixels. Returns the launches of
    the serving legs."""
    from robotic_discovery_platform_tpu_torch.ops import pipeline
    from robotic_discovery_platform_tpu_torch.serving import entropy, ingest

    qy, qc = ingest.quant_tables(COEF_QUALITY)
    coefs = [entropy.unpack_coefficients(entropy.pack_coefficients(
        encode_coefficients(entropy, rgb, qy, qc))) for rgb, _ in frames]
    geometry = dict(height=FRAME_H, width=FRAME_W, subsampling="420")
    decoded, psnr, psnr_rgb = [], [], []
    for cf, (rgb, _) in zip(coefs, frames):
        decoded.append(pipeline.decode_coef_batch(
            *pipeline.coef_planes(cf), **geometry)[0].numpy())
        psnr.append(psnr_db(luma(decoded[-1]), luma(rgb)))
        psnr_rgb.append(psnr_db(decoded[-1], rgb))
    check(min(psnr) >= COEF_PSNR_DB, f"encoder sanity: luma PSNR {psnr} dB "
          f"below {COEF_PSNR_DB}")
    planes = [torch.cat(p).cuda() for p in zip(*(pipeline.coef_planes(cf)
                                                  for cf in coefs))]
    reset_launches()
    card = pipeline.decode_coef_batch(*planes, **geometry)
    torch.cuda.synchronize()
    check(read_launches() == launches_of(dequant_idct=3),
          f"decode_coef_batch launches {read_launches()}")
    check(np.array_equal(card.cpu().numpy(), np.stack(decoded)),
          "decode_coef_batch: the card's RGB differs from the CPU plain "
          "decode")
    n = len(frames)
    decode_ms = time_ms(torch, lambda: pipeline.decode_coef_batch(
        *planes, **geometry), iters=10) / n
    log(f"coefficient frames: {n} at quality {COEF_QUALITY}, "
        f"{len(entropy.pack_coefficients(coefs[0]))} payload bytes each; "
        f"CPU plain decode luma PSNR {min(psnr):.2f}-{max(psnr):.2f} dB "
        f"against the source (bar {COEF_PSNR_DB}; RGB "
        f"{min(psnr_rgb):.2f}-{max(psnr_rgb):.2f}); card decode of [{n}] bitwise "
        f"equal to the CPU's, {decode_ms:.4f} ms per frame (CUDA events)")

    k = port.default_intrinsics(FRAME_W, FRAME_H)
    analyze = pipeline.make_coef_frame_analyzer(folded, img_size=256,
                                                device="cuda")
    pixels = port.make_frame_analyzer(folded, img_size=256, device="cuda")
    analyze(coefs[0], frames[0][1], k, 0.001)
    torch.cuda.synchronize()
    reset_launches()
    outs = [analyze(cf, depth, k, 0.001)
            for cf, (_, depth) in zip(coefs, frames)]
    torch.cuda.synchronize()
    counts = read_launches()
    check(counts == frame_launches(n, coef=True),
          f"coefficient analyzer launches {counts} for {n} frames")
    for i, (out, rgb, (_, depth)) in enumerate(zip(outs, decoded, frames)):
        check(torch.equal(out.mask, pixels(rgb, depth, k, 0.001).mask),
              f"coefficient frame {i}: mask differs from the pixel "
              "analyzer's on the decoded pixels")
    log(f"coefficient analyzer: {n} frames, launches {counts} (3 + 18 + 1 + "
        "3 per frame), masks equal to the pixel analyzer's on the decoded "
        "pixels")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_coef_"))
    cfg = port.ServerConfig(address="localhost:0",
                            metrics_csv=str(tmp / "metrics.csv"),
                            calibration_path=str(tmp / "none.npz"))
    service = port.VisionAnalysisService(folded, cfg=cfg, device="cuda")
    service.warmup(FRAME_W, FRAME_H)
    service.warmup_coef(FRAME_W, FRAME_H)
    raw = [port.raw_request(rgb, depth, mask_format=i % 3)
           for i, (rgb, (_, depth)) in enumerate(zip(decoded, frames))]
    coef = [ingest.coef_request(cf, depth, mask_format=i % 3)
            for i, (cf, (_, depth)) in enumerate(zip(coefs, frames))]
    walls = {}
    for lane, requests in (("raw", raw), ("coef", coef), ("raw", raw),
                           ("coef", coef)):
        reset_launches()
        t0 = time.perf_counter()
        out = list(service.analyze_stream(iter(requests)))
        walls.setdefault(lane, []).append((time.perf_counter() - t0) * 1e3 / n)
        if lane == "raw":
            want = out
        else:
            got, launches = out, read_launches()
    check(launches == frame_launches(n, coef=True, served=True),
          f"served coefficient launches {launches}")
    same_responses(got, want, "format 2, direct")
    log(f"format-2 requests, direct: {n} responses byte-equal to the format-1 "
        f"responses of the decoded pixels; ms per frame over a stream (two "
        f"runs each) raw {' '.join(f'{v:.2f}' for v in walls['raw'])}, "
        f"coefficient {' '.join(f'{v:.2f}' for v in walls['coef'])}; "
        f"proc_time_ms median raw {np.median([r.proc_time_ms for r in want]):.2f}"
        f", coefficient {np.median([r.proc_time_ms for r in got]):.2f}")
    service.close()
    over_grpc = grpc_responses(cfg, folded, coef)
    if over_grpc is not None:
        same_responses(over_grpc, want, "format 2, gRPC")
        log(f"format-2 requests over gRPC: {len(over_grpc)} responses "
            "byte-equal to the format-1 responses")

    bcfg = dataclasses.replace(cfg, metrics_csv=str(tmp / "batched.csv"),
                               batch_window_ms=2.0, max_batch=MAX_BATCH)
    batched = port.VisionAnalysisService(folded, cfg=bcfg, device="cuda")
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    batched.warmup(FRAME_W, FRAME_H)
    batched.warmup_coef(FRAME_W, FRAME_H)
    reserved = torch.cuda.memory_reserved() - reserved
    log(f"batched servicer graphs at {FRAME_H}x{FRAME_W}, buckets "
        f"{batched._buckets()}, both lanes: "
        f"{sum(len(a.graphs.graphs) for a in batch_analyzers(batched))} "
        f"graphs, reserved memory +{reserved / 2**20:.0f} MiB")
    orders = [[(s * 2 + j) % n for j in range(n)] for s in range(STREAMS)]
    batched.dispatcher.dispatch_sizes.clear()
    reset_launches()
    out, wall_s = concurrent_streams(
        batched, [[coef[i] for i in order] for order in orders])
    blaunches = read_launches()
    sizes = dict(sorted(batched.dispatcher.dispatch_sizes.items()))
    dispatches = sum(sizes.values())
    check(blaunches == frame_launches(0, coef=True, dispatches=dispatches,
                                      ones=sizes.get(1, 0)),
          f"batched coefficient launches {blaunches} for dispatch sizes "
          f"{sizes}")
    for order, responses in zip(orders, out):
        same_responses(responses, [want[i] for i in order],
                       "format 2, batched", exact=False)
    batched.close()
    log(f"format-2 requests batched (batch_window_ms=2), {STREAMS} streams x "
        f"{n} frames: dispatch sizes {sizes}, {STREAMS * n / wall_s:.1f} "
        f"frames/s aggregate; launches {blaunches}; status, mask bytes and "
        f"coverage equal to the format-1 responses, curvature within rtol "
        f"{GEOM_RTOL}")
    return {k: launches[k] + blaunches[k] for k in launches}


# -- phase 8: the non-bilinear model --------------------------------------------


def nonbilinear_phase(torch, port, conv, frames) -> dict:
    """``ModelConfig(bilinear=False)`` at full width from a seed
    (BatchNorm calibrated as ``seeded_model`` does): the folded kernel
    forward against ``forward_plain``; the analyzer's exact launches (18
    conv3x3_bn_relu + 4 conv_transpose2x2 + 1 conv1x1 + 3 geometry per
    frame); 8 frames served directly and batched, masks equal to the
    analyzer's; the training conv's kernels at the ladder's new shapes;
    one train step at B = 4 (18 + 17 conv3x3_bn_relu, 18
    conv3x3_grad_weights, no conv_transpose2x2: training runs the plain
    transposed conv). Returns the serving legs' launches."""
    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.training import (
        synthetic,
        trainer,
    )

    cfg = port.ModelConfig(bilinear=False)
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    folded = port.FoldedUNet(seeded_model(torch, port, x0, cfg),
                             device="cuda")
    with torch.no_grad():
        got = folded(x0)
        want = folded.forward_plain(x0)
    torch.cuda.synchronize()
    rel = rel_l2(torch, got, want)
    check(bool(torch.isfinite(got).all()) and got.shape == (1, 256, 256, 1)
          and rel <= LOGITS_REL_L2,
          f"non-bilinear forward: kernels vs plain relative L2 {rel} > "
          f"{LOGITS_REL_L2} (or logits not finite)")
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: folded(x0), iters=10)
    log(f"non-bilinear forward: kernel vs plain logits relative L2 "
        f"{rel:.3g} (tol {LOGITS_REL_L2}); {fwd_ms:.3f} ms per forward")

    k = port.default_intrinsics(FRAME_W, FRAME_H)
    analyze = port.make_frame_analyzer(folded, img_size=256, device="cuda")
    analyze(*frames[0], k, 0.001)
    torch.cuda.synchronize()
    n = len(frames)
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    masks = [analyze(rgb, depth, k, 0.001).mask for rgb, depth in frames]
    end.record()
    torch.cuda.synchronize()
    counts = read_launches()
    check(counts == frame_launches(n, convt=True),
          f"non-bilinear analyzer launches {counts} for {n} frames")
    masks = [m.cpu().numpy() for m in masks]
    for i, (rgb, depth) in enumerate(frames[:2]):
        check(tree_equal(torch, analyze(rgb, depth, k, 0.001),
                         analyze.eager(rgb, depth, k, 0.001)),
              f"non-bilinear frame {i}: replay differs from the eager run")
    delta, = capture_deltas(analyze)
    check(delta == frame_launches(1, convt=True),
          f"non-bilinear analyzer: capture delta {delta}")
    check_replay_kernels(torch, lambda: analyze(*frames[0], k, 0.001), delta,
                         "non-bilinear analyzer")
    log(f"non-bilinear analyzer: {n} frames, launches {counts} (18 + 4 + 1 + "
        f"3 per frame), {start.elapsed_time(end) / n:.3f} ms per frame (CUDA "
        f"events); coverage {[round(100 * float(m.mean()), 1) for m in masks]}"
        "; replays equal bit for bit to the eager runs")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_nb_"))
    requests = [port.raw_request(rgb, depth) for rgb, depth in frames]
    legs = {}
    for leg, window in (("direct", 0.0), ("batched", 2.0)):
        scfg = port.ServerConfig(address="localhost:0",
                                 metrics_csv=str(tmp / f"{leg}.csv"),
                                 calibration_path=str(tmp / "none.npz"),
                                 batch_window_ms=window, max_batch=MAX_BATCH)
        service = port.VisionAnalysisService(folded, cfg=scfg, device="cuda")
        service.warmup(FRAME_W, FRAME_H)
        reset_launches()
        if window:
            service.dispatcher.dispatch_sizes.clear()
            out, _ = concurrent_streams(service, [[r] for r in requests])
            responses = [o[0] for o in out]
            sizes = dict(service.dispatcher.dispatch_sizes)
            want = frame_launches(0, convt=True,
                                  dispatches=sum(sizes.values()),
                                  ones=sizes.get(1, 0))
        else:
            responses = list(service.analyze_stream(iter(requests)))
            sizes, want = None, frame_launches(n, convt=True, served=True)
        legs[leg] = read_launches()
        service.close()
        check(legs[leg] == want, f"non-bilinear {leg} launches {legs[leg]}, "
              f"want {want}")
        for i, resp in enumerate(responses):
            check(resp.status.startswith(("OK", "DEGRADED")) and np.array_equal(
                (decode_png(resp.mask) > 0).astype(np.uint8), masks[i]),
                f"non-bilinear {leg} frame {i}: status {resp.status!r} or "
                "mask differs from the analyzer's")
        log(f"non-bilinear served {leg}: {n} frames, masks equal to the "
            f"analyzer's; launches {legs[leg]}"
            + (f"; dispatch sizes {sizes}" if sizes else ""))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    train_conv_shapes(torch, conv, NB_NEW_3X3, gen)

    imgs, labels = synthetic.generate_arrays(TRAIN_BATCH, 256, 256, seed=SEED)
    xs, ys = trainer.normalize_arrays(imgs, labels)
    x, y = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    net = trainer.init_model(cfg, SEED, torch.device("cuda"))
    opt = trainer.make_optimizer(net, 1e-4)
    loss_fn = losses.make_loss_fn("bce")
    reset_launches()
    loss = float(trainer.train_step(net, opt, loss_fn, x, y))
    torch.cuda.synchronize()
    counts = read_launches()
    check(np.isfinite(loss) and counts == launches_of(
        conv3x3_bn_relu=18 + 17, conv3x3_grad_weights=18),
        f"non-bilinear train step: loss {loss}, launches {counts}")
    step_ms = []
    for _ in range(3):
        start.record()
        trainer.train_step(net, opt, loss_fn, x, y)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    log(f"non-bilinear train step (B = {TRAIN_BATCH}, 256x256, bf16): loss "
        f"{loss:.6f}, launches {counts} (no conv_transpose2x2: training runs "
        f"the plain transposed conv); ms per step "
        f"{' '.join(f'{v:.2f}' for v in step_ms)}")
    del net, opt
    torch.cuda.empty_cache()
    return {key: legs["direct"][key] + legs["batched"][key]
            for key in legs["direct"]}


# -- the CUDA graphs of the hot entries -----------------------------------------


def batch_analyzers(service) -> list:
    """The analyzers of a batched servicer's dispatcher."""
    return service.dispatcher.analyzers()


def tree_equal(torch, a, b) -> bool:
    """Two results (FrameAnalysis trees or tensors) equal bit for bit."""
    from robotic_discovery_platform_tpu_torch.ops import graphs

    la, lb = [], []
    graphs.tree_map(la.append, a)
    graphs.tree_map(lb.append, b)
    return len(la) == len(lb) and all(bitwise_equal(torch, x, y)
                                      for x, y in zip(la, lb))


def capture_deltas(analyzer) -> list:
    """Each captured graph's launches per replay, by kernel name."""
    out = []
    for _, cap in analyzer.graphs.graphs.values():
        delta = dict.fromkeys(KERNELS, 0)
        for fn, d in cap.launches:
            delta[fn.__name__] = d
        out.append(delta)
    return out


def kernel_functions() -> dict:
    """Each kernel function of the port's sources, by name, to the wrapper
    that launches it: one of them runs per launch the wrapper counts (the
    split-K ``fold_kernel`` runs beside a conv's and is left out)."""
    root = Path(__file__).resolve().parent
    names = {}
    for wrapper, (source, _, _) in KERNELS.items():
        for fn in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s*)?(\w+)\s*\(",
                             (root / source).read_text()):
            if fn != "fold_kernel":
                check(names.setdefault(fn, wrapper) == wrapper,
                      f"kernel function {fn} in two sources")
    return names


def profiled_kernels(torch, fn) -> dict:
    """The port's kernels that one call of ``fn`` ran on the card, by
    wrapper, from the profiler's device rows (a CUDA graph's kernels are
    traced one by one)."""
    from torch.profiler import ProfilerActivity, profile

    names = kernel_functions()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(KERNELS, 0)
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            continue
        m = re.search(r"(\w+)\s*[<(]",
                      e.key.replace("(anonymous namespace)::", ""))
        if m and m.group(1) in names:
            counts[names[m.group(1)]] += e.count
    return counts


def check_replay_kernels(torch, replay, delta: dict, what: str) -> None:
    """One call of ``replay`` ran on the card exactly the kernels its
    capture's launch delta says: the profiler's rows, not the counts. The
    profiler once dropped a short launch's record, so up to three
    profiled calls."""
    for _ in range(3):
        seen = profiled_kernels(torch, replay)
        if seen == delta:
            return
    check(False, f"{what}: one replay ran {seen} on the card (profiler), "
          f"the capture delta says {delta}")


def scaled(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def replay_cases(torch, analyzer, calls: list, want_delta: dict,
                 what: str) -> None:
    """``calls`` (argument tuples of one static shape, whose graph the
    analyzer has captured) replayed: launches exactly the capture's delta
    times the replays, every result equal bit for bit to the same call run
    eagerly, a result not overwritten by the calls after it, and one
    replay's kernels on the card (profiler) those of the delta."""
    delta, = capture_deltas(analyzer)
    check(delta == want_delta, f"{what}: capture delta {delta}, want "
          f"{want_delta}")
    reset_launches()
    got = [analyzer(*args) for args in calls]
    torch.cuda.synchronize()
    counts = read_launches()
    check(counts == scaled(delta, len(calls)), f"{what}: {len(calls)} "
          f"replays launched {counts}, want {len(calls)} x {delta}")
    for i, args in enumerate(calls):
        check(tree_equal(torch, got[i], analyzer.eager(*args)),
              f"{what} call {i}: replay differs from the eager run")
    check_replay_kernels(torch, lambda: analyzer(*calls[0]), delta, what)


def graph_phase(torch, port) -> dict:
    """The hot entries as CUDA graphs (``ops/graphs.py``) on the default
    model at 480x640: the frame analyzer, the coefficient analyzer and
    the packed batch analyzer at buckets 1, 2, 4 and 8 -- each replay
    equal bit for bit to the eager run of the same call, launches exactly
    the capture's delta times the replays, one capture per static shape
    within the JAX package's budgets; two graphs replayed at once from two
    threads on two streams (every deprojection ticket counter back at 0,
    results equal to the eager runs); and the train step (B = 4 at
    256x256) replayed against the same capturable Adam step run eagerly
    over 3 steps from one state, bit for bit, and against the
    single-tensor Adam step within phase 6's bars (in float32). Times each
    entry replayed against eager."""
    import threading

    from robotic_discovery_platform_tpu_torch.analysis import recompile
    from robotic_discovery_platform_tpu_torch.ops import geometry_kernels as gk
    from robotic_discovery_platform_tpu_torch.ops import pipeline
    from robotic_discovery_platform_tpu_torch.serving import entropy, ingest

    rng = np.random.default_rng(SEED)
    frames = [port.render_scene(rng, FRAME_H, FRAME_W)[::2]
              for _ in range(MAX_BATCH)]
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    folded = port.FoldedUNet(seeded_model(torch, port, x0), device="cuda")
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    qy, qc = ingest.quant_tables(COEF_QUALITY)
    coefs = [encode_coefficients(entropy, rgb, qy, qc) for rgb, _ in frames]
    recompile.reset()
    times = {}

    def replay_vs_eager(name, analyzer, args) -> None:
        times[name] = {"replay_host_ms": host_ms(torch, lambda: analyzer(
                           *args), iters=30),
                       "replay_ms": time_ms(torch, lambda: analyzer(*args),
                                            iters=30),
                       "eager_host_ms": host_ms(torch, lambda: analyzer.eager(
                           *args), iters=30),
                       "eager_ms": time_ms(torch, lambda: analyzer.eager(
                           *args), iters=30)}
        log(f"graphs, {name}: replay {times[name]['replay_ms']:.3f} ms per "
            f"call (CUDA events, back to back), host "
            f"{times[name]['replay_host_ms']:.3f} ms; eager "
            f"{times[name]['eager_ms']:.3f} ms, host "
            f"{times[name]['eager_host_ms']:.3f} ms")

    analyze = port.make_frame_analyzer(folded, img_size=256, device="cuda")
    calls = [(rgb, depth, k, 0.001) for rgb, depth in frames[:4]]
    analyze(*calls[0])
    replay_cases(torch, analyze, calls, frame_launches(1), "frame analyzer")
    replay_vs_eager("frame analyzer", analyze, calls[0])

    coef = pipeline.make_coef_frame_analyzer(folded, img_size=256,
                                             device="cuda")
    ccalls = [(cf, depth, k, 0.001) for cf, (_, depth) in zip(coefs, frames)]
    coef(*ccalls[0])
    replay_cases(torch, coef, ccalls[:4], frame_launches(1, coef=True),
                 "coefficient analyzer")
    replay_vs_eager("coefficient analyzer", coef, ccalls[0])

    batch = pipeline.make_batch_analyzer(folded, img_size=256, device="cuda",
                                         pack=True)
    for b in (1, 2, 4, 8):
        one = pipeline.make_batch_analyzer(folded, img_size=256,
                                           device="cuda", pack=True)
        args = (np.stack([f[0] for f in frames[:b]]),
                np.stack([f[1] for f in frames[:b]]),
                np.repeat(k[None], b, axis=0), np.full((b,), 0.001,
                                                       np.float32))
        one(*args)
        replay_cases(torch, one, [args, args], frame_launches(
            0, dispatches=1, ones=int(b == 1)), f"batch analyzer, bucket {b}")
        batch(*args)
        if b == MAX_BATCH:
            replay_vs_eager(f"batch analyzer, bucket {b}", one, args)
    check(len(batch.graphs.graphs) == 4 and batch.graphs.guard.stats.traces
          == 4, f"batch analyzer: {len(batch.graphs.graphs)} graphs for 4 "
          "buckets")

    # two graphs at once, from two threads on two caller streams
    frame_want = [analyze.eager(*c).mask for c in calls]
    coef_want = [coef.eager(*c).mask for c in ccalls[:4]]
    errors, results = [], {"frame": [], "coef": []}

    def hammer(name, analyzer, cs):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(5):
                    for c in cs:
                        results[name].append(analyzer(*c).mask)
                torch.cuda.current_stream().synchronize()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=a) for a in (
        ("frame", analyze, calls), ("coef", coef, ccalls[:4]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    check(not any(t.is_alive() for t in threads), "a replay thread hung")
    for name, want in (("frame", frame_want), ("coef", coef_want)):
        check(all(torch.equal(m, want[i % 4])
                  for i, m in enumerate(results[name])),
              f"concurrent replays: a {name} mask differs from the eager run")
    tickets = {key: int(t.item()) for key, t in gk._tickets.items()}
    check(all(v == 0 for v in tickets.values()), f"ticket counters after "
          f"concurrent replays: {tickets}")
    log(f"graphs: the frame and coefficient analyzers replayed 20 times "
        f"each from two threads on two streams at once: masks equal to the "
        f"eager runs, every ticket counter at 0 ({len(tickets)} counters)")

    snap = {name: [e["traces"] for e in entries]
            for name, entries in recompile.snapshot().items()}
    check(recompile.over_budget() == {}, f"capture budgets exceeded: "
          f"{recompile.over_budget()}")
    log(f"graphs: captures per guard instance {snap}, within budget")
    del analyze, coef, batch
    torch.cuda.empty_cache()
    times["train step"] = step_replay(torch, port)
    scan_resume_leg(torch, port)
    return {(name,): t for name, t in times.items()}


def step_replay(torch, port) -> dict:
    """The scan epoch's train step (``ops/graphs.StepGraph``: the first
    call eager, then captured and replayed) against the same capturable
    foreach Adam step run eagerly, over 3 steps from one state: losses,
    parameters, BatchNorm statistics and Adam's state equal bit for bit;
    in float32 compute, 3 replayed steps against the single-tensor Adam
    step within LOSS_RTOL (loss) and GRAD_REL_L2 (the parameters'
    change). Then replay against eager: ms per step
    (CUDA events and host wall), the replayed step's busy share under the
    profiler, and Adam's device time."""
    from robotic_discovery_platform_tpu_torch.analysis import recompile
    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.ops import graphs
    from robotic_discovery_platform_tpu_torch.training import (
        synthetic,
        trainer,
    )

    cfg = port.ModelConfig()
    imgs, masks = synthetic.generate_arrays(TRAIN_BATCH, 256, 256,
                                            seed=SEED)
    xs, ys = trainer.normalize_arrays(imgs, masks)
    x, y = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    loss_fn = losses.make_loss_fn("bce")
    dev = torch.device("cuda")

    def setup(model_cfg, single: bool = False):
        net = trainer.init_model(model_cfg, SEED, dev)
        opt = (torch.optim.Adam(net.parameters(), lr=1e-4, betas=(0.9, 0.999),
                                eps=1e-8, foreach=False)
               if single else trainer.make_optimizer(net, 1e-4))
        out = torch.zeros((), device=dev)

        def step():
            out.copy_(trainer.train_step(net, opt, loss_fn, x, y))

        return net, opt, out, step

    def state(net, opt) -> list:
        return ([t.detach().clone() for t in net.state_dict().values()]
                + [t.clone() for s in opt.state.values()
                   for t in s.values()])

    def three_steps(*steps) -> list:
        losses = [[] for _ in steps]
        for _ in range(3):
            for fn, out in steps:
                fn()
            torch.cuda.synchronize()
            for row, (_, out) in zip(losses, steps):
                row.append(out.clone())
        return losses

    net_e, opt_e, loss_e, step_e = setup(cfg)
    net_r, opt_r, loss_r, step_r = setup(cfg)
    check(opt_r.defaults["capturable"] and opt_r.defaults["foreach"],
          f"the trainer's Adam on the card: {opt_r.defaults}")
    graph = graphs.StepGraph(step_r, recompile.capture_guard(
        "trainer.train_epoch", 2), dev)
    eager_losses, replay_losses = three_steps((step_e, loss_e),
                                              (graph, loss_r))
    check(graph.capture is not None, "the train step was not captured")
    check(all(bitwise_equal(torch, a, b) for a, b in zip(
        eager_losses, replay_losses)), f"replayed train step losses "
        f"{replay_losses} differ from the eager step's {eager_losses}")
    check(all(bitwise_equal(torch, a, b) for a, b in zip(
        state(net_r, opt_r), state(net_e, opt_e))),
        "replayed train step: parameters, BatchNorm statistics or Adam "
        "state differ from the eager capturable step's")
    delta = dict.fromkeys(KERNELS, 0)
    for fn, d in graph.capture.launches:
        delta[fn.__name__] = d
    check(delta == launches_of(conv3x3_bn_relu=18 + 17,
                               conv3x3_grad_weights=18),
          f"captured train step's launches {delta}")
    check_replay_kernels(torch, graph, delta, "train step graph")

    # against the old single-tensor Adam, in float32 compute, where phase
    # 6's bars hold two summation orders (in bfloat16 a rounding flip of
    # one step's activations moves the next steps' gradients by percents)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    net_f, opt_f, loss_f, step_f = setup(f32)
    net_s, opt_s, loss_s, step_s = setup(f32, single=True)
    before = [p.detach().clone() for p in net_s.parameters()]
    graph_f = graphs.StepGraph(step_f, recompile.capture_guard(
        "trainer.train_epoch", 2), dev)
    f32_losses, single_losses = three_steps((graph_f, loss_f),
                                            (step_s, loss_s))
    change_f, change_s = (torch.cat([(p.detach() - b).flatten() for p, b in
                                     zip(n.parameters(), before)])
                          for n in (net_f, net_s))
    rel = rel_l2(torch, change_f, change_s)
    worst = max(abs(float(a) - float(b)) / abs(float(b))
                for a, b in zip(f32_losses, single_losses))
    check(worst <= LOSS_RTOL and rel <= GRAD_REL_L2,
          f"capturable foreach Adam vs single-tensor, float32: losses rel "
          f"{worst} (bar {LOSS_RTOL}), parameter change relative L2 {rel} "
          f"(bar {GRAD_REL_L2})")
    log(f"train step graph: 3 bf16 steps replayed equal bit for bit to the "
        f"eager capturable foreach Adam step (losses "
        f"{[round(float(v), 6) for v in replay_losses]}); launches per "
        f"replay {delta}; in float32, 3 replayed steps against single-tensor "
        f"Adam: losses within {worst:.3g} (bar {LOSS_RTOL}), parameter "
        f"change relative L2 {rel:.3g} (bar {GRAD_REL_L2})")
    del net_s, opt_s, net_f, opt_f, graph_f, change_f, change_s, before
    torch.cuda.empty_cache()

    def timed_steps(fn, n: int = 10) -> tuple:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(end) / n,
                (time.perf_counter() - t0) * 1e3 / n)

    t = {}
    for label in ("eager", "replay", "replay", "eager"):
        ms, wall = timed_steps(step_e if label == "eager" else graph)
        t.setdefault(f"{label}_ms", []).append(ms)
        t.setdefault(f"{label}_host_wall_ms", []).append(wall)
    busy = {label: device_busy(torch, lambda f=fn: [f() for _ in range(5)])
            for label, fn in (("eager", step_e), ("replay", graph))}
    from torch.profiler import ProfilerActivity, profile

    # one more Adam update on the last step's gradients, alone
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt_e.step()
        torch.cuda.synchronize()
    adam_ms = sum(r[0] for r in device_rows(prof))
    opt_e.zero_grad(set_to_none=True)
    t["adam_device_ms"] = adam_ms
    log(f"train step (B = {TRAIN_BATCH}, 256x256, bf16), eager vs replayed "
        f"in turns (eager, replay, replay, eager; 10 steps each): ms per "
        f"step (CUDA events) eager {' '.join(f'{v:.2f}' for v in t['eager_ms'])}"
        f", replay {' '.join(f'{v:.2f}' for v in t['replay_ms'])}; host wall "
        f"ms per step eager "
        f"{' '.join(f'{v:.2f}' for v in t['eager_host_wall_ms'])}, replay "
        f"{' '.join(f'{v:.2f}' for v in t['replay_host_wall_ms'])}; 5 steps "
        f"under the profiler: eager {busy['eager']}, replay "
        f"{busy['replay']}; capturable foreach Adam device time "
        f"{adam_ms:.3f} ms (profiler, one step)")
    del net_e, opt_e, net_r, opt_r, graph
    torch.cuda.empty_cache()
    return t


def scan_resume_leg(torch, port) -> None:
    """``train_model`` resumed on the card in the scan epoch (``"auto"``)
    from a checkpoint written by the single-tensor Adam of checkpoints
    older than the scan epoch (foreach and capturable off, step on the
    host), after one step of it: the resumed epoch is captured and
    replayed, its losses finite, and the checkpoint it writes carries
    capturable foreach Adam whose step went on from 1."""
    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.analysis import recompile
    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.training import (
        checkpoint,
        synthetic,
        trainer,
    )

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    cfg = port.TrainConfig(epochs=2, batch_size=TRAIN_BATCH, img_size=256,
                           learning_rate=1e-4, loss="bce", seed=SEED,
                           tracking_uri=f"file:{tmp}/mlruns",
                           checkpoint_dir=str(tmp / "ckpt"),
                           async_checkpointing=False)
    model_cfg = port.ModelConfig()
    arrays = synthetic.generate_arrays(TRAIN_SAMPLES, 256, 256, seed=SEED)
    xs, ys = trainer.normalize_arrays(*arrays)
    net = trainer.init_model(model_cfg, SEED, torch.device("cuda"))
    old = torch.optim.Adam(net.parameters(), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8, foreach=False)
    trainer.train_step(net, old, losses.make_loss_fn("bce"),
                       torch.from_numpy(xs[:TRAIN_BATCH]).cuda(),
                       torch.from_numpy(ys[:TRAIN_BATCH]).cuda())
    saved = old.state_dict()
    check(not saved["param_groups"][0]["foreach"]
          and not saved["param_groups"][0]["capturable"]
          and all(not s["step"].is_cuda for s in saved["state"].values()),
          "the single-tensor Adam's state is not the old form")
    checkpoint.CheckpointManager(cfg.checkpoint_dir).save(1, {
        "model": net.state_dict(), "optimizer": saved, "epoch": 1,
        "best_val_loss": float("inf"), "best": net.state_dict()})
    del net, old
    guards = len(recompile.stats_for("trainer.train_epoch"))
    res = trainer.train_model(cfg, model_cfg, arrays=arrays, resume=True,
                              register=False, device="cuda")
    torch.cuda.synchronize()
    captures = [s.traces
                for s in recompile.stats_for("trainer.train_epoch")[guards:]]
    hist = [h["value"] for h in tracking.store_for(
        cfg.tracking_uri).get_metric_history(res.run_id, "train_loss")]
    written = checkpoint.CheckpointManager(cfg.checkpoint_dir).restore()
    group, = written["optimizer"]["param_groups"]
    steps = {float(s["step"]) for s in written["optimizer"]["state"].values()}
    check(res.epochs_run == 1 and captures == [1] and len(hist) == 1
          and np.isfinite(hist[0]), f"scan resume on the card: epochs "
          f"{res.epochs_run}, captures {captures}, train loss {hist}")
    check(group["foreach"] and group["capturable"] and steps == {5.0},
          f"scan resume: the checkpoint it wrote has Adam foreach "
          f"{group['foreach']}, capturable {group['capturable']}, steps "
          f"{steps} (want 1 + 4)")
    log(f"scan resume from a single-tensor Adam checkpoint: 1 epoch of 4 "
        f"replayed steps, train loss {hist[0]:.6f}, the train step "
        f"captured once; the checkpoint it wrote holds capturable foreach "
        f"Adam at step 5")


#: the phases ``--phase`` runs alone
# -- phase 9: a server that can be deployed ------------------------------------

#: alias moves per leg: more than the 32 side streams PyTorch's pool hands
#: out per device and priority, so a capture that could land on a stream
#: a live graph cache uses would
DEPLOY_RELOADS = 40
#: memory_allocated after the last reload, its grace period and a
#: collection may differ from its value after the first generation's
#: warm-up by at most this many bytes: a generation left reachable holds
#: its folded weights (about 35 MB in bf16) and graph outputs, far more;
#: set before the phase's first run: memory_allocated, and (set before
#: its first check) memory_reserved, after the last reload against their
#: values after the first warm-up
DEPLOY_SLACK = 4 * 2**20
DEPLOY_RESERVED_SLACK = 128 * 2**20
DEPLOY_GRACE_S = 0.5  # reload_grace_s of the phase's servers


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def http_get(port: int, path: str, timeout: float = 30.0) -> bytes:
    """GET ``path`` from the phase's own metrics endpoint on localhost."""
    import urllib.request

    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=timeout) as resp:
        return resp.read()


def metric_value(text: str, name: str, **labels) -> float:
    """The sample of ``name`` with exactly ``labels`` (in any order) in a
    /metrics page (0.0 when absent)."""
    for line in text.splitlines():
        key, _, value = line.rpartition(" ")
        family, _, rest = key.partition("{")
        if family != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', rest))
        if got == {k: str(v) for k, v in labels.items()}:
            return float(value)
    return 0.0


def graph_pool_report(torch) -> str:
    """The caching allocator's CUDA graph pools: their segments, and the
    blocks still allocated in them (a block left allocated keeps its whole
    pool reserved)."""
    segments = [s for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0)]
    held = [b["size"] for s in segments for b in s["blocks"]
            if b["state"] == "active_allocated"]
    pools = {tuple(s["segment_pool_id"]) for s in segments}
    return (f"{len(pools)} graph pools in {len(segments)} segments, "
            f"{sum(s['total_size'] for s in segments) / 2**20:.1f} MiB, "
            f"{len(held)} blocks allocated in them "
            f"({sum(held) / 2**20:.2f} MiB; largest "
            f"{sorted(held)[-3:]})")


def check_graph_pools(torch, caches: list, what: str) -> int:
    """Each cache's private graph pool holds, allocated, exactly its live
    graphs' static outputs: everything else a capture allocated was freed
    inside the pool, and no other thread's allocation (serving threads
    allocate while a reload captures) landed there. Returns the blocks
    checked."""
    from robotic_discovery_platform_tpu_torch.ops import graphs

    segments = torch.cuda.memory_snapshot()
    checked = 0
    for cache in caches:
        if cache._pool is None:
            continue
        held = sorted(b["address"] for s in segments
                      if tuple(s.get("segment_pool_id", (0, 0)))
                      == tuple(cache._pool)
                      for b in s["blocks"] if b["state"] == "active_allocated")
        outputs = []
        for _, cap in cache.graphs.values():
            graphs.tree_map(lambda t: outputs.append(
                t.untyped_storage().data_ptr()), cap.outputs)
        check(held == sorted(outputs),
              f"{what}: graph pool {cache._pool} holds {len(held)} blocks, "
              f"its graphs' outputs are {len(outputs)}")
        checked += len(held)
    return checked


def cache_streams(engine) -> list:
    """Every graph cache of one servicer generation (``serving.server.
    Engine``): the direct analyzers', and the dispatcher's analyzers'."""
    analyzers = [engine.analyze, engine.analyze_coef]
    if engine.dispatcher is not None:
        analyzers += engine.dispatcher.analyzers()
    return [a.graphs for a in analyzers]


def stream_handles(caches) -> set:
    """The streams graph caches warm, capture and replay on (those that
    ran on the card)."""
    return {c.stream_handle for c in caches} - {None}


def generation_refs(engine) -> list:
    """Weak references to what holds one generation's memory: its graph
    caches and its folded weights."""
    return [weakref.ref(x) for x in (*cache_streams(engine), engine.forward)]


def deploy_leg(torch, port, uri: str, tmp: Path, requests: list,
               expect: dict, batched: bool, profile: bool) -> dict:
    """One server from the registry at ``uri`` (``build_server`` with a
    640x480 warm-up and a metrics endpoint), 8 closed-loop streams
    through ``analyze_stream`` while the ``staging`` alias moves
    between versions 1 and 2 DEPLOY_RELOADS times, then the checks of
    ``deploy_phase``; returns the leg's figures."""
    import gc
    import threading

    import grpc

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.observability import journal
    from robotic_discovery_platform_tpu_torch.ops import graphs
    from robotic_discovery_platform_tpu_torch.serving import (
        grpc_service,
        health,
    )
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        health_pb2,
        vision_grpc,
        vision_pb2,
    )

    leg = "batched" if batched else "direct"
    name = port.ServerConfig().model_name
    store = tracking.store_for(uri)
    store.set_alias(name, "staging", 1)
    mport = free_port()
    cfg = port.ServerConfig(
        address="localhost:0", tracking_uri=uri,
        metrics_csv=str(tmp / f"{leg}.csv"),
        calibration_path=str(tmp / "none.npz"), reload_poll_s=0.2,
        reload_grace_s=DEPLOY_GRACE_S, drain_grace_s=5.0,
        metrics_port=mport, batch_window_ms=2.0 if batched else 0.0,
        max_batch=MAX_BATCH)
    cursor = journal.JOURNAL.snapshot()["next_cursor"]
    server, servicer = grpc_service.build_server(
        cfg, warmup_shape=(FRAME_W, FRAME_H), device="cuda")
    server.start()
    channel = grpc.insecure_channel(f"localhost:{servicer.bound_port}")
    hstub = health.HealthStub(channel)
    for service in ("", "evofab.vision.VisionAnalysisService"):
        status = hstub.Check(health_pb2.HealthCheckRequest(
            service=service), timeout=30).status
        check(status == health.SERVING,
              f"{leg}: health of {service!r} is {status} after warm-up")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()  # what earlier phases left cached
    mem0 = torch.cuda.memory_allocated()
    res0 = torch.cuda.memory_reserved()
    page0 = http_get(mport, "/metrics").decode()
    before = {st: metric_value(page0, "rdp_frames_total", model="seg",
                               status=st) for st in ("ok", "degraded")}

    stop = threading.Event()
    got: list = [[] for _ in range(STREAMS)]  # (t, frame index, response)
    errors: list = []

    def stream(i: int) -> None:
        order = [(i + j) % len(requests) for j in range(len(requests))]

        def feed():
            n = 0
            while not stop.is_set():
                yield requests[order[n % len(order)]]
                n += 1

        try:
            n = 0
            for resp in servicer.analyze_stream(feed()):
                got[i].append((time.perf_counter(), order[n % len(order)],
                               resp))
                n += 1
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=stream, args=(i,), daemon=True)
               for i in range(STREAMS)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    profile_out: dict = {}
    if profile:
        def take_profile():
            try:
                profile_out["reply"] = json.loads(
                    http_get(mport, "/debug/profile?seconds=1", timeout=120))
            except BaseException as exc:  # noqa: BLE001 - checked below
                profile_out["error"] = exc

        profiler = threading.Thread(target=take_profile, daemon=True)
    swaps, windows, disjoint = [], [], 0
    version = 1
    # every generation that went live, and the streams each ran on
    generations = [generation_refs(servicer._engine)]
    handles = [stream_handles(cache_streams(servicer._engine))]
    per_generation = len(handles[0])
    made_half = None
    for k in range(DEPLOY_RELOADS):
        if k == DEPLOY_RELOADS // 2:
            made_half = graphs.streams_made(0)
            if profile:
                profiler.start()  # a profile while reloads capture
        prev = servicer._engine
        target = 2 if version == 1 else 1
        t0 = time.perf_counter()
        store.set_alias(name, "staging", target)
        deadline = t0 + 120
        while servicer.current_version != target:
            check(time.perf_counter() < deadline,
                  f"{leg}: no swap to version {target} within 120 s")
            check(not errors, f"{leg}: a stream failed: {errors[:1]}")
            time.sleep(0.001)
        t1 = time.perf_counter()
        swaps.append(t1 - t0)
        windows.append((t0, t1, target))
        version = target
        # the new generation warmed and captured on streams that no
        # generation still alive holds: the one it replaced, and those
        # whose grace has not ended
        eng = servicer._engine
        new = stream_handles(cache_streams(eng))
        check(len(new) == per_generation,
              f"{leg} reload {k}: the new generation ran on {len(new)} "
              f"streams, the first on {per_generation}")
        live = stream_handles(
            c for refs in generations for c in (r() for r in refs[:-1])
            if c is not None)
        check(stream_handles(cache_streams(prev)) <= live,
              f"{leg} reload {k}: the replaced generation's streams are "
              "not among the live ones")
        check(not new & live, f"{leg} reload {k}: the new generation "
              f"captured on streams {new & live} of a live one")
        disjoint += 1
        generations.append(generation_refs(eng))
        handles.append(new)
        del prev, eng
    if profile:
        profiler.join(timeout=180)
    time.sleep(0.5)  # frames served by the last swap's version
    t_end = time.perf_counter()
    stop.set()
    for t in threads:
        t.join(timeout=120)
    check(not errors, f"{leg}: a stream failed: {errors[:1]}")
    check(not any(t.is_alive() for t in threads), f"{leg}: a stream hung")
    responses = [r for g in got for r in g]
    n_frames = len(responses)

    # every response OK and equal to v1's or v2's answer for its frame
    served_by = []
    for t, i, resp in responses:
        mask = port.decode_mask_wire(resp.mask)
        versions = [v for v in (1, 2)
                    if np.array_equal(mask, expect[v][i][0])]
        check(versions, f"{leg} frame {i}: mask equal to neither version's "
              f"(status {resp.status!r})")
        for v in versions:
            _, mean_k, max_k, valid = expect[v][i]
            check(resp.status == ("OK" if valid else
                                  "DEGRADED: insufficient geometry"),
                  f"{leg} frame {i}: status {resp.status!r}, version {v} "
                  f"{'has' if valid else 'lacks'} its geometry")
            check(not valid or np.allclose(
                [resp.mean_curvature, resp.max_curvature], [mean_k, max_k],
                rtol=GEOM_RTOL, atol=0),
                  f"{leg} frame {i}: curvature {resp.mean_curvature} vs "
                  f"version {v}'s {mean_k} beyond rtol {GEOM_RTOL}")
        served_by.append((t, versions))
    statuses = collections.Counter(resp.status for _, _, resp in responses)
    ends = [w[1] for w in windows[1:]] + [t_end]
    for k, ((_, t1, v), t_next) in enumerate(zip(windows, ends)):
        check(any(t1 <= t <= t_next and vs == [v] for t, vs in served_by),
              f"{leg}: no frame served by version {v} after swap {k}")
    in_reload = [resp.proc_time_ms for t, _, resp in responses
                 if any(a <= t <= b for a, b, _ in windows)]
    steady = [resp.proc_time_ms for t, _, resp in responses
              if not any(a <= t <= b for a, b, _ in windows)]

    # the old generations are gone once their grace has passed, and the
    # reloader's next polls return their graph memory to the card
    time.sleep(DEPLOY_GRACE_S + 0.5)
    uncollected = sum(any(r() is not None for r in refs)
                      for refs in generations[:-1])
    gc.collect()
    time.sleep(4 * 0.2)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    res1 = torch.cuda.memory_reserved()
    pools = graph_pool_report(torch)
    pooled = check_graph_pools(torch, cache_streams(servicer._engine), leg)
    torch.cuda.empty_cache()
    res2 = torch.cuda.memory_reserved()
    check(abs(mem1 - mem0) <= DEPLOY_SLACK,
          f"{leg}: memory_allocated {mem1} after {DEPLOY_RELOADS} reloads "
          f"vs {mem0} after the first warm-up: beyond the "
          f"{DEPLOY_SLACK}-byte slack")
    check(res1 <= res0 + DEPLOY_RESERVED_SLACK,
          f"{leg}: memory_reserved {res1} after {DEPLOY_RELOADS} reloads "
          f"and their grace vs {res0} after the first warm-up: beyond the "
          f"{DEPLOY_RESERVED_SLACK}-byte slack")
    alive = sum(any(r() is not None for r in refs)
                for refs in generations[:-1])
    check(alive == 0, f"{leg}: {alive} swapped-out generations still alive")
    # streams are handed on: the second half of the reloads made no
    # stream, every generation took one a collected owner had left (the
    # process may hold more free streams than the first half draws, from
    # earlier graph caches and dispatchers, so a stream the first half
    # never ran on is not a new one)
    made = graphs.streams_made(0) - made_half
    check(made == 0, f"{leg}: the last {DEPLOY_RELOADS - DEPLOY_RELOADS // 2}"
          f" reloads made {made} new stream(s)")
    n_streams = len(set().union(*handles))

    page = http_get(mport, "/metrics").decode()
    served = sum(metric_value(page, "rdp_frames_total", model="seg",
                              status=st) - before[st]
                 for st in ("ok", "degraded"))
    ok = metric_value(page, "rdp_frames_total", model="seg",
                      status="ok") - before["ok"]
    check(served == n_frames and ok == statuses["OK"],
          f"{leg}: /metrics counts {served} frames served ({ok} ok), want "
          f"{n_frames} ({statuses['OK']} OK)")
    inflight = metric_value(page, "rdp_inflight_streams")
    check(inflight == 0, f"{leg}: rdp_inflight_streams {inflight} after "
          "the streams ended")
    if profile:
        check("reply" in profile_out,
              f"{leg}: /debug/profile failed: {profile_out.get('error')}")
        trace_file = Path(profile_out["reply"]["profile_dir"]) / "trace.json"
        names = kernel_functions()
        seen = set()
        for event in json.loads(trace_file.read_text()).get(
                "traceEvents", []):
            m = re.search(r"(\w+)\s*[<(]", str(event.get("name", "")).replace(
                "(anonymous namespace)::", ""))
            if m and m.group(1) in names:
                seen.add(names[m.group(1)])
        check({"conv3x3_bn_relu", "deproject_edge_stats"} <= seen,
              f"{leg}: the profile taken during traffic shows the port's "
              f"kernels {sorted(seen)}")
        log(f"{leg}: /debug/profile?seconds=1 during reloads: "
            f"{trace_file.stat().st_size} bytes, the port's kernels "
            f"{sorted(seen)}")

    # drain with one stream in flight
    import queue

    q: queue.Queue = queue.Queue()

    def held():
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    live = servicer.analyze_stream(held())
    q.put(requests[0])
    first = next(live)
    check(first.status == "OK", f"{leg}: held stream status {first.status}")
    drained: dict = {}

    def drain():
        t = time.perf_counter()
        drained["ok"] = servicer.drain(timeout_s=30.0)
        drained["s"] = time.perf_counter() - t

    drainer = threading.Thread(target=drain, daemon=True)
    drainer.start()
    time.sleep(0.5)
    check(drainer.is_alive() and servicer.active_streams == 1,
          f"{leg}: drain returned with a stream in flight")
    status = hstub.Check(health_pb2.HealthCheckRequest(), timeout=30).status
    check(status == health.NOT_SERVING,
          f"{leg}: health {status} while draining")
    stub = vision_grpc.VisionAnalysisServiceStub(channel)
    pb = vision_pb2.AnalysisRequest(
        color_image=vision_pb2.Image(
            data=requests[0].color_image.data, width=FRAME_W,
            height=FRAME_H, format=1),
        depth_image=vision_pb2.Image(
            data=requests[0].depth_image.data, width=FRAME_W,
            height=FRAME_H, format=1))
    try:
        list(stub.AnalyzeActuatorPerformance(iter([pb]), timeout=30))
        refused = None
    except grpc.RpcError as exc:
        refused = exc.code()
    check(refused == grpc.StatusCode.UNAVAILABLE,
          f"{leg}: a new stream while draining got {refused}")
    q.put(None)
    check(list(live) == [], f"{leg}: the held stream answered past its end")
    drainer.join(timeout=60)
    check(drained.get("ok") is True,
          f"{leg}: drain returned {drained.get('ok')} after the stream ended")
    events = json.loads(http_get(mport, f"/debug/events?since={cursor}"))
    kinds = [(e["kind"], e["attrs"].get("version"))
             for e in events["events"]]
    check(("server.ready", "1") in kinds,
          f"{leg}: /debug/events lacks server.ready of version 1: {kinds}")
    check(any(kind == "server.drain" for kind, _ in kinds),
          f"{leg}: /debug/events lacks server.drain: {kinds}")
    channel.close()
    t = time.perf_counter()
    grpc_service.shutdown(server, servicer)
    shutdown_s = time.perf_counter() - t
    wall = t_end - t_start
    swaps_sorted = sorted(swaps)
    log(f"{leg} leg ({STREAMS} streams, reload_poll_s 0.2, "
        f"{DEPLOY_RELOADS} reloads): alias move to swap s min "
        f"{swaps_sorted[0]:.3f} median {np.median(swaps):.3f} max "
        f"{swaps_sorted[-1]:.3f}; {n_frames} frames {dict(statuses)}, each "
        f"equal to version 1's or 2's; {n_frames / wall:.1f} frames/s over "
        f"{wall:.1f} s; proc_time_ms in reload windows p50 "
        f"{np.percentile(in_reload, 50):.2f} p99 "
        f"{np.percentile(in_reload, 99):.2f} ({len(in_reload)} frames), "
        f"steady p50 {np.percentile(steady, 50):.2f} p99 "
        f"{np.percentile(steady, 99):.2f} ({len(steady)} frames); "
        f"{disjoint} new generations on streams no live one held, "
        f"{n_streams} streams in all ({per_generation} a generation); "
        f"memory_allocated {mem0 / 2**20:.1f} -> {mem1 / 2**20:.1f} MiB "
        f"(slack {DEPLOY_SLACK / 2**20:.0f}), memory_reserved "
        f"{res0 / 2**20:.1f} -> {res1 / 2**20:.1f} MiB (slack "
        f"{DEPLOY_RESERVED_SLACK / 2**20:.0f}; {res2 / 2**20:.1f} after "
        f"empty_cache; {uncollected} swapped-out generations left for the "
        f"collector; {pools}; the serving generation's pools "
        f"hold its {pooled} graph outputs and nothing else); drain with a "
        f"stream in flight {drained['s']:.2f} s; shutdown {shutdown_s:.2f} s"
        f"; [{nvidia_smi_line()}]")
    return {"frames": n_frames, "wall_s": wall}


def deploy_phase(torch, port) -> dict:
    """A server that can be deployed: two versions of ``ModelConfig()``
    (seeds 0 and 1, BatchNorm calibrated as in the serving cell) in a
    temporary file registry, served by ``grpc_service.build_server``
    directly and batched, each leg under 8 live streams while the
    ``staging`` alias moves DEPLOY_RELOADS times (``deploy_leg``):
    health over gRPC, every response byte-equal to one version's answer,
    new generations on streams no live one held, memory back within
    DEPLOY_SLACK and DEPLOY_RESERVED_SLACK, /metrics, /debug/events,
    /debug/profile (direct leg),
    drain and the shutdown order. Returns the launches of the phase's
    run."""
    import os

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models import weights

    log(f"deploy_phase: {torch.cuda.get_device_name(0)} "
        f"[{nvidia_smi_line()}]")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_deploy_"))
    os.environ["RDP_PROFILE_DIR"] = str(tmp / "profiles")
    rng = np.random.default_rng(SEED)
    frames = []
    for _ in range(8):
        rgb, _, depth = port.render_scene(rng, FRAME_H, FRAME_W)
        frames.append((rgb, depth))
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    uri = f"file:{tmp}/mlruns"
    name = port.ServerConfig().model_name
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    expect = {}
    with tracking.start_run():
        for version, seed in ((1, 0), (2, 1)):
            net = seeded_model(torch, port, x0, seed=seed)
            check(tracking.log_model(weights.to_flax_variables(net), net.cfg,
                                     registered_model_name=name) == version,
                  f"registry version of seed {seed}")
            analyze = port.make_frame_analyzer(
                port.FoldedUNet(net, device="cuda"), img_size=256,
                device="cuda")
            expect[version] = []
            for rgb, depth in frames:
                out = analyze(rgb, depth, k, 0.001)
                expect[version].append((
                    out.mask.cpu().numpy(),
                    float(out.profile.mean_curvature),
                    float(out.profile.max_curvature),
                    bool(out.profile.valid)))
            del analyze, net
    differ = sum(not np.array_equal(a[0], b[0])
                 for a, b in zip(expect[1], expect[2]))
    check(differ > 0, "the two versions' masks are equal on every frame")
    log(f"deploy_phase: versions 1 and 2 registered; masks differ on "
        f"{differ} of {len(frames)} frames; frames with geometry "
        f"{[sum(e[3] for e in expect[v]) for v in (1, 2)]}")
    requests = [port.raw_request(rgb, depth, mask_format=1)
                for rgb, depth in frames]
    reset_launches()
    legs = [deploy_leg(torch, port, uri, tmp, requests, expect,
                       batched=False, profile=True),
            deploy_leg(torch, port, uri, tmp, requests, expect,
                       batched=True, profile=False)]
    launches = read_launches()
    log(f"deploy_phase: launches {launches}")
    return launches


# -- phase 10: the drift loop -------------------------------------------------

#: the retraining workflow's eval scenes (``capture_drift_profile``'s
#: defaults: 16 frames at 120x160) and the served frames of the phase
DRIFT_H, DRIFT_W = 120, 160
DRIFT_STREAM = 256  # in-distribution frames per serving leg, each a scene
# of its own (seed SEED + 1): a window of repeated scenes holds fewer
# samples than its count, and its PSI sits above the noise floor
DRIFT_CHUNK = 64  # shifted frames per round, until a recommendation fires
DRIFT_MAX_SHIFTED = 2048
DRIFT_SUSTAIN_S = 0.5
#: one frame's signals, card capture against the CPU capture of the same
#: registered weights and frames (the card's bf16 kernels against the
#: plain bf16 convs: logits a few bf16 ulps apart flip the mask pixels
#: next to the threshold), set before the phase's first run: validity
#: and the depth-valid fraction equal; coverage within 0.5 percentage
#: points; the confidence margin within 2e-3; the mean curvature within
#: 10% (or 0.1 1/m), the max within 25% (or 0.5 1/m); and per signal the
#: PSI of the card profile against the CPU one at or below its noise
#: floor
DRIFT_COVERAGE_ATOL = 0.5
DRIFT_MARGIN_ATOL = 2e-3
DRIFT_MEAN_K = (0.10, 0.1)  # (rtol, atol in 1/m)
DRIFT_MAX_K = (0.25, 0.5)
#: the supervised run against an unbroken run in this process, set
#: before the phase's first run. The killed attempt's epoch-1 checkpoint
#: and the restarted attempt's final state against the unbroken run's:
#: bit for bit where every op of the step is deterministic, else within
#: SUPERVISED_SAME_ATOL in every parameter and Adam moment (a tenth of
#: one step of lr 1e-4); the epoch-2 train loss within
#: SUPERVISED_LOSS_RTOL; the same number of steps (the checkpoint
#: carries the epoch order's state, so the restart takes the unbroken
#: run's batches).
SUPERVISED_SAME_ATOL = 1e-5
SUPERVISED_LOSS_RTOL = 5e-2


def drift_scenes(port, seed: int, n: int, shifted: bool = False) -> list:
    """``n`` synthetic (rgb, depth) scenes at the drift size from
    ``seed``; ``shifted`` zeroes the lower half of each depth frame."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rgb, _, depth = port.render_scene(rng, DRIFT_H, DRIFT_W)
        if shifted:
            depth = depth.copy()
            depth[DRIFT_H // 2:] = 0
        out.append((rgb, depth))
    return out


def signals_of(torch, port, net, frames, device: str) -> list:
    """Each frame's five drift signals through the frame analyzer of
    ``net`` on ``device`` (``monitoring/profile.frame_signals``)."""
    from robotic_discovery_platform_tpu_torch.monitoring import profile

    analyze = port.make_frame_analyzer(
        port.FoldedUNet(net, device=device), img_size=256, device=device)
    out = []
    for rgb, depth in frames:
        k = port.default_intrinsics(DRIFT_W, DRIFT_H).astype(np.float32)
        out.append(profile.frame_signals(
            analyze.eager(rgb, depth, k, np.float32(0.001)), depth))
    return out


def signals_agree(got: dict, want: dict) -> bool:
    def close(a, b, rtol, atol):
        return abs(a - b) <= max(rtol * abs(b), atol)

    if np.isnan(got["mean_curvature"]) != np.isnan(want["mean_curvature"]):
        return False
    curv = np.isnan(want["mean_curvature"]) or (
        close(got["mean_curvature"], want["mean_curvature"], *DRIFT_MEAN_K)
        and close(got["max_curvature"], want["max_curvature"], *DRIFT_MAX_K))
    return (curv and got["depth_valid_fraction"] == want["depth_valid_fraction"]
            and abs(got["mask_coverage"] - want["mask_coverage"])
            <= DRIFT_COVERAGE_ATOL
            and abs(got["confidence_margin"] - want["confidence_margin"])
            <= DRIFT_MARGIN_ATOL)


def capture_leg(torch, port, cfg, res) -> None:
    """The profile the retraining cycle wrote, against a CPU capture of the
    same registered weights and frames: per frame (printed side by side)
    within the DRIFT_* bars, per signal PSI at or below its noise floor."""
    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.monitoring import profile

    saved = profile.FeatureProfile.load(res.drift_profile_path)
    check((saved.generation, saved.source, saved.n_frames)
          == (res.version, "capture", 16),
          f"profile of version {res.version}: generation {saved.generation}"
          f", source {saved.source}, {saved.n_frames} frames")
    frames = drift_scenes(port, 0, 16)  # capture_drift_profile's scenes
    store = tracking.store_for(cfg.tracking_uri)
    uri = f"models:/{cfg.registered_model_name}/{res.version}"
    _, card_net = tracking.load_model(uri, store=store, device="cuda")
    _, cpu_net = tracking.load_model(uri, store=store, device="cpu")
    t0 = time.perf_counter()
    card = signals_of(torch, port, card_net, frames, "cuda")
    cpu = signals_of(torch, port, cpu_net, frames, "cpu")
    cpu_s = time.perf_counter() - t0
    del card_net, cpu_net
    rebuilt = profile.FeatureProfile()
    cpu_prof = profile.FeatureProfile()
    bad = []
    for i, (g, w) in enumerate(zip(card, cpu)):
        rebuilt.observe(g)
        cpu_prof.observe(w)
        log(f"capture frame {i}: card {json.dumps(g)} cpu {json.dumps(w)}")
        if not signals_agree(g, w):
            bad.append(i)
    check(not bad, f"card and CPU signals beyond the DRIFT_* bars on "
          f"frames {bad}")
    scores = {}
    for name, sketch in saved.sketches.items():
        check(sketch.counts() == rebuilt.sketches[name].counts(),
              f"the saved profile's {name} is not the card analyzer's")
        s = profile.score_sketches(sketch, cpu_prof.sketches[name])
        scores[name] = (round(s.psi, 4), round(s.noise_floor, 4))
        check(s.psi <= s.noise_floor, f"{name}: card vs CPU profile psi "
              f"{s.psi:.4f} above its noise floor {s.noise_floor:.4f}")
    log(f"capture: card profile against the CPU capture, (psi, noise "
        f"floor) per signal {scores}; both captures {cpu_s:.1f} s")


def bias_leg(torch, port, uri: str, tmp: Path, inside: list) -> None:
    """The retraining cycle's own profile (16 frames, the JAX default)
    behind a direct server with the default 256-frame window, on the
    in-distribution scenes: printed, not gated. The scoring (the JAX
    package's) smooths each cell with a pseudo-count of 0.5 before the
    PSI, so two samples of different sizes held in one and the same cell
    score above zero: at 16 reference and 256 live frames about 1.2,
    above 0.25 plus that pair's 0.066 noise floor, and a signal constant
    on these scenes fires (ROADMAP queue 3)."""
    from robotic_discovery_platform_tpu_torch.serving import server

    cfg = port.ServerConfig(
        tracking_uri=uri, metrics_csv=str(tmp / "bias.csv"),
        calibration_path=str(tmp / "none.npz"), reload_poll_s=0.0,
        drift_sustain_s=DRIFT_SUSTAIN_S, drift_cooldown_s=1e9)
    service = server.build_service(cfg, warmup_shape=(DRIFT_W, DRIFT_H),
                                   device="cuda")
    fired_at = None
    try:
        check(service.drift.reference.n_frames == 16,
              f"the cycle's profile holds {service.drift.reference.n_frames}"
              " frames, not 16")
        # each scene twice: past the window's 64th frame and the sustain
        stream = service.analyze_stream(iter(
            [port.raw_request(rgb, depth, mask_format=1)
             for rgb, depth in inside * 2]))
        for i, _ in enumerate(stream):
            if fired_at is None and service.drift.recommendations_total:
                fired_at = i + 1
        scores = {k: (round(v.psi, 3), round(v.noise_floor, 3))
                  for k, v in service.drift.scores.items()}
        ref = service.drift.reference
        cells = {k: sum(1 for c in sk.counts() if c)
                 for k, sk in ref.sketches.items()}
        rec = service.drift.recommendations[-1:]
    finally:
        service.close()
    log(f"bias leg (not gated): the 16-frame profile against "
        f"{len(inside)} in-distribution scenes, each twice: recommendation "
        f"{'after ' + str(fired_at) + ' frames on ' + str(rec[0].signals) if fired_at else 'none'}"
        f"; (psi, noise floor) {scores}; occupied cells of the reference "
        f"{cells}")


def live_graphs() -> str:
    """The graph caches, step graphs and scan epochs still alive, and what
    refers to each step graph (for a memory check's message)."""
    import gc

    from robotic_discovery_platform_tpu_torch.ops import graphs
    from robotic_discovery_platform_tpu_torch.training import trainer

    import torch

    kinds = (graphs.GraphCache, graphs.StepGraph, trainer.ScanEpochs,
             graphs.Capture, torch.cuda.CUDAGraph)
    live = [o for o in gc.get_objects() if isinstance(o, kinds)]
    out = collections.Counter(type(o).__name__ for o in live)
    refs = [f"{type(o).__name__} <- {type(r).__name__}: {str(r)[:80]}"
            for o in live if isinstance(o, (graphs.StepGraph, graphs.Capture))
            for r in gc.get_referrers(o) if r is not live]
    pools = sorted({tuple(s.get("segment_pool_id", (0, 0)))
                    for s in torch.cuda.memory_snapshot()} - {(0, 0)})
    caches = [tuple(o._pool) for o in live
              if isinstance(o, graphs.GraphCache) and o._pool is not None]
    return (f"alive {dict(out)}; held by {refs[:8]}; pools with segments "
            f"{pools}, live caches' pools {caches}")


def drift_leg(torch, port, uri: str, tmp: Path, batched: bool,
              inside: list, shifted: list, reload=None) -> dict:
    """A server from ``@staging`` (``build_server``, default
    ``drift_enabled``, sustain DRIFT_SUSTAIN_S, a cooldown past the
    phase; version 1's reference captured over DRIFT_STREAM scenes) with
    a metrics endpoint: DRIFT_STREAM in-distribution frames
    over gRPC (one stream, or STREAMS batched), no recommendation; then
    shifted frames until exactly one fires, naming depth_valid_fraction;
    /metrics, the journal and /debug/drift. ``reload`` (the direct leg)
    then runs a second retraining cycle under a live stream and checks
    the reference the reload adopts."""
    import threading

    import grpc

    from robotic_discovery_platform_tpu_torch.observability import journal
    from robotic_discovery_platform_tpu_torch.serving import grpc_service
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        vision_grpc,
        vision_pb2,
    )

    leg = "batched" if batched else "direct"
    mport = free_port()
    cfg = port.ServerConfig(
        address="localhost:0", tracking_uri=uri,
        metrics_csv=str(tmp / f"{leg}.csv"),
        calibration_path=str(tmp / "none.npz"), reload_poll_s=0.2,
        reload_grace_s=DEPLOY_GRACE_S, metrics_port=mport,
        batch_window_ms=2.0 if batched else 0.0, max_batch=MAX_BATCH,
        drift_sustain_s=DRIFT_SUSTAIN_S, drift_cooldown_s=1e9)
    check(cfg.drift_enabled, "ServerConfig().drift_enabled is not the default")
    cursor = journal.JOURNAL.snapshot()["next_cursor"]
    server, servicer = grpc_service.build_server(
        cfg, warmup_shape=(DRIFT_W, DRIFT_H), device="cuda")
    server.start()
    channel = grpc.insecure_channel(f"localhost:{servicer.bound_port}")
    stub = vision_grpc.VisionAnalysisServiceStub(channel)
    dbg = json.loads(http_get(mport, "/debug/drift"))
    ref = dbg["reference"] or {}
    check((dbg["state"], ref.get("source"), ref.get("generation"),
           ref.get("n_frames"), dbg["model_version"])
          == ("scoring", "capture", 1, DRIFT_STREAM, 1),
          f"{leg}: /debug/drift reference {ref} state {dbg['state']}")
    page0 = http_get(mport, "/metrics").decode()

    def proto(rgb, depth):
        return vision_pb2.AnalysisRequest(
            color_image=vision_pb2.Image(data=rgb.tobytes(), width=DRIFT_W,
                                         height=DRIFT_H, format=1),
            depth_image=vision_pb2.Image(
                data=depth.astype("<u2").tobytes(), width=DRIFT_W,
                height=DRIFT_H, format=1),
            mask_format=1)

    def serve(frames, n: int) -> float:
        """``n`` of ``frames`` (cycled) over gRPC: one stream directly,
        STREAMS streams batched; returns the wall seconds."""
        reqs = [proto(*frames[i % len(frames)]) for i in range(n)]
        parts = ([reqs] if not batched else
                 [reqs[s::STREAMS] for s in range(STREAMS)])
        out: list = []
        errors: list = []

        def run(part):
            try:
                out.extend(stub.AnalyzeActuatorPerformance(iter(part),
                                                           timeout=300))
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=run, args=(p,)) for p in parts]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not errors, f"{leg}: a stream failed: {errors[:1]}")
        check(len(out) == n and not [r for r in out
                                     if r.status.startswith("ERROR")],
              f"{leg}: {len(out)} of {n} frames answered, statuses "
              f"{collections.Counter(r.status for r in out)}")
        return wall

    wall = serve(inside, DRIFT_STREAM)
    served = DRIFT_STREAM
    check(servicer.drift.recommendations_total == 0,
          f"{leg}: in-distribution traffic fired "
          f"{servicer.drift.recommendations[-1:]}")
    quiet = {k: round(v.psi, 4) for k, v in servicer.drift.scores.items()}
    n_shifted = 0
    while servicer.drift.recommendations_total == 0:
        check(n_shifted < DRIFT_MAX_SHIFTED, f"{leg}: no recommendation "
              f"after {n_shifted} shifted frames: scores "
              f"{servicer.drift.scores}")
        serve(shifted, DRIFT_CHUNK)
        n_shifted += DRIFT_CHUNK
    serve(shifted, DRIFT_CHUNK)  # past the excursion: no second one
    n_shifted += DRIFT_CHUNK
    served += n_shifted
    rec = servicer.drift.recommendations[-1]
    check(servicer.drift.recommendations_total == 1
          and "depth_valid_fraction" in rec.signals,
          f"{leg}: {servicer.drift.recommendations_total} recommendations, "
          f"the last on {rec.signals}")
    page = http_get(mport, "/metrics").decode()

    def delta(name):
        return metric_value(page, name) - metric_value(page0, name)

    recs = delta("rdp_drift_recommendations_total")
    margins = delta("rdp_model_confidence_margin_count")
    check(recs == 1 and margins == served,
          f"{leg}: /metrics moved rdp_drift_recommendations_total by {recs}"
          f" and rdp_model_confidence_margin_count by {margins} over "
          f"{served} frames")
    events = json.loads(http_get(mport, f"/debug/events?since={cursor}"))
    kinds = [e["kind"] for e in events["events"]]
    check("drift.recommendation" in kinds,
          f"{leg}: the journal lacks drift.recommendation: {kinds}")
    dbg = json.loads(http_get(mport, "/debug/drift"))
    shown = {k: v["psi"] for k, v in dbg["signals"].items()}
    check(dbg["signals"]["depth_valid_fraction"]["above_threshold"]
          and dbg["recommendations"]["count"] == 1,
          f"{leg}: /debug/drift scores {shown}")
    log(f"drift {leg} leg: reference capture v1; {DRIFT_STREAM} "
        f"in-distribution frames in {wall:.2f} s "
        f"({DRIFT_STREAM / wall:.1f} frames/s over gRPC), no "
        f"recommendation, psi {quiet}; one recommendation after "
        f"{n_shifted - DRIFT_CHUNK} shifted frames on {rec.signals} "
        f"(psi {json.dumps({k: round(v, 3) for k, v in rec.scores.items()})})"
        f", none in the next {DRIFT_CHUNK}; /metrics recommendations +1, "
        f"confidence margins +{margins:.0f}; /debug/drift psi "
        f"{ {k: None if v is None else round(v, 3) for k, v in shown.items()} }")
    if reload is not None:
        reload(servicer, mport, stub, proto)
    channel.close()
    grpc_service.shutdown(server, servicer)
    return {"frames": served}


def reload_leg(torch, port, cfg, arrays, frames, tmp: Path):
    """The direct leg's reload: the second retraining cycle (another seed)
    registers version 2, moves ``staging`` and writes its profile while a
    stream runs; after the reloader's swap /debug/drift's reference is
    version 2's capture and the engine serves version 2; every response of
    the stream is one version's answer; memory is back within
    deploy_phase's slacks."""
    import gc
    import threading

    from robotic_discovery_platform_tpu_torch.ops import graphs
    from robotic_discovery_platform_tpu_torch.workflows import retraining

    def run(servicer, mport, stub, proto):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()  # what earlier legs left cached
        mem0 = torch.cuda.memory_allocated()
        res0 = torch.cuda.memory_reserved()
        stop = threading.Event()
        got: list = []

        def feed():
            n = 0
            while not stop.is_set():
                yield proto(*frames[n % len(frames)])
                n += 1

        def stream():
            for i, r in enumerate(stub.AnalyzeActuatorPerformance(
                    feed(), timeout=600)):
                got.append((i % len(frames), r))

        thread = threading.Thread(target=stream, daemon=True)
        thread.start()
        t0 = time.perf_counter()
        res = retraining.run_retraining_pipeline(
            cfg, port.ModelConfig(), arrays=arrays, device="cuda")
        cycle_s = time.perf_counter() - t0
        check(res.succeeded and res.version == 2 and res.drift_profile_path,
              f"second retraining cycle: {res}")
        deadline = time.perf_counter() + 120
        while servicer.current_version != 2:
            check(time.perf_counter() < deadline, "no swap to version 2")
            time.sleep(0.01)
        swap_s = time.perf_counter() - t0
        time.sleep(1.0)
        stop.set()
        thread.join(timeout=120)
        check(not thread.is_alive(), "the reload leg's stream hung")
        # the pipeline moves the alias before it captures the profile
        # (the JAX package's order), so a reload that lands first adopts
        # a self-baseline stamped 2 (ROADMAP queue 3)
        dbg = json.loads(http_get(mport, "/debug/drift"))
        ref = dbg["reference"] or {}
        source = ref.get("source", "self-baseline (forming)")
        check(dbg["model_version"] == dbg["generation"] == 2
              and ref.get("generation", 2) == 2,
              f"after the swap /debug/drift reference {ref} generation "
              f"{dbg['generation']}, engine {dbg['model_version']}")
        check(servicer.version_and_reference() == (2, 2),
              f"version and reference {servicer.version_and_reference()}")
        # memory before this leg's own eager runs below (each keeps a
        # cuBLAS workspace of its thread and stream): after the old
        # generation's grace, a collection and the reloader's polls, no
        # graph pool but a live cache's holds memory (the cycle's train
        # steps and capture and the old generation are gone), allocated
        # memory is back, and reserved memory too once the allocator's
        # ordinary cache (the training's blocks: this process also
        # trained) is emptied
        time.sleep(DEPLOY_GRACE_S + 0.5)
        gc.collect()
        time.sleep(4 * 0.2)
        graphs.release_dead_pools()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        cached = torch.cuda.memory_reserved()
        pools = {tuple(seg.get("segment_pool_id", (0, 0)))
                 for seg in torch.cuda.memory_snapshot()} - {(0, 0)}
        live = {tuple(c._pool) for c in gc.get_objects()
                if isinstance(c, graphs.GraphCache) and c._pool is not None}
        torch.cuda.empty_cache()
        res1 = torch.cuda.memory_reserved()
        check(pools <= live, f"reload leg: graph pools {pools - live} of "
              f"dead caches or steps hold memory; {live_graphs()}")
        check(abs(mem1 - mem0) <= DEPLOY_SLACK
              and res1 <= res0 + DEPLOY_RESERVED_SLACK,
              f"reload leg: memory_allocated {mem0} -> {mem1}, "
              f"memory_reserved {res0} -> {res1} beyond deploy_phase's "
              f"slacks; {graph_pool_report(torch)}")
        # each response is version 1's or version 2's answer
        from robotic_discovery_platform_tpu_torch import tracking

        store = tracking.store_for(cfg.tracking_uri)
        k = port.default_intrinsics(DRIFT_W, DRIFT_H)
        answers = {}
        for v in (1, 2):
            _, net = tracking.load_model(
                f"models:/{cfg.registered_model_name}/{v}", store=store,
                device="cuda")
            analyze = port.make_frame_analyzer(
                port.FoldedUNet(net, device="cuda"), img_size=256,
                device="cuda")
            answers[v] = [analyze.eager(rgb, depth, k, 0.001).mask.cpu()
                          .numpy() for rgb, depth in frames]
            del analyze, net
        by = collections.Counter()
        for i, r in got:
            mask = port.decode_mask_wire(r.mask)
            versions = tuple(v for v in (1, 2)
                             if np.array_equal(mask, answers[v][i]))
            check(versions, f"reload leg frame {i}: a mask of neither "
                  "version")
            by[versions] += 1
        differ = sum(not np.array_equal(a, b)
                     for a, b in zip(answers[1], answers[2]))
        # where the two versions' masks differ on a frame, version 2 must
        # have answered some; else the swap shows in the engine version
        check(not differ or by[(2,)] > 0,
              f"no response of version 2 alone: {dict(by)}")
        log(f"reload leg: second retraining cycle {cycle_s:.1f} s (train, "
            f"register v2, staging, profile); swap {swap_s:.1f} s after "
            f"the cycle began; /debug/drift reference generation 2 "
            f"({source}) with engine version 2; {len(got)} responses during "
            f"the cycle by version {dict(by)} (the versions' masks differ "
            f"on {differ} of {len(frames)} frames); memory_allocated "
            f"{mem0 / 2**20:.1f} -> {mem1 / 2**20:.1f} MiB, reserved "
            f"{res0 / 2**20:.1f} -> {res1 / 2**20:.1f} MiB ("
            f"{cached / 2**20:.1f} before emptying the ordinary cache; "
            f"graph pools {sorted(pools)})")

    return run


def supervised_leg(torch, port, cfg, arrays, tmp: Path) -> None:
    """``run_supervised`` with ``fault_epoch=1`` over two epochs on the
    card against an unbroken run (the SUPERVISED_* bars), and which ops of
    a train step are not deterministic on the card."""
    import warnings

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.training import (
        checkpoint,
        supervisor,
        trainer,
    )

    def cfg_in(name, **kw):
        return dataclasses.replace(
            cfg, tracking_uri=f"file:{tmp}/{name}/mlruns",
            checkpoint_dir=str(tmp / name / "ckpt"), **kw)

    sup = cfg_in("supervised")
    t0 = time.perf_counter()
    res = supervisor.run_supervised(sup, port.ModelConfig(), fault_epoch=1,
                                    max_restarts=1, device="cuda",
                                    attempt_timeout_s=600, arrays=arrays)
    sup_s = time.perf_counter() - t0
    check(res.restarts == 1 and res.epochs_run == 1
          and res.registry_version == 1,
          f"supervised run: {res.restarts} restarts, {res.epochs_run} "
          f"epochs after the restart, version {res.registry_version}")
    unbroken = cfg_in("unbroken")
    t0 = time.perf_counter()
    ures = trainer.train_model(unbroken, port.ModelConfig(), arrays=arrays,
                               register=False, device="cuda")
    unbroken_s = time.perf_counter() - t0

    def state(c, step):
        return checkpoint.CheckpointManager(c.checkpoint_dir).restore(step)

    def apart(a, b) -> float:
        diffs = [float((a["model"][k].double() - b["model"][k].double())
                       .abs().max()) for k in a["model"]]
        for pid, st in a["optimizer"]["state"].items():
            for k, v in st.items():
                diffs.append(float((v.double() - b["optimizer"]["state"][pid][
                    k].double()).abs().max()))
        return max(diffs)

    s2, u2 = state(sup, 2), state(unbroken, 2)
    first, final = apart(state(sup, 1), state(unbroken, 1)), apart(s2, u2)
    steps = [{float(s["step"]) for s in x["optimizer"]["state"].values()}
             for x in (s2, u2)]

    def losses_of(c, run_id):
        store = tracking.store_for(c.tracking_uri)
        return {key: [h["value"] for h in store.get_metric_history(run_id, key)]
                for key in ("train_loss", "val_loss")}

    got, want = losses_of(sup, res.run_id), losses_of(unbroken, ures.run_id)
    loss_ok = (abs(got["train_loss"][-1] - want["train_loss"][-1])
               <= SUPERVISED_LOSS_RTOL * abs(want["train_loss"][-1]))
    check(first <= SUPERVISED_SAME_ATOL and final <= SUPERVISED_SAME_ATOL
          and loss_ok and steps[0] == steps[1] == {8.0},
          f"supervised against unbroken: epoch 1 {first}, final {final} "
          f"apart (bar {SUPERVISED_SAME_ATOL}), epoch-2 losses {got} vs "
          f"{want}, Adam steps {steps}")
    # which ops of one eager train step are not deterministic here
    xs, ys = trainer.normalize_arrays(*arrays)
    x = torch.from_numpy(xs[:TRAIN_BATCH]).cuda()
    y = torch.from_numpy(ys[:TRAIN_BATCH]).cuda()
    grads = []
    for _ in range(2):
        net = trainer.init_model(port.ModelConfig(), SEED, torch.device("cuda"))
        opt = trainer.make_optimizer(net, 1e-4)
        trainer.train_step(net, opt, losses.make_loss_fn("bce"), x, y)
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
    differ = sorted(n for n in grads[0]
                    if not torch.equal(grads[0][n], grads[1][n]))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train_step(net, opt, losses.make_loss_fn("bce"), x, y)
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" does not have")[0]
                      for w in caught if "deterministic" in str(w.message)})
    log(f"supervised leg: run_supervised(fault_epoch=1) restarted "
        f"{res.restarts} time(s) in {sup_s:.1f} s (two child interpreters;"
        f" the unbroken run {unbroken_s:.1f} s in process); against the "
        f"unbroken run, epoch-1 state {first:.3g} and final state "
        f"{final:.3g} apart "
        f"({'bit for bit' if first == final == 0 else 'not bit for bit'}), "
        f"epoch-2 losses {got} vs {want}, Adam steps {steps[0]}; two eager steps "
        f"from one state: {len(differ)} of {len(grads[0])} gradients "
        f"differ ({differ[:4]}); ops without a deterministic CUDA "
        f"implementation in the step: {flagged or 'none flagged'}")


def drift_cost_leg(torch, port) -> None:
    """The monitor's host cost, printed and not gated: frames/s over one
    stream, 8 direct and 8 batched streams with the monitor on (the
    default) and off, in turns (on, off, off, on), and its microseconds
    per frame (``tools/torch_serving_cost.py``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_serving_cost",
        Path(__file__).resolve().parent / "tools" / "torch_serving_cost.py")
    cost = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cost)
    smoke = sys.modules[__name__]
    rng = np.random.default_rng(SEED)
    frames = [port.render_scene(rng, FRAME_H, FRAME_W) for _ in range(8)]
    requests = [port.raw_request(rgb, depth, mask_format=i % 3)
                for i, (rgb, _, depth) in enumerate(frames)]
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    folded = port.FoldedUNet(seeded_model(torch, port, x0), device="cuda")
    rows = []
    for name in ("base", "drift", "drift", "base"):
        with cost.switched_off(torch, cost.OFF[name]):
            got = cost.measure(port, smoke, folded, requests, 2)["median"]
        rows.append((name, {k: round(v, 1) for k, v in got.items()
                            if k.endswith("fps")}))
    log(f"drift host cost (monitor on = base, off = drift; medians of 2, "
        f"in turns): {rows}; one frame's drift work on the host "
        f"{ {k: round(v, 2) for k, v in cost.drift_us().items()} } us "
        f"[{nvidia_smi_line()}]")


def drift_phase(torch, port) -> dict:
    """The drift loop on the card at ``ModelConfig()``: a retraining cycle
    (phase 6's training setting) registers version 1, promotes it and
    writes its drift profile, held against a CPU capture
    (``capture_leg``); servers from ``@staging`` monitor in-distribution
    and shifted traffic directly and batched (``drift_leg``); a second
    cycle's reload adopts version 2's reference (``reload_leg``); the
    supervised trainer restarts once (``supervised_leg``); the monitor's
    host cost (``drift_cost_leg``). Returns the launches of the phase."""
    import gc

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.observability import (
        instruments as obs,
    )
    from robotic_discovery_platform_tpu_torch.ops import graphs
    from robotic_discovery_platform_tpu_torch.training import synthetic
    from robotic_discovery_platform_tpu_torch.workflows import retraining

    log(f"drift_phase: {torch.cuda.get_device_name(0)} [{nvidia_smi_line()}]")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_drift_"))
    cfg = port.TrainConfig(epochs=2, batch_size=TRAIN_BATCH, img_size=256,
                           learning_rate=1e-4, loss="bce", seed=SEED,
                           tracking_uri=f"file:{tmp}/mlruns",
                           checkpoint_dir=str(tmp / "ckpt"))
    arrays = synthetic.generate_arrays(TRAIN_SAMPLES, 256, 256, seed=SEED)
    failures = obs.DRIFT_PROFILE_FAILURES.value
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    mem0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    reset_launches()
    t0 = time.perf_counter()
    res = retraining.run_retraining_pipeline(cfg, port.ModelConfig(),
                                             arrays=arrays, device="cuda")
    cycle_s = time.perf_counter() - t0
    launches = read_launches()
    check(res.succeeded and (res.version, res.promoted_alias)
          == (1, "staging") and res.drift_profile_path is not None
          and obs.DRIFT_PROFILE_FAILURES.value == failures,
          f"retraining cycle on the card: {res}")
    steps = cfg.epochs * 4
    capture = frame_launches(16)
    want = {k: capture[k] for k in capture}
    want["conv3x3_bn_relu"] += 35 * steps
    want["conv3x3_grad_weights"] += 18 * steps
    check(launches == want, f"retraining cycle launches {launches}, want "
          f"{want} ({steps} steps, 16 captured frames)")
    gc.collect()
    graphs.release_dead_pools()
    torch.cuda.synchronize()
    mem1, res1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    check(abs(mem1 - mem0) <= DEPLOY_SLACK
          and res1 <= res0 + DEPLOY_RESERVED_SLACK,
          f"after the cycle memory_allocated {mem0} -> {mem1}, reserved "
          f"{res0} -> {res1}: the capture's graphs outlived it")
    log(f"retraining cycle: {cycle_s:.1f} s (train {TRAIN_SAMPLES} samples "
        f"x {cfg.epochs} epochs, register, staging, capture 16 frames); "
        f"launches {launches}; memory_allocated {mem0 / 2**20:.1f} -> "
        f"{mem1 / 2**20:.1f} MiB, reserved {res0 / 2**20:.1f} -> "
        f"{res1 / 2**20:.1f} MiB around it")
    capture_leg(torch, port, cfg, res)
    inside = drift_scenes(port, SEED + 1, DRIFT_STREAM)
    shifted = drift_scenes(port, SEED + 1, DRIFT_STREAM, shifted=True)
    bias_leg(torch, port, cfg.tracking_uri, tmp, inside)
    # the served legs' reference: version 1's profile captured again over
    # as many scenes as the live window holds, so the PSI of two equal
    # distributions sits at its noise floor (bias_leg)
    t0 = time.perf_counter()
    path = retraining.capture_drift_profile(
        1, model_name=cfg.registered_model_name,
        tracking_uri=cfg.tracking_uri, n_frames=DRIFT_STREAM,
        img_size=cfg.img_size, device="cuda")
    recapture_s = time.perf_counter() - t0
    check(path == res.drift_profile_path, f"profile written to {path}")
    log(f"version 1's profile captured again over {DRIFT_STREAM} scenes "
        f"in {recapture_s:.1f} s")

    cfg2 = dataclasses.replace(cfg, seed=SEED + 1,
                               checkpoint_dir=str(tmp / "ckpt2"))
    arrays2 = synthetic.generate_arrays(TRAIN_SAMPLES, 256, 256,
                                        seed=SEED + 1)
    serving = ("conv3x3_bn_relu", "conv1x1", "deproject_edge_stats",
               "bspline_design", "bspline_curvature", "bitpack_mask")
    for batched in (False, True):
        # each leg from version 1 (the direct leg's reload moves staging)
        tracking.store_for(cfg.tracking_uri).set_alias(
            cfg.registered_model_name, "staging", 1)
        reset_launches()
        drift_leg(torch, port, cfg.tracking_uri, tmp, batched, inside,
                  shifted, reload=None if batched else reload_leg(
                      torch, port, cfg2, arrays2, inside[:8], tmp))
        leg = read_launches()
        check(all(leg[k] > 0 for k in serving),
              f"drift {'batched' if batched else 'direct'} leg launches "
              f"{leg}: a serving kernel never ran")
        launches = {k: launches[k] + leg[k] for k in launches}
    supervised_leg(torch, port, cfg, arrays, tmp)
    drift_cost_leg(torch, port)
    return launches


# -- the model zoo, the SLO controller and the rollout ------------------------

ZOO_MODELS = ("seg", "multi", "aux")
#: the aux variant's 18 conv3x3_bn_relu launches (base 16: every width of
#: MAIN_PATH_3X3 over 4 but the input's 3 channels), and the multi
#: variant's 4-class head (H = W, Cin, Cout)
AUX_3X3 = [(s, cin if cin == 3 else cin // 4, cout // 4)
           for s, cin, cout in MAIN_PATH_3X3]
HEAD4 = (256, 64, 4)
#: the request ``model`` of each of the batched leg's 8 mixed streams
ZOO_STREAM_MODELS = ("", "multi", "aux", "seg")
ZOO_ROUNDS = 4  # each stream sends the 8 frames this many times


def zoo_kernel_cases(torch, conv) -> dict:
    """conv3x3_bn_relu at every shape of the aux variant at 256x256 and
    conv1x1 at the multi variant's [1, 256, 256, 64] -> 4 head (and the
    Cout = 1 head beside it), each against its plain version within
    BF16_TOL, called twice (equal bit for bit), with the profiler's
    device ms beside the plain version's and the bound. Returns the
    per-frame sums."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    seen = {}
    for s, cin, cout in sorted(set(AUX_3X3), key=AUX_3X3.index):
        x = rand(1, s, s, cin).to(torch.bfloat16)
        wt = rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(torch.bfloat16)
        scale = torch.rand(cout, generator=gen, device="cuda") + 0.5
        bias = rand(cout, scale=0.1)
        got = conv.conv3x3_bn_relu(x, wt, scale, bias)
        want = conv.conv3x3_bn_relu_plain(x, wt, scale, bias)
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), atol=BF16_TOL,
                             rtol=BF16_TOL),
              f"conv3x3_bn_relu aux {(s, cin, cout)}: max |err| {err} over "
              f"tolerance {BF16_TOL}")
        check(torch.equal(conv.conv3x3_bn_relu(x, wt, scale, bias), got),
              f"conv3x3_bn_relu aux {(s, cin, cout)}: two calls differ")
        ms = device_ms(torch, lambda: conv.conv3x3_bn_relu(x, wt, scale,
                                                           bias))
        plain = device_ms(torch, lambda: conv.conv3x3_bn_relu_plain(
            x, wt, scale, bias))
        bound, by = bound_ms(*flops_lib().conv3x3_bn_relu_cost(
            1, s, s, cin, cout))
        seen[(s, cin, cout)] = (ms, plain, bound, err)
        log(f"conv3x3_bn_relu aux [1,{s},{s},{cin}]->{cout} bfloat16: "
            f"max|err| {err:.3g} (tol {BF16_TOL}), deterministic; device "
            f"ms {ms:.4f} plain {plain:.4f} bound {bound:.5f} ({by}); "
            f"{conv.fwd_plan(1, s, s, cin, cout)[0]} K splits; Cout tile "
            f"64, {min(cout, 64) / 64:.0%} of it used")
    rows = [seen[s] for s in AUX_3X3]
    out = {"aux_3x3_ms": sum(r[0] for r in rows),
           "aux_3x3_plain_ms": sum(r[1] for r in rows),
           "aux_3x3_bound_ms": sum(r[2] for r in rows),
           "aux_3x3_max_abs_err": max(r[3] for r in rows)}
    log("conv3x3_bn_relu, the aux variant's 18 launches of one frame: "
        + ", ".join(f"{k[8:]} {v:.4f}" for k, v in out.items()))
    s, cin, _ = HEAD4
    x = rand(1, s, s, cin).to(torch.bfloat16)
    for cout in (4, 1):
        wt = rand(cin, cout, scale=cin ** -0.5).to(torch.bfloat16)
        scale = torch.ones(cout, device="cuda")
        bias = rand(cout, scale=0.1)

        def kernel():
            return conv.conv1x1(x, wt, scale, bias, relu=False,
                                out_dtype=torch.float32)

        def plain():
            return conv.conv1x1_plain(x, wt, scale, bias, relu=False,
                                      out_dtype=torch.float32)

        got, want = kernel(), plain()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL),
              f"conv1x1 [1,{s},{s},{cin}]->{cout}: max |err| {err} over "
              f"tolerance {BF16_TOL}")
        check(torch.equal(kernel(), got),
              f"conv1x1 [1,{s},{s},{cin}]->{cout}: two calls differ")
        path = conv.conv1x1_path(torch.bfloat16, cin, cout, x_aligned=True)
        check(path == ("fma" if cout > 1 else "head"),
              f"conv1x1 ->{cout} takes path {path}")
        xc = x.permute(0, 3, 1, 2)
        wc = wt.t().reshape(cout, cin, 1, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return (torch.nn.functional.conv2d(xc, wc).float()
                    * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1))

        ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain)
        lib_ms = device_ms(torch, library)
        # CUDA events over back-to-back calls beside the profiler's sum
        # (an upper bound: the host's cost per call is in it)
        call_ms = time_ms(torch, kernel)
        lib_call_ms = time_ms(torch, library)
        bound, by = bound_ms(*flops_lib().conv1x1_cost(1, s, s, cin, cout))
        out[f"head{cout}_ms"], out[f"head{cout}_bound_ms"] = ms, bound
        out[f"head{cout}_plain_ms"], out[f"head{cout}_err"] = plain_ms, err
        out[f"head{cout}_library_ms"] = lib_ms
        out[f"head{cout}_call_ms"] = call_ms
        log(f"conv1x1 [1,{s},{s},{cin}]->{cout} bfloat16->float32 ({path}"
            f" path): max|err| {err:.3g} (tol {BF16_TOL}), deterministic; "
            f"device ms {ms:.4f} plain {plain_ms:.4f} cudnn {lib_ms:.4f} "
            f"bound {bound:.5f} ({by}); ms per call back to back "
            f"{call_ms:.4f} cudnn {lib_call_ms:.4f}")
    return out


def register_named(port, nets: dict, uri: str) -> dict:
    """Each (registered name -> UNet) as the next version of that name in
    the registry at ``uri``, under ``staging``; returns the versions."""
    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models import weights

    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    store = tracking.store_for(uri)
    versions = {}
    with tracking.start_run():
        for name, net in nets.items():
            versions[name] = tracking.log_model(
                weights.to_flax_variables(net), net.cfg,
                registered_model_name=name)
            store.set_alias(name, "staging", versions[name])
    return versions


def answers(responses) -> list:
    """The comparable fields of responses: status, mask, coverage,
    curvatures and the packed spline."""
    return [(r.status, r.mask, r.mask_coverage, r.mean_curvature,
             r.max_curvature, r.packed_spline) for r in responses]


def without_anomaly(rows) -> list:
    return [(r[0].split(" anomaly=")[0],) + r[1:] for r in rows]


def batched_bar(got: list, want: list, what: str) -> None:
    """The batched path against the direct one (``servicer_phase``'s bar):
    statuses, mask bytes and coverage equal; curvature within GEOM_RTOL
    (a dispatch of B > 1 frames runs the reference geometry ops)."""
    check(len(got) == len(want), f"{what}: {len(got)} answers, want "
          f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(g[:3] == w[:3] and (not g[0].startswith("OK") or np.allclose(
            g[3:5], w[3:5], rtol=GEOM_RTOL, atol=0)),
              f"{what} frame {i}: {g[0]!r} vs {w[0]!r}, curvature "
              f"{g[3:5]} vs {w[3:5]}")


def union_and_anomaly(torch, port, frames, multi, aux, multi_out,
                      aux_out) -> None:
    """The 4-class head on the card, as the JAX package defines it: the
    served mask (through the packed row) is the union over classes of
    sigmoid > 0.5 of the folded net's logits, resized nearest; and the
    aux head's status carries 1 - 2 x its confidence margin (mean
    |sigmoid - 0.5| of its logits)."""
    F = torch.nn.functional
    for (rgb, _), resp in zip(frames, multi_out):
        x = port.preprocess(torch.from_numpy(rgb).cuda()[None], 256)
        with torch.no_grad():
            logits = port.FoldedUNet(multi, device="cuda")(x)
        prob = torch.sigmoid(logits)
        union = (prob.amax(-1) > 0.5).float()[:, None]
        want = F.interpolate(union, size=rgb.shape[:2],
                             mode="nearest-exact")[0, 0].to(torch.uint8)
        got = port.decode_mask_wire(resp.mask)
        per_class = [float((prob[..., c] > 0.5).float().mean())
                     for c in range(prob.shape[-1])]
        check(np.array_equal(got, want.cpu().numpy()),
              f"multi: the served mask is not the union of the classes "
              f"(class coverage {per_class})")
        log(f"multi: served mask = union over 4 classes bit for bit; "
            f"coverage per class {[round(c, 4) for c in per_class]}, "
            f"union {float(union.mean()):.4f}")
    for (rgb, _), resp in zip(frames, aux_out):
        x = port.preprocess(torch.from_numpy(rgb).cuda()[None], 256)
        with torch.no_grad():
            logits = port.FoldedUNet(aux, device="cuda")(x)
        margin = float(torch.mean(torch.abs(torch.sigmoid(logits) - 0.5)))
        score = float(resp.status.rsplit("anomaly=", 1)[1])
        check(abs(score - (1.0 - 2.0 * margin)) <= 1e-4,
              f"aux: status score {score}, 1 - 2 x margin "
              f"{1.0 - 2.0 * margin}")
        log(f"aux: status {resp.status!r}, 1 - 2 x margin "
            f"{1.0 - 2.0 * margin:.6f}")


def resident_mib(torch, forward, analyzer) -> tuple:
    """One zoo entry's memory on the card, MiB: its folded weights and the
    reserved segments of its direct analyzer's graph pool."""
    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                yield from tensors(y)
        elif isinstance(x, dict):
            for y in x.values():
                yield from tensors(y)

    weights = sum(t.untyped_storage().nbytes()
                  for t in tensors(forward._layers))
    pool = analyzer.graphs._pool
    graph = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if pool is not None
                and tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool))
    return weights / 2**20, graph / 2**20


def zoo_phase(torch, port, conv, frames=None) -> dict:
    """The model zoo at ``ModelConfig()``: its kernels at the aux and
    4-class shapes (``zoo_kernel_cases``); a registry of the three
    variants, seeded and calibrated as ``seeded_model``; a direct zoo
    server (``zoo_models="multi,aux"``) whose "", "seg", "multi" and
    "aux" answers equal single-model servicers of each bit for bit, with
    exact launches per frame per model, an unknown name answered per
    frame, device ms and peak memory per model, ``/debug/zoo`` and the
    ``model`` labels of ``/metrics``; a batched zoo server under 8 mixed
    streams (every answer its model's, no dispatch mixing models) against
    8 seg-only streams; ``zoo_eager_warm`` 1 against -1. Returns the
    phase's launches."""
    import gc

    from robotic_discovery_platform_tpu_torch.models import variants
    from robotic_discovery_platform_tpu_torch.serving import (
        grpc_service,
        server as server_lib,
    )

    log(f"zoo_phase: {torch.cuda.get_device_name(0)} [{nvidia_smi_line()}]")
    figures = zoo_kernel_cases(torch, conv)
    if frames is None:
        rng = np.random.default_rng(SEED)
        frames = [port.render_scene(rng, FRAME_H, FRAME_W)[::2]
                  for _ in range(8)]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_zoo_"))
    uri = f"file:{tmp}/mlruns"
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    base = port.ServerConfig().model_name
    names = {m: variants.registered_name(variants.VARIANTS[m], base)
             for m in ZOO_MODELS}
    nets = {names[m]: seeded_model(
        torch, port, x0, variants.VARIANTS[m].model_config(port.ModelConfig()))
        for m in ZOO_MODELS}
    register_named(port, nets, uri)
    mport = free_port()

    def cfg(**fields):
        return port.ServerConfig(
            address="localhost:0", tracking_uri=uri,
            metrics_csv=str(tmp / "m.csv"),
            calibration_path=str(tmp / "none.npz"), reload_poll_s=0.0,
            **fields)

    total = launches_of()

    def tally():
        got = read_launches()
        for k in total:
            total[k] += got[k]
        reset_launches()
        return got

    reset_launches()
    t0 = time.perf_counter()
    server, zoo = grpc_service.build_server(
        cfg(zoo_models="multi,aux", metrics_port=mport),
        warmup_shape=(FRAME_W, FRAME_H), device="cuda")
    warm_s = time.perf_counter() - t0
    server.start()
    singles = {m: server_lib.build_service(
        cfg(model_name=names[m]), warmup_shape=(FRAME_W, FRAME_H),
        device="cuda") for m in ZOO_MODELS}
    tally()
    check(zoo.zoo.names() == ZOO_MODELS, f"zoo roster {zoo.zoo.names()}")

    def reqs(model):
        return [port.raw_request(rgb, depth, mask_format=1, model=model)
                for rgb, depth in frames]

    want = {m: answers(singles[m].analyze_stream(iter(reqs(""))))
            for m in ZOO_MODELS}
    tally()
    page0 = http_get(mport, "/metrics").decode()
    per_model = {}
    for model in ("", "seg", "multi", "aux"):
        name = model or "seg"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        got = answers(zoo.analyze_stream(iter(reqs(model))))
        peak = torch.cuda.max_memory_allocated() - base_mem
        counted = tally()
        check(counted == frame_launches(len(frames), served=True),
              f"zoo model {model!r}: launches {counted} for {len(frames)} "
              f"frames, want 18/1/1/1/1/1 per frame")
        if name == "aux":
            check(all(" anomaly=" in g[0] and 0.0 <= float(
                g[0].rsplit("anomaly=", 1)[1]) <= 1.0 for g in got),
                f"aux statuses {[g[0] for g in got]}")
            got = without_anomaly(got)
        check(got == want[name], f"zoo model {model!r}: answers differ from "
              f"its single-model servicer's")
        entry = zoo.zoo.get(name)
        analyze = zoo.analyze if name == "seg" else entry.analyze
        resident = resident_mib(
            torch, zoo._engine.forward if name == "seg" else entry.forward,
            analyze)
        rgb, depth = frames[0]
        with torch.cuda.device(0):
            k, scale = zoo._geometry(FRAME_W, FRAME_H).staged()
            ms = device_ms(torch, lambda: analyze(rgb, depth, k, scale))
        tally()
        per_model[model] = (ms, peak, resident)
        log(f"zoo model {model!r}: {len(frames)} frames bit for bit equal "
            f"to its own servicer's, launches per frame "
            f"{ {k: v // len(frames) for k, v in counted.items() if v} }; "
            f"device ms per frame {ms:.4f}; peak allocated over the stream "
            f"{peak / 2**20:.1f} MiB above {base_mem / 2**20:.1f} MiB; "
            f"resident: folded weights {resident[0]:.1f} MiB, the direct "
            f"graph's pool {resident[1]:.1f} MiB")
    union_and_anomaly(torch, port, frames, nets[names["multi"]],
                      nets[names["aux"]],
                      zoo.analyze_stream(iter(reqs("multi")[:2])),
                      zoo.analyze_stream(iter(reqs("aux")[:2])))
    tally()
    del nets
    got = list(zoo.analyze_stream(iter([
        port.raw_request(*frames[0], mask_format=1, model="nope"),
        port.raw_request(*frames[0], mask_format=1)])))
    check(got[0].status.startswith("ERROR: UnknownModel")
          and answers(got[1:]) == want["seg"][:1],
          f"an unknown model: statuses {[r.status for r in got]}")
    tally()
    dbg = json.loads(http_get(mport, "/debug/zoo"))
    page = http_get(mport, "/metrics").decode()
    served = {n: dbg["models"][n]["frames"] for n in ZOO_MODELS}
    labelled = {n: sum(metric_value(page, "rdp_frames_total", status=s,
                                    model=n)
                       - metric_value(page0, "rdp_frames_total", status=s,
                                      model=n)
                       for s in ("ok", "degraded", "error"))
                for n in ZOO_MODELS}
    check(sorted(dbg["models"]) == sorted(ZOO_MODELS)
          and labelled == served
          and served == {"seg": 2 * len(frames) + 1,
                         "multi": len(frames) + 2, "aux": len(frames) + 2},
          f"/debug/zoo frames {served}, /metrics model labels {labelled}")
    log(f"zoo direct leg: warm-up {warm_s:.2f} s; /debug/zoo models "
        f"{sorted(dbg['models'])} frames {served}; /metrics "
        f"rdp_frames_total by model {labelled}")
    grpc_service.shutdown(server, zoo)
    for s in singles.values():
        s.close()
    del zoo, singles, server
    gc.collect()

    # the batched path: 8 mixed streams, then 8 seg-only streams
    def batched(eager: int):
        t0 = time.perf_counter()
        service = server_lib.build_service(
            cfg(zoo_models="multi,aux", batch_window_ms=2.0,
                max_batch=MAX_BATCH, zoo_eager_warm=eager),
            warmup_shape=(FRAME_W, FRAME_H), device="cuda")
        warm = time.perf_counter() - t0
        d = service.dispatcher
        caps = {"seg": len(d._analyze.graphs.graphs)}
        for e in service.zoo.extras():
            caps[e.name] = len(e.batch_analyze.graphs.graphs)
        return service, warm, caps

    full, full_warm, full_caps = batched(-1)
    full.close()
    del full
    gc.collect()
    service, capped_warm, capped_caps = batched(1)
    check(capped_caps == {"seg": 4, "multi": 1, "aux": 1}
          and full_caps == {"seg": 4, "multi": 4, "aux": 4},
          f"captures per model at warm-up: zoo_eager_warm 1 {capped_caps},"
          f" -1 {full_caps}")
    log(f"zoo warm-up, batched: zoo_eager_warm 1 {capped_warm:.2f} s, "
        f"captures {capped_caps}; -1 {full_warm:.2f} s, captures "
        f"{full_caps}")
    tally()
    groups: list = []
    launch = service.dispatcher._launch_group

    def spy(group, *a, **kw):
        groups.append({p.model for p in group})
        return launch(group, *a, **kw)

    service.dispatcher._launch_group = spy

    def mixed(models):
        streams = [reqs(models[i % len(models)]) * ZOO_ROUNDS
                   for i in range(STREAMS)]
        out, wall = concurrent_streams(service, streams)
        for i, resp in enumerate(out):
            name = models[i % len(models)] or "seg"
            got = answers(resp)
            if name == "aux":
                got = without_anomaly(got)
            batched_bar(got, want[name] * ZOO_ROUNDS,
                        f"batched stream {i} ({name})")
        return STREAMS * len(frames) * ZOO_ROUNDS / wall

    fps_mixed = mixed(ZOO_STREAM_MODELS)
    mixed_groups = list(groups)
    fps_seg = mixed(("",))
    check(all(len(g) == 1 for g in groups),
          f"a dispatch mixed models: {[g for g in groups if len(g) > 1]}")
    check({m for g in mixed_groups for m in g} == {"", "multi", "aux"},
          f"dispatched models {mixed_groups[:8]}")
    sizes = dict(service.dispatcher.dispatch_sizes)
    log(f"zoo batched leg: 8 streams mixing {ZOO_STREAM_MODELS} "
        f"{fps_mixed:.1f} frames/s, 8 seg-only streams {fps_seg:.1f} "
        f"frames/s (same process, {len(frames) * ZOO_ROUNDS} frames a "
        f"stream); every answer its model's direct one (statuses, masks "
        f"and coverage equal, curvature within {GEOM_RTOL}); "
        f"{len(groups)} dispatches, each of one model; dispatch sizes "
        f"{sizes}")
    service.close()
    tally()
    figures.update({
        "fps_mixed": fps_mixed, "fps_seg": fps_seg,
        "ms": {m or "default": v[0] for m, v in per_model.items()},
        "peak_mib": {m or "default": v[1] / 2**20
                     for m, v in per_model.items()},
        "resident_mib": {m or "default": v[2] for m, v in per_model.items()},
        "warm_s": {"capped": capped_warm, "full": full_warm}})
    log(f"zoo_phase figures: {json.dumps(figures)}")
    return total


CONTROLLER_STREAMS = 16  # closed-loop streams of the overload leg
CONTROLLER_FRAMES = 4  # frames per stream: the leg opens streams anew
CONTROLLER_TIMEOUT_S = 60.0  # to reach rung 3, and to come back to 0
CONTROLLER_CALIBRATION = 640  # frames of each calibration load


def controller_phase(torch, port, folded=None, frames=None) -> dict:
    """The reactive SLO controller on the card, batched (``batch_window_ms
    =2``, ``max_batch=8``). The idle leg: enabled with ``slo_ms`` far
    above any latency, 8 streams' responses equal the controller-off
    servicer's bit for bit. The overload leg: on a controller-off gRPC
    server and with the leg's own traffic, one stream's ``proc_time_ms``
    at the quantile the ladder's way down tolerates (1 - burn_low x
    slo_budget) and 16 streams' p50, measured first; a gRPC server whose
    ``slo_ms`` is their geometric mean, its controller ticking every 0.1 s
    (sustain 0.2 s, cooldown 0.3 s), under 16 closed-loop gRPC streams of
    CONTROLLER_FRAMES frames opened anew: the ladder reaches level 3 and
    refuses every other new stream (UNAVAILABLE); then one stream: the
    ladder comes back to 0. Prints the time to each rung and back and the
    controller's /metrics. Returns the phase's launches."""
    import threading

    import grpc

    from robotic_discovery_platform_tpu_torch.serving import grpc_service
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        vision_grpc,
        vision_pb2,
    )

    log(f"controller_phase: {torch.cuda.get_device_name(0)} "
        f"[{nvidia_smi_line()}]")
    if folded is None:
        folded, frames = phase_model(torch, port)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_controller_"))
    reset_launches()
    reqs = [port.raw_request(rgb, depth, mask_format=1)
            for rgb, depth in frames]

    def cfg(**fields):
        return port.ServerConfig(
            address="localhost:0", metrics_csv=str(tmp / "m.csv"),
            calibration_path=str(tmp / "none.npz"), batch_window_ms=2.0,
            max_batch=MAX_BATCH, **fields)

    def servicer(**fields):
        service = port.VisionAnalysisService(folded, cfg=cfg(**fields),
                                             device="cuda")
        service.warmup(FRAME_W, FRAME_H)
        return service

    # the idle leg: one stream (a frame a dispatch, so the answers are
    # bit for bit comparable), then 8 under the batched bar
    streams = [[reqs[(i + j) % len(reqs)] for j in range(len(reqs))] * 2
               for i in range(STREAMS)]
    serial = [reqs * 4]
    off = servicer()
    want1, _ = concurrent_streams(off, serial)
    want8, _ = concurrent_streams(off, streams)
    off.close()
    on = servicer(slo_ms=1e6, controller_enabled=True,
                  controller_interval_s=0.1, controller_sustain_s=0.2,
                  controller_cooldown_s=0.3)
    check(on.controller is not None, "the controller was not built")
    got1, _ = concurrent_streams(on, serial)
    actions1 = on.controller.actions_total
    got8, _ = concurrent_streams(on, streams)
    actions = on.controller.actions_total
    on.close()
    check(answers(got1[0]) == answers(want1[0]) and actions1 == 0,
          f"idle controller, one stream: a response differs from the "
          f"controller-off servicer's ({actions1} actions)")
    for i, (g, w) in enumerate(zip(got8, want8)):
        batched_bar(answers(g), answers(w), f"idle controller stream {i}")
    log(f"controller idle leg: slo_ms 1e6; one stream of {len(serial[0])} "
        f"frames bit for bit equal to the controller-off servicer's, no "
        f"action; {STREAMS} streams x {len(streams[0])} frames within the "
        f"batched bar, {actions - actions1} actions (level-0 tuning)")

    # the overload leg. The controller leaves a rung only while fewer than
    # burn_low x slo_budget of the last slo_window frames violate the
    # objective, so what one stream must keep under it is that tail, not
    # its median; 16 streams' median must breach it. Both are measured
    # over gRPC with the leg's own traffic (streams of CONTROLLER_FRAMES
    # frames opened anew) on a controller-off server.
    protos = [vision_pb2.AnalysisRequest(
        color_image=vision_pb2.Image(data=rgb.tobytes(), width=FRAME_W,
                                     height=FRAME_H, format=1),
        depth_image=vision_pb2.Image(data=depth.astype("<u2").tobytes(),
                                     width=FRAME_W, height=FRAME_H,
                                     format=1),
        mask_format=1) for rgb, depth in frames]
    base = port.ServerConfig()
    keep_q = 1.0 - base.controller_burn_low * base.slo_budget
    pserver, pservice = grpc_service.build_server(
        cfg(), folded, warmup_shape=(FRAME_W, FRAME_H), device="cuda")
    pserver.start()
    pchannel = grpc.insecure_channel(f"localhost:{pservice.bound_port}")
    pstub = vision_grpc.VisionAnalysisServiceStub(pchannel)
    one = grpc_proc_times(grpc, pstub, protos, 1,
                          CONTROLLER_CALIBRATION // CONTROLLER_FRAMES)
    many = grpc_proc_times(grpc, pstub, protos, CONTROLLER_STREAMS,
                           CONTROLLER_CALIBRATION // CONTROLLER_FRAMES
                           // CONTROLLER_STREAMS)
    pchannel.close()
    grpc_service.shutdown(pserver, pservice)
    p50_1 = float(np.median(one))
    tail_1 = float(np.quantile(one, keep_q))
    p50_16 = float(np.median(many))
    check(p50_16 > tail_1, f"16 streams' p50 {p50_16:.2f} ms is not above "
          f"one stream's q{keep_q} {tail_1:.2f} ms: no objective separates "
          "the loads")
    slo_ms = float(np.sqrt(tail_1 * p50_16))
    mport = free_port()
    server, service = grpc_service.build_server(
        cfg(slo_ms=slo_ms, controller_enabled=True,
            controller_interval_s=0.1, controller_sustain_s=0.2,
            controller_cooldown_s=0.3, metrics_port=mport),
        folded, warmup_shape=(FRAME_W, FRAME_H), device="cuda")
    server.start()
    channel = grpc.insecure_channel(f"localhost:{service.bound_port}")
    stub = vision_grpc.VisionAnalysisServiceStub(channel)
    levels = [(time.perf_counter(), 0)]
    done = threading.Event()

    def watch():
        while not done.is_set():
            lv = service.controller.level
            if lv != levels[-1][1]:
                levels.append((time.perf_counter(), lv))
            time.sleep(0.002)

    counts = collections.Counter()
    errors: list = []
    lock = threading.Lock()
    latencies: list = []  # proc_time_ms of every frame the workers got

    def worker(i: int, stop: threading.Event):
        n = 0
        while not stop.is_set():
            part = [protos[(i + n + j) % len(protos)]
                    for j in range(CONTROLLER_FRAMES)]
            n += 1
            try:
                out = list(stub.AnalyzeActuatorPerformance(iter(part),
                                                           timeout=60))
                with lock:
                    latencies.extend(r.proc_time_ms for r in out)
                    counts["streams"] += 1
                    counts["frames"] += len(out)
                    counts["errors"] += sum(
                        r.status.startswith("ERROR") for r in out)
            except grpc.RpcError as exc:
                if exc.code() != grpc.StatusCode.UNAVAILABLE:
                    errors.append(exc)
                    return
                with lock:
                    counts["refused"] += 1
                time.sleep(0.002)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    page0 = http_get(mport, "/metrics").decode()
    stop_many = threading.Event()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i, stop_many),
                                daemon=True)
               for i in range(CONTROLLER_STREAMS)]
    for t in threads:
        t.start()
    while service.controller.level < 3:
        check(time.perf_counter() - t0 < CONTROLLER_TIMEOUT_S and not errors,
              f"the ladder reached level {service.controller.level} in "
              f"{CONTROLLER_TIMEOUT_S} s under {CONTROLLER_STREAMS} streams"
              f" (errors {errors[:1]})")
        time.sleep(0.01)
    t3 = time.perf_counter()
    time.sleep(1.0)  # level 3 held: new streams refused every other one
    page3 = http_get(mport, "/metrics").decode()
    stop_many.set()
    for t in threads:
        t.join(timeout=120)
    with service._streams_cond:
        ticks = service._brownout_tick
    refused = counts["refused"]
    check(not errors and refused > 0 and refused == (ticks + 1) // 2,
          f"rung 3 refused {refused} new streams of {ticks} opened while "
          f"refusing (every other one: {(ticks + 1) // 2}); errors "
          f"{errors[:1]}")
    stop_one = threading.Event()
    with lock:
        latencies.clear()
    t_one = time.perf_counter()
    single = threading.Thread(target=worker, args=(0, stop_one), daemon=True)
    single.start()
    while service.controller.level > 0:
        if time.perf_counter() - t_one >= CONTROLLER_TIMEOUT_S:
            with lock:
                last = latencies[-base.slo_window:]
            check(False, f"the ladder is at level {service.controller.level}"
                  f" {CONTROLLER_TIMEOUT_S} s into one stream: burn "
                  f"{service.slo.burn:.2f}, slo_ms {slo_ms:.2f} (one stream "
                  f"calibrated p50 {p50_1:.2f}, q{keep_q} {tail_1:.2f}); of "
                  f"its last {len(last)} frames "
                  f"{sum(t > slo_ms for t in last)} over it, p50 "
                  f"{np.median(last):.2f}, max {max(last):.2f} ms")
        time.sleep(0.01)
    t_back = time.perf_counter()
    stop_one.set()
    single.join(timeout=120)
    done.set()
    watcher.join(timeout=5)
    page = http_get(mport, "/metrics").decode()
    channel.close()
    grpc_service.shutdown(server, service)
    check(counts["errors"] == 0, f"{counts['errors']} frames answered "
          "with an error")
    rungs = [(round(t - t0, 3), lv) for t, lv in levels[1:]]
    acts = {a: metric_value(page, "rdp_controller_actions_total", action=a)
            - metric_value(page0, "rdp_controller_actions_total", action=a)
            for a in ("window_down", "admission_tighten", "refuse_streams",
                      "accept_streams", "admission_relax", "window_up",
                      "inflight_up", "floor_up", "floor_down")}
    log(f"controller overload leg: one stream's p50 {p50_1:.2f} ms and "
        f"q{keep_q} {tail_1:.2f} ms, {CONTROLLER_STREAMS} streams' p50 "
        f"{p50_16:.2f} ms ({len(one)} and {len(many)} frames over gRPC), "
        f"slo_ms {slo_ms:.2f}; level 3 after {t3 - t0:.3f} s, back to 0 "
        f"{t_back - t_one:.3f} s after the load dropped to one stream; "
        f"rungs (s from the load's start, level) {rungs}; "
        f"{counts['streams']} streams served, {refused} refused "
        f"(UNAVAILABLE) of {ticks} opened at rung 3, {counts['frames']} "
        f"frames; /metrics at level 3: level "
        f"{metric_value(page3, 'rdp_controller_brownout_level')}, "
        f"max_inflight {metric_value(page3, 'rdp_controller_max_inflight')}"
        f", window_ms {metric_value(page3, 'rdp_controller_window_ms')}; "
        f"at the end: level "
        f"{metric_value(page, 'rdp_controller_brownout_level')}, "
        f"max_inflight {metric_value(page, 'rdp_controller_max_inflight')}"
        f", window_ms {metric_value(page, 'rdp_controller_window_ms')}; "
        f"actions {acts}")
    check([lv for _, lv in levels[1:4]] == [1, 2, 3]
          and levels[-1][1] == 0,
          f"the ladder's moves {rungs}")
    return read_launches()


def grpc_proc_times(grpc, stub, protos: list, workers: int,
                    streams_each: int) -> list:
    """``proc_time_ms`` of every frame of ``workers`` closed-loop gRPC
    workers, each opening ``streams_each`` streams of CONTROLLER_FRAMES
    frames anew: the controller phase's traffic."""
    import threading

    out: list = []
    errors: list = []
    lock = threading.Lock()

    def run(i):
        try:
            for n in range(streams_each):
                part = [protos[(i + n + j) % len(protos)]
                        for j in range(CONTROLLER_FRAMES)]
                got = [r.proc_time_ms for r in stub.AnalyzeActuatorPerformance(
                    iter(part), timeout=60)]
                with lock:
                    out.extend(got)
        except grpc.RpcError as exc:
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not errors, f"calibration load: {errors[:1]}")
    check(len(out) == workers * streams_each * CONTROLLER_FRAMES,
          f"calibration load: {len(out)} frames answered")
    return out


ROLLOUT_TAIL = 8  # frames the drained replica's stream sends once drained


def rollout_phase(torch, port) -> dict:
    """The drift-triggered rollout on the card at ``ModelConfig()``.

    Version 1 is trained by ``run_retraining_pipeline`` at the drift
    phase's setting (TRAIN_SAMPLES samples, batch 4, 2 epochs); such a
    net masks nothing (PERF.md), so the served version is it with its
    head's bias set so that half of a fixed scene's logits are positive
    (``seeded_model``'s recipe): its masks are not empty, and the gates
    cannot pass on empty masks. Its profile is captured over DRIFT_STREAM
    scenes. Two servers from that registry
    (``build_server``, direct), joined by ``attach_rollout`` to one
    started ``RolloutManager``; two streams into the first replica,
    in-distribution then depth-shifted scenes, until its monitor fires a
    real recommendation, and one stream into the second, in flight when
    it is drained. Leg A: the train function trains again at the same
    setting on the card (the same bits: the card's training is
    deterministic) and gives the candidate the same head; the cycle
    walks IDLE -> DRAINING -> RETRAINING -> SHADOW -> CANARY -> PROMOTING
    -> REJOINING -> IDLE and both replicas serve the new version. Leg B:
    the same recommendation again, and a zero-weight candidate: refused
    at CANARY, rolled back, the served version unchanged. Throughout,
    every response is one version's answer, the drained replica's stream
    finishes, and ``memory_allocated`` and ``memory_reserved`` come back
    within DEPLOY_SLACK and DEPLOY_RESERVED_SLACK. Returns the phase's
    launches."""
    import gc
    import threading

    import grpc

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models import weights
    from robotic_discovery_platform_tpu_torch.ops import graphs
    from robotic_discovery_platform_tpu_torch.serving import (
        grpc_service,
        rollout,
    )
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        vision_grpc,
        vision_pb2,
    )
    from robotic_discovery_platform_tpu_torch.training import synthetic
    from robotic_discovery_platform_tpu_torch.utils.config import (
        RolloutConfig,
    )
    from robotic_discovery_platform_tpu_torch.workflows import retraining

    log(f"rollout_phase: {torch.cuda.get_device_name(0)} "
        f"[{nvidia_smi_line()}]")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_rollout_"))
    uri = f"file:{tmp}/mlruns"
    cfg = port.TrainConfig(epochs=2, batch_size=TRAIN_BATCH, img_size=256,
                           learning_rate=1e-4, loss="bce", seed=SEED,
                           tracking_uri=uri,
                           checkpoint_dir=str(tmp / "ckpt"))
    arrays = synthetic.generate_arrays(TRAIN_SAMPLES, 256, 256, seed=SEED)
    name = cfg.registered_model_name
    store = tracking.store_for(uri)
    reset_launches()

    def register(net, alias: str) -> int:
        tracking.set_tracking_uri(uri)
        with tracking.start_run():
            version = tracking.log_model(weights.to_flax_variables(net),
                                         net.cfg, registered_model_name=name)
        store.set_alias(name, alias, version)
        return int(version)

    rgb0, _, _ = port.render_scene(np.random.default_rng(SEED), DRIFT_H,
                                   DRIFT_W)
    x0 = port.preprocess(torch.from_numpy(rgb0).cuda()[None], 256)

    def sensitive(version: int, alias: str) -> int:
        """``version`` with its head's bias moved by the median logit of
        one fixed scene (through the kernels, the same bits every run),
        registered under ``alias``."""
        _, net = tracking.load_model(f"models:/{name}/{version}",
                                     store=store, device="cuda")
        with torch.no_grad():
            median = float(port.FoldedUNet(net, device="cuda")(x0).median())
            net.Conv_0.bias -= median
        return register(net.cpu(), alias)

    t0 = time.perf_counter()
    res = retraining.run_retraining_pipeline(cfg, port.ModelConfig(),
                                             arrays=arrays, device="cuda")
    check(res.succeeded and res.version == 1, f"the first cycle: {res}")
    v_live = sensitive(res.version, "staging")
    retraining.capture_drift_profile(
        v_live, model_name=name, tracking_uri=uri, n_frames=DRIFT_STREAM,
        img_size=cfg.img_size, device="cuda")
    inside = drift_scenes(port, SEED + 1, DRIFT_STREAM)
    shifted = drift_scenes(port, SEED + 1, DRIFT_STREAM, shifted=True)
    scenes = inside + shifted
    k = port.default_intrinsics(DRIFT_W, DRIFT_H).astype(np.float32)

    def expected(version: int) -> list:
        """Each scene's (mask, mean, max, valid) under ``version``."""
        _, net = tracking.load_model(f"models:/{name}/{version}",
                                     store=store, device="cuda")
        analyze = port.make_frame_analyzer(
            port.FoldedUNet(net, device="cuda"), img_size=256,
            device="cuda")
        out = []
        for rgb, depth in scenes:
            a = analyze.eager(rgb, depth, k, np.float32(0.001))
            valid = bool(a.profile.valid)
            out.append((a.mask.cpu().numpy(), float(a.profile.mean_curvature),
                        float(a.profile.max_curvature), valid))
        return out

    expect = {v_live: expected(v_live)}
    coverage = np.mean([m.mean() for m, *_ in expect[v_live]])
    check(coverage > 0.01, f"the served net masks {coverage:.2%} of a frame"
          ": the gates would pass on empty masks")
    setup_s = time.perf_counter() - t0
    gc.collect()
    mport = free_port()
    servers = []
    for i in range(2):
        scfg = port.ServerConfig(
            address="localhost:0", tracking_uri=uri,
            metrics_csv=str(tmp / f"r{i}.csv"),
            calibration_path=str(tmp / "none.npz"), reload_poll_s=0.0,
            reload_grace_s=DEPLOY_GRACE_S, drift_sustain_s=DRIFT_SUSTAIN_S,
            drift_cooldown_s=1e9, metrics_port=mport if i == 0 else 0)
        server, sv = grpc_service.build_server(
            scfg, warmup_shape=(DRIFT_W, DRIFT_H), device="cuda")
        server.start()
        servers.append((server, sv, scfg))
    (_, sv1, scfg1), (_, sv2, _) = servers
    check(sv1.drift.reference is not None
          and sv1.drift.reference.n_frames == DRIFT_STREAM,
          f"replica 1's reference: {sv1.drift.reference}")
    torch.cuda.synchronize()
    gc.collect()
    graphs.release_dead_pools()
    mem0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    legs = {"leg": "A"}

    def train_fn(target, cancel):
        if legs["leg"] == "B":
            # the bad candidate: zero weights, logits 0, empty masks
            _, net = tracking.load_model(
                f"models:/{name}/{target.current_version}", store=store,
                device="cpu")
            with torch.no_grad():
                for p in net.parameters():
                    p.zero_()
            return retraining.PipelineResult(
                True, register(net, "shadow"), "shadow", "zero weights")
        trained = retraining.run_retraining_pipeline(
            dataclasses.replace(cfg, checkpoint_dir=str(tmp / "ckpt_a")),
            port.ModelConfig(), arrays=arrays, alias="shadow",
            cancel=cancel, device="cuda")
        if not trained.succeeded:
            return trained
        return retraining.PipelineResult(
            True, sensitive(trained.version, "shadow"), "shadow",
            trained.message)

    manager = rollout.RolloutManager(
        [], RolloutConfig(), scfg1, train_fn=train_fn, train_cfg=cfg,
        model_cfg=port.ModelConfig(), device="cuda")
    rollout.attach_rollout(manager, [sv1, sv2], names=["replica-1",
                                                       "replica-2"])
    taken: list = []  # the recommendations the replicas handed over
    hand = manager.on_recommendation

    def on_recommendation(rec):
        taken.append(rec)
        return hand(rec)

    manager.on_recommendation = on_recommendation
    manager.start()

    def proto(i):
        rgb, depth = scenes[i]
        return vision_pb2.AnalysisRequest(
            color_image=vision_pb2.Image(data=rgb.tobytes(), width=DRIFT_W,
                                         height=DRIFT_H, format=1),
            depth_image=vision_pb2.Image(
                data=depth.astype("<u2").tobytes(), width=DRIFT_W,
                height=DRIFT_H, format=1), mask_format=1)

    got: list = []  # (stream, scene index, response)
    errors: list = []
    lock = threading.Lock()

    def stream(sv, tag, order, stop):
        """A gRPC stream of ``order``'s scenes (cycled from its last
        entry) into ``sv`` until ``stop`` returns True."""
        channel = grpc.insecure_channel(f"localhost:{sv.bound_port}")
        sent: list = []

        def feed():
            n = 0
            while not stop(n):
                i = order[min(n, len(order) - 1)] if n < len(order) else \
                    order[len(order) // 2 + n % (len(order) // 2)]
                sent.append(i)
                n += 1
                yield proto(i)

        try:
            stub = vision_grpc.VisionAnalysisServiceStub(channel)
            for j, resp in enumerate(stub.AnalyzeActuatorPerformance(
                    feed(), timeout=600)):
                with lock:
                    got.append((tag, sent[j], resp))
        except BaseException as exc:  # noqa: BLE001 - checked below
            errors.append((tag, exc))
        finally:
            channel.close()

    quit_live = threading.Event()
    live_order = list(range(DRIFT_STREAM)) + [DRIFT_STREAM + i for i in
                                              range(DRIFT_STREAM)]
    live = [threading.Thread(target=stream, args=(
        sv1, f"live{j}", live_order, lambda n: quit_live.is_set()),
        daemon=True) for j in range(2)]

    def drained_stream():
        """One stream into replica 2 that ends ROLLOUT_TAIL frames after
        the replica is drained (its in-flight stream at the drain)."""
        seen = {"at": None}

        def stop(n):
            if seen["at"] is None and sv2.is_draining:
                seen["at"] = n
            return seen["at"] is not None and n >= seen["at"] + ROLLOUT_TAIL

        t = threading.Thread(target=stream, args=(
            sv2, "drained", list(range(DRIFT_STREAM)), stop), daemon=True)
        t.start()
        return t, seen

    def wait_cycles(n, what):
        deadline = time.perf_counter() + 600
        while len(manager.history) < n:
            check(time.perf_counter() < deadline and not errors,
                  f"{what}: no cycle ended in 600 s (state "
                  f"{manager.state}, errors {errors[:1]})")
            time.sleep(0.05)
        return manager.history[n - 1]

    page0 = http_get(mport, "/metrics").decode()
    drained_a, seen_a = drained_stream()
    time.sleep(0.5)  # replica 2's stream in flight before the live load
    t_live = time.perf_counter()
    for t in live:
        t.start()
    cycle_a = wait_cycles(1, "leg A")
    drained_a.join(timeout=120)
    v_good = cycle_a.get("candidate_version")
    check(cycle_a["outcome"] == "promoted"
          and [s["stage"] for s in cycle_a["stages"]] == [
              rollout.DRAINING, rollout.RETRAINING, rollout.SHADOW,
              rollout.CANARY, rollout.PROMOTING, rollout.REJOINING]
          and sv1.current_version == sv2.current_version == v_good
          and not sv2.is_draining and manager.state == rollout.IDLE,
          f"leg A: {cycle_a.get('outcome')} at "
          f"{cycle_a.get('rolled_back_at')}: {cycle_a.get('error')}; "
          f"versions {sv1.current_version}/{sv2.current_version}")
    check(seen_a["at"] is not None and not drained_a.is_alive(),
          "leg A: the drained replica's stream did not finish")
    expect[v_good] = expected(v_good)
    retrained = [tracking.load_model(f"models:/{name}/{v}", store=store,
                                     device="cpu")[1].state_dict()
                 for v in (1, v_good - 1)]
    same_bits = all(torch.equal(retrained[0][key], retrained[1][key])
                    for key in retrained[0])
    log(f"rollout leg A: the retrained version {v_good - 1} equal to "
        f"version 1 bit for bit: {same_bits}")
    check(len(taken) == 1 and taken[0].signals,
          f"recommendations handed to the manager: "
          f"{[r.signals for r in taken]}")
    rec = taken[0]
    # leg B: the same recommendation, a zero-weight candidate
    legs["leg"] = "B"
    drained_b, seen_b = drained_stream()
    time.sleep(0.5)
    check(hand(rec), "leg B: the recommendation was not taken")
    cycle_b = wait_cycles(2, "leg B")
    drained_b.join(timeout=120)
    check(cycle_b["outcome"] == "rolled_back"
          and cycle_b["rolled_back_at"] == rollout.CANARY
          and not cycle_b["gates"]["shadow_iou"]["pass"]
          and sv1.current_version == sv2.current_version == v_good
          and store.get_alias(name, "staging") == v_good
          and not sv2.is_draining and manager.state == rollout.IDLE,
          f"leg B: {cycle_b.get('outcome')} at "
          f"{cycle_b.get('rolled_back_at')}: {cycle_b.get('error')}; "
          f"versions {sv1.current_version}/{sv2.current_version}")
    check(seen_b["at"] is not None and not drained_b.is_alive(),
          "leg B: the drained replica's stream did not finish")
    quit_live.set()
    for t in live:
        t.join(timeout=120)
    live_s = time.perf_counter() - t_live
    check(not errors, f"a stream failed: {errors[:1]}")
    # every response one version's answer
    by = collections.Counter()
    for tag, i, resp in got:
        mask = port.decode_mask_wire(resp.mask)
        versions = [v for v, want in expect.items()
                    if np.array_equal(mask, want[i][0])
                    and resp.status == ("OK" if want[i][3] else
                                        "DEGRADED: insufficient geometry")
                    and (not want[i][3] or np.allclose(
                        [resp.mean_curvature, resp.max_curvature],
                        want[i][1:3], rtol=GEOM_RTOL, atol=0))]
        check(versions, f"{tag} scene {i}: {resp.status!r}, the answer of "
              f"no version of {sorted(expect)}")
        by[tag] += 1
    page = http_get(mport, "/metrics").decode()
    debug = json.loads(http_get(mport, "/debug/rollout"))
    manager.stop()
    # the swapped-out generation and the cycles' analyzers gone, with the
    # same two servers up as at the start
    time.sleep(DEPLOY_GRACE_S + 0.5)
    torch.cuda.synchronize()
    gc.collect()
    graphs.release_dead_pools()
    mem1, res1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    graphs.release_workspaces()
    log(f"rollout: memory_allocated {mem1 / 2**20:.1f} MiB, "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB after cuBLAS's "
        f"per-stream workspaces are dropped")
    for server, sv, _ in servers:
        grpc_service.shutdown(server, sv)
    del servers, sv1, sv2, manager
    if not (abs(mem1 - mem0) <= DEPLOY_SLACK
            and res1 <= res0 + DEPLOY_RESERVED_SLACK):
        check(False, f"memory_allocated {mem0} -> {mem1}, reserved {res0} "
              f"-> {res1} around the two cycles: {live_graphs()}")

    def stages(cycle):
        marks = [(s["stage"], s["at_s"]) for s in cycle["stages"]]
        ends = [t for _, t in marks[1:]] + [
            cycle["started_s"] + cycle["duration_s"]]
        return {st: round(e - t, 3) for (st, t), e in zip(marks, ends)}

    def gates(cycle):
        return {g: (round(v["value"], 4), v["threshold"], v["pass"])
                for g, v in (cycle["gates"] or {}).items()}

    moved = {s: metric_value(page, "rdp_rollout_transitions_total", to=s)
             - metric_value(page0, "rdp_rollout_transitions_total", to=s)
             for s in rollout.STATES}
    rolled = {s: metric_value(page, "rdp_rollout_rollbacks_total", stage=s)
              - metric_value(page0, "rdp_rollout_rollbacks_total", stage=s)
              for s in rollout.STATES}
    log(f"rollout setup {setup_s:.1f} s (train v1, its head, a "
        f"{DRIFT_STREAM}-scene profile; masks cover {coverage:.2%}); "
        f"recommendation on {rec.signals} ({rec.reason})")
    for leg, cycle in (("A", cycle_a), ("B", cycle_b)):
        shadow = cycle["shadow"] or {}
        log(f"rollout leg {leg}: {cycle['outcome']} "
            f"(candidate v{cycle['candidate_version']}, drained "
            f"{cycle['replica']}) in {cycle['duration_s']} s; seconds per "
            f"stage {stages(cycle)}; shadow frames diffed "
            f"{shadow.get('frames')} (mirrored {shadow.get('mirrored')}, "
            f"dropped {shadow.get('dropped')}); gates (value, threshold, "
            f"pass) {gates(cycle)}; fixture {cycle['fixture']}")
    log(f"rollout: {len(got)} responses over {live_s:.1f} s ({dict(by)}), "
        f"each one version's answer; /metrics transitions {moved}, "
        f"rollbacks {rolled}; memory_allocated {mem0 / 2**20:.1f} -> "
        f"{mem1 / 2**20:.1f} MiB, reserved {res0 / 2**20:.1f} -> "
        f"{res1 / 2**20:.1f} MiB; /debug/rollout "
        f"{json.dumps({k: debug[k] for k in ('state', 'cycles_total')})} "
        f"history {[c['outcome'] for c in debug['history']]}")
    check(debug["cycles_total"] == 2 and moved[rollout.REJOINING] == 2
          and rolled[rollout.CANARY] == 1,
          f"/debug/rollout {debug['cycles_total']} cycles, transitions "
          f"{moved}, rollbacks {rolled}")
    return read_launches()


# -- the lab's loop around the server -----------------------------------------

LAB_SCENES = 24  # the geometry corpus's scenes, each scored on card and CPU
LAB_GROUP_STEPS = 3  # train steps of the group-norm net on the card
# the bound figures the kernel phases printed before their arithmetic
# moved into utils/flops (PERF.md's kernel table): (ms as printed, word)
PRINTED_BOUNDS = {
    "conv3x3_bn_relu, 18 a frame": ("0.0842", "operations"),
    "conv1x1 head [1,256,256,64]->1": ("0.00258", "bytes"),
    "deproject_edge_stats 480x640": ("0.00165", "bytes"),
    "deproject_edge_stats 240x320": ("0.00041", "bytes"),
    "bspline_design N=6400 C=16": ("0.0000772", "bytes"),
    "bspline_curvature N=100 C=16": ("0.00000081", "bytes"),
    "bitpack_mask [8,480,640]": ("0.000825", "bytes"),
    "bitpack_mask [1,480,640]": ("0.000103", "bytes"),
    "dequant_idct, a 4:2:0 frame": ("0.00083", "bytes"),
    "conv_transpose2x2, 4 at B = 1": ("0.0087", "bytes"),
    "conv3x3_grad_weights, 18 at B = 4": ("0.334", "operations"),
    "training forward, 18 at B = 4": ("0.334", "operations"),
    "training dx, 17 at B = 4": ("0.323", "operations"),
}


def reference_torch_unet(torch, base: int = 64):
    """The reference's torch U-Net from the SURVEY spec (bilinear, BatchNorm;
    ``inc``, ``down1``-``down4``, ``up1``-``up4``, ``outc``), the layout of
    the ``.pth`` files a user brings from the reference deployment."""
    nn = torch.nn

    class DoubleConv(nn.Module):
        def __init__(self, cin, cout, mid=None):
            super().__init__()
            mid = mid or cout
            self.block = nn.Sequential(
                nn.Conv2d(cin, mid, 3, padding=1, bias=False),
                nn.BatchNorm2d(mid), nn.ReLU(inplace=True),
                nn.Conv2d(mid, cout, 3, padding=1, bias=False),
                nn.BatchNorm2d(cout), nn.ReLU(inplace=True))

        def forward(self, x):
            return self.block(x)

    class Down(nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.block = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

        def forward(self, x):
            return self.block(x)

    class Up(nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.up = nn.Upsample(scale_factor=2, mode="bilinear",
                                  align_corners=True)
            self.conv = DoubleConv(cin, cout, mid=cin // 2)

        def forward(self, x, skip):
            return self.conv(torch.cat([skip, self.up(x)], dim=1))

    class UNet(nn.Module):
        def __init__(self, f):
            super().__init__()
            self.inc = DoubleConv(3, f)
            self.down1 = Down(f, f * 2)
            self.down2 = Down(f * 2, f * 4)
            self.down3 = Down(f * 4, f * 8)
            self.down4 = Down(f * 8, f * 16 // 2)
            self.up1 = Up(f * 16, f * 8 // 2)
            self.up2 = Up(f * 8, f * 4 // 2)
            self.up3 = Up(f * 4, f * 2 // 2)
            self.up4 = Up(f * 2, f)
            self.outc = nn.Conv2d(f, 1, 1)

        def forward(self, x):
            x1 = self.inc(x)
            x2 = self.down1(x1)
            x3 = self.down2(x2)
            x4 = self.down3(x3)
            x5 = self.down4(x4)
            y = self.up1(x5, x4)
            y = self.up2(y, x3)
            y = self.up3(y, x2)
            return self.outc(self.up4(y, x1))

    return UNet(base)


def answer(r) -> tuple:
    """A response's answer, every field but the timing."""
    return (r.status, r.mask, r.mask_coverage, r.mean_curvature,
            r.max_curvature, r.packed_spline,
            tuple((p.x, p.y, p.z) for p in r.spline_points))


def lab_server_cfg(port, tmp: Path, uri: str, **fields):
    return port.ServerConfig(address="localhost:0", tracking_uri=uri,
                             metrics_csv=str(tmp / f"m{time.time_ns()}.csv"),
                             calibration_path=str(tmp / "none.npz"),
                             reload_poll_s=0.0, **fields)


def lab_registry_leg(torch, port, http: str, tmp: Path, frames: list,
                     requests: list, arrays) -> dict:
    """(a) The registry over HTTP: ``train_model`` logs and registers over
    REST; a servicer loads that version over REST and answers as one
    built from the same weights in a ``file:`` store, bit for bit; a
    second version registered over REST and the alias moved there swap
    the servicer under a live stream (every response one version's); a
    retraining cycle promotes over REST."""
    import threading

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models import weights
    from robotic_discovery_platform_tpu_torch.serving import server
    from robotic_discovery_platform_tpu_torch.training import trainer
    from robotic_discovery_platform_tpu_torch.tracking.rest_backend import (
        RestMlflowStore,
    )
    from robotic_discovery_platform_tpu_torch.workflows import retraining

    out = dict.fromkeys(KERNELS, 0)
    name = port.ServerConfig().model_name
    cfg = port.TrainConfig(epochs=1, batch_size=TRAIN_BATCH, img_size=256,
                           learning_rate=1e-4, loss="bce", seed=SEED,
                           tracking_uri=http,
                           checkpoint_dir=str(tmp / "ckpt_http"))
    reset_launches()
    t0 = time.perf_counter()
    res = trainer.train_model(cfg, port.ModelConfig(), arrays=arrays,
                              device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = read_launches()
    want = launches_of(conv3x3_bn_relu=35 * 4, conv3x3_grad_weights=18 * 4)
    check(got == want, f"train_model over HTTP: launches {got}, want {want}")
    out = {k: out[k] + got[k] for k in out}
    store = tracking.store_for(http)
    check(isinstance(store, RestMlflowStore), f"{http}: {type(store)}")
    hist = store.get_metric_history(res.run_id, "train_loss")
    check(res.registry_version == 1 and len(hist) == 1
          and store.get_run(res.run_id)["status"] == "FINISHED"
          and np.isfinite(hist[0]["value"]),
          f"train_model over HTTP: version {res.registry_version}, "
          f"history {hist}")
    store.set_alias(name, "staging", 1)

    # the same weights in a file: store, and a servicer from each
    _, net1 = tracking.load_model(f"models:/{name}@staging", store=store,
                                  device="cpu")
    file_uri = f"file:{tmp}/mlruns_file"
    register_models(port, {"staging": net1}, file_uri)
    t0 = time.perf_counter()
    service = server.build_service(lab_server_cfg(port, tmp, http),
                                   device="cuda")
    build_s = time.perf_counter() - t0
    reference = server.build_service(lab_server_cfg(port, tmp, file_uri),
                                     device="cuda")
    check(service.current_version == reference.current_version == 1,
          f"versions {service.current_version}, {reference.current_version}")
    reset_launches()
    v1 = list(service.analyze_stream(iter(requests)))
    torch.cuda.synchronize()
    got = read_launches()
    want = frame_launches(len(requests), served=True)
    check(got == want, f"REST-loaded servicer: launches {got}, want {want}")
    out = {k: out[k] + got[k] for k in out}
    same_responses(v1, list(reference.analyze_stream(iter(requests))),
                   "servicer from http:// vs file:", exact=True)
    reference.close()

    # a second version over REST; the alias moves under a live stream
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    net2 = seeded_model(torch, port, x0, seed=SEED + 1)
    tracking.set_tracking_uri(http)
    tracking.set_experiment("Actuator Segmentation")
    with tracking.start_run():
        v = tracking.log_model(weights.to_flax_variables(net2), net2.cfg,
                               registered_model_name=name)
    check(v == 2, f"second version over REST: {v}")
    live, done, errors = [], threading.Event(), []

    def stream():
        try:
            while not done.is_set():
                live.extend(service.analyze_stream(iter(requests)))
            live.extend(service.analyze_stream(iter(requests)))
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    worker = threading.Thread(target=stream)
    worker.start()
    time.sleep(0.05)
    store.set_alias(name, "staging", 2)
    t0 = time.perf_counter()
    swapped = service.maybe_reload()
    reload_s = time.perf_counter() - t0
    done.set()
    worker.join(120)
    check(not worker.is_alive() and not errors,
          f"live stream across the reload: {errors}")
    check(swapped and service.current_version == 2,
          f"alias moved over REST: swapped {swapped}, version "
          f"{service.current_version}")
    v2 = list(service.analyze_stream(iter(requests)))
    first, second = [answer(r) for r in v1], [answer(r) for r in v2]
    check(first != second, "versions 1 and 2 answer alike")
    n = len(requests)
    owners = [(0 if answer(r) == first[i % n] else
               1 if answer(r) == second[i % n] else None)
              for i, r in enumerate(live)]
    strays = [i for i, o in enumerate(owners) if o is None]
    check(not strays, f"live responses {strays[:4]} of {len(live)} are "
          "neither version's")
    service.close()

    # a retraining cycle promotes over REST
    t0 = time.perf_counter()
    cycle = retraining.run_retraining_pipeline(
        dataclasses.replace(cfg, checkpoint_dir=str(tmp / "ckpt_retrain")),
        port.ModelConfig(), arrays=arrays, device="cuda")
    cycle_s = time.perf_counter() - t0
    check(cycle.succeeded and cycle.version == 3
          and cycle.promoted_alias == "staging"
          and store.get_alias(name, "staging") == 3,
          f"retraining over REST: {cycle}")
    log(f"lab (a) registry over HTTP ({http}): train_model 1 epoch in "
        f"{train_s:.2f} s, version 1; servicer from http:// built in "
        f"{build_s:.2f} s, {n} answers equal to the file: store's bit for "
        f"bit; alias to version 2 over REST: swap in {reload_s:.2f} s, "
        f"{len(live)} live responses ({owners.count(0)} version 1, "
        f"{owners.count(1)} version 2); retraining cycle promoted version "
        f"{cycle.version} in {cycle_s:.2f} s")
    return out


def lab_group_leg(torch, port, tmp: Path, frames: list, requests: list,
                  arrays, folded) -> dict:
    """(b) Group norm at ``ModelConfig(norm="group")`` widths: train steps
    on the card (18 forward and 17 dx conv3x3_bn_relu and 18
    conv3x3_grad_weights launches a step); ``model_forward="auto"``
    refused with the JAX ``PallasUNet`` error; ``"flax"`` serving over
    gRPC (18 / 1 / 1 / 1 / 1 launches a frame: the 3x3 convs, the three
    geometry kernels, the bitpack), its masks the direct analyzer's, its
    logits within LOGITS_REL_L2 of the CPU plain forward, and unchanged
    through a hot reload."""
    import grpc

    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.models.unet import (
        eval_on_kernels,
    )
    from robotic_discovery_platform_tpu_torch.ops.unet_infer import (
        reference_forward,
    )
    from robotic_discovery_platform_tpu_torch.serving import (
        grpc_service,
        server,
    )
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        vision_grpc,
    )
    from robotic_discovery_platform_tpu_torch.training import trainer

    out = dict.fromkeys(KERNELS, 0)
    cfg = port.ModelConfig(norm="group")
    net = trainer.init_model(cfg, SEED, torch.device("cuda"))
    opt = trainer.make_optimizer(net, 1e-4)
    xs, ys = trainer.normalize_arrays(*arrays)
    loss_fn = losses.make_loss_fn("bce")
    per_step, step_loss = [], []
    for i in range(LAB_GROUP_STEPS):
        rows = slice(TRAIN_BATCH * i, TRAIN_BATCH * (i + 1))
        x = torch.from_numpy(xs[rows]).cuda()
        y = torch.from_numpy(ys[rows]).cuda()
        reset_launches()
        step_loss.append(float(trainer.train_step(net, opt, loss_fn, x, y)))
        per_step.append(read_launches())
    want = launches_of(conv3x3_bn_relu=35, conv3x3_grad_weights=18)
    check(all(p == want for p in per_step) and np.all(np.isfinite(step_loss)),
          f"group-norm train steps: launches {per_step}, want {want}; "
          f"losses {step_loss}")
    for k in out:
        out[k] += sum(p[k] for p in per_step)
    net.eval()
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    with torch.no_grad():  # the head at the median logit: masks with edges
        net.Conv_0.bias -= torch.median(net(x0))
    cpu_net = port.UNet(cfg)
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    uri = f"file:{tmp}/mlruns_group"
    register_models(port, {"staging": cpu_net.eval()}, uri)

    try:
        server.build_service(lab_server_cfg(port, tmp, uri), device="cuda")
    except ValueError as exc:
        refused = str(exc)
    else:
        refused = ""
    check("PallasUNet folds BatchNorm; got norm='group' (use the Flax "
          "module instead)" in refused, f"model_forward='auto' on a "
          f"group-norm net: {refused!r}")

    flax_cfg = lab_server_cfg(port, tmp, uri, model_forward="flax")
    srv, service = grpc_service.build_server(flax_cfg, device="cuda")
    srv.start()
    try:
        with grpc.insecure_channel(
                f"localhost:{service.bound_port}") as channel:
            stub = vision_grpc.VisionAnalysisServiceStub(channel)
            wire = wire_requests(requests)
            reset_launches()
            before = list(stub.AnalyzeActuatorPerformance(iter(wire)))
            torch.cuda.synchronize()
            got = read_launches()
            n = len(requests)
            want = launches_of(conv3x3_bn_relu=18 * n, deproject_edge_stats=n,
                               bspline_design=n, bspline_curvature=n,
                               bitpack_mask=n)
            check(got == want, f"group-norm net served with 'flax': "
                  f"launches {got}, want {want}")
            out = {k: out[k] + got[k] for k in out}
            register_models(port, {"staging": cpu_net}, uri)
            t0 = time.perf_counter()
            swapped = service.maybe_reload()
            reload_s = time.perf_counter() - t0
            after = list(stub.AnalyzeActuatorPerformance(iter(wire)))
    finally:
        srv.stop(grace=None).wait()
        service.close()
    check(swapped and service.current_version == 2,
          f"group-norm reload: swapped {swapped}, version "
          f"{service.current_version}")
    check([answer(r) for r in before] == [answer(r) for r in after],
          "group-norm net: answers changed through a reload of the same "
          "weights")

    # the served forward against the direct analyzer and the CPU plain one
    gforward = reference_forward(net, device="cuda")
    analyze = port.make_frame_analyzer(gforward, img_size=256,
                                       device="cuda")
    bn_analyze = port.make_frame_analyzer(folded, img_size=256,
                                          device="cuda")
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    for i, ((rgb, depth), resp) in enumerate(zip(frames, before)):
        mask = analyze(rgb, depth, k, 0.001).mask.cpu().numpy()
        check(np.array_equal(port.decode_mask_wire(resp.mask), mask),
              f"group-norm frame {i}: served mask differs from the direct "
              "analyzer's")
    with torch.no_grad():
        logits = eval_on_kernels(net)(x0)
        plain = cpu_net(x0.cpu())
    rel = rel_l2(torch, logits.cpu(), plain)
    check(rel <= LOGITS_REL_L2, f"group-norm logits on the card vs the CPU "
          f"plain forward: relative L2 {rel} > {LOGITS_REL_L2}")
    rgb, depth = frames[0]
    g_ms = device_ms(torch, lambda: analyze(rgb, depth, k, 0.001))
    b_ms = device_ms(torch, lambda: bn_analyze(rgb, depth, k, 0.001))
    log(f"lab (b) group norm (ModelConfig(norm='group')): {LAB_GROUP_STEPS} "
        f"train steps, losses {[round(v, 5) for v in step_loss]}, launches "
        f"a step {per_step[-1]}; 'auto' refused ({refused!r}); 'flax' over "
        f"gRPC: {len(before)} frames, launches {got}, statuses "
        f"{[r.status for r in before]}; reload of the same weights in "
        f"{reload_s:.2f} s, answers unchanged; logits vs CPU plain rel L2 "
        f"{rel:.3g}; device ms a frame (direct analyzer, profiler) "
        f"group {g_ms:.4f} vs batch-norm folded {b_ms:.4f}")
    return out


def lab_checkpoint_leg(torch, port, tmp: Path, frames: list,
                       requests: list) -> dict:
    """(c) A reference checkpoint: the reference's torch U-Net at full
    width, BatchNorm statistics calibrated on frame 0, saved as ``.pth``
    and imported with ``import_checkpoint(register=True)`` at float32
    compute, the reference's own (``ModelConfig(compute_dtype=
    "float32")``, full widths); the served forward's logits within
    LOGITS_REL_L2 of the torch module's own float32 output on the card,
    and two frames served from the registry. The same weights in bf16
    compute (``ModelConfig()``): the kernels within LOGITS_REL_L2 of
    their plain versions, and the distance to the float32 output
    printed."""
    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.models.unet import (
        with_compute_dtype,
    )
    from robotic_discovery_platform_tpu_torch.serving import server
    from robotic_discovery_platform_tpu_torch.tools import (
        import_torch_weights,
    )

    torch.manual_seed(SEED)
    ref = reference_torch_unet(torch).cuda()
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).cuda()[None], 256)
    xn = x0.permute(0, 3, 1, 2).contiguous()
    for m in ref.modules():  # running statistics = frame 0's batch ones
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    with torch.no_grad():
        ref.train()(xn)
        ref.eval()
        ref.outc.bias -= torch.median(ref(xn))
        want = ref(xn).permute(0, 2, 3, 1)
    pth = tmp / "best_segmentation_model.pth"
    torch.save({k: v.cpu() for k, v in ref.state_dict().items()}, pth)
    uri = f"file:{tmp}/mlruns_import"
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    t0 = time.perf_counter()
    _, version = import_torch_weights.import_checkpoint(
        pth, port.ModelConfig(compute_dtype="float32"), register=True)
    import_s = time.perf_counter() - t0
    check(version == 1, f"imported checkpoint registered as {version}")
    tracking.store_for(uri).set_alias(port.ServerConfig().model_name,
                                      "staging", 1)
    scfg = lab_server_cfg(port, tmp, uri)
    _, registered, _ = server.resolve_serving_model(scfg, device="cuda")
    with torch.no_grad():
        got = port.FoldedUNet(registered, device="cuda")(x0)
        bf16 = port.FoldedUNet(with_compute_dtype(registered, "bfloat16"),
                               device="cuda")
        got16, plain16 = bf16(x0), bf16.forward_plain(x0)
    rel = rel_l2(torch, got, want)
    check(rel <= LOGITS_REL_L2, f"imported checkpoint: served logits vs the "
          f"torch module's float32 output, relative L2 {rel} > "
          f"{LOGITS_REL_L2}")
    rel16 = rel_l2(torch, got16, plain16)
    check(rel16 <= LOGITS_REL_L2, f"imported checkpoint in bf16: kernels vs "
          f"plain, relative L2 {rel16} > {LOGITS_REL_L2}")
    service = server.build_service(scfg, device="cuda")
    reset_launches()
    responses = list(service.analyze_stream(iter(requests[:2])))
    torch.cuda.synchronize()
    launches = read_launches()
    service.close()
    want_l = frame_launches(2, served=True)
    check(launches == want_l and all(r.status.startswith(("OK", "DEGRADED"))
                                     for r in responses),
          f"imported checkpoint served: launches {launches}, want "
          f"{want_l}; statuses {[r.status for r in responses]}")
    log(f"lab (c) reference checkpoint: {pth.stat().st_size / 2**20:.1f} MiB"
        f" .pth imported and registered in {import_s:.2f} s; served float32 "
        f"logits vs the torch module's float32 output rel L2 {rel:.3g} (bar "
        f"{LOGITS_REL_L2}); in bf16 compute the kernels vs plain {rel16:.3g}"
        f", vs the float32 output {rel_l2(torch, got16, want):.3g} (logits "
        f"std {float(want.std()):.4g}); 2 frames served, statuses "
        f"{[r.status for r in responses]}")
    return launches


def lab_corpus_leg(torch, port) -> dict:
    """(d) The geometry parity corpus (``tools/geometry_parity``) over
    LAB_SCENES scenes at 480x640 on the card and on the CPU: every scene's
    validity equal and its mean and max curvature within GEOM_RTOL, card
    against CPU (``geometry_phase``'s bar), one launch of each geometry
    kernel per scene and stride on the card."""
    from robotic_discovery_platform_tpu_torch.tools import geometry_parity

    reset_launches()
    t0 = time.perf_counter()
    card = geometry_parity.run_corpus(LAB_SCENES, seed=SEED, device="cuda")
    card_s = time.perf_counter() - t0
    launches = read_launches()
    n = 2 * LAB_SCENES
    want = launches_of(deproject_edge_stats=n, bspline_design=n,
                       bspline_curvature=n)
    check(launches == want, f"corpus on the card: launches {launches}, "
          f"want {want}")
    t0 = time.perf_counter()
    cpu = geometry_parity.run_corpus(LAB_SCENES, seed=SEED, device="cpu")
    cpu_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(card["scenes"], cpu["scenes"],
                                   strict=True)):
        check(a["params"] == b["params"], f"corpus scene {i}: draws differ")
        for s in ("stride1", "stride2"):
            check(a[s]["valid"] == b[s]["valid"] and np.allclose(
                [a[s]["mean"], a[s]["max"]], [b[s]["mean"], b[s]["max"]],
                rtol=GEOM_RTOL, atol=0.0),
                f"corpus scene {i} {s}: card {a[s]} vs CPU {b[s]}")
    summary = []
    for s in ("stride1", "stride2"):
        errs = np.asarray([sc[s]["rel_err_mean"] for sc in card["scenes"]])
        truth = np.asarray([abs(sc[s]["mean"] - sc["true_curvature"])
                            / sc["true_curvature"] for sc in card["scenes"]])
        summary.append(
            f"{s}: vs oracle median {np.median(errs):.4f} p95 "
            f"{np.percentile(errs, 95):.4f}, vs truth median "
            f"{np.median(truth):.4f} p95 {np.percentile(truth, 95):.4f}, "
            f"valid {card['summary'][s]['valid_frac']:.2f}")
    log(f"lab (d) geometry corpus, {LAB_SCENES} scenes at 480x640: card "
        f"{card_s:.1f} s, CPU {cpu_s:.1f} s, card equal to CPU within "
        f"rtol {GEOM_RTOL} scene by scene; mean curvature relative errors "
        + "; ".join(summary))
    return launches


def lab_guard_leg(torch, port, folded, tmp: Path, frames: list,
                  requests: list, arrays) -> None:
    """(e) ``RDP_TRANSFER_GUARD=strict``: the direct, batched and scan
    servicers and a scan-epoch ``train_model`` answer as with the guard
    off, and inside a guarded call after warm-up an injected ``.item()``
    raises."""
    import os

    from robotic_discovery_platform_tpu_torch.ops import graphs
    from robotic_discovery_platform_tpu_torch.serving import server
    from robotic_discovery_platform_tpu_torch.training import trainer

    settings = {"direct": {}, "batched": dict(batch_window_ms=2.0,
                                              max_batch=MAX_BATCH),
                "scan": dict(batch_window_ms=2.0, max_batch=MAX_BATCH,
                             batch_impl="scan")}
    runs = {}
    for guard in ("off", "strict"):
        os.environ["RDP_TRANSFER_GUARD"] = guard
        try:
            for leg, fields in settings.items():
                service = server.build_service(
                    lab_server_cfg(port, tmp, f"file:{tmp}/unused",
                                   **fields),
                    folded, device="cuda")
                try:
                    guarded = getattr(service._engine.analyze,
                                      "__transfer_guard__", "off")
                    check(guarded == guard, f"{leg} servicer's analyzer "
                          f"guard {guarded!r}, want {guard!r}")
                    runs[guard, leg] = [answer(r) for r in
                                        service.analyze_stream(iter(requests))
                                        ] + [answer(r) for r in
                                             service.analyze_stream(
                                                 iter(requests))]
                finally:
                    service.close()
            cfg = port.TrainConfig(
                epochs=1, batch_size=TRAIN_BATCH, img_size=256,
                learning_rate=1e-4, loss="bce", seed=SEED,
                tracking_uri=f"file:{tmp}/mlruns_guard_{guard}",
                checkpoint_dir=str(tmp / f"ckpt_guard_{guard}"))
            res = trainer.train_model(cfg, port.ModelConfig(), arrays=arrays,
                                      register=False, device="cuda")
            runs[guard, "train"] = (res.best_val_loss,
                                    sorted(res.final_metrics.items()))
        finally:
            os.environ.pop("RDP_TRANSFER_GUARD", None)
    for leg in (*settings, "train"):
        check(runs["strict", leg] == runs["off", leg],
              f"{leg} under RDP_TRANSFER_GUARD=strict differs from the "
              "guard off")

    os.environ["RDP_TRANSFER_GUARD"] = "strict"
    try:
        analyze = port.make_frame_analyzer(folded, img_size=256,
                                           device="cuda")
    finally:
        os.environ.pop("RDP_TRANSFER_GUARD", None)
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    rgb, depth = frames[0]
    analyze(rgb, depth, k, 0.001)  # warm-up and capture: exempt
    first = analyze(rgb, depth, k, 0.001, finish=graphs.clone)  # exempt
    again = analyze(rgb, depth, k, 0.001, finish=graphs.clone)  # guarded

    def item_finish(out):
        out.mask.sum().item()  # a synchronising read-back
        return graphs.clone(out)

    try:
        analyze(rgb, depth, k, 0.001, finish=item_finish)
    except RuntimeError as exc:
        raised = str(exc)
    else:
        raised = ""
    check("synchronizing" in raised, f"an injected .item() inside a guarded "
          f"call did not raise ({raised!r})")
    check(torch.equal(first.mask, again.mask), "guarded replay differs")
    log(f"lab (e) RDP_TRANSFER_GUARD=strict: direct, batched, scan servicers "
        f"({2 * len(requests)} frames each) and a scan-epoch train_model "
        f"(best val loss {runs['strict', 'train'][0]:.6f}) answer as with "
        f"the guard off; an injected .item() raised: {raised!r}")


def lab_bounds_leg(torch) -> None:
    """(f) The bound figures the kernel phases print, now from
    ``utils/flops``, against the figures they printed before (PERF.md's
    kernel table), each to its printed digits."""
    lib = flops_lib()

    def b(cost, peak=None):
        return bound_ms(*cost, peak)

    f32, f64 = lib.H100_F32_FLOPS, lib.H100_F64_FLOPS

    def total(costs, peak=None):
        parts = [b(c, peak) for c in costs]
        ops = sum(t for t, by in parts if by == "operations")
        byt = sum(t for t, by in parts if by == "bytes")
        return ops + byt, "operations" if ops >= byt else "bytes"

    rate = int32_ops_per_s(torch)
    got = {
        "conv3x3_bn_relu, 18 a frame": total(
            [lib.conv3x3_bn_relu_cost(1, h, h, ci, co)
             for h, ci, co in MAIN_PATH_3X3]),
        "conv1x1 head [1,256,256,64]->1": b(lib.conv1x1_cost(1, 256, 256, 64,
                                                              1)),
        "deproject_edge_stats 480x640": b(
            lib.deproject_edge_stats_cost(480, 640), f32),
        "deproject_edge_stats 240x320": b(
            lib.deproject_edge_stats_cost(240, 320), f32),
        "bspline_design N=6400 C=16": b(lib.bspline_design_cost(6400, 16, 20),
                                        f64),
        "bspline_curvature N=100 C=16": b(
            lib.bspline_curvature_cost(100, 16, 20), f32),
        "bitpack_mask [8,480,640]": b(lib.bitpack_mask_cost(8, 480, 640),
                                      f32),
        "bitpack_mask [1,480,640]": b(lib.bitpack_mask_cost(1, 480, 640),
                                      f32),
        "dequant_idct, a 4:2:0 frame": total(
            [lib.dequant_idct_cost(1, n) for n in IDCT_PLANES], rate),
        "conv_transpose2x2, 4 at B = 1": total(
            [lib.conv_transpose2x2_cost(1, h, h, ci, co)
             for h, ci, co in CONVT_SHAPES]),
        "conv3x3_grad_weights, 18 at B = 4": total(
            [lib.train_conv_costs(TRAIN_BATCH, h, ci, co)["dw"]
             for h, ci, co in MAIN_PATH_3X3]),
        "training forward, 18 at B = 4": total(
            [lib.train_conv_costs(TRAIN_BATCH, h, ci, co)["fwd"]
             for h, ci, co in MAIN_PATH_3X3]),
        "training dx, 17 at B = 4": total(
            [lib.train_conv_costs(TRAIN_BATCH, h, ci, co)["dx"]
             for h, ci, co in MAIN_PATH_3X3[1:]]),
    }
    for name, (printed, word) in PRINTED_BOUNDS.items():
        ms, by = got[name]
        digits = len(printed.split(".")[1])
        check(abs(ms - float(printed)) <= 0.5 * 10 ** -digits and by == word,
              f"bound of {name}: {ms:.8g} ms ({by}), printed {printed} "
              f"({word})")
    log("lab (f) bounds from utils/flops equal the printed figures: " + "; "
        .join(f"{n} {got[n][0]:.6g} ({got[n][1]})" for n in PRINTED_BOUNDS))


def lab_phase(torch, port, folded=None, frames=None) -> dict:
    """The lab's loop around the server and the trainer, at full width
    (``ModelConfig()`` widths, 256x256 input, 480x640 frames): (a) the
    registry over HTTP against ``tests/fake_mlflow_server.py`` in
    process; (b) a group-norm net trained, refused by the folded forward
    and served with ``model_forward="flax"``; (c) a reference ``.pth``
    imported and served; (d) the geometry parity corpus on card and CPU;
    (e) the transfer guard; (f) the bounds from ``utils/flops``. Returns
    the launches of its main-path legs."""
    import sys

    from robotic_discovery_platform_tpu_torch import tracking
    from robotic_discovery_platform_tpu_torch.training import synthetic

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from fake_mlflow_server import FakeMlflowServer

    if folded is None:
        folded, frames = phase_model(torch, port)
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lab_"))
    requests = [port.raw_request(rgb, depth, mask_format=1)
                for rgb, depth in frames]
    arrays = synthetic.generate_arrays(TRAIN_SAMPLES, 256, 256, seed=SEED)
    prev_uri = tracking.get_tracking_uri()
    seconds, total = {}, dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    try:
        t0 = time.perf_counter()
        with FakeMlflowServer() as http:
            add(lab_registry_leg(torch, port, http, tmp, frames, requests,
                                 arrays))
        seconds["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        add(lab_group_leg(torch, port, tmp, frames, requests, arrays,
                          folded))
        seconds["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        add(lab_checkpoint_leg(torch, port, tmp, frames, requests))
        seconds["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        add(lab_corpus_leg(torch, port))
        seconds["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lab_guard_leg(torch, port, folded, tmp, frames, requests, arrays)
        seconds["e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lab_bounds_leg(torch)
        seconds["f"] = time.perf_counter() - t0
    finally:
        tracking.set_tracking_uri(prev_uri)
    log(f"lab_phase: {time.perf_counter() - t_phase:.1f} s (legs "
        + ", ".join(f"({k}) {v:.1f}" for k, v in seconds.items())
        + f" s) [{nvidia_smi_line()}]")
    return total


# -- phase 19: the tuning table ------------------------------------------------


def answer_key(resp) -> tuple:
    """A response's fields but ``proc_time_ms`` (each run's own)."""
    return (resp.status, bytes(resp.mask), resp.mask_coverage,
            resp.mean_curvature, resp.max_curvature, bytes(resp.packed_spline),
            tuple((p.x, p.y, p.z) for p in resp.spline_points))


def tune_tool():
    """``tools/tune_kernels.py`` as a module."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import tune_kernels

    return tune_kernels


def sweep_lines(records: list, counts: dict, label: str) -> None:
    """Each shape's fwd_plan split and its ms, then the best split and
    its ms, and both summed over the forward's launches (``counts``: the
    launches of each shape)."""
    for r in records:
        b, h, w, cin, cout = r["shape"]
        cands = " ".join(f"{s}:{ms:.4f}" for s, ms in sorted(r["ms"].items()))
        log(f"tune {label} [{b},{h},{w},{cin}]->{cout}: fwd_plan {r['heuristic']}"
            f" splits {r['heuristic_ms']:.4f} ms, best {r['best']} splits "
            f"{r['best_ms']:.4f} ms ({r['best_ms'] / r['heuristic_ms']:.3f}x); "
            f"max|err| {r['max_abs_err']:.3g}; every split ms: {cands}")
    heur = sum(counts[tuple(r["shape"][1:])] * r["heuristic_ms"]
               for r in records)
    best = sum(counts[tuple(r["shape"][1:])] * r["best_ms"] for r in records)
    n = sum(counts.values())
    log(f"tune {label}, the {n} launches of one forward: fwd_plan {heur:.4f} ms,"
        f" best splits {best:.4f} ms ({best / heur:.3f}x)")


def tuning_phase(torch, port, folded=None, frames=None) -> dict:
    """The per-shape tuning table of the 3x3 conv on the card: the tuning
    tool's sweep (``tools/tune_kernels.py``: every split the launch takes,
    median of TUNE_LAUNCHES CUDA-event-timed launches, each held within
    BF16_TOL of the plain version) over the serving forward's shapes at
    B = 1, and over the training forward's at B = TRAIN_BATCH (printed
    only); then a table in a temporary file (the measured winners, else
    each shape's fastest other split, and one invalid entry) and a
    servicer built under it: 18/1/1/1/1/1 launches per frame, every
    tuned shape launched at the table's split and the invalid entry's at
    fwd_plan's, the logits within BF16_TOL relative L2 of the untuned
    forward, a B = 8 forward bit for bit the frames alone, and 8 batched
    streams' masks equal to the direct frames' (curvature within
    GEOM_RTOL, as the servicer phase holds them). The table is removed
    at the end. Returns the served legs' launches."""
    from robotic_discovery_platform_tpu_torch.ops import conv, tuning

    tk = tune_tool()
    log(f"tuning_phase: {torch.cuda.get_device_name(0)} [{nvidia_smi_line()}]")
    if folded is None:
        folded, frames = phase_model(torch, port)
    t_phase = time.perf_counter()
    main = [(s, s, cin, cout) for s, cin, cout in MAIN_PATH_3X3]
    counts = collections.Counter(main)
    shapes = tk.serving_shapes()
    check(shapes == sorted(counts, key=main.index),
          f"the tool's serving shapes {shapes} are not MAIN_PATH_3X3's")
    serving = tk.sweep(torch, shapes, 1, launches=TUNE_LAUNCHES)
    sweep_lines(serving, counts, "serving B = 1")
    training = tk.sweep(torch, shapes, TRAIN_BATCH, relu=False,
                        launches=TUNE_LAUNCHES)
    sweep_lines(training, counts, f"training forward B = {TRAIN_BATCH}")
    measured = tk.entries(serving)
    log(f"tune: {len(measured)} shape(s) beat fwd_plan by more than "
        f"{tk.GAIN:.0%}: {sorted(measured)}")
    # the check table: the measured winners, else each shape's fastest
    # other split (the check is that a table reaches the launches), and
    # one invalid entry, which must be ignored
    table = dict(measured)
    for r in serving:
        key = tuning.key(*r["shape"][1:])
        others = {s: ms for s, ms in r["ms"].items() if s != r["heuristic"]}
        if key not in table and others:
            s = min(others, key=others.get)
            table[key] = {"splits": s, "ms": others[s],
                          "heuristic_ms": r["heuristic_ms"]}
    invalid = shapes[0]
    table[tuning.key(*invalid)] = {"splits": 0}
    want_splits = {s: (table[tuning.key(*s)]["splits"]
                       if s != invalid and tuning.key(*s) in table
                       else conv.fwd_plan(1, *s)[0]) for s in shapes}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    committed = tuning._TUNE_PATH
    requests = [port.raw_request(rgb, depth, mask_format=1)
                for rgb, depth in frames]
    x = torch.cat([port.preprocess(torch.from_numpy(rgb).cuda()[None], 256)
                   for rgb, _ in frames[:2]])
    with torch.no_grad():
        untuned = folded(x)
    total = dict.fromkeys(KERNELS, 0)
    try:
        tuning._TUNE_PATH = tmp / "CUDA_TUNE.json"
        tuning.save_entries(table, {"device": torch.cuda.get_device_name(0),
                                    "card": nvidia_smi_line()})
        conv.conv3x3_bn_relu.splits_taken.clear()
        with torch.no_grad():
            tuned_logits = folded(x)
        err = rel_l2(torch, tuned_logits, untuned)
        check(err <= BF16_TOL, f"tuned logits: relative L2 {err} > {BF16_TOL}")

        def servicer(**fields):
            service = port.VisionAnalysisService(folded, cfg=port.ServerConfig(
                address="localhost:0", metrics_csv=str(tmp / "m.csv"),
                calibration_path=str(tmp / "none.npz"), **fields),
                device="cuda")
            service.warmup(FRAME_W, FRAME_H)
            return service

        direct = servicer()
        reset_launches()
        answers = list(direct.analyze_stream(iter(requests)))
        launches = read_launches()
        direct.close()
        want = frame_launches(len(requests), served=True)
        check(launches == want, f"tuned servicer launches {launches}, want "
              f"{want}")
        total = dict(launches)
        taken = {s: conv.conv3x3_bn_relu.splits_taken.get(s) for s in shapes}
        check(taken == want_splits, f"splits taken {taken}, want {want_splits}")
        batched = servicer(batch_window_ms=2.0, max_batch=MAX_BATCH)
        reset_launches()
        got, _ = concurrent_streams(batched, [requests] * STREAMS)
        for k, v in read_launches().items():
            total[k] += v
        batched.close()
        # as the servicer phase holds them: status, mask bytes and
        # coverage equal, curvature within GEOM_RTOL (a batch of more than
        # one frame takes the reference geometry ops)
        for i, stream in enumerate(got):
            for resp, ref in zip(stream, answers):
                check(resp.status == ref.status and resp.mask == ref.mask
                      and resp.mask_coverage == ref.mask_coverage,
                      f"tuned batched stream {i}: status, mask bytes or "
                      "coverage differ from the direct frames'")
                check(np.allclose([resp.mean_curvature, resp.max_curvature],
                                  [ref.mean_curvature, ref.max_curvature],
                                  rtol=GEOM_RTOL, atol=0),
                      f"tuned batched stream {i}: curvature beyond rtol "
                      f"{GEOM_RTOL}")
        # the forward itself: a stack of MAX_BATCH frames bit for bit the
        # frames alone under the table
        x8 = torch.cat([port.preprocess(torch.from_numpy(rgb).cuda()[None],
                                        256) for rgb, _ in frames])
        with torch.no_grad():
            stacked = folded(x8)
            alone = torch.cat([folded(x8[i:i + 1]) for i in range(len(x8))])
        check(bitwise_equal(torch, stacked, alone),
              f"tuned forward: a frame of a B = {len(x8)} stack differs from "
              "the frame alone")
        check(all(a.status.startswith(("OK", "DEGRADED")) for a in answers),
              f"tuned statuses {[a.status for a in answers]}")
        log(f"tune table ({len(table) - 1} entries + 1 invalid, ignored): "
            f"{len(requests)} frames served, launches {launches}; logits "
            f"relative L2 {err:.3g} of the untuned forward; {STREAMS} batched "
            f"streams' masks equal the direct frames' and a B = {len(x8)} "
            f"forward the frames alone bit for bit; splits taken "
            + ", ".join(f"{s[0]}x{s[1]}:{s[2]}->{s[3]} {taken[s]}"
                        for s in shapes))
    finally:
        tuning._TUNE_PATH = committed
        tuning.invalidate_cache()
        (tmp / "CUDA_TUNE.json").unlink(missing_ok=True)
    check(not committed.exists(), f"{committed} was left behind")
    log(f"tuning_phase: {time.perf_counter() - t_phase:.1f} s "
        f"[{nvidia_smi_line()}]")
    return total


# -- phase 20: the serving fleet -------------------------------------------------


def compute_apps() -> list:
    """(pid, used memory) of each process holding a context on the card,
    as ``nvidia-smi --query-compute-apps`` lists them. In a sandbox with
    its own PID namespace nvidia-smi may report another pid (1) for every
    process: :func:`fleet_on_card` then counts contexts."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    apps = []
    for line in out.stdout.strip().splitlines():
        pid, mem = (part.strip() for part in line.split(",", 1))
        apps.append((int(pid), mem))
    return apps


def fleet_on_card(baseline: list, pids: dict, replicas: tuple,
                  absent: tuple) -> str:
    """Check that each of ``replicas`` holds a context on the card and
    none of ``absent`` does: by pid where nvidia-smi reports this
    namespace's pids, else by count (``baseline``: the contexts before
    the spawns). Returns the line to print."""
    apps = compute_apps()
    listed = dict(apps)
    if any(pids[k] in listed for k in replicas):
        check(all(pids[k] in listed for k in replicas),
              f"replica pids {pids} not all among the card's {apps}")
        check(not any(pids[k] in listed for k in absent),
              f"{absent} hold a context on the card: {apps}")
        return ", ".join(f"{k} pid {pids[k]} {listed.get(pids[k], 'absent')}"
                         for k in replicas + absent)
    check(len(apps) == len(baseline) + len(replicas),
          f"{len(apps)} contexts on the card, want {len(baseline)} before "
          f"the spawns + {len(replicas)} replicas ({absent} none): {apps}")
    return (f"nvidia-smi lists pids {sorted(set(listed))} (not this "
            f"namespace's), so by count: {len(baseline)} context(s) before, "
            f"{len(apps)} after: + replicas "
            + ", ".join(f"{k} pid {pids[k]}" for k in replicas)
            + f"; the card's entries {apps}; {', '.join(absent)} "
            + "(pid " + ", ".join(str(pids[k]) for k in absent)
            + ") add none")


def fleet_stats(fleet_lib, grpc, endpoint: str) -> dict:
    """One ``rdp.fleet.ReplicaStats/Get`` of a replica or a front-end."""
    with grpc.insecure_channel(endpoint) as channel:
        return fleet_lib.fetch_replica_stats(
            fleet_lib.ReplicaStatsStub(channel), timeout_s=10.0)


def set_drain(fleet_lib, grpc, endpoint: str, draining: bool) -> None:
    """The Drain RPC: a replica leaves (or rejoins) new-stream placement
    with its health up."""
    with grpc.insecure_channel(endpoint) as channel:
        fleet_lib.ReplicaStatsStub(channel).Drain(
            json.dumps({"draining": draining}).encode(), timeout=10.0)


def wait_for(what: str, fn, timeout_s: float = FLEET_WAIT_S,
             poll_s: float = 0.1):
    """Poll ``fn`` until it returns a true value; fails after
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = fn()
        if got:
            return got
        check(time.monotonic() < deadline,
              f"fleet: {what} not reached in {timeout_s:.0f} s")
        time.sleep(poll_s)


def http_text(port_no: int, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://localhost:{port_no}{path}",
                                timeout=30) as resp:
        return resp.read().decode()


def fleet_streams(grpc, vision_grpc, endpoint: str, streams: list,
                  metadata=()) -> tuple[list, float]:
    """Each request list as one gRPC stream to ``endpoint`` on its own
    thread; returns (responses per stream, wall seconds)."""
    import threading

    out: list = [None] * len(streams)
    errors: list = []

    def run(i):
        try:
            with grpc.insecure_channel(endpoint) as channel:
                stub = vision_grpc.VisionAnalysisServiceStub(channel)
                out[i] = list(stub.AnalyzeActuatorPerformance(
                    iter(streams[i]), timeout=300, metadata=metadata))
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
    check(all(o is not None for o in out), "a fleet stream did not finish")
    for i, o in enumerate(out):
        check(all(r.status.startswith(("OK", "DEGRADED")) for r in o),
              f"fleet stream {i}: statuses {[r.status for r in o]}")
    return out, wall


def fleet_phase(torch, port) -> dict:
    """A fleet of port servers behind one front-end on the card: a
    registry of ``ModelConfig()`` calibrated as ``seeded_model``; an
    elastic front-end (``spawn_local_frontends``) and two replicas
    (``spawn_local_replicas``, 256x256 input, warmed at 640x480) joined
    by their leases, each one's seconds to spawn, each replica's pid and
    memory on the card and the front-end's pid absent there; 16 frames
    through the front-end with one placeable replica equal to that
    replica's direct answers bit for bit, and ``/debug/trace`` stitching
    one frame's front-end and replica spans, and an in-process servicer
    built from the same registry entry with the replica's settings
    (``replica.replica_config``) answering the same 16 frames bit for bit
    through the port's kernels, each launched as its dispatches ask (the
    replicas count their launches in their own processes, so this is the
    fleet's link to the counts); failover: a frame pinned in
    replica B (``serving.analyze:slow:1``) while B is killed is answered
    on A and the stream goes on there, ``/federate`` marks B up then down
    and still serves its last good scrape, and B respawned rejoins
    through its lease; frames/s of 8 streams over two replicas, over one
    and direct to one, FLEET_RATE_ROUNDS rounds each (median and range);
    then an autoscaler front-end (min 1, max 2) over A
    with a capacity file of this run's one-replica rate spawns a second
    replica under 8 streams and drains it when the load stops. Every
    process of the phase is stopped in a ``finally``. Returns the
    in-process servicer's launches."""
    import dataclasses as dc
    import threading

    import grpc

    from robotic_discovery_platform_tpu_torch.ops import build
    from robotic_discovery_platform_tpu_torch.serving import client as client_lib
    from robotic_discovery_platform_tpu_torch.serving import fleet as fleet_lib
    from robotic_discovery_platform_tpu_torch.serving import (
        frontend as frontend_lib,
    )
    from robotic_discovery_platform_tpu_torch.serving import (
        replica as replica_lib,
    )
    from robotic_discovery_platform_tpu_torch.serving.proto import vision_grpc

    from robotic_discovery_platform_tpu_torch import tracking

    log(f"fleet_phase: {torch.cuda.get_device_name(0)} [{nvidia_smi_line()}]")
    t_phase = time.perf_counter()
    prev_uri = tracking.get_tracking_uri()
    build.build()  # before the spawns: every replica loads these libraries
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    uri = f"file:{tmp / 'mlruns'}"
    rng = np.random.default_rng(SEED)
    frames = [port.render_scene(rng, FRAME_H, FRAME_W)[::2] for _ in range(8)]
    x0 = port.preprocess(torch.from_numpy(frames[0][0]).to(FLEET_DEVICE)[None],
                         FLEET_IMG)
    register_models(port, {"staging": seeded_model(torch, port, x0)}, uri)
    tracking.set_tracking_uri(prev_uri)
    reqs = [client_lib.encode_request(rgb[..., ::-1], depth, fmt="raw",
                                      mask_format=1) for rgb, depth in frames]
    stream16 = (reqs * 2)[:FLEET_FRAMES]
    fes, reps, pids = [], {}, {}
    spawn_s = {}

    def spawn_replica(name, env, registrars):
        t0 = time.perf_counter()
        rep = replica_lib.spawn_local_replicas(
            1, uri, img_size=FLEET_IMG, warmup=(FRAME_W, FRAME_H),
            device=FLEET_DEVICE, metrics_port=-1, registrars=registrars,
            lease_ttl_s=FLEET_LEASE_TTL_S, per_replica_env={0: env})[0]
        spawn_s[name] = time.perf_counter() - t0
        reps[name] = rep
        pids[name] = rep.proc.pid

    torch.cuda.synchronize()
    baseline = compute_apps()  # this process's own context
    try:
        t0 = time.perf_counter()
        fes = frontend_lib.spawn_local_frontends(
            1, elastic=True, lease_ttl_s=FLEET_LEASE_TTL_S, poll_s=0.25,
            metrics_port=-1, replica_device=FLEET_DEVICE)
        fe = fes[0]
        spawn_s["frontend"] = time.perf_counter() - t0
        pids["frontend"] = fe.proc.pid
        errors = []

        def spawn_safely(*args):
            try:
                spawn_replica(*args)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        # both replicas at once, each registered with the front-end by
        # its lease; B's first served frame will sleep FLEET_PIN_S
        threads = [threading.Thread(target=spawn_safely, args=(
            name, env, fe.endpoint)) for name, env in (
                ("A", {}), ("B", {"RDP_FAULTS": "serving.analyze:slow:1",
                                  "RDP_FAULT_SLOW_S": str(FLEET_PIN_S)}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        a, b = reps["A"], reps["B"]
        wait_for("two leased replicas live", lambda: fleet_stats(
            fleet_lib, grpc, fe.endpoint)["live_replicas"] == 2)
        on_card = fleet_on_card(baseline, pids, ("A", "B"), ("frontend",))
        log("fleet spawn seconds: " + ", ".join(
            f"{k} {v:.1f}" for k, v in spawn_s.items()) + "; on the card: "
            + on_card)

        # (1) one placeable replica: the relay is bit for bit the replica
        set_drain(fleet_lib, grpc, b.endpoint, True)
        wait_for("B out of placement", lambda: fleet_stats(
            fleet_lib, grpc, fe.endpoint)["live_replicas"] == 1)
        direct, _ = fleet_streams(grpc, vision_grpc, a.endpoint, [stream16])
        tid = "%032x" % (SEED + 0xF1EE7)
        meta = (("traceparent", f"00-{tid}-{'%016x' % 1}-01"),)
        relayed, _ = fleet_streams(grpc, vision_grpc, fe.endpoint,
                                   [stream16], metadata=meta)
        check([answer_key(r) for r in relayed[0]]
              == [answer_key(r) for r in direct[0]],
              "one-replica fleet: relayed answers differ from the replica's")
        check(fleet_stats(fleet_lib, grpc, b.endpoint)["frames_total"] == 0,
              "the drained replica served frames")
        stitched = json.loads(http_text(fe.metrics_port,
                                        f"/debug/trace?id={tid}"))
        roles = {s["role"] for s in stitched["tree"]["children"]}
        check(roles == {"frontend", "replica"},
              f"/debug/trace stitched {roles}, want the front-end's and a "
              "replica's spans")
        log(f"fleet one replica: {FLEET_FRAMES} frames relayed equal the "
            f"replica's direct answers bit for bit; /debug/trace {tid}: "
            f"{stitched['timelines_total']} timelines from {sorted(roles)}")
        launches = same_servicer_launches(port, replica_lib, uri, tmp,
                                          stream16, direct[0])

        # (2) failover: the stream on B, B's first frame pinned, B killed
        set_drain(fleet_lib, grpc, a.endpoint, True)
        set_drain(fleet_lib, grpc, b.endpoint, False)
        time.sleep(4 * 0.25)  # the front-end's polls see both flags
        federate = http_text(fe.metrics_port, "/federate")
        up = f'rdp_replica_up{{replica="{b.endpoint}"}}'
        check(f"{up} 1.0" in federate or f"{up} 1" in federate,
              f"/federate before the kill lacks {up} 1")
        import queue as queue_lib

        outbox: queue_lib.Queue = queue_lib.Queue()

        def gen():
            while (item := outbox.get()) is not None:
                yield item

        channel = grpc.insecure_channel(fe.endpoint)
        responses = vision_grpc.VisionAnalysisServiceStub(
            channel).AnalyzeActuatorPerformance(gen(), timeout=300)
        outbox.put(reqs[0])
        wait_for("the stream on B", lambda: fleet_stats(
            fleet_lib, grpc, b.endpoint)["inflight_streams"] == 1, 30.0)
        set_drain(fleet_lib, grpc, a.endpoint, False)
        time.sleep(4 * 0.25)  # A placeable again: the failover target
        t_kill = time.perf_counter()
        b.kill()
        answers = [next(responses)]
        failover_s = time.perf_counter() - t_kill
        for req in reqs[1:]:
            outbox.put(req)
            answers.append(next(responses))
        outbox.put(None)
        check(list(responses) == [], "the failed-over stream has stragglers")
        channel.close()
        check(len(answers) == len(reqs), "an accepted frame was dropped")
        statuses = [r.status.split(":")[0] for r in answers]
        check(all(s in ("OK", "DEGRADED", "ERROR") for s in statuses),
              f"failover statuses {statuses}")
        check(all(s != "ERROR" for s in statuses[1:]),
              f"the stream did not go on on the survivor: {statuses}")
        fe_metrics = http_text(fe.metrics_port, "/metrics")
        failovers = [line for line in fe_metrics.splitlines()
                     if line.startswith("rdp_fleet_failover")]
        federate = http_text(fe.metrics_port, "/federate")
        check(f"{up} 0" in federate, f"/federate after the kill lacks {up} 0")
        kept = [line for line in federate.splitlines()
                if f'replica="{b.endpoint}"' in line
                and not line.startswith("rdp_replica_")]
        check(kept, "/federate lost the killed replica's last good scrape")
        log(f"fleet failover: B killed {FLEET_PIN_S} s into a pinned frame; "
            f"that frame answered {statuses[0]} after {failover_s:.2f} s, the "
            f"stream went on on A ({len(answers)} of {len(reqs)} frames "
            f"answered); /federate: {up} 1 -> 0, {len(kept)} samples of B's "
            f"last good scrape kept; {failovers}")

        # (3) B respawned on its port rejoins through its lease
        t0 = time.perf_counter()
        clean = {k: v for k, v in b.env.items()
                 if k not in ("RDP_FAULTS", "RDP_FAULT_SLOW_S")}
        b = reps["B"] = replica_lib.respawn_replica(dc.replace(b, env=clean))
        pids["B'"] = b.proc.pid
        respawn_s = time.perf_counter() - t0
        wait_for("B rejoined", lambda: fleet_stats(
            fleet_lib, grpc, fe.endpoint)["live_replicas"] == 2)
        rejoin_s = time.perf_counter() - t0
        lease = fleet_stats(fleet_lib, grpc, fe.endpoint)["leases"][b.endpoint]
        check(lease["state"] == "active", f"B's lease {lease}")
        log(f"fleet rejoin: B respawned in {respawn_s:.1f} s, placeable "
            f"again {rejoin_s:.1f} s after its respawn began (lease "
            f"re-registered, breaker half-open probe)")

        # (4) frames/s: 8 streams over two replicas, over one, direct;
        # each leg FLEET_RATE_ROUNDS rounds of about a second
        streams = [[reqs[(i + j) % len(reqs)] for j in range(FLEET_FRAMES)]
                   for i in range(STREAMS)]
        n = STREAMS * FLEET_FRAMES

        def rates(endpoint):
            return [n / fleet_streams(grpc, vision_grpc, endpoint,
                                      streams)[1]
                    for _ in range(FLEET_RATE_ROUNDS)]

        before = {k: fleet_stats(fleet_lib, grpc, r.endpoint)["frames_total"]
                  for k, r in (("A", a), ("B", b))}
        rates2 = rates(fe.endpoint)
        served = {k: fleet_stats(fleet_lib, grpc, r.endpoint)["frames_total"]
                  - before[k] for k, r in (("A", a), ("B", b))}
        check(all(v > 0 for v in served.values()) and sum(
            served.values()) == FLEET_RATE_ROUNDS * n,
            f"8 streams over two replicas: frames per replica {served}")
        set_drain(fleet_lib, grpc, b.endpoint, True)
        wait_for("B out of placement", lambda: fleet_stats(
            fleet_lib, grpc, fe.endpoint)["live_replicas"] == 1)
        rates1 = rates(fe.endpoint)
        rates_direct = rates(a.endpoint)
        rate1 = float(np.median(rates1))

        def spread(r):
            return (f"median {np.median(r):.1f} (range {min(r):.1f}-"
                    f"{max(r):.1f}; rounds {', '.join(f'{x:.1f}' for x in r)})")

        log(f"fleet frames/s, {STREAMS} streams x {FLEET_FRAMES} frames, "
            f"{FLEET_RATE_ROUNDS} rounds per leg: front-end over 2 replicas "
            f"{spread(rates2)} (A {served['A']}, B {served['B']} frames); "
            f"over 1 {spread(rates1)}; direct to one {spread(rates_direct)} "
            f"[{nvidia_smi_line()}]")
        set_drain(fleet_lib, grpc, b.endpoint, False)

        # (5) the autoscaler over A: up under load, down when it stops
        capacity = tmp / "capacity.json"
        capacity.write_text(json.dumps({"rows": [{
            "goodput_rps": rate1, "violation_rate": 0.0, "chips": 1,
            "placement": "shared"}]}))
        t0 = time.perf_counter()
        fes += frontend_lib.spawn_local_frontends(
            1, replicas=a.endpoint, tracking_uri=uri, elastic=True,
            lease_ttl_s=FLEET_LEASE_TTL_S, poll_s=0.25, window_ms=2.0,
            autoscaler=True, autoscaler_min=1, autoscaler_max=2,
            sustain_s=0.5, cooldown_s=2.0, headroom=0.7,
            capacity_path=str(capacity), metrics_port=-1,
            replica_device=FLEET_DEVICE)
        scaler = fes[-1]
        pids["autoscaler"] = scaler.proc.pid
        wait_for("the autoscaler's front-end over A", lambda: fleet_stats(
            fleet_lib, grpc, scaler.endpoint)["live_replicas"] == 1)
        stop = threading.Event()
        load_errors = []

        def load():
            long = [reqs[j % len(reqs)] for j in range(FLEET_FRAMES)]
            while not stop.is_set():
                try:
                    fleet_streams(grpc, vision_grpc, scaler.endpoint,
                                  [long] * STREAMS)
                except BaseException as exc:  # noqa: BLE001
                    load_errors.append(exc)
                    return

        loader = threading.Thread(target=load)
        t_load = time.perf_counter()
        loader.start()
        try:
            stats = wait_for("the autoscaler's scale-up", lambda: (
                s if (s := fleet_stats(fleet_lib, grpc, scaler.endpoint))[
                    "live_replicas"] == 2 else None), 180.0, 0.25)
            up_s = time.perf_counter() - t_load
        finally:
            stop.set()
            t_stop = time.perf_counter()
            loader.join(timeout=300)
        if load_errors:
            raise load_errors[0]
        last_round_s = time.perf_counter() - t_stop
        spawned = [ep for ep, lease in stats["leases"].items()
                   if lease["state"] == "active" and ep != a.endpoint]
        check(len(spawned) == 1, f"autoscaler leases {stats['leases']}")
        pids["spawned"] = fleet_stats(fleet_lib, grpc, spawned[0])["pid"]
        wait_for("the autoscaler's scale-down", lambda: fleet_stats(
            fleet_lib, grpc, scaler.endpoint)["live_replicas"] == 1, 120.0,
            0.25)
        down_s = time.perf_counter() - t_stop
        actions = [line for line in http_text(
            scaler.metrics_port, "/metrics").splitlines()
            if line.startswith("rdp_autoscaler_actions_total")]
        acted = {x.split('action="')[1].split('"')[0]
                 for x in actions if float(x.rsplit(" ", 1)[1]) > 0}
        check({"scale_up", "scale_down"} <= acted,
              f"autoscaler actions {actions}")
        log(f"fleet autoscaler (capacity {rate1:.1f} frames/s per replica, "
            f"headroom 0.7): scale-up to 2 replicas {up_s:.1f} s after the "
            f"load began (spawned {spawned[0]}, pid {pids['spawned']}), "
            f"drained back to 1 {down_s:.1f} s after the load was stopped "
            f"(its streams in flight ended {last_round_s:.1f} s after); "
            f"{actions}")
    finally:
        frontend_lib.stop_frontends(fes)
        replica_lib.stop_replicas(list(reps.values()))
    left, apps = [], []
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        apps = compute_apps()
        left = [k for k, p in pids.items() if pid_alive(p)]
        if not left and len(apps) == len(baseline):
            break
        time.sleep(0.5)
    check(not left, f"fleet processes left running: {left}")
    check(len(apps) == len(baseline),
          f"contexts left on the card: {apps}, before the phase {baseline}")
    log(f"fleet_phase: {time.perf_counter() - t_phase:.1f} s, every process "
        f"of the phase stopped [{nvidia_smi_line()}]")
    return launches


def same_servicer_launches(port, replica_lib, uri: str, tmp: Path,
                           stream: list, direct: list) -> dict:
    """A servicer in this process built from the replica's registry entry
    and settings (``replica.replica_config``: the input size, the batch
    window and the batch cap) answers ``stream`` as the replica did
    (``direct``), bit for bit, and launches each kernel as many times as
    its dispatches ask; returns those launches."""
    from robotic_discovery_platform_tpu_torch import tracking

    prev_uri = tracking.get_tracking_uri()
    cfg = replica_lib.replica_config(uri, img_size=FLEET_IMG,
                                     workdir=str(tmp / "in_process"))
    (tmp / "in_process").mkdir(exist_ok=True)
    service = port.build_service(cfg, warmup_shape=(FRAME_W, FRAME_H),
                                 device="cuda")
    try:
        tracking.set_tracking_uri(prev_uri)
        service.dispatcher.dispatch_sizes.clear()
        reset_launches()
        answers = list(service.analyze_stream(iter(stream)))
        launches = read_launches()
        sizes = dict(sorted(service.dispatcher.dispatch_sizes.items()))
    finally:
        service.close()
    check(sum(k * v for k, v in sizes.items()) == len(stream),
          f"in-process replica: dispatch sizes {sizes} for {len(stream)} "
          "frames")
    want = frame_launches(0, dispatches=sum(sizes.values()),
                          ones=sizes.get(1, 0))
    check(launches == want, f"in-process replica: launches {launches}, want "
          f"{want} for dispatch sizes {sizes}")
    check([answer_key(r) for r in answers] == [answer_key(r) for r in direct],
          "in-process replica: answers differ from the replica process's")
    log(f"fleet in-process replica (replica_config, {FLEET_IMG}^2, batch cap "
        f"{cfg.max_batch}): {len(stream)} frames equal replica A's direct "
        f"answers bit for bit; dispatch sizes {sizes}; launches {launches}")
    return launches


def pid_alive(pid: int) -> bool:
    import os

    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


SIM_MODELS = ("seg", "aux")
SIM_SEED = 0
SIM_SLO_MS = 250.0  # the server's objective and the legs' (JAX defaults)
SIM_RATE_SHARE = 0.3  # each model's mean rate: this share of the closed
# loop's frames/s in the legs' own shape (one request a stream)
SIM_PERIOD_S = 4.0
SIM_DURATION_S = 8.0
SIM_CLOSED_FRAMES = 200  # frames of each closed-loop measurement
SIM_CLIENT_GAP_S = 1.0  # least time between two arrivals of one client
# process: four times the SLO, and above the longest latency an H100 host
# has shown in the legs (569 ms)
SIM_LEG_TRIES = 10  # a leg not open loop is fired again, this often in
# all (an H100 host has missed the bar in four attempts of a leg in a row
# under the whole script; a round of the three legs takes ~28 s)
SIM_START_S = 0.5  # from every client's being warm to the first leg
SIM_GAP_S = 1.0  # from a leg's last offset to the next leg's start
SIM_MAX_LAG_MS = 2.0  # an arrival later than this was not open loop
SIM_SPIN_S = 0.015  # the end of a client's wait, spun rather than slept
SIM_ABS_TOL_MS = 1.0  # calibrate's absolute floor (its default: 20 ms)
SIM_LEGS = (("baseline-seg", ("seg",)), ("baseline-aux", ("aux",)),
            ("multiplexed", ("seg", "aux")))
SIM_LEGS_FILE = (Path(__file__).resolve().parent / "chiprun_out"
                 / "sim_card_legs.json")


def open_loop_client(job_path: str, index: int) -> None:
    """One of ``sim_clients`` load-generator processes of the sim phase (no
    torch, no card), with one thread. Once warm it prints ``ready``, then
    reads rounds from its standard input until the input ends, one file
    a line: the file's ``legs`` give each leg's schedule and its
    ``starts`` each leg's start (``time.perf_counter``, the system's
    monotonic clock, which every process shares). It sends every
    ``clients``-th arrival of a leg's schedule (from ``index``) at its
    offset, as one gRPC call of one pre-serialised request
    (``unary_stream`` on the wire of the streaming method: the request
    goes out in the call's first batch, from this thread), and reads its
    answer before it takes the next. There are enough processes that
    the previous answer is in long before (a process's arrivals lie
    SIM_CLIENT_GAP_S or more apart), and an arrival that finds its
    process still reading is recorded as having waited. The thread sleeps until
    SIM_SPIN_S before an offset and spins the rest, with no system call:
    an H100 host has woken a sleeping thread 9 ms late when idle and 13
    ms late under the legs, and has delayed a thread handed the
    interpreter lock, or one spinning through an event loop's polls, by
    as much, so a process of one thread hands nothing to another at the
    offset. The garbage collector is off during a round. Writes per
    arrival (model, offset, start lag, latency from the offset, ok, how
    late the sleep woke, whether it waited for the previous answer) and
    each leg's last completion to the round's ``out`` file with
    ``index`` appended, then prints ``done``."""
    import gc

    import grpc

    from robotic_discovery_platform_tpu_torch.serving.proto import (
        vision_grpc,
        vision_pb2,
    )

    job = json.loads(Path(job_path).read_text())
    payload = {m: Path(f).read_bytes() for m, f in job["requests"].items()}
    with grpc.insecure_channel(job["address"]) as channel:
        call = channel.unary_stream(vision_grpc._ANALYZE_PATH,
                                    request_serializer=None,
                                    response_deserializer=None)

        def one(model: str) -> bool:
            status = None
            try:
                for raw in call(payload[model], timeout=60):
                    status = vision_pb2.AnalysisResponse.FromString(
                        raw).status
            except grpc.RpcError:
                return False
            return status is not None and not status.startswith("ERROR")

        for model in payload:  # the channel and each model's path warm
            for _ in range(2):
                one(model)
        print("ready", flush=True)
        for line in sys.stdin:
            go = json.loads(Path(line.strip()).read_text())
            out = {"legs": {}}
            # no collector pause inside a leg: what exists now is frozen
            # out of the collections, and none runs until the round ends
            gc.collect()
            gc.freeze()
            gc.disable()
            done = 0.0  # the previous answer's completion
            for (name, sched), t0 in zip(go["legs"].items(), go["starts"]):
                records = []
                for offset, model in sched[index::job["clients"]]:
                    target = t0 + offset
                    delay = target - SIM_SPIN_S - time.perf_counter()
                    woke = 0.0
                    if delay > 0:
                        time.sleep(delay)
                        woke = time.perf_counter() - (target - SIM_SPIN_S)
                    while time.perf_counter() < target:
                        pass
                    waited = done > target
                    start = time.perf_counter()
                    ok = one(model)
                    done = time.perf_counter()
                    records.append((model, offset, start - target,
                                    done - target, ok, woke, waited))
                out["legs"][name] = {"records": records,
                                     "end_s": time.perf_counter() - t0}
            gc.enable()
            Path(f"{go['out']}.{index}").write_text(json.dumps(out))
            print("done", flush=True)


def await_clients(folder: Path, procs: list, word: str,
                  timeout_s: float) -> None:
    """Read one line from each ``open_loop_client`` and fail unless every
    one said ``word`` within ``timeout_s``."""
    import select

    deadline = time.perf_counter() + timeout_s
    for i, proc in enumerate(procs):
        ready, _, _ = select.select(
            [proc.stdout], [], [], max(0.0, deadline - time.perf_counter()))
        said = proc.stdout.readline().decode().strip() if ready else ""
        err = (folder / f"client.{i}.err").read_text()[-2000:]
        check(said == word, f"open-loop client {i} said {said!r}, not "
              f"{word!r} (exit code {proc.poll()}): {err}")


def sim_clients(schedules: dict) -> int:
    """The fewest client processes among which every leg's arrivals,
    dealt out in turn, lie SIM_CLIENT_GAP_S or more apart in each."""
    n = 1
    for sched in schedules.values():
        offsets = sorted(offset for offset, _ in sched)
        while any(b - a < SIM_CLIENT_GAP_S
                  for a, b in zip(offsets, offsets[n:])):
            n += 1
    return n


def start_clients(folder: Path, address: str, files: dict,
                  clients: int) -> list:
    """``clients`` ``open_loop_client`` processes, launched together and
    returned once every one is warm. Each one's errors go to
    ``client.<index>.err`` in ``folder``."""
    folder.mkdir(parents=True)
    job = folder / "job.json"
    job.write_text(json.dumps({"address": address, "requests": files,
                               "clients": clients}))
    procs = []
    for i in range(clients):
        with open(folder / f"client.{i}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.open_loop_client(sys.argv[1], "
                 "int(sys.argv[2]))", str(job), str(i)],
                cwd=Path(__file__).resolve().parent, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, bufsize=0))
    await_clients(folder, procs, "ready", 120.0)
    return procs


def stop_clients(procs: list) -> list:
    """End the clients' input and reap them (killing any that outlive 60
    s); returns their exit codes."""
    for proc in procs:
        proc.stdin.close()
    deadline = time.perf_counter() + 60.0
    for proc in procs:
        try:
            proc.wait(timeout=max(0.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return [proc.returncode for proc in procs]


def fire_legs(folder: Path, procs: list, name: str,
              schedules: dict) -> tuple:
    """One round of open-loop legs from the warm clients: the legs start
    SIM_START_S after the round is handed out, one after another
    SIM_GAP_S apart. Returns each leg's merged records and last
    completion, and the round's seconds."""
    t0 = time.perf_counter()
    cpu0 = os.times()
    start = t0 + SIM_START_S
    go = folder / f"{name}.json"
    go.write_text(json.dumps({
        "legs": schedules, "out": str(folder / f"{name}.legs"),
        "starts": [start + i * (SIM_DURATION_S + SIM_GAP_S)
                   for i in range(len(schedules))]}))
    for proc in procs:
        proc.stdin.write(f"{go}\n".encode())
        proc.stdin.flush()
    await_clients(folder, procs, "done", SIM_START_S + 120.0
                  + len(schedules) * (SIM_DURATION_S + SIM_GAP_S))
    cpu1 = os.times()
    wall = time.perf_counter() - t0
    server = cpu1.user - cpu0.user + cpu1.system - cpu0.system
    log(f"sim {name}: this process (the server) used {server / wall:.2f} "
        f"cores over {wall:.1f} s")
    legs: dict = {}
    for i in range(len(procs)):
        part = json.loads(Path(f"{folder / name}.legs.{i}").read_text())
        for leg_name, got in part["legs"].items():
            leg = legs.setdefault(leg_name, {"records": [], "end_s": 0.0})
            leg["records"] += got["records"]
            leg["end_s"] = max(leg["end_s"], got["end_s"])
    SIM_LEGS_FILE.parent.mkdir(parents=True, exist_ok=True)
    (SIM_LEGS_FILE.parent / f"sim_client_records_{name}.json"
     ).write_text(json.dumps(legs))
    return legs, wall


def leg_row(got: dict, leg: str, active, n: int, cfg,
            clients: int) -> tuple:
    """One leg's LOADBENCH row (``sim.metrics.summarize_level`` per model
    and over all), with its start lags, the latest wake of a client's
    sleep, the most arrivals in flight at once, the arrivals that waited
    for their client's previous answer and the least time between two
    arrivals of one client; and its answered frames."""
    from robotic_discovery_platform_tpu_torch.sim import metrics

    recs = got["records"]
    check(len(recs) == n, f"sim {leg}: {len(recs)} of {n} arrivals recorded")
    lags = [r[2] * 1e3 for r in recs]
    edges = sorted([(r[1] + r[2], 1) for r in recs]
                   + [(r[1] + r[3], -1) for r in recs])
    errors = sum(1 for r in recs if not r[4])
    offsets = sorted(r[1] for r in recs)
    models = {}
    for m in SIM_MODELS:
        mine = [r for r in recs if r[0] == m]
        models[m] = metrics.summarize_level(
            [r[3] * 1e3 for r in mine if r[4]],
            sum(1 for r in mine if not r[4]),
            len(mine) / got["end_s"], got["end_s"], SIM_SLO_MS)
    row = metrics.summarize_level(
        [r[3] * 1e3 for r in recs if r[4]], errors,
        len(recs) / got["end_s"], got["end_s"], SIM_SLO_MS)
    row.update(models=models, multimodel_leg=leg, chips=1,
               placement="shared", active_models=list(active),
               batch_window_ms=cfg.batch_window_ms,
               start_lag_ms={"max": max(lags),
                             "p50": float(np.percentile(lags, 50)),
                             "p99": float(np.percentile(lags, 99))},
               inflight_max=max(itertools.accumulate(d for _, d in edges)),
               waited=sum(1 for r in recs if r[6]),
               client_gap_min_ms=min(
                   (b - a for a, b in zip(offsets, offsets[clients:])),
                   default=got["end_s"]) * 1e3,
               sleep_woke_late_ms=max(r[5] for r in recs) * 1e3)
    return row, len(recs) - errors


def sim_attempt(legs: dict, pending: list, schedules: dict, cfg,
                clients: int, attempt: int, round_s: float, rows: dict,
                rejected: list) -> int:
    """Sort one round's legs: a leg whose every arrival started within
    SIM_MAX_LAG_MS of its offset goes to ``rows``, any other to
    ``rejected``; an error or an arrival that waited for its client's
    previous answer fails the phase. Returns the answered frames."""
    answered = 0
    for leg, active in pending:
        row, ok_frames = leg_row(legs[leg], leg, active,
                                 len(schedules[leg]), cfg, clients)
        answered += ok_frames
        lag = row["start_lag_ms"]["max"]
        per = {m: tuple(row["models"][m][k] for k in (
            "n", "offered_rps", "p50_ms", "p99_ms", "violation_rate"))
            for m in active}
        log(f"sim leg {leg}, attempt {attempt}: {row['arrivals']} "
            f"arrivals in {row['wall_s']:.2f} s, {row['errors']} "
            f"errors; per model (n, offered/s, p50 ms, p99 ms, "
            f"violation rate) {per}; "
            f"start lag ms max {lag:.3f} p99 "
            f"{row['start_lag_ms']['p99']:.3f}; the clients' sleeps "
            f"woke at most {row['sleep_woke_late_ms']:.3f} ms late "
            f"(spun from {SIM_SPIN_S * 1e3:.0f} ms before the "
            f"offset); at most {row['inflight_max']} arrivals in "
            f"flight at once; a client's arrivals at least "
            f"{row['client_gap_min_ms']:.0f} ms apart, "
            f"{row['waited']} waited for an answer; round "
            f"{round_s:.1f} s")
        check(row["errors"] == 0,
              f"sim {leg}: {row['errors']} arrivals failed")
        check(row["waited"] == 0,
              f"sim {leg}: {row['waited']} arrivals waited for their "
              f"client's previous answer: {clients} clients are "
              f"too few for an open loop")
        row["attempt"] = attempt
        if lag <= SIM_MAX_LAG_MS:
            rows[leg] = row
        else:
            rejected.append(row)
            log(f"sim leg {leg}, attempt {attempt}: an arrival "
                f"started {lag:.3f} ms late (bar {SIM_MAX_LAG_MS} "
                f"ms): not open loop, the leg is fired again")
    return answered


def sim_phase(torch, port) -> dict:
    """The fleet's twin calibrated against legs measured on the card. (a)
    The zoo's seg and aux models at ``ModelConfig()`` widths (seeded and
    calibrated as ``seeded_model``) behind one gRPC zoo server (shared
    placement, ``slo_ms`` SIM_SLO_MS, the direct path): each model's
    answer over gRPC equal to the servicer's own bit for bit; seg's
    closed-loop frames/s over one stream and over one-frame streams back
    to back; then three open-loop legs of the port's
    ``sim.workload.multimodel`` schedule (seed SIM_SEED, SIM_RATE_SHARE
    of the one-frame streams' rate per model, period SIM_PERIOD_S,
    SIM_DURATION_S s) fired by ``sim_clients`` client processes
    (``open_loop_client``): baseline-seg, baseline-aux and multiplexed,
    every arrival answered. An arrival that waited for its client's
    previous answer fails the phase (the clients are too few). A leg in
    which an arrival started more than SIM_MAX_LAG_MS after its offset
    (a client's late wake-up) was not open loop: it is not kept and is
    fired again, SIM_LEG_TRIES times in all. The kept rows go to SIM_LEGS_FILE
    in the LOADBENCH row shape, the rejected attempts' rows beside them
    under ``rejected_attempts``. (b) ``sim.calibrate`` over
    that file at ``abs_tol_ms`` SIM_ABS_TOL_MS must pass; baseline-seg's
    arrivals replayed through the multiplexed fit is reported, not gated.
    (c) ``sim.sweep`` over the card's fit, with no real ``time.sleep`` on
    its thread. Returns the phase's launches."""
    import random
    import threading

    import grpc

    from robotic_discovery_platform_tpu_torch.models import variants
    from robotic_discovery_platform_tpu_torch.serving import grpc_service
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        vision_grpc,
        vision_pb2,
    )
    from robotic_discovery_platform_tpu_torch.sim import (
        calibrate as calibrate_lib,
        sweep as sweep_lib,
        workload,
    )
    from robotic_discovery_platform_tpu_torch.sim.model import (
        ServiceTimeModel,
    )

    t_phase = time.perf_counter()
    log(f"sim_phase: {torch.cuda.get_device_name(0)} [{nvidia_smi_line()}]")
    rng = np.random.default_rng(SEED)
    rgb, _, depth = port.render_scene(rng, FRAME_H, FRAME_W)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sim_"))
    uri = f"file:{tmp}/mlruns"
    x0 = port.preprocess(torch.from_numpy(rgb).cuda()[None], 256)
    base = port.ServerConfig().model_name
    nets = {variants.registered_name(variants.VARIANTS[m], base): seeded_model(
        torch, port, x0, variants.VARIANTS[m].model_config(port.ModelConfig()))
        for m in SIM_MODELS}
    register_named(port, nets, uri)
    del nets
    reset_launches()
    cfg = port.ServerConfig(
        address="localhost:0", tracking_uri=uri,
        metrics_csv=str(tmp / "m.csv"),
        calibration_path=str(tmp / "none.npz"), reload_poll_s=0.0,
        zoo_models=",".join(SIM_MODELS[1:]), slo_ms=SIM_SLO_MS)
    server, service = grpc_service.build_server(
        cfg, warmup_shape=(FRAME_W, FRAME_H), device="cuda")
    server.start()
    warm = read_launches()
    reset_launches()
    address = f"localhost:{service.bound_port}"
    wire = {m: "" if m == SIM_MODELS[0] else m for m in SIM_MODELS}
    protos = {m: vision_pb2.AnalysisRequest(
        color_image=vision_pb2.Image(data=rgb.tobytes(), width=FRAME_W,
                                     height=FRAME_H, format=1),
        depth_image=vision_pb2.Image(data=depth.astype("<u2").tobytes(),
                                     width=FRAME_W, height=FRAME_H, format=1),
        mask_format=1, model=wire[m]) for m in SIM_MODELS}
    answered = 0
    try:
        with grpc.insecure_channel(address) as channel:
            stub = vision_grpc.VisionAnalysisServiceStub(channel)
            for m in SIM_MODELS:
                got = without_anomaly(answers(stub.AnalyzeActuatorPerformance(
                    iter([protos[m]]), timeout=60)))
                want = without_anomaly(answers(service.analyze_stream(iter([
                    port.raw_request(rgb, depth, mask_format=1,
                                     model=wire[m])]))))
                check(got == want and got[0][0].startswith("OK"),
                      f"sim {m}: gRPC answer {got[0][0]!r} differs from the "
                      f"servicer's {want[0][0]!r}")
                answered += 2
            closed = [protos["seg"]] * SIM_CLOSED_FRAMES
            list(stub.AnalyzeActuatorPerformance(iter(closed[:20]),
                                                 timeout=120))
            t0 = time.perf_counter()
            n = len(list(stub.AnalyzeActuatorPerformance(iter(closed),
                                                         timeout=120)))
            stream_fps = n / (time.perf_counter() - t0)
            # the legs' shape: every frame a gRPC stream of its own, one
            # after the other; 0.3 of the one stream's rate above held
            # such legs near saturation (p99 ~200 ms on an H100 host)
            t0 = time.perf_counter()
            for _ in range(SIM_CLOSED_FRAMES):
                list(stub.AnalyzeActuatorPerformance(iter([protos["seg"]]),
                                                     timeout=60))
            fps = SIM_CLOSED_FRAMES / (time.perf_counter() - t0)
            answered += 20 + n + SIM_CLOSED_FRAMES
        rate = SIM_RATE_SHARE * fps
        log(f"sim closed loop, seg: one gRPC stream of {n} frames "
            f"{stream_fps:.1f} frames/s; {SIM_CLOSED_FRAMES} streams of "
            f"one frame back to back {fps:.1f} frames/s; open-loop rate "
            f"per model {rate:.2f}/s ({SIM_RATE_SHARE} of the latter), "
            f"period {SIM_PERIOD_S} s, {SIM_DURATION_S} s a leg")

        # (a) the open-loop legs, from client processes of their own
        schedules = {leg: workload.multimodel(
            list(active), rate, SIM_DURATION_S, SIM_PERIOD_S,
            random.Random(SIM_SEED)) for leg, active in SIM_LEGS}
        files = {}
        for m in SIM_MODELS:
            files[m] = str(tmp / f"request-{m}.bin")
            Path(files[m]).write_bytes(protos[m].SerializeToString())
        rows: dict = {}
        rejected: list = []  # rows of the attempts that missed the bar
        cpu0 = os.times()
        t_clients = time.perf_counter()
        clients = sim_clients(schedules)
        procs = start_clients(tmp / "clients", address, files, clients)
        answered += 2 * clients * len(SIM_MODELS)  # warm-ups
        rounds = 0
        try:
            for attempt in range(1, SIM_LEG_TRIES + 1):
                pending = [(leg, active) for leg, active in SIM_LEGS
                           if leg not in rows]
                if not pending:
                    break
                legs, round_s = fire_legs(
                    tmp / "clients", procs, f"round{attempt}",
                    {leg: schedules[leg] for leg, _ in pending})
                rounds = attempt
                answered += sim_attempt(legs, pending, schedules, cfg,
                                        clients, attempt, round_s, rows,
                                        rejected)
        finally:
            codes = stop_clients(procs)
        cpu1 = os.times()
        client_cpu = (cpu1.children_user - cpu0.children_user
                      + cpu1.children_system - cpu0.children_system)
        clients_s = time.perf_counter() - t_clients
        log(f"sim clients: {clients} processes used "
            f"{client_cpu / clients_s:.2f} cores over {clients_s:.1f} s, "
            f"{rounds} rounds; exit codes {sorted(set(codes))}")
        check(codes == [0] * clients,
              f"open-loop clients exited with {sorted(set(codes))}")
        check(len(rows) == len(SIM_LEGS),
              f"sim legs {[leg for leg, _ in SIM_LEGS if leg not in rows]}: "
              f"no attempt of {SIM_LEG_TRIES} started every arrival within "
              f"{SIM_MAX_LAG_MS} ms of its offset: not open loop")
    finally:
        grpc_service.shutdown(server, service)
    rows = [rows[leg] for leg, _ in SIM_LEGS]
    for row in rows:
        p99 = {m: [(r["attempt"], r["models"][m]["p99_ms"]) for r in rejected
                   if r["multimodel_leg"] == row["multimodel_leg"]]
               for m in row["active_models"]}
        log(f"sim leg {row['multimodel_leg']}: p99 ms of the kept attempt "
            f"{row['attempt']} "
            f"{ {m: row['models'][m]['p99_ms'] for m in p99} }; of the "
            f"rejected (attempt, p99) {p99}")
    SIM_LEGS_FILE.parent.mkdir(parents=True, exist_ok=True)
    SIM_LEGS_FILE.write_text(json.dumps({
        "metric": "open_loop_tail_latency", "unit": "ms",
        "device": torch.cuda.get_device_name(0), "card": nvidia_smi_line(),
        "arrivals": "modulated-poisson", "slo_ms": SIM_SLO_MS,
        "frame": [FRAME_W, FRAME_H], "mask_format": 1,
        "closed_loop_fps": fps, "one_stream_fps": stream_fps,
        "clients": clients,
        "multimodel": {"models": list(SIM_MODELS), "chips": 1,
                       "rate_per_model": rate, "period_s": SIM_PERIOD_S,
                       "duration_s": SIM_DURATION_S, "seed": SIM_SEED},
        "rows": rows, "rejected_attempts": rejected}, indent=1) + "\n")
    counted = read_launches()
    check(counted == frame_launches(answered, served=True),
          f"sim legs: launches {counted} for {answered} answered frames, "
          f"want 18/1/1/1/1/1 a frame")
    total = {k: warm[k] + counted[k] for k in counted}

    # (b) the calibration gate over the card's own legs
    report = calibrate_lib.calibrate(SIM_LEGS_FILE, None,
                                     seed=SIM_SEED, abs_tol_ms=SIM_ABS_TOL_MS)
    for rec in report["rows"]:
        for m, comp in rec["models"].items():
            log(f"sim calibrate {rec['leg']} {m}: p50 measured "
                f"{comp['p50_ms']['measured']} sim {comp['p50_ms']['sim']} "
                f"({comp['p50_ms']['delta_pct']}%), p99 measured "
                f"{comp['p99_ms']['measured']} sim {comp['p99_ms']['sim']} "
                f"({comp['p99_ms']['delta_pct']}%), violation rate "
                f"{comp['violation_rate']['measured']} / "
                f"{comp['violation_rate']['sim']}; "
                f"{'ok' if rec['ok'] else 'FAILED'}")
    check(report["ok"], f"sim calibrate at abs_tol_ms {SIM_ABS_TOL_MS}: "
          f"{json.dumps(report)}")
    fit = ServiceTimeModel.fit_loadbench(SIM_LEGS_FILE)
    data = json.loads(SIM_LEGS_FILE.read_text())
    seg_row = next(r for r in data["rows"]
                   if r["multimodel_leg"] == "baseline-seg")
    confused = ServiceTimeModel(
        [dataclasses.replace(e, leg="baseline-seg") for e in fit.entries
         if e.leg == "multiplexed"], slo_ms=SIM_SLO_MS, chips=1)
    rec = calibrate_lib.calibrate_row(
        seg_row, confused, seed=SIM_SEED, rate_per_model=rate,
        period_s=SIM_PERIOD_S, duration_s=SIM_DURATION_S, slo_ms=SIM_SLO_MS,
        abs_tol_ms=SIM_ABS_TOL_MS)
    comp = rec["models"]["seg"]
    log(f"sim regime confusion (baseline-seg arrivals through the "
        f"multiplexed fit): p50 {comp['p50_ms']['measured']} vs "
        f"{comp['p50_ms']['sim']} ({comp['p50_ms']['delta_pct']}%), p99 "
        f"{comp['p99_ms']['measured']} vs {comp['p99_ms']['sim']} "
        f"({comp['p99_ms']['delta_pct']}%): the gate "
        f"{'did NOT tell' if rec['ok'] else 'told'} the regimes apart "
        f"(reported, not gated)")

    # (c) the twin at speed, over the card's fit
    sleeps = [0]
    me = threading.get_ident()
    real_sleep = time.sleep

    def counting_sleep(s):
        if threading.get_ident() == me:
            sleeps[0] += 1
        return real_sleep(s)

    time.sleep = counting_sleep
    try:
        t0 = time.perf_counter()
        sweep = sweep_lib.sweep(loadbench_path=SIM_LEGS_FILE, seed=SIM_SEED)
        wall = time.perf_counter() - t0
    finally:
        time.sleep = real_sleep
    virtual = len(sweep["rows"]) * sweep["duration_s"]
    check(not sweep["synthetic_fit"] and len(sweep["rows"]) == 9
          and sleeps[0] == 0,
          f"sim sweep: synthetic {sweep['synthetic_fit']}, "
          f"{len(sweep['rows'])} cells, {sleeps[0]} real sleeps")
    worst = max(sweep["rows"], key=lambda r: r["p99_ms"] or 0.0)
    log(f"sim sweep over the card's fit: {len(sweep['rows'])} cells "
        f"(rates {sweep['grid']['rates']} per model x "
        f"{sweep['grid']['failures']}), {virtual:.0f} virtual s in "
        f"{wall:.2f} s: {virtual / wall:.1f} virtual s per wall s, "
        f"{sum(r['sweep']['events_run'] for r in sweep['rows'])} events, 0 "
        f"real sleeps; worst cell p99 {worst['p99_ms']} ms "
        f"({worst['sweep']['failure']} at {worst['sweep']['rate_per_model']}"
        f"/s)")
    log(f"sim_phase: {time.perf_counter() - t_phase:.1f} s (the clients "
        f"{clients_s:.1f} s, {rounds} rounds)")
    return total


# -- the mesh phase: contracts, the serving ring, the data axis -----------------

MESH_TIMING_FRAMES = 200  # frames per side of the contracts' host cost
MESH_STEP_ITERS = 7  # timed steps of each data-axis step (the median)
# the convolutions' kernels in a profile of a plain-conv train step
# (cuDNN's forward, data-gradient and weight-gradient kernels)
CONV_KERNEL = re.compile(r"conv|cudnn|fprop|dgrad|wgrad|implicit|xmma",
                         re.IGNORECASE)
# a data-axis step against the single-device step: the port's one-step
# bars (tests/test_torch_port_training.py: loss rtol 1e-5, the updated
# parameters' relative L2 over all of them 1e-4) and the JAX package's DP
# bar for each element (tests/test_parallel.py: atol 5e-3, where Adam's
# step on a gradient near 0 can flip sign)
MESH_LOSS_RTOL = 1e-5
MESH_PARAM_REL_L2 = 1e-4
MESH_PARAM_ATOL = 5e-3
MESH_RESET_S = 0.5  # chip_breaker_reset_s of the two-position ring


def frame_answer(r) -> tuple:
    """Everything a response carries of one analyzed frame."""
    return (r.mean_k, r.max_k, r.mask_bytes, r.spline_wire, r.coverage,
            r.valid, r.confidence_margin)


def serve_frames(service, frames, mask_format: int = 1) -> list:
    return [frame_answer(service.analyze_frame(rgb, depth, mask_format))
            for rgb, depth in frames]


def submit_rows(dispatcher, frames, k) -> list:
    """Each frame submitted alone (a dispatch of one frame): its packed
    row, copied."""
    rows = []
    for rgb, depth in frames:
        r = dispatcher.submit(rgb, depth, k, 0.001, timeout_s=60.0)
        rows.append(np.array(r.payload))
        r.release()
    return rows


def contracts_on(on: bool) -> None:
    os.environ["RDP_CONTRACTS"] = "1" if on else "0"


def mesh_contracts_leg(torch, port, folded, frames, tmp: Path) -> tuple:
    """(a) The same frames through the direct servicer and the batched
    dispatcher with the contracts on and off (RDP_CONTRACTS): bit for bit
    the same answers; the host time the contracts add per frame; a
    misshaped submit refused with ContractError before any launch.
    Returns (launches, the batched server's answers)."""
    from robotic_discovery_platform_tpu_torch.analysis.contracts import (
        ContractError,
    )

    total = launches_of()
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    answers = {}
    for leg, window in (("direct", 0.0), ("batched", 2.0)):
        cfg = port.ServerConfig(
            metrics_csv=str(tmp / f"{leg}.csv"), batch_window_ms=window,
            max_batch=MAX_BATCH, calibration_path=str(tmp / "none.npz"))
        service = port.VisionAnalysisService(folded, cfg=cfg, device="cuda")
        try:
            service.warmup(FRAME_W, FRAME_H)
            got = {}
            for on in (True, False):
                contracts_on(on)
                reset_launches()
                got[on] = serve_frames(service, frames)
                total = {n: total[n] + c for n, c in read_launches().items()}
            check(got[True] == got[False], f"contracts leg, {leg}: answers "
                  "with the contracts on differ from those with them off")
            answers[leg] = got[True]
            # the host time per frame, on against off, in alternate blocks
            rgb, depth = frames[0]
            times = {True: [], False: []}
            for block in range(8):
                on = block % 2 == 0
                contracts_on(on)
                for _ in range(MESH_TIMING_FRAMES // 4):
                    t0 = time.perf_counter()
                    service.analyze_frame(rgb, depth, 1)
                    times[on].append(time.perf_counter() - t0)
            added = (np.median(times[True]) - np.median(times[False])) * 1e6
            # the checks alone: the entry's contract, called as a frame
            # calls it, on against off
            entry = (service.analyze._prepare if leg == "direct"
                     else type(service.dispatcher).submit)
            check_us = {}
            for on in (True, False):
                contracts_on(on)
                if leg == "direct":
                    kd, _ = service._geometry(FRAME_W, FRAME_H).staged()
                    fn = functools.partial(entry, rgb, depth, kd, 0.001)
                else:
                    fn = functools.partial(_contract_only(entry), rgb, depth,
                                           k)
                t0 = time.perf_counter()
                for _ in range(MESH_TIMING_FRAMES):
                    fn()
                check_us[on] = ((time.perf_counter() - t0)
                                / MESH_TIMING_FRAMES * 1e6)
            contracts_on(True)
            log(f"mesh (a) contracts, {leg}: {len(frames)} frames bit for bit "
                f"with RDP_CONTRACTS on and off; host time per frame "
                f"{np.median(times[True]) * 1e3:.3f} ms on, "
                f"{np.median(times[False]) * 1e3:.3f} ms off (median of "
                f"{MESH_TIMING_FRAMES // 2} each, alternate blocks): "
                f"{added:+.1f} us per frame; the entry's check alone "
                f"{check_us[True] - check_us[False]:.2f} us per call "
                f"[{nvidia_smi_line()}]")
            if leg == "batched":
                reset_launches()
                try:
                    service.dispatcher.submit(rgb[..., :2], depth, k, 0.001)
                    check(False, "a misshaped submit was taken")
                except ContractError as exc:
                    log(f"mesh (a): misshaped submit refused: {exc}")
                check(read_launches() == launches_of(),
                      f"a refused submit launched {read_launches()}")
        finally:
            contracts_on(True)
            service.close()
    return total, answers["batched"]


def _contract_only(submit):
    """``BatchDispatcher.submit``'s contract around a function that does
    nothing: the check alone, as a submit pays it."""
    from robotic_discovery_platform_tpu_torch.analysis.contracts import (
        shape_contract,
    )

    specs = dict(submit.__shape_contract__)
    specs.pop("out")
    return shape_contract(**specs)(
        lambda frame_rgb, depth, intrinsics: None)


def mesh_ring_leg(torch, port, folded, frames, tmp: Path,
                  batched_answers: list) -> dict:
    """(b) serving_mesh=-1 on one card: one chip, no router, the default
    batched server's answers bit for bit. (c) a two-position ring on the
    one card, built directly: each position its own analyzer, graph cache
    and streams; round_robin and sharded bit for bit as the router-less
    dispatcher, launches per position-dispatch; a fault on position 1
    quarantines it, its frames fail over, a probe reinstates it; the
    controller's _tune_mode flips on full buckets and back."""
    from robotic_discovery_platform_tpu_torch.resilience import (
        configure_faults,
    )
    from robotic_discovery_platform_tpu_torch.serving import (
        batching,
        controller,
    )

    total = launches_of()
    cfg = port.ServerConfig(
        metrics_csv=str(tmp / "ring1.csv"), batch_window_ms=2.0,
        max_batch=MAX_BATCH, serving_mesh=-1,
        calibration_path=str(tmp / "none.npz"))
    one = port.VisionAnalysisService(folded, cfg=cfg, device="cuda")
    try:
        check(one.serving_chips == 1 and one.dispatcher.router is None,
              f"serving_mesh=-1 on one card: {one.serving_chips} chip(s), "
              f"router {one.dispatcher.router}")
        one.warmup(FRAME_W, FRAME_H)
        reset_launches()
        got = serve_frames(one, frames)
        total = {n: total[n] + c for n, c in read_launches().items()}
        check(got == batched_answers, "serving_mesh=-1: answers differ from "
              "the default batched server's")
    finally:
        one.close()
    log("mesh (b): serving_mesh=-1 with batch_window_ms=2 on one card "
        "resolves to 1 chip and builds no router; its 8 answers equal the "
        "default batched server's bit for bit")

    k = port.default_intrinsics(FRAME_W, FRAME_H)
    dev = torch.device("cuda", 0)

    def analyzer():
        from robotic_discovery_platform_tpu_torch.ops import pipeline

        return pipeline.make_batch_analyzer(folded, img_size=256, device=dev,
                                            pack=True)

    plain = batching.BatchDispatcher(analyzer(), window_ms=2.0,
                                     max_batch=MAX_BATCH, max_inflight=1,
                                     device="cuda")
    try:
        want = submit_rows(plain, frames, k)
    finally:
        plain.stop()
    per = [analyzer(), analyzer()]
    flips = []
    router = batching.DeviceRouter(
        [dev, dev], "round_robin", per,
        sharded_analyzer=batching.ShardedAnalyzer(per), breaker_failures=2,
        breaker_reset_s=MESH_RESET_S,
        on_health=lambda c, ok: flips.append((c, ok)))
    ring = batching.BatchDispatcher(per[0], window_ms=2.0,
                                    max_batch=MAX_BATCH, max_inflight=1,
                                    device="cuda", router=router)
    try:
        for b in (1, 2):
            ring.warm(np.stack([frames[0][0]] * b),
                      np.stack([frames[0][1]] * b),
                      np.repeat(k[None], b, axis=0),
                      np.full((b,), 0.001, np.float32))
        streams = {ring._streams[0].cuda_stream, ring._streams[1].cuda_stream,
                   *(a.graphs.stream_handle for a in per)}
        check(len(streams) == 4, f"ring streams not distinct: {streams}")
        for mode, dispatches in (("round_robin", len(frames)),
                                 ("sharded", 2 * len(frames))):
            router.set_mode(mode)
            before = list(ring.chip_dispatches)
            reset_launches()
            rows = submit_rows(ring, frames, k)
            counts = read_launches()
            total = {n: total[n] + c for n, c in counts.items()}
            check(all(np.array_equal(a, b) for a, b in zip(rows, want)),
                  f"two-position ring, {mode}: rows differ from the "
                  "router-less dispatcher's")
            # a sharded bucket of 2 is one row per position: each position
            # runs the one-frame path
            pw = frame_launches(0, dispatches=dispatches, ones=dispatches)
            check(counts == pw, f"two-position ring, {mode}: launches "
                  f"{counts}, want {pw} ({dispatches} position-dispatches)")
            log(f"mesh (c) two-position ring on one card "
                f"[{torch.cuda.get_device_name(0)}], {mode}: 8 frames bit for "
                f"bit as the router-less dispatcher; window dispatches "
                f"{[a - b for a, b in zip(ring.chip_dispatches, before)]}; "
                f"launches {counts} = 18/1/1/1/1/1 per position-dispatch")
        router.set_mode("round_robin")
        configure_faults("serving.chip.1.dispatch:exc:-1")
        try:
            reset_launches()
            rows = submit_rows(ring, frames, k)
            total = {n: total[n] + c for n, c in read_launches().items()}
        finally:
            configure_faults(None)
        check(all(np.array_equal(a, b) for a, b in zip(rows, want)),
              "fault leg: failed-over frames answer differently")
        check(router.quarantined == frozenset({1}) and flips == [(1, False)],
              f"fault leg: quarantined {set(router.quarantined)}, health "
              f"{flips}")
        time.sleep(MESH_RESET_S * 1.5)
        reset_launches()
        rows = submit_rows(ring, frames[:2], k)
        total = {n: total[n] + c for n, c in read_launches().items()}
        # the completer records the probe's outcome after its answer
        deadline = time.perf_counter() + 5.0
        while router.quarantined and time.perf_counter() < deadline:
            time.sleep(0.01)
        check(not router.quarantined and flips == [(1, False), (1, True)],
              f"probe leg: quarantined {set(router.quarantined)}, health "
              f"{flips}")
        log(f"mesh (c) fault on position 1: quarantined after "
            f"{router.breakers[1].failure_threshold} failures, 8 frames "
            f"failed over and answered bit for bit; reinstated by a probe "
            f"after {MESH_RESET_S} s; health {flips}")
        # the controller's mode switch on the two positions: full
        # buckets switch to sharded; one-frame dispatches switch back
        # (the port's rule allows MODE_BACK_SLACK above half the ring,
        # which their average only approaches from above)
        ctl = controller.ReactiveController(dispatcher=lambda: ring,
                                            burn=lambda: 0.0)
        results: list = []

        def burst(i: int) -> None:
            for j in range(4):
                rgb, depth = frames[(i + j) % len(frames)]
                r = ring.submit(rgb, depth, k, 0.001, timeout_s=60.0)
                results.append(r)
                r.release()

        ring.set_window_ms(20.0)
        reset_launches()
        threads = [threading.Thread(target=burst, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        occupancy = ring.recent_batch
        action = ctl._tune_mode(ring)
        check(len(results) == 128 and action == "mode_sharded"
              and router.mode == "sharded",
              f"_tune_mode under full buckets: {action} at recent_batch "
              f"{occupancy:.2f}")
        ring.set_window_ms(2.0)
        back, n = None, 0
        while back is None and n < 100:
            submit_rows(ring, frames[:1], k)
            back, n = ctl._tune_mode(ring), n + 1
        total = {c: total[c] + v for c, v in read_launches().items()}
        check(back == "mode_round_robin" and router.mode == "round_robin",
              f"_tune_mode after the backlog: {back} after {n} frames "
              f"(recent_batch {ring.recent_batch})")
        log(f"mesh (c) _tune_mode on the two positions of the card: "
            f"round_robin -> sharded at recent_batch {occupancy:.2f} "
            f"(32 streams x 4 frames), back to round_robin after {n} "
            f"single frames (recent_batch {ring.recent_batch:.4f})")
    finally:
        configure_faults(None)
        ring.stop()
    return total


def mesh_train_leg(torch, port, tmp: Path) -> None:
    """(d) The data axis on an NCCL group of world size 1: one
    parallelize_training step and one shard_map_train_step step at B = 4
    on the default config against the single-device conv_impl="flax"
    step, their times, then train_model over the mesh for one epoch and a
    single-device servicer from its checkpoint."""
    import torch.distributed as dist

    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.parallel import dp
    from robotic_discovery_platform_tpu_torch.parallel import (
        mesh as mesh_lib,
    )
    from robotic_discovery_platform_tpu_torch.training import (
        checkpoint,
        synthetic,
        trainer,
    )
    from robotic_discovery_platform_tpu_torch.utils.config import MeshConfig

    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            world_size=1, rank=0)
    # cuDNN's deterministic algorithms: the plain convs' backward is then
    # the same bits from the same state, so a step can be held to another
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        check(dist.get_backend() == "nccl", "the group is not NCCL")
        mesh = mesh_lib.make_mesh(MeshConfig(data=1))
        cfg = dataclasses.replace(port.ModelConfig(), conv_impl="flax")
        imgs, masks = synthetic.generate_arrays(TRAIN_BATCH, 256, 256,
                                                seed=SEED)
        xs, ys = trainer.normalize_arrays(imgs, masks)
        loss_fn = losses.make_loss_fn("bce")
        dev = torch.device("cuda", 0)

        def fresh():
            net = trainer.init_model(cfg, SEED, dev)
            return net, trainer.make_optimizer(net, 1e-4)

        net0, opt0 = fresh()
        x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        loss0 = float(trainer.train_step(net0, opt0, loss_fn, x, y))
        # copies: the timing below steps net0 on
        want = {n: t.clone() for n, t in net0.state_dict().items()}
        net1, opt1 = fresh()
        trainer.train_step(net1, opt1, loss_fn, x, y)
        control = all(torch.equal(t, want[n])
                      for n, t in net1.state_dict().items())
        del net1, opt1
        steps, lines = {}, []
        for kind in ("parallelize_training", "shard_map_train_step"):
            net, opt = fresh()
            if kind == "parallelize_training":
                step, _, state = dp.parallelize_training(mesh, net, opt,
                                                         loss_fn)
            else:
                state = dp.replicated_state(mesh, net, opt)
                step = dp.shard_map_train_step(mesh, net, opt, loss_fn)
            state, loss = step(state, x, y)
            steps[kind] = (step, state)
            got = state.net.state_dict()
            bitwise = float(loss) == loss0 and all(
                torch.equal(got[n], want[n]) for n in want)
            names = [n for n, p in state.net.named_parameters()]
            err = rel_l2(torch, torch.cat([got[n].float().ravel()
                                           for n in names]),
                         torch.cat([want[n].float().ravel() for n in names]))
            diffs = {n: float((got[n].float() - want[n].float()).abs().max())
                     for n in want if want[n].is_floating_point()}
            worst = max(diffs, key=diffs.get)
            check(abs(float(loss) - loss0) <= MESH_LOSS_RTOL * abs(loss0)
                  and err <= MESH_PARAM_REL_L2
                  and diffs[worst] <= MESH_PARAM_ATOL,
                  f"{kind}: loss {float(loss)} vs {loss0}, parameters' rel "
                  f"L2 {err:.3g}, worst element {diffs[worst]:.3g} "
                  f"({worst})")
            lines.append(f"{kind} " + ("bitwise" if bitwise else
                f"not bitwise (loss equal {float(loss) == loss0}, "
                f"parameters' rel L2 {err:.3g}, worst element "
                f"{diffs[worst]:.3g} in {worst})"))
        # timed on cuDNN's default algorithms, as training runs: each
        # step alone between CUDA events, the three kinds interleaved
        torch.backends.cudnn.deterministic = deterministic
        calls = {"single-device": lambda: trainer.train_step(
            net0, opt0, loss_fn, x, y)}
        for kind, (step, state) in steps.items():
            calls[kind] = lambda step=step, state=state: step(state, x, y)
        samples = {k: [] for k in calls}
        for fn in calls.values():
            fn()
        for _ in range(MESH_STEP_ITERS):
            for kind, fn in calls.items():
                samples[kind].append(time_ms(torch, fn, 1, warm=0))
        times = {k: float(np.median(v)) for k, v in samples.items()}
        log(f"mesh (d) data axis, NCCL world size 1, B = {TRAIN_BATCH} at "
            f"256x256, default config with conv_impl='flax', one step from "
            f"one state with cuDNN deterministic: two single-device steps "
            f"{'bitwise' if control else 'NOT bitwise'}; {'; '.join(lines)} "
            f"against the single-device step. Step times (median of "
            f"{MESH_STEP_ITERS}, each step alone between CUDA events, cuDNN "
            f"default): " + ", ".join(
                f"{k} {v:.2f} ms (range {min(samples[k]):.2f}-"
                f"{max(samples[k]):.2f})" for k, v in times.items())
            + f" [{nvidia_smi_line()}]")
        # where a step's device time goes: the profiler's kernels of one
        # single-device step, the convolutions' share by kernel name
        rows = profiled_rows(torch, calls["single-device"], 1)
        busy = sum(r[0] for r in rows)
        conv_ms = sum(r[0] for r in rows if CONV_KERNEL.search(r[2]))
        if busy > 0:
            log(f"mesh (d) profile of one single-device step: device busy "
                f"{busy:.2f} ms of the {times['single-device']:.2f} ms step, "
                f"convolution kernels {conv_ms:.2f} ms "
                f"({100 * conv_ms / busy:.1f}% of busy); largest: "
                + "; ".join(f"{ms:.2f} ms x{n} {name[:90]}"
                            for ms, n, name in rows[:6])
                + f" [{nvidia_smi_line()}]")
        else:
            log("mesh (d) profile of one single-device step: the profiler "
                "recorded no device time (not measured)")

        tcfg = port.TrainConfig(epochs=1, batch_size=TRAIN_BATCH,
                                img_size=256, loss="bce", seed=SEED,
                                tracking_uri=f"file:{tmp}/mlruns",
                                checkpoint_dir=str(tmp / "ckpt"))
        arrays = synthetic.generate_arrays(TRAIN_SAMPLES, 256, 256, seed=SEED)
        t0 = time.perf_counter()
        res = trainer.train_model(tcfg, port.ModelConfig(), arrays=arrays,
                                  mesh=mesh_lib.make_mesh(
                                      MeshConfig(data=1)))
        train_s = time.perf_counter() - t0
        check(np.isfinite(res.best_val_loss) and res.registry_version == 1,
              f"train_model over the mesh: {res.to_jsonable()}")
        state = checkpoint.CheckpointManager(tcfg.checkpoint_dir).restore()
        net = port.UNet(port.ModelConfig())
        net.load_state_dict(state["model"], strict=True)
        sv = port.VisionAnalysisService(
            port.FoldedUNet(net, device="cuda"), device="cuda",
            cfg=port.ServerConfig(metrics_csv=str(tmp / "ckpt.csv"),
                                  calibration_path=str(tmp / "none.npz")))
        try:
            rng = np.random.default_rng(SEED + 7)
            rgb, _, depth = port.render_scene(rng, FRAME_H, FRAME_W)
            r = sv.analyze_frame(rgb, depth, 1)
            check(np.isfinite(r.mean_k) and 0.0 <= r.coverage <= 100.0,
                  f"servicer from the mesh checkpoint: {frame_answer(r)[:2]}")
        finally:
            sv.close()
        log(f"mesh (d) train_model(mesh=make_mesh(MeshConfig(data=1))): one "
            f"epoch in {train_s:.1f} s, best val loss "
            f"{res.best_val_loss:.4f}; its checkpoint loaded into a "
            f"single-device servicer, which answered a frame")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()


def mesh_phase(torch, port, folded=None, frames=None) -> dict:
    """Shape contracts and the data axis on the card (see the legs)."""
    t0 = time.perf_counter()
    if folded is None:
        folded, frames = phase_model(torch, port)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    total, batched_answers = mesh_contracts_leg(torch, port, folded, frames,
                                                tmp)
    ring = mesh_ring_leg(torch, port, folded, frames, tmp, batched_answers)
    total = {n: total[n] + ring[n] for n in total}
    mesh_train_leg(torch, port, tmp)
    log(json.dumps({"phase": "mesh", "seconds": round(
        time.perf_counter() - t0, 1), "card": nvidia_smi_line(),
        "launches": total}))
    return total


PHASES = ("kernel_phase", "conv1x1_kernel_phase", "convt_kernel_phase",
          "decode_kernel_phase", "geometry_kernel_phase",
          "train_kernel_phase", "graph_phase", "bitpack_phase",
          "bitpack_timing_phase", "precision_phase", "trained_tier_phase",
          "deploy_phase", "drift_phase", "host_path_phase", "zoo_phase",
          "controller_phase", "rollout_phase", "lab_phase", "tuning_phase",
          "fleet_phase", "sim_phase", "mesh_phase")


def run_phase(torch, port, conv, name: str) -> int:
    """One kernel phase alone: the card's line, the phase's log, then its
    timings as one JSON line (keys joined by spaces)."""
    import inspect

    check(name in PHASES, f"--phase: {name!r} is none of {', '.join(PHASES)}")
    fn = globals()[name]
    args = {"torch": torch, "port": port, "conv": conv}
    log(f"{name}: {torch.cuda.get_device_name(0)} [{nvidia_smi_line()}]")
    results = fn(*(args[p] for p in inspect.signature(fn).parameters
                   if p in args))
    log(json.dumps({k if isinstance(k, str) else " ".join(map(str, k)): v
                    for k, v in results.items()}))
    return 0


def main(argv: list | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    phase = None
    if argv:
        if len(argv) != 2 or argv[0] != "--phase":
            print("usage: chip_smoke.py [--phase NAME]", file=sys.stderr)
            return 2
        phase = argv[1]
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
    if phase is not None:
        return run_phase(torch, port, conv, phase)
    t_start = time.perf_counter()

    card = nvidia_smi_line()
    build_s = build.build()
    log(f"env: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)} [{card}], kernel build "
        f"{build_s:.1f} s")

    results = kernel_phase(torch, conv)
    results.update(convt_kernel_phase(torch, conv))
    results.update(decode_kernel_phase(torch))
    rng = np.random.default_rng(SEED)
    frames = []
    for _ in range(8):
        rgb, _, depth = port.render_scene(rng, FRAME_H, FRAME_W)
        frames.append((rgb, depth))
    results.update(geometry_kernel_phase(torch, port))
    folded, outs = analyzer_phase(torch, port, frames[:4])
    graph_phase(torch, port)
    analyze = port.make_frame_analyzer(folded, img_size=256, device="cuda")
    k = port.default_intrinsics(FRAME_W, FRAME_H)
    want_masks = [analyze(rgb, depth, k, 0.001).mask.cpu().numpy()
                  for rgb, depth in frames]
    launches = servicer_phase(torch, port, folded, frames, want_masks)
    legs = [host_path_phase(torch, port, folded, frames),
            precision_phase(torch, port, frames),
            coef_phase(torch, port, folded, frames)]
    geometry_phase(torch, port)
    results.update(train_kernel_phase(torch, conv))
    step_phase(torch, port)
    legs.append(train_serve_phase(torch, port, frames))
    legs.append(nonbilinear_phase(torch, port, conv, frames))
    legs.append(train_serve_phase(torch, port, frames,
                                  port.ModelConfig(bilinear=False), epochs=1))
    legs.append(deploy_phase(torch, port))
    legs.append(drift_phase(torch, port))
    legs.append(zoo_phase(torch, port, conv, frames))
    legs.append(controller_phase(torch, port, folded, frames))
    legs.append(rollout_phase(torch, port))
    legs.append(lab_phase(torch, port, folded, frames))
    legs.append(tuning_phase(torch, port, folded, frames))
    legs.append(fleet_phase(torch, port))
    legs.append(sim_phase(torch, port))
    legs.append(mesh_phase(torch, port, folded, frames))
    launches = {k: launches[k] + sum(leg[k] for leg in legs)
                for k in launches}
    from robotic_discovery_platform_tpu_torch.analysis import recompile

    check(recompile.over_budget() == {}, f"capture budgets exceeded: "
          f"{recompile.over_budget()}")
    log(f"captures since the graph phase, per guard instance: "
        f"{ {n: [e['traces'] for e in v] for n, v in recompile.snapshot().items()} }"
        ", all within budget")
    log(f"total {time.perf_counter() - t_start:.1f} s [{card}]")

    log(json.dumps(kernel_record(results, launches)))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
