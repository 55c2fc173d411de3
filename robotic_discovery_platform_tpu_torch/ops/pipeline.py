"""The per-frame analysis: frame -> mask -> curvature, on the device.

The port of the JAX package's ``ops/pipeline.py``: ``preprocess``
(antialiased bilinear resize to the model input as two static float32
matmuls), the model forward, ``logits_to_native_masks`` (sigmoid,
threshold, nearest resize back to the camera resolution), the confidence
margin, the mask coverage and the curvature profile, for one frame
(:func:`make_frame_analyzer`) or a batch (:func:`make_batch_analyzer`,
one forward over the batch, or :func:`make_scan_batch_analyzer`, the
frame path once per frame; either can end in :func:`pack_analysis`: one
[B, P] uint8 payload per dispatch). The frames' host-to-device copy is the only transfer in; the
result stays on the device until the caller reads it.

Each analyzer is an :class:`Analyzer`: on the card one CUDA graph per
static shape (``ops/graphs.GraphCache``, under the JAX package's capture
budgets), replayed with the call's inputs copied into its static inputs;
on the CPU the same function runs eagerly.

The coefficient lane (:func:`make_coef_frame_analyzer`,
:func:`make_coef_batch_analyzer`) takes entropy-decoded JPEG coefficient
planes instead of pixels and runs the pixel half of the decode on the
device ahead of the same analyzer (:func:`decode_coef_batch`: the
``ops/decode.dequant_idct`` kernel per plane, then libjpeg's exact
integer fancy upsampling and color conversion as plain torch integer
ops), so a frame's RGB never exists on the host.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from robotic_discovery_platform_tpu_torch.analysis.contracts import (
    mapped,
    shape_contract,
)
from robotic_discovery_platform_tpu_torch.ops import decode, geometry, pack
from robotic_discovery_platform_tpu_torch.ops import graphs as graphs_lib
from robotic_discovery_platform_tpu_torch.serving.entropy import block_grids
from robotic_discovery_platform_tpu_torch.utils.config import (
    GeometryConfig,
    check_supported,
)
from robotic_discovery_platform_tpu_torch.utils import transferguard
from robotic_discovery_platform_tpu_torch.utils.device import resolve_device


class FrameAnalysis(NamedTuple):
    mask: torch.Tensor  # [(B,) H, W] uint8 native-resolution binary mask
    mask_coverage: torch.Tensor  # [(B,)] percent of the frame covered
    profile: geometry.CurvatureProfile  # leaves lead with B in batch mode
    # mean |sigmoid(logit) - 0.5| at model resolution: distance from the
    # decision boundary (0 = maximally uncertain, 0.5 = saturated)
    confidence_margin: torch.Tensor


@functools.lru_cache(maxsize=64)
def _header_on(h: int, w: int, n_pts: int,
               device: torch.device) -> torch.Tensor:
    """The row header on the device, copied there once per geometry (a
    per-dispatch copy from pageable memory would wait on the stream)."""
    return torch.from_numpy(pack.payload_header(h, w, n_pts).copy()).to(device)


def pack_analysis(out: FrameAnalysis, *, n_pts: int) -> torch.Tensor:
    """A batched :class:`FrameAnalysis` -> one ``[B, P]`` uint8 packed
    payload on the device (``ops/pack.py``'s row layout, byte for byte the
    JAX package's): the header, the float32 sidecar of coverage, mean and
    max curvature, validity and confidence margin, then the spline block,
    then the bitpacked mask, zero-padded to ``frame_payload_bytes``.

    Invalid profiles' curvatures are masked with ``where``, not
    multiplied, so a non-finite curvature on an invalid frame packs as the
    exact 0.0 the direct path reports."""
    b, h, w = out.mask.shape
    prof = out.profile
    if prof.spline_points.shape[-2] != n_pts:
        raise ValueError(
            f"spline block has {prof.spline_points.shape[-2]} samples; "
            f"the packed layout was declared with n_pts={n_pts}"
        )
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=out.mask.device)
    sidecar = torch.cat([
        torch.stack([
            out.mask_coverage.to(f32),
            torch.where(prof.valid, prof.mean_curvature, zero).to(f32),
            torch.where(prof.valid, prof.max_curvature, zero).to(f32),
            prof.valid.to(f32),
            out.confidence_margin.to(f32),
        ], dim=1),
        prof.spline_points.to(f32).reshape(b, -1),
    ], dim=1)
    header = _header_on(h, w, n_pts, out.mask.device)
    row = torch.zeros((b, pack.frame_payload_bytes(h, w, n_pts)),
                      dtype=torch.uint8, device=out.mask.device)
    side = sidecar.contiguous().view(torch.uint8)  # little-endian f32 bytes
    lo = pack.HEADER_BYTES + side.shape[1]
    row[:, :pack.HEADER_BYTES] = header
    row[:, pack.HEADER_BYTES:lo] = side
    # the bits land in the row itself: no packed tensor, no copy
    bits = row[:, lo:lo + h * pack.packed_row_bytes(w)]
    pack.bitpack_mask(out.mask, out=bits)
    return row


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] matrix R with ``R @ v == jax.image.resize(v, ...)``
    for 1-D antialiased bilinear resize: half-pixel sample centres, a
    triangle kernel widened by 1/scale when downscaling, per-output weight
    normalization and out-of-bounds zeroing."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)  # triangle kernel
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1e-7, weights / np.where(total != 0, total, 1), 0.0
    )
    in_bounds = ((sample_f >= -0.5) & (sample_f <= n_in - 0.5))[None, :]
    return np.where(in_bounds, weights, 0.0).T.astype(np.float32)


@shape_contract(frames_rgb="b h w 3", out="b s s 3")
def preprocess(frames_rgb: torch.Tensor, img_size: int,
               r_h: torch.Tensor | None = None,
               r_w: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 [B, H, W, 3] RGB -> float32 [B, S, S, 3] in [0, 1]: the
    antialiased resize as an H contraction then a W contraction, in
    float32 (TF32 stays off on the card). ``r_h``/``r_w`` are the
    :func:`_resize_matrix` tables already on the device, if the caller
    keeps them."""
    h, w = frames_rgb.shape[1], frames_rgb.shape[2]
    dev = frames_rgb.device
    if r_h is None:
        r_h = torch.from_numpy(_resize_matrix(h, img_size)).to(dev)
    if r_w is None:
        r_w = torch.from_numpy(_resize_matrix(w, img_size)).to(dev)
    x = frames_rgb.to(torch.float32) / 255.0
    x = torch.einsum("Oh,bhwc->bOwc", r_h, x)
    return torch.einsum("Pw,bOwc->bOPc", r_w, x)


@shape_contract(logits="b s s c", out="b h w")
def logits_to_native_masks(logits: torch.Tensor, h: int, w: int,
                           threshold: float = 0.5) -> torch.Tensor:
    """[B, S, S, C] logits -> [B, H, W] uint8 masks: sigmoid > threshold at
    model resolution (any class, for C > 1), then a nearest resize with
    ``jax.image.resize``'s half-pixel rule (``mode="nearest-exact"``)."""
    if logits.shape[-1] == 1:
        prob = torch.sigmoid(logits[..., 0])
    else:
        prob = torch.amax(torch.sigmoid(logits), dim=-1)
    masks = (prob > threshold).to(torch.float32)
    masks = F.interpolate(masks[:, None], size=(h, w), mode="nearest-exact")
    return masks[:, 0].to(torch.uint8)


def confidence_margin(logits: torch.Tensor) -> torch.Tensor:
    """[B] mean |sigmoid(logit) - 0.5| over the model-resolution output
    (over every class channel for C > 1)."""
    if logits.shape[-1] == 1:
        return torch.mean(
            torch.abs(torch.sigmoid(logits[..., 0].to(torch.float32)) - 0.5),
            dim=(1, 2))
    return torch.mean(torch.abs(torch.sigmoid(logits.to(torch.float32)) - 0.5),
                      dim=(1, 2, 3))


def _as_device_frame(frame_rgb: torch.Tensor, depth: torch.Tensor,
                     device: torch.device):
    """Frames and raw depth -> uint8 RGB and float32 raw depth on
    ``device``. Depth crosses as its 16-bit pattern in int16 and widens on
    the device (z16 is exact in float32)."""
    frame_rgb = frame_rgb.to(device, non_blocking=True)
    depth = depth.to(device, non_blocking=True)
    if depth.dtype == torch.int16:
        depth = depth.to(torch.int32) & 0xFFFF
    return frame_rgb, depth.to(torch.float32)


def _depth_inputs(depths, intrinsics, depth_scales) -> tuple:
    """Depths, intrinsics and depth scales as a graph takes them (see
    :func:`_pixel_inputs`)."""
    if not isinstance(depths, torch.Tensor):
        depths = np.asarray(depths, np.uint16).view(np.int16)
    if not isinstance(intrinsics, torch.Tensor):
        intrinsics = np.asarray(intrinsics, np.float32)
    if isinstance(depth_scales, torch.Tensor):
        depth_scales = depth_scales.reshape(-1)
    else:
        depth_scales = np.asarray(depth_scales, np.float32).reshape(-1)
    return depths, intrinsics, depth_scales


def _pixel_inputs(frames_rgb, depths, intrinsics, depth_scales) -> tuple:
    """A batch's analyzer inputs as the graph takes them, without a copy
    where none is needed: numpy stays numpy (frames uint8, depths uint16
    as their int16 bit pattern, intrinsics and depth scales float32),
    tensors stay tensors (a caller that keeps intrinsics and depth scales
    on the device as float32 tensors saves their host copies)."""
    if not isinstance(frames_rgb, torch.Tensor):
        frames_rgb = np.asarray(frames_rgb, np.uint8)
    return (frames_rgb, *_depth_inputs(depths, intrinsics, depth_scales))


def mask_coverage(count: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Percent of an h x w frame covered, from the exact pixel counts: the
    float32 count times the float32 constant 100 / (h * w). That is the
    JAX package's jitted ``100 * jnp.mean`` of the 0/1 mask, which XLA
    folds into this one product (eager ``jnp.mean`` rounds twice)."""
    return count.to(torch.float32) * (100.0 / (h * w))


def _analyzer(forward, img_size: int, geom_cfg: GeometryConfig,
              threshold: float, device):
    """The shared core: ``(frames [B, H, W, 3] u8, depths [B, H, W] z16,
    intrinsics [B, 3, 3], depth_scales [B]) -> FrameAnalysis`` with a
    leading B on every field, tensors in and out on ``device``. It makes
    no host copy once warm (the resize tables are made on first use per
    geometry), so it can be captured into a CUDA graph."""
    check_supported(geom_cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        # every float32 product of the analyzer is a full float32 product
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tables: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def analyze(frames_rgb, depths, intrinsics, depth_scales) -> FrameAnalysis:
        frames, raw_depth = _as_device_frame(frames_rgb, depths, device)
        b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        mats = tables.get((h, w))
        if mats is None:
            mats = tables[(h, w)] = (
                torch.from_numpy(_resize_matrix(h, img_size)).to(device),
                torch.from_numpy(_resize_matrix(w, img_size)).to(device),
            )
        k = intrinsics.to(device, torch.float32)
        scales = depth_scales.to(device, torch.float32)
        with torch.no_grad():
            # frame by frame, so each frame's float32 resize sums are those
            # of a batch of one: a frame's mask does not depend on the batch
            # it rode in (the forward's kernels compute each pixel alone)
            x = torch.cat([preprocess(frames[i:i + 1], img_size, *mats)
                           for i in range(b)])
            logits = forward(x)
            masks = logits_to_native_masks(logits, h, w, threshold)
            margin = confidence_margin(logits)
            if b == 1:
                # one frame takes geom_cfg.kernel_impl's path (the fused
                # kernels by default); a batch runs the reference ops, as
                # the JAX package's vmapped leg pins "xla"
                profile = geometry.CurvatureProfile(*(
                    t[None] for t in geometry.compute_curvature_profile(
                        masks[0], raw_depth[0], k[0], scales[0], geom_cfg)))
            else:
                # the batch's leading axis is the JAX package's vmap: each
                # contract inside checks one frame's shapes
                with mapped():
                    profile = geometry.compute_curvature_profile(
                        masks, raw_depth, k, scales, geom_cfg)
            coverage = mask_coverage(
                torch.sum(masks, dim=(1, 2), dtype=torch.int64), h, w)
        return FrameAnalysis(mask=masks, mask_coverage=coverage,
                             profile=profile, confidence_margin=margin)

    return analyze


def _unbatched(out: FrameAnalysis) -> FrameAnalysis:
    """A batch-of-one :class:`FrameAnalysis` without its leading axis."""
    return FrameAnalysis(
        mask=out.mask[0], mask_coverage=out.mask_coverage[0],
        profile=geometry.CurvatureProfile(*(t[0] for t in out.profile)),
        confidence_margin=out.confidence_margin[0])


def _pixel_run(core, pack_pts):
    """The analyzer core, then :func:`pack_analysis` when ``pack_pts`` is
    the packed layout's sample count."""
    def run(*inputs):
        out = core(*inputs)
        return out if pack_pts is None else pack_analysis(out, n_pts=pack_pts)

    return run


def _frame_finish(pack: bool) -> Callable:
    """A frame analyzer's ``finish``: the packed row ``[P]`` read back to
    the host, or copies of the fields without the leading batch of one."""
    if pack:
        return lambda out: graphs_lib.read_back(out)[0]
    return lambda out: _unbatched(graphs_lib.clone(out))


class Analyzer:
    """A hot entry of the pipeline (each factory returns it behind the
    transfer guard, ``utils/transferguard.apply``: the object itself while
    ``RDP_TRANSFER_GUARD`` is off), dispatched as one CUDA graph per
    static shape on the card (:class:`ops.graphs.GraphCache` under the
    entry's capture guard: the JAX package's ``trace_guard`` name and
    budget), eagerly on the CPU.

    ``prepare(*args) -> (run, inputs, static)`` turns a call's arguments
    into the graph's inputs (host or device tensors, numpy arrays), the
    function over them and what else it bakes in. ``finish`` turns run's
    outputs into the call's result before the graph is released (fresh
    tensors or a host read-back, never the graph's static outputs: a later
    call does not overwrite an earlier result); a call may pass its own
    (the batch dispatcher copies into its landing buffer). :meth:`eager`
    runs the same function and ``finish`` without a graph (the reference a
    replay is held against on the card); ``graphs`` is the cache (its
    ``guard`` and captures)."""

    def __init__(self, prepare: Callable, name: str, budget: int,
                 device: torch.device, finish: Callable):
        self._prepare = prepare
        #: the entry's ``@shape_contract`` specs (``analysis/contracts``)
        self.__shape_contract__ = getattr(prepare, "__shape_contract__",
                                          None)
        self._finish = finish
        self.graphs = graphs_lib.GraphCache(name, budget, device)

    def __call__(self, *args, finish: Callable | None = None):
        run, inputs, static = self._prepare(*args)
        return self.graphs(run, *inputs, static=static,
                           finish=finish or self._finish)

    def eager(self, *args):
        run, inputs, _ = self._prepare(*args)
        return self._finish(self.graphs.eager(run, *inputs))


def make_frame_analyzer(
    forward: Callable[[torch.Tensor], torch.Tensor],
    img_size: int = 256,
    geom_cfg: GeometryConfig = GeometryConfig(),
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
    *,
    pack: bool = False,
) -> Analyzer:
    """Build the single-frame analyzer around ``forward`` (NHWC float32
    -> NHWC float32 logits, e.g. :class:`ops.unet_infer.FoldedUNet`).

    Returns ``analyze(frame_rgb [H, W, 3] u8, depth [H, W] u16,
    intrinsics [3, 3], depth_scale) -> FrameAnalysis`` with unbatched
    fields on ``device``. Inputs may be numpy arrays or tensors; a caller
    that keeps the intrinsics and depth scale on the device as float32
    tensors saves their host copies. On the card each camera geometry
    (H, W) is one CUDA graph (capture guard ``pipeline.frame_analyzer``,
    budget 2: one mid-run camera change before the guard flags).

    ``pack=True`` (the servicer's direct path) ends the graph in
    :func:`pack_analysis` and returns the frame's packed row ``[P]`` as a
    host numpy array: one device-to-host copy, made and waited for before
    the graph is released to the next call.
    """
    core = _analyzer(forward, img_size, geom_cfg, threshold, device)
    device = resolve_device(device)
    run = _pixel_run(core, geom_cfg.num_samples if pack else None)

    @shape_contract(frame_rgb="h w 3", depth="h w", intrinsics="3 3")
    def analyze(frame_rgb, depth, intrinsics, depth_scale):
        return run, _pixel_inputs(_leading(frame_rgb), _leading(depth),
                                    _leading(intrinsics), depth_scale), ()

    return transferguard.apply(Analyzer(
        analyze, "pipeline.frame_analyzer", 2, device,
        _frame_finish(pack)))


def make_batch_analyzer(
    forward: Callable[[torch.Tensor], torch.Tensor],
    img_size: int = 256,
    geom_cfg: GeometryConfig = GeometryConfig(),
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
    *,
    pack: bool = False,
) -> Analyzer:
    """Batched analyzer for cross-stream micro-batching: one forward over
    ``[B, H, W, 3]``, the geometry over the batch.

    Returns ``analyze(frames [B, H, W, 3] u8, depths [B, H, W] (z16, as
    uint16 numpy or the int16 bit pattern of the dispatcher's pinned
    staging), intrinsics [B, 3, 3], depth_scales [B])``: a
    :class:`FrameAnalysis` with a leading B, or with ``pack=True`` the
    ``[B, P]`` uint8 payload of :func:`pack_analysis` (the dispatcher's one
    device-to-host copy). On the card each (B, H, W) is one CUDA graph
    (capture guard ``pipeline.batch_analyzer``, budget 8: the dispatcher's
    power-of-two buckets of one geometry); the inputs are copied into its
    static inputs on the cache's stream, and the call returns copies of
    the outputs (or what a ``finish=`` given to the call makes of them:
    the dispatcher copies them into its landing buffer) once they are
    enqueued, with the current stream waiting for them.
    """
    core = _analyzer(forward, img_size, geom_cfg, threshold, device)
    device = resolve_device(device)
    run = _pixel_run(core, geom_cfg.num_samples if pack else None)

    @shape_contract(frames_rgb="b h w 3", depths="b h w",
                    intrinsics="b 3 3", depth_scales="b")
    def analyze(frames_rgb, depths, intrinsics, depth_scales):
        return run, _pixel_inputs(frames_rgb, depths, intrinsics,
                                    depth_scales), ()

    return transferguard.apply(Analyzer(
        analyze, "pipeline.batch_analyzer", 8, device,
        graphs_lib.clone))


def _stacked(outs: list[FrameAnalysis]) -> FrameAnalysis:
    """Per-frame :class:`FrameAnalysis` results, each with a leading batch
    of one, as one with a leading B."""
    def cat(parts):
        return torch.cat(list(parts))

    return FrameAnalysis(
        mask=cat(o.mask for o in outs),
        mask_coverage=cat(o.mask_coverage for o in outs),
        profile=geometry.CurvatureProfile(*(
            cat(leaf) for leaf in zip(*(o.profile for o in outs)))),
        confidence_margin=cat(o.confidence_margin for o in outs))


def make_scan_batch_analyzer(
    forward: Callable[[torch.Tensor], torch.Tensor],
    img_size: int = 256,
    geom_cfg: GeometryConfig = GeometryConfig(),
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
    *,
    pack: bool = False,
) -> Analyzer:
    """Batched analyzer that runs the single-frame path once per frame
    (the JAX package's ``lax.scan`` over the frames): the working set is
    one frame's, and each frame takes ``geom_cfg.kernel_impl``'s geometry
    path (the fused kernels by default), while the batch is still one
    dispatch. Each frame's fields go into the stacked ``[B, ...]``
    outputs; with ``pack=True`` one :func:`pack_analysis` over the stacked
    masks follows (one bitpack launch per dispatch).

    The call shape is :func:`make_batch_analyzer`'s, so the dispatcher
    takes either (``ServerConfig.batch_impl``). On the card each (B, H, W)
    is one CUDA graph that replays the B frame passes (capture guard
    ``pipeline.scan_batch_analyzer``, budget 8); frame i's outputs equal
    the frame analyzer's for that frame bit for bit.
    """
    core = _analyzer(forward, img_size, geom_cfg, threshold, device)
    device = resolve_device(device)
    pack_pts = geom_cfg.num_samples if pack else None

    def run(frames_rgb, depths, intrinsics, depth_scales):
        out = _stacked([
            core(frames_rgb[i:i + 1], depths[i:i + 1], intrinsics[i:i + 1],
                 depth_scales[i:i + 1])
            for i in range(frames_rgb.shape[0])])
        return out if pack_pts is None else pack_analysis(out, n_pts=pack_pts)

    @shape_contract(frames_rgb="b h w 3", depths="b h w",
                    intrinsics="b 3 3", depth_scales="b")
    def analyze(frames_rgb, depths, intrinsics, depth_scales):
        return run, _pixel_inputs(frames_rgb, depths, intrinsics,
                                    depth_scales), ()

    return transferguard.apply(Analyzer(
        analyze, "pipeline.scan_batch_analyzer", 8, device,
        graphs_lib.clone))


def _leading(a):
    """An array with a leading batch axis of one (numpy or tensor)."""
    return a[None] if isinstance(a, torch.Tensor) else np.asarray(a)[None]


# -- the coefficient lane: the pixel half of the split JPEG decode ------------

_YCC_SCALE = 16
_YCC_HALF = 1 << (_YCC_SCALE - 1)


def _ycc_fix(x: float) -> int:
    return int(x * (1 << _YCC_SCALE) + 0.5)


def _assemble_plane(samples: torch.Tensor, blocks_h: int,
                    blocks_w: int) -> torch.Tensor:
    """[B, blocks_h*blocks_w, 64] block samples -> [B, 8*bh, 8*bw]."""
    b = samples.shape[0]
    x = samples.reshape(b, blocks_h, blocks_w, 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, blocks_h * 8, blocks_w * 8)


def _clamped(n: int, step: int, device) -> torch.Tensor:
    """Indices ``i + step`` clamped to ``[0, n)``: the edge-replicated
    neighbour of each of ``n`` samples."""
    return torch.clamp(torch.arange(n, device=device) + step, 0, n - 1)


def _upsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """libjpeg ``h2v2_fancy_upsample``, exact integer arithmetic.

    [B, ch, cw] int32 -> [B, 2ch, 2cw]: vertical 3:1 column sums with
    edge-clamped neighbours, then the 9/16-3/16-3/16-1/16 horizontal
    triangle with libjpeg's alternating +8/+7 rounding biases."""
    b, ih, iw = plane.shape
    dev = plane.device
    even = 3 * plane + plane[:, _clamped(ih, -1, dev)]
    odd = 3 * plane + plane[:, _clamped(ih, 1, dev)]
    colsum = torch.stack([even, odd], dim=2).reshape(b, 2 * ih, iw)
    h_even = (3 * colsum + colsum[:, :, _clamped(iw, -1, dev)] + 8) >> 4
    h_odd = (3 * colsum + colsum[:, :, _clamped(iw, 1, dev)] + 7) >> 4
    return torch.stack([h_even, h_odd], dim=3).reshape(b, 2 * ih, 2 * iw)


def _upsample_h2v1(plane: torch.Tensor) -> torch.Tensor:
    """libjpeg ``h2v1_fancy_upsample``: horizontal-only triangle."""
    b, ih, iw = plane.shape
    dev = plane.device
    h_even = (3 * plane + plane[:, :, _clamped(iw, -1, dev)] + 1) >> 2
    h_odd = (3 * plane + plane[:, :, _clamped(iw, 1, dev)] + 2) >> 2
    return torch.stack([h_even, h_odd], dim=3).reshape(b, ih, 2 * iw)


def _ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                cr: torch.Tensor) -> torch.Tensor:
    """libjpeg ``ycc_rgb_convert``: SCALEBITS=16 fixed point, exact.

    int32 planes (0..255) -> uint8 [B, H, W, 3]; arithmetic right shifts
    on int32 match the C tables bit for bit."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((_ycc_fix(1.40200) * cr + _YCC_HALF) >> _YCC_SCALE)
    b = y + ((_ycc_fix(1.77200) * cb + _YCC_HALF) >> _YCC_SCALE)
    g = y + ((-_ycc_fix(0.34414) * cb - _ycc_fix(0.71414) * cr + _YCC_HALF)
             >> _YCC_SCALE)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255).to(torch.uint8)


def decode_coef_batch(y, cb, cr, qy, qc, *, height: int, width: int,
                      subsampling: str) -> torch.Tensor:
    """The on-device half of the split JPEG decode, batched.

    Args:
        y/cb/cr: [B, N, 64] int16 quantized coefficient planes (natural
            order, block raster: ``serving.entropy.CoefficientFrame``).
        qy/qc: [B, 64] int32 quant tables (per frame).
        height/width/subsampling: the frame geometry.

    Returns uint8 RGB [B, height, width, 3], bitwise equal to what
    libjpeg / ``cv2.imdecode`` produces from the same coefficients: one
    :func:`ops.decode.dequant_idct` launch per plane, then plain torch
    integer ops on the same device.
    """
    (ybh, ybw), (cbh, cbw) = block_grids(height, width, subsampling)
    y_pix = _assemble_plane(decode.dequant_idct(y, qy), ybh, ybw)
    cb_pix = _assemble_plane(decode.dequant_idct(cb, qc), cbh, cbw)
    cr_pix = _assemble_plane(decode.dequant_idct(cr, qc), cbh, cbw)
    # crop the chroma planes to their true downsampled size before
    # upsampling: the block grid pads to whole MCUs, and the upsamplers'
    # edge-clamped taps must replicate the real last row and column
    # (libjpeg's edge rule), not read MCU padding
    if subsampling == "420":
        ch, cw = (height + 1) // 2, (width + 1) // 2
        cb_pix = _upsample_h2v2(cb_pix[:, :ch, :cw])
        cr_pix = _upsample_h2v2(cr_pix[:, :ch, :cw])
    elif subsampling == "422":
        ch, cw = height, (width + 1) // 2
        cb_pix = _upsample_h2v1(cb_pix[:, :ch, :cw])
        cr_pix = _upsample_h2v1(cr_pix[:, :ch, :cw])
    return _ycc_to_rgb(y_pix[:, :height, :width], cb_pix[:, :height, :width],
                       cr_pix[:, :height, :width])


def _coef_arrays(frame) -> tuple:
    """A :class:`serving.entropy.CoefficientFrame` -> its planes and tables
    with a leading batch of one, numpy, copied only where widened (the
    planes may be read-only views of the wire bytes; the tables widen to
    int32)."""
    planes = tuple(np.asarray(a, np.int16)[None]
                   for a in (frame.y, frame.cb, frame.cr))
    tables = tuple(np.asarray(a, np.int32)[None]
                   for a in (frame.qy, frame.qc))
    return planes + tables


def coef_planes(frame) -> tuple:
    """:func:`_coef_arrays` as host tensors (copies: the planes may be
    read-only views of the wire bytes)."""
    return tuple(torch.from_numpy(np.array(a)) for a in _coef_arrays(frame))


def _coef_run(core, height: int, width: int, subsampling: str, pack_pts):
    """The coefficient lane's function over device tensors: the decode,
    then :func:`_pixel_run`'s."""
    pixels = _pixel_run(core, pack_pts)

    def run(y, cb, cr, qy, qc, depths, intrinsics, depth_scales):
        with torch.no_grad():
            frames = decode_coef_batch(y, cb, cr, qy, qc, height=height,
                                       width=width, subsampling=subsampling)
        return pixels(frames, depths, intrinsics, depth_scales)

    return run


def make_coef_batch_analyzer(
    forward: Callable[[torch.Tensor], torch.Tensor],
    img_size: int = 256,
    geom_cfg: GeometryConfig = GeometryConfig(),
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
    *,
    height: int,
    width: int,
    subsampling: str = "420",
    pack: bool = False,
) -> Analyzer:
    """Batched analyzer whose input is coefficient planes: the decode
    (:func:`decode_coef_batch`) ahead of the batch analyzer's core, on the
    device. The frame geometry is fixed per analyzer (the dispatcher
    groups coefficient frames by geometry and subsampling).

    Returns ``analyze(y, cb, cr, qy, qc, depths, intrinsics,
    depth_scales)`` (the tensors the dispatcher stages): a
    :class:`FrameAnalysis` with a leading B, or with ``pack=True`` the
    ``[B, P]`` uint8 payload of :func:`pack_analysis`. On the card each B
    is one CUDA graph (capture guard ``pipeline.coef_batch_analyzer``,
    budget 8).
    """
    block_grids(height, width, subsampling)  # validates the geometry
    core = _analyzer(forward, img_size, geom_cfg, threshold, device)
    device = resolve_device(device)
    run = _coef_run(core, height, width, subsampling,
                    geom_cfg.num_samples if pack else None)

    @shape_contract(y="b n 64", cb="b m 64", cr="b m 64", qy="b 64",
                    qc="b 64", depths="b h w", intrinsics="b 3 3",
                    depth_scales="b")
    def analyze(y, cb, cr, qy, qc, depths, intrinsics, depth_scales):
        return run, (y, cb, cr, qy, qc,
                     *_depth_inputs(depths, intrinsics, depth_scales)), ()

    return transferguard.apply(Analyzer(
        analyze, "pipeline.coef_batch_analyzer", 8, device,
        graphs_lib.clone))


def make_coef_frame_analyzer(
    forward: Callable[[torch.Tensor], torch.Tensor],
    img_size: int = 256,
    geom_cfg: GeometryConfig = GeometryConfig(),
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
    *,
    pack: bool = False,
) -> Analyzer:
    """Single-frame analyzer of the coefficient lane (the direct path).

    Returns ``analyze(frame: CoefficientFrame, depth [H, W] u16,
    intrinsics [3, 3], depth_scale) -> FrameAnalysis`` with unbatched
    fields on ``device``: the frame's planes and tables go to the device,
    are decoded there as a batch of one and analyzed as
    :func:`make_frame_analyzer` analyzes pixels. The decoded RGB never
    reaches the host. Any geometry and subsampling the frame carries; on
    the card each is one CUDA graph (capture guard
    ``pipeline.frame_analyzer``, budget 2, as the pixel analyzer).
    ``pack=True`` returns the packed row on the host, as
    :func:`make_frame_analyzer` does."""
    core = _analyzer(forward, img_size, geom_cfg, threshold, device)
    device = resolve_device(device)
    runs: dict[tuple, Callable] = {}

    def prepare(frame, depth, intrinsics, depth_scale):
        geom = (frame.height, frame.width, frame.subsampling)
        run = runs.get(geom)
        if run is None:
            run = runs[geom] = _coef_run(
                core, *geom, geom_cfg.num_samples if pack else None)
        return run, (*_coef_arrays(frame), *_depth_inputs(
            _leading(depth), _leading(intrinsics), depth_scale)), geom

    return transferguard.apply(Analyzer(
        prepare, "pipeline.frame_analyzer", 2, device,
        _frame_finish(pack)))
