"""Analytic FLOP and byte counts: the U-Net's, for a share of the peak,
and each kernel's least traffic, for its bound.

The first part is the JAX package's ``utils/flops.py`` with the same
counts: every 3x3/1x1 conv at 2*K^2*H*W*Cin*Cout FLOPs plus the two
interpolation matmuls of each bilinear upsample (pooling, normalization,
activations and the geometry are left out, as in the MFU literature), and
a roofline per kernel family (``*_roofline_ms``: ``max(compute, memory)``
at a peak and a memory rate).

The peak basis is one NVIDIA H100 SXM (H100 80GB HBM3) from its
datasheet: 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s float32
off them and float64 on them, 3.35 TB/s HBM3. A card whose power limit is
set below 700 W does not reach these rates, so a figure computed here
stands beside the card's name and power limit.

The second part (:func:`bound_ms` and the ``*_cost`` functions) is the
bound each kernel's line of ``chip_smoke.py`` prints: the bytes the
function must move (each input read once, each output written once) over
the HBM rate, and its operations over the peak of their type, the larger
of the two.
"""

from __future__ import annotations

#: dense bf16 tensor-core peak of one H100 SXM, TFLOP/s
H100_PEAK_BF16_TFLOPS = 989.0
#: HBM3 rate of one H100 SXM, GB/s
H100_HBM_GBPS = 3350.0
#: the same peaks in operations (bytes) per second
H100_BF16_FLOPS = H100_PEAK_BF16_TFLOPS * 1e12
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_F64_FLOPS = 67e12  # float64, on the tensor cores
H100_BYTES_PER_S = H100_HBM_GBPS * 1e9
#: Hopper's int32 multiply-add rate per SM and clock
INT32_OPS_PER_SM_CLOCK = 64


def roofline_ms(flops: int, bytes_moved: int,
                peak_tflops: float = H100_PEAK_BF16_TFLOPS,
                hbm_gbps: float = H100_HBM_GBPS) -> dict:
    """Roofline lower bound for one kernel launch: compute time at the
    chip's dense peak vs memory time for the given minimal HBM traffic.
    A launch cannot run faster than ``max(compute_ms, memory_ms)``; real
    traffic (halos, re-reads) is strictly larger than the minimum the
    callers count, so the bound is optimistic and 'percent of bound' is a
    conservative utilization figure."""
    compute_ms = flops / (peak_tflops * 1e12) * 1e3
    memory_ms = bytes_moved / (hbm_gbps * 1e9) * 1e3
    return {
        "flops": flops,
        "bytes": bytes_moved,
        "compute_ms": compute_ms,
        "memory_ms": memory_ms,
        "bound_ms": max(compute_ms, memory_ms),
        "bound_by": "compute" if compute_ms >= memory_ms else "memory",
    }


def conv3x3_roofline_ms(h: int, w: int, cin: int, cout: int,
                        batch: int = 1, itemsize: int = 2) -> dict:
    """Roofline for one fused 3x3 conv+BN+ReLU launch: minimal traffic is
    read input once, read weights once, write output once."""
    return roofline_ms(
        2 * 9 * batch * h * w * cin * cout,
        itemsize * (
            batch * h * w * cin + 9 * cin * cout + batch * h * w * cout
        ),
    )


def conv1x1_roofline_ms(h: int, w: int, cin: int, cout: int,
                        batch: int = 1, itemsize: int = 2) -> dict:
    """Roofline for the fused 1x1 head launch."""
    return roofline_ms(
        2 * batch * h * w * cin * cout,
        itemsize * (
            batch * h * w * cin + cin * cout + batch * h * w * cout
        ),
    )


def conv_transpose2x2_roofline_ms(h: int, w: int, cin: int, cout: int,
                                  batch: int = 1,
                                  itemsize: int = 2) -> dict:
    """Roofline for the 2x2 stride-2 transposed-conv launch (each INPUT
    pixel spawns four taps; output is [2H, 2W])."""
    return roofline_ms(
        2 * 4 * batch * h * w * cin * cout,
        itemsize * (
            batch * h * w * cin + 4 * cin * cout
            + batch * 4 * h * w * cout
        ),
    )


def deproject_roofline_ms(h: int, w: int) -> dict:
    """Roofline for the fused deproject+edge-stats kernel
    (``csrc/deproject_edge_stats.cu``): ~12 vector ops per pixel (two iota builds, the
    z/x/y formulas, the validity test, five masked reductions) against
    reading mask+depth once (f32) and writing the four maps once.
    Bandwidth-bound by construction -- the kernel's whole purpose is
    collapsing the XLA chain's multiple HBM passes into one."""
    return roofline_ms(12 * h * w, 4 * (2 * h * w + 4 * h * w))


def bspline_design_roofline_ms(n: int, c: int, d: int = 3,
                               degree: int = 3) -> dict:
    """Roofline for the fused B-spline design kernel: the Cox-de Boor
    recursion (~8 vector ops per (point, basis-function) per level) plus the
    two matrix contractions, against reading u/w/points once and writing the
    [C, C]+[C, D] outputs -- the [N, C] basis matrix itself never touches
    HBM (that is the fusion's point, and why the XLA chain's traffic is
    ~(2 + degree) x larger)."""
    basis_flops = 8 * degree * n * (c + degree)
    mm_flops = 2 * n * c * c + 2 * n * c * d
    return roofline_ms(
        basis_flops + mm_flops,
        4 * (n * (2 + d) + c * c + c * d),
    )


def bspline_curvature_roofline_ms(n: int, c: int, d: int = 3,
                                  degree: int = 3) -> dict:
    """Roofline for the fused curvature kernel: three basis builds, three
    design+evaluate matmul chains, and the cross/norm formula (~40 vector
    ops per sample), against ctrl+u in / kappa+valid+r out."""
    basis_flops = 3 * 8 * degree * n * (c + degree)
    mm_flops = 2 * n * c * d * 3 + 2 * n * (c + degree) * c * 2
    return roofline_ms(
        basis_flops + mm_flops + 40 * n,
        4 * (c * d + n + n * (2 + d)),
    )


def jpeg_dequant_roofline_ms(n_blocks: int, batch: int = 1) -> dict:
    """Roofline for the standalone dequantize stage (one int multiply per
    coefficient against the broadcast [64] quant row): read int16
    coefficients, write int32 products. Counted separately only for the
    analytic table -- the shipped kernel fuses it into the IDCT matmuls,
    which is why the fused bound below charges the int16 read once."""
    n = batch * n_blocks * 64
    return roofline_ms(n, 2 * n + 4 * n)


def jpeg_idct_roofline_ms(n_blocks: int, batch: int = 1) -> dict:
    """Roofline for the fused dequant+IDCT launch
    (``ops/decode.dequant_idct``): two [N, 64] x [64, 64] integer basis
    matmuls per pass over the block axis (islow's two passes), plus the
    dequant multiply and the descale/clamp elementwise tail, against
    reading the int16 coefficients + [64] quant row once and writing the
    int32 samples once. At 64 blocks of reuse per basis element the
    arithmetic intensity is ~43 FLOP/byte of coefficient traffic, yet the
    tiny 64-wide contractions leave the matrix units idle enough that the launch
    stays bandwidth-bound at every deployed shape -- which is the point:
    the decode stage must ride free under the analyzer's compute."""
    n = batch * n_blocks
    matmul_flops = 2 * (2 * n * 64 * 64)
    elementwise_flops = 3 * n * 64  # dequant mul + two descale add/shifts
    return roofline_ms(
        matmul_flops + elementwise_flops,
        2 * n * 64 + 2 * 64 + 4 * n * 64,
    )


def chroma_upsample_roofline_ms(h: int, w: int, batch: int = 1,
                                subsampling: str = "420") -> dict:
    """Roofline for the fancy (triangle) chroma upsample of both chroma
    planes to the [H, W] luma grid: ~6 integer vector ops per output sample
    (two neighbor adds, two scaled sums, bias, shift) per plane, against
    reading the subsampled planes and writing the full-resolution ones."""
    if subsampling == "444":
        return roofline_ms(0, 0)
    div = 4 if subsampling == "420" else 2
    in_px = 2 * batch * h * w // div
    out_px = 2 * batch * h * w
    return roofline_ms(6 * out_px, 4 * (in_px + out_px))


def ycbcr_to_rgb_roofline_ms(h: int, w: int, batch: int = 1) -> dict:
    """Roofline for the fixed-point YCbCr->RGB convert + clamp: ~12
    integer vector ops per pixel against reading three int32 planes and
    writing the uint8 RGB image."""
    px = batch * h * w
    return roofline_ms(12 * px, 4 * 3 * px + 3 * px)


def jpeg_decode_roofline_ms(h: int, w: int, batch: int = 1,
                            subsampling: str = "420") -> dict:
    """Combined roofline for the whole on-device decode stage
    (ops/pipeline.decode_coef_batch): dequant+IDCT over every block of all
    three components, chroma upsample, color convert. The stage should be
    bandwidth-bound (bound_by == "memory"): decode rides the analyzer's
    HBM streams, it does not compete for its matrix units."""
    sh, sv = {"444": (1, 1), "420": (2, 2), "422": (2, 1)}[subsampling]
    mcux = -(-w // (8 * sh))
    mcuy = -(-h // (8 * sv))
    blocks_y = (mcuy * sv) * (mcux * sh)
    blocks_c = 2 * mcuy * mcux
    idct = jpeg_idct_roofline_ms(blocks_y + blocks_c, batch)
    ups = chroma_upsample_roofline_ms(h, w, batch, subsampling)
    ycc = ycbcr_to_rgb_roofline_ms(h, w, batch)
    return roofline_ms(
        idct["flops"] + ups["flops"] + ycc["flops"],
        idct["bytes"] + ups["bytes"] + ycc["bytes"],
    )


def mask_bitpack_roofline_ms(h: int, w: int, batch: int = 1) -> dict:
    """Roofline for the egress mask bitpack (``ops/pack.bitpack_mask``):
    ~2 integer vector ops per input pixel (the nonzero test and one
    shift-accumulate step of the unrolled 8-way reduction), against
    reading the [B, H, W] uint8 mask once and writing the 8x-smaller
    [B, H, ceil(W/8)] packed bytes once. At ~2 FLOP per ~1.1 bytes the
    launch is bandwidth-bound by construction -- one HBM pass over the
    mask, which is the point: packing must ride free under the analyzer,
    and the D2H payload it buys shrinks 8x."""
    px = batch * h * w
    return roofline_ms(2 * px, px + batch * h * ((w + 7) // 8))


def unet_forward_flops(img_size: int = 256, base: int = 64,
                       in_ch: int = 3, num_classes: int = 1,
                       bilinear: bool = True) -> int:
    """FLOPs of one forward pass at batch 1 (multiply-adds counted as 2)."""
    f = base
    factor = 2 if bilinear else 1

    def dconv(h: int, cin: int, mid: int, cout: int) -> int:
        return 2 * 9 * h * h * (cin * mid + mid * cout)

    total = 0
    # encoder: inc + 4 downs; spatial halves each level
    enc = [f, 2 * f, 4 * f, 8 * f, 16 * f // factor]
    h = img_size
    total += dconv(h, in_ch, f, f)
    prev = f
    for c in enc[1:]:
        h //= 2
        total += dconv(h, prev, c, c)
        prev = c
    # decoder: 4 ups; each doubles spatial, interpolation matmuls + DoubleConv
    skips = [8 * f, 4 * f, 2 * f, f]
    feats = [8 * f // factor, 4 * f // factor, 2 * f // factor, f]
    x_ch = enc[-1]
    for skip, feat in zip(skips, feats):
        h2 = h * 2
        if bilinear:
            # upsample_align_corners: einsum over H then W
            # [h2,h]x[h,w,c] then [w2,w]x[h2,w,c] with w == h, w2 == h2
            total += 2 * h2 * h * h * x_ch + 2 * h2 * h2 * h * x_ch
        else:
            # 2x2 stride-2 transpose conv: each INPUT pixel spawns four
            # taps, so the cost scales with the input's h*h
            total += 2 * 4 * h * h * x_ch * (x_ch // 2)
        cat = x_ch + skip if bilinear else x_ch // 2 + skip
        # bilinear Up: mid_features = (x + skip concat) // 2 (models/unet.Up)
        mid = cat // 2 if bilinear else feat
        total += dconv(h2, cat, mid, feat)
        x_ch = feat
        h = h2
    # 1x1 head
    total += 2 * img_size * img_size * x_ch * num_classes
    return total


def unet_train_step_flops(batch: int, img_size: int = 256, base: int = 64,
                          in_ch: int = 3, num_classes: int = 1,
                          bilinear: bool = True) -> int:
    """FLOPs of one optimizer step: forward + backward. The backward pass
    costs ~2x the forward (dx and dw are each a conv-sized contraction),
    the standard 3x-forward rule."""
    return 3 * batch * unet_forward_flops(
        img_size, base, in_ch, num_classes, bilinear
    )


def mfu(flops: int, seconds: float,
        peak_tflops: float = H100_PEAK_BF16_TFLOPS) -> float:
    """Fraction of peak: (flops / seconds) / peak."""
    return (flops / max(seconds, 1e-12)) / (peak_tflops * 1e12)


# -- the bounds chip_smoke.py prints ---------------------------------------------


def int32_ops_per_s(sms: int, max_sm_mhz: float) -> float:
    """The card's int32 multiply-add rate: SMs x 64 per clock x the
    maximum SM clock."""
    return sms * INT32_OPS_PER_SM_CLOCK * max_sm_mhz * 1e6


def bound_ms(flops: float, nbytes: float,
             peak: float = H100_BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the
    operations at ``peak`` and the bytes at the HBM rate, and which one
    it is (``"operations"`` or ``"bytes"``)."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def conv3x3_bn_relu_cost(b: int, h: int, w: int, cin: int, cout: int,
                         itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one ``conv3x3_bn_relu``: x, the kernel and
    the output at ``itemsize``, the float32 scale and bias."""
    return (2.0 * b * h * w * 9 * cin * cout,
            (b * h * w * cin + 9 * cin * cout + b * h * w * cout) * itemsize
            + 8 * cout)


def conv1x1_cost(b: int, h: int, w: int, cin: int, cout: int,
                 itemsize: int = 2, out_itemsize: int = 4
                 ) -> tuple[float, float]:
    """(operations, bytes) of one ``conv1x1``: x and the weights at
    ``itemsize``, the float32 scale and bias, the output at
    ``out_itemsize``."""
    return (2.0 * b * h * w * cin * cout,
            (b * h * w * cin + cin * cout) * itemsize + 8 * cout
            + b * h * w * cout * out_itemsize)


def conv_transpose2x2_cost(b: int, h: int, w: int, cin: int, cout: int,
                           itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one ``conv_transpose2x2`` from an
    ``[b, h, w, cin]`` input: x, the [2, 2, cin, cout] kernel and the
    ``[b, 2h, 2w, cout]`` output at ``itemsize``, the float32 bias."""
    return (2.0 * b * h * w * cin * 4 * cout,
            (b * h * w * cin + 4 * cin * cout + 4 * b * h * w * cout)
            * itemsize + 4 * cout)


def deproject_edge_stats_cost(h: int, w: int) -> tuple[float, float]:
    """(operations, bytes) of one ``deproject_edge_stats`` on an h x w
    map (float32 operations): mask u8 and depth f32 in, x/y/z f32 and
    valid u8 out, the five parameters and five statistics."""
    return 10.0 * h * w, h * w * (1 + 4 + 3 * 4 + 1) + 5 * 4 + 5 * 4


def bspline_design_cost(n: int, c: int, n_knots: int,
                        degree: int = 3) -> tuple[float, float]:
    """(operations, bytes) of one ``bspline_design`` (float64 operations):
    a basis row has degree + 1 nonzeros, so (degree + 1)^2 Gram and
    3 (degree + 1) right-hand-side products per point, a multiply and an
    add each; points, weights and parameters in, the Gram matrix and the
    right-hand side out."""
    nz = degree + 1
    return (2.0 * n * (nz * nz + 3 * nz),
            8 * (n * 5 + n_knots + c * c + 3 * c))


def bspline_curvature_cost(ns: int, c: int, n_knots: int,
                           degree: int = 3) -> tuple[float, float]:
    """(operations, bytes) of one ``bspline_curvature`` at ``ns`` samples
    (float32 operations): ctrl, u, the knots and the nonzero bands of the
    two derivative matrices in, kappa, valid and r out; the derivative
    control points once, and per sample r, r', r'' from their basis
    nonzeros and about 40 operations of the curvature formula."""
    nbytes = (4 * (3 * c + ns + n_knots + 2 * (c + 1) + 3 * (c + 2))
              + ns * (4 + 1 + 12))
    flops = (2 * 3 * (2 * (c + 1) + 3 * (c + 2))
             + ns * (2 * 3 * (3 * degree) + 40))
    return float(flops), float(nbytes)


def bitpack_mask_cost(b: int, h: int, w: int) -> tuple[float, float]:
    """(operations, bytes) of one ``bitpack_mask`` (operations counted at
    the float32 rate): the u8 mask in, ``ceil(w / 8)`` bytes a row out."""
    wb = (w + 7) // 8
    return 16.0 * b * h * wb, float(b * h * w + b * h * wb)


#: int32 operations per 8x8 block of the least work computing
#: ``dequant_idct``: libjpeg's islow butterfly, about 12 multiplies, 32
#: adds and 18 shifts or rounding adds per 8-point pass, 16 passes, plus
#: the dequantizing multiply, the level shift and the clamp per sample
ISLOW_OPS_PER_BLOCK = 16 * 62 + 64 * 4


def dequant_idct_cost(b: int, n_blocks: int) -> tuple[float, float]:
    """(int32 operations, bytes) of one ``dequant_idct`` of ``b`` planes
    of ``n_blocks`` blocks: int16 coefficients in and int32 samples out,
    the quantization tables and the 64 constants."""
    blocks = b * n_blocks
    return (float(blocks * ISLOW_OPS_PER_BLOCK),
            float(blocks * 64 * (2 + 4) + b * 64 * 4 + 64 * 4))


def train_conv_costs(b: int, s: int, cin: int, cout: int
                     ) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of the training conv's three bf16 launches at
    ``[b, s, s, cin] -> cout``: the weight gradient (x and dy in, the
    float32 dw out), the forward (x and the kernel in, y out, the unit
    scale and bias) and dx (dy and the flipped kernel in, dx out, the
    unit scale and bias)."""
    flops = 2.0 * b * s * s * 9 * cin * cout
    act = b * s * s * 2  # bytes per channel of a bf16 activation
    return {
        "dw": (flops, act * (cin + cout) + 9 * cin * cout * 4),
        "fwd": (flops, act * (cin + cout) + 9 * cin * cout * 2 + 8 * cout),
        "dx": (flops, act * (cin + cout) + 9 * cin * cout * 2 + 8 * cin),
    }
