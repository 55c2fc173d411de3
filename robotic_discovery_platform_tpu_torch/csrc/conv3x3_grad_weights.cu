// Weight gradient of a stride-1 SAME 3x3 no-bias convolution for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/conv.py
//   conv3x3_grad_weights (kernel body _conv3x3_dw_kernel): the dw of the
//   training conv's custom VJP (conv3x3, whose forward and dx run the
//   conv3x3_bn_relu kernel).
//
// What it computes: dw[ky, kx, ci, co] = sum over (b, y, x) of
//   x[b, y + ky - 1, x + kx - 1, ci] * g[b, y, x, co]
// accumulated in float32, x read as zero outside the image, for x and g
// both bfloat16 or both float32; dw is float32 [3, 3, Cin, Cout].
//
// Bound on one H100 SXM: max(2*B*H*W*9*Cin*Cout / 989 TFLOP/s (bf16 tensor
// cores), (x + g + dw bytes) / 3.35 TB/s). At the training batch (4 x
// 256^2) the RGB layer (Cin = 3) is bound by its bytes (mostly g's) and
// the others by their operations, 0.9 us to 39 us per launch.
//
// Design against that bound, bf16 (dtypes 1): an implicit GEMM on the
// tensor cores with M = 9*Cin (tap x input channel), N = Cout and K =
// B*H*W pixels, with no im2col and no padded copy of x. A block of three
// warpgroups owns 64 input x 64 output channels for all nine taps
// (warpgroup g: taps 3g .. 3g + 2, one wgmma.m64n64k16 accumulator of 64
// input x 64 output channels each; warp q of it owns input channels
// 16q ..) and walks a contiguous range of 8x16 pixel tiles (row-major: a
// band of image rows). Per pixel tile it stages the 10x18 halo of x
// ([pos][ci], rows padded to 144 bytes) and the 128-pixel tile of g
// ([pixel][co], 128-byte rows in the 128-byte swizzle) in shared memory
// as bf16 with 16-byte cp.async copies (zero-fill at the image border,
// past Cin and for pixels past the image), in a ring of 4 stages with two
// tiles' loads in flight. Per 16 pixels (a tile row) each warp reads, for
// each of its warpgroup's taps, the shifted window of the one halo,
// transposed, as its 16 rows of A with ldmatrix.trans (one row address
// per lane: the nine taps come from one staged halo, as the TPU kernel
// slices nine windows of one slab), and wgmma reads g as B through a
// shared-memory descriptor; the three wgmmas form one group, left in
// flight while the next row's fragments load (two register sets); the
// partials leave through shared memory in 16-byte stores. An x
// with Cin not a multiple of 8 (the RGB layer, bound by g's bytes) cannot
// take 16-byte copies of its pixels: it flattens (tap, ci) into M = 9*Cin
// in tiles of 32 (27 padded to 32), gathered element by element into an
// im2col tile, and runs mma.sync.m16n8k16 tiles from a 3-stage ring (4
// warps, each 16 rows x 32 output channels). g takes 16-byte copies when
// Cout is a multiple of 8, else element loads.
//
// K is split over blocks without float atomics: each (tile, split) block
// writes its float32 partial to a workspace [splits, 9, Cin, Cout], and a
// second small kernel folds the partials in split order, so one call
// gives the same bits every run. The caller picks the split count to fill
// the 132 SMs and caps the workspace (ops/conv.py dw_splits).
//
// float32 (dtypes 0, off the main path): the first version's FMA kernel
// on the CUDA cores (32 x 64 channels per block over 8x8 pixel tiles, 72
// float32 accumulators per thread), with the same split and fold.

#include "conv_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int FOLD_THREADS = 256;

namespace f32 {

constexpr int TP = 8;                  // pixel tile: TP x TP
constexpr int HALO_W = TP + 2;
constexpr int HALO = HALO_W * HALO_W;  // staged input positions per tile
constexpr int CT = 32;                 // input channels per block
constexpr int NT = 64;                 // output channels per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
          float* __restrict__ ws, int H, int W, int Cin, int Cout,
          int tiles_w, int tiles_per_image, int n_tiles, int co_tiles,
          int splits) {
  __shared__ __align__(16) float x_s[HALO][CT];
  __shared__ __align__(16) float g_s[TP * TP][NT];

  const int tid = threadIdx.x;
  const int ci0 = (blockIdx.x / co_tiles) * CT;
  const int co0 = (blockIdx.x % co_tiles) * NT;
  const int split = blockIdx.y;
  // this block's contiguous range of pixel tiles
  const int t_begin = (int)(((long long)n_tiles * split) / splits);
  const int t_end = (int)(((long long)n_tiles * (split + 1)) / splits);

  // thread -> 2 adjacent input channels x 4 adjacent output channels
  const int cp = (tid % 16) * 2;
  const int cg = (tid / 16) * 4;

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int b = tile / tiles_per_image;
    const int r = tile % tiles_per_image;
    const int y0 = (r / tiles_w) * TP;
    const int x0 = (r % tiles_w) * TP;
    const float* xb = x + (size_t)b * H * W * Cin;
    const float* gb = g + (size_t)b * H * W * Cout;

    // x halo: neighbouring threads read neighbouring input channels
    for (int e = tid; e < HALO * CT; e += THREADS) {
      const int c = e % CT;
      const int pos = e / CT;
      const int hy = y0 - 1 + pos / HALO_W;
      const int hx = x0 - 1 + pos % HALO_W;
      const int ci = ci0 + c;
      float v = 0.f;
      if (ci < Cin && hy >= 0 && hy < H && hx >= 0 && hx < W)
        v = xb[((size_t)hy * W + hx) * Cin + ci];
      x_s[pos][c] = v;
    }
    // g tile: neighbouring threads read neighbouring output channels
    for (int e = tid; e < TP * TP * NT; e += THREADS) {
      const int n = e % NT;
      const int p = e / NT;
      const int gy = y0 + p / TP;
      const int gx = x0 + p % TP;
      const int co = co0 + n;
      float v = 0.f;
      if (co < Cout && gy < H && gx < W)
        v = gb[((size_t)gy * W + gx) * Cout + co];
      g_s[p][n] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int p = 0; p < TP * TP; ++p) {
      const int py = p / TP;
      const int px = p % TP;
      const float4 gv = *reinterpret_cast<const float4*>(&g_s[p][cg]);
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int pos = (py + t / 3) * HALO_W + px + t % 3;
        const float2 xv = *reinterpret_cast<const float2*>(&x_s[pos][cp]);
        acc[t][0][0] = fmaf(xv.x, gv.x, acc[t][0][0]);
        acc[t][0][1] = fmaf(xv.x, gv.y, acc[t][0][1]);
        acc[t][0][2] = fmaf(xv.x, gv.z, acc[t][0][2]);
        acc[t][0][3] = fmaf(xv.x, gv.w, acc[t][0][3]);
        acc[t][1][0] = fmaf(xv.y, gv.x, acc[t][1][0]);
        acc[t][1][1] = fmaf(xv.y, gv.y, acc[t][1][1]);
        acc[t][1][2] = fmaf(xv.y, gv.z, acc[t][1][2]);
        acc[t][1][3] = fmaf(xv.y, gv.w, acc[t][1][3]);
      }
    }
    __syncthreads();
  }

  // this split's partial (or, with one split, dw itself)
  float* out = ws + (size_t)split * 9 * Cin * Cout;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = ci0 + cp + i;
      if (ci >= Cin) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + cg + j;
        if (co < Cout) out[((size_t)t * Cin + ci) * Cout + co] = acc[t][i][j];
      }
    }
}

int launch(const float* x, const float* g, float* partial, int B, int H,
           int W, int Cin, int Cout, int splits, cudaStream_t stream) {
  const int tiles_w = (W + TP - 1) / TP;
  const int tiles_per_image = ((H + TP - 1) / TP) * tiles_w;
  const long long n_tiles = (long long)B * tiles_per_image;
  const int co_tiles = (Cout + NT - 1) / NT;
  const long long out_tiles = (long long)((Cin + CT - 1) / CT) * co_tiles;
  if (splits > n_tiles || n_tiles > INT32_MAX || out_tiles > INT32_MAX)
    return -1;
  const dim3 grid((unsigned)out_tiles, (unsigned)splits);
  dw_kernel<<<grid, THREADS, 0, stream>>>(x, g, partial, H, W, Cin, Cout,
                                          tiles_w, tiles_per_image,
                                          (int)n_tiles, co_tiles, splits);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bf16 on the tensor cores -------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace conv_mma;

constexpr int TH = 8;                  // pixel tile rows
constexpr int TW = 16;                 // pixel tile columns
constexpr int BP = TH * TW;            // pixels per tile
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;
constexpr int BN = 64;                 // output channels per block

// -- Cin not a multiple of 8 (the RGB layer): mma.sync over the flattened
// (tap, ci) rows -----------------------------------------------------------

namespace gather {

constexpr int MG = 32;                 // (tap, ci) rows per block
constexpr int XS = MG + 8;             // im2col row: 80 bytes
constexpr int GS = BN + 8;             // g row: 144 bytes
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int A = BP * XS;
constexpr int ELEMS = A + BP * GS;     // one stage
constexpr int BYTES = STAGES * ELEMS * 2;

__global__ void __launch_bounds__(THREADS)
dw_gather_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 float* __restrict__ ws, int H, int W, int Cin, int Cout,
                 int tiles_w, int tiles_per_image, int n_tiles, int co_tiles,
                 int splits, int g_vec) {
  extern __shared__ __align__(16) bf16 smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;             // rows 16*wm .. 16*wm + 15 of M
  const int wn = warp >> 1;            // channels 32*wn .. 32*wn + 31
  const int m0 = (blockIdx.x / co_tiles) * MG;  // flattened (tap, ci) rows
  const int co0 = (blockIdx.x % co_tiles) * BN;
  const int split = blockIdx.y;
  const int t_begin = (int)(((long long)n_tiles * split) / splits);
  const int t_end = (int)(((long long)n_tiles * (split + 1)) / splits);
  const bf16 zero = __float2bfloat16_rn(0.f);

  // This thread's g copies: pixels (row k, column tid / 8) of the tile,
  // channels co0 + 8 (tid % 8) ..
  static_assert(THREADS / (BN / 8) == TW, "");
  const int gcol = tid / (BN / 8);
  const int co = co0 + (tid % (BN / 8)) * 8;

  // stage `st` <- pixel tile t: the im2col tile of x and g
  auto load = [&](int st, int t) {
    bf16* x_s = smem + st * ELEMS;
    bf16* g_s = x_s + A;
    const int b = t / tiles_per_image;
    const int r = t % tiles_per_image;
    const int y0 = (r / tiles_w) * TH;
    const int x0 = (r % tiles_w) * TW;
    gather_im2col<BP, TW, MG>(x_s, XS, x + (size_t)b * H * W * Cin, H, W,
                              Cin, y0, x0, m0, tid, THREADS);
    const int gx = x0 + gcol;
    const bf16* src = g + (((size_t)b * H + y0) * W + gx) * Cout + co;
    const bool cok = gx < W && co < Cout;
#pragma unroll
    for (int k = 0; k < TH; ++k) {
      const bool ok = cok && y0 + k < H;
      const bf16* sk = src + (size_t)k * W * Cout;
      bf16* dst = g_s + (k * TW + gcol) * GS + (tid % (BN / 8)) * 8;
      if (g_vec) {
        cp_async16(dst, ok ? sk : g, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i] = ok && co + i < Cout ? sk[i] : zero;
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  const int nt = t_end - t_begin;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load(s, t_begin + s);
    cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < nt)
      load((it + STAGES - 1) % STAGES, t_begin + it + STAGES - 1);
    cp_async_commit();

    const bf16* x_s = smem + (it % STAGES) * ELEMS;
    const bf16* g_s = x_s + A;
#pragma unroll 1
    for (int ry = 0; ry < TH; ++ry) {  // 16 pixels: one tile row
      uint32_t bfr[2][4];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldmatrix_x4_trans(bfr[jp], g_s + (ry * TW + frag_row(lane)) * GS +
                                       wn * 32 + jp * 16 + frag_col(lane));
      uint32_t afr[4];
      ldmatrix_x4_trans(afr, x_s + (ry * TW + frag_t_row(lane)) * XS +
                                 wm * 16 + frag_t_col(lane));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[j], afr, bfr[j / 2][(j % 2) * 2],
                 bfr[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // this split's partial (or, with one split, dw itself); dw's row
  // tap * Cin + ci is the flattened M row
  float* out = ws + (size_t)split * 9 * Cin * Cout;
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wm * 16 + lane / 4 + half * 8;
    if (m >= 9 * Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = co0 + wn * 32 + j * 8 + (lane % 4) * 2;
      if (c >= Cout) continue;
      float* o = out + (size_t)m * Cout + c;
      if (pairs) {
        store_pair(o, acc[j][half * 2], acc[j][half * 2 + 1]);
      } else {
        o[0] = acc[j][half * 2];
        if (c + 1 < Cout) o[1] = acc[j][half * 2 + 1];
      }
    }
  }
}

int launch(const bf16* x, const bf16* g, float* partial, int B, int H, int W,
           int Cin, int Cout, int splits, cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(
      dw_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_image = ((H + TH - 1) / TH) * tiles_w;
  const long long n_tiles = (long long)B * tiles_per_image;
  const int co_tiles = (Cout + BN - 1) / BN;
  const long long out_tiles = (long long)((9 * Cin + MG - 1) / MG) * co_tiles;
  if (splits > n_tiles || n_tiles > INT32_MAX || out_tiles > INT32_MAX)
    return -1;
  const int g_vec = Cout % 8 == 0 && (uintptr_t)g % 16 == 0;
  const dim3 grid((unsigned)out_tiles, (unsigned)splits);
  dw_gather_kernel<<<grid, THREADS, BYTES, stream>>>(
      x, g, partial, H, W, Cin, Cout, tiles_w, tiles_per_image, (int)n_tiles,
      co_tiles, splits, g_vec);
  return (int)cudaGetLastError();
}

}  // namespace gather

// -- the halo path on warpgroup MMA (Cin a multiple of 8) --------------------

namespace wg {

constexpr int CT = 64;                 // input channels per block
constexpr int XS = CT + 8;             // halo row: 144 bytes
constexpr int STAGES = 4;
constexpr int AHEAD = STAGES - 2;      // pixel tiles whose loads are in flight
constexpr int THREADS = 384;           // three warpgroups, three taps each
// one stage: the g tile first (swizzle atoms 1024-byte aligned), then the
// x halo
constexpr int G_ELEMS = BP * BN;
constexpr int ELEMS = (G_ELEMS + HALO * XS + 511) / 512 * 512;
constexpr int BYTES = STAGES * ELEMS * 2;

// g tile pixel p, channel group grp (8 channels): 128-byte rows, the
// 16-byte group grp of row p at grp ^ (p % 8)
__device__ __forceinline__ int g_off(int p, int grp) {
  return p * BN + ((grp ^ (p & 7)) * 8);
}

__global__ void __launch_bounds__(THREADS, 1)
dw_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                float* __restrict__ ws, int H, int W, int Cin, int Cout,
                int tiles_w, int tiles_per_image, int n_tiles, int co_tiles,
                int splits, int g_vec) {
  extern __shared__ __align__(1024) bf16 smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tap0 = (tid >> 7) * 3;     // warpgroup: taps tap0 .. tap0 + 2
  const int q = (tid >> 5) & 3;        // warp: input channels 16 q ..
  const int ci0 = (blockIdx.x / co_tiles) * CT;
  const int co0 = (blockIdx.x % co_tiles) * BN;
  const int split = blockIdx.y;
  const int t_begin = (int)(((long long)n_tiles * split) / splits);
  const int t_end = (int)(((long long)n_tiles * (split + 1)) / splits);
  const bf16 zero = __float2bfloat16_rn(0.f);

  // This thread's copies: halo positions tid / 8 + 48 k and g pixels
  // tid / 8 + 48 k, channel group tid % 8 of each
  constexpr int SLOT = THREADS / 8;
  constexpr int H_SLOTS = (HALO + SLOT - 1) / SLOT;
  constexpr int G_SLOTS = (BP + SLOT - 1) / SLOT;
  const int grp = tid % 8;
  const int ci = ci0 + grp * 8;
  const bool ci_ok = ci < Cin;
  const int co = co0 + grp * 8;

  auto load = [&](int st, int t) {
    bf16* g_s = smem + st * ELEMS;
    bf16* x_s = g_s + G_ELEMS;
    const int b = t / tiles_per_image;
    const int r = t % tiles_per_image;
    const int y0 = (r / tiles_w) * TH;
    const int x0 = (r % tiles_w) * TW;
    const bf16* xb = x + (size_t)b * H * W * Cin;
#pragma unroll
    for (int k = 0; k < H_SLOTS; ++k) {
      const int pos = tid / 8 + k * SLOT;
      if (k + 1 < H_SLOTS || pos < HALO) {
        const int hy = y0 - 1 + pos / HALO_W;
        const int hx = x0 - 1 + pos % HALO_W;
        const bool ok = ci_ok && hy >= 0 && hy < H && hx >= 0 && hx < W;
        cp_async16(x_s + pos * XS + grp * 8,
                   ok ? xb + ((size_t)hy * W + hx) * Cin + ci : x,
                   ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int k = 0; k < G_SLOTS; ++k) {
      const int p = tid / 8 + k * SLOT;
      if (k + 1 < G_SLOTS || p < BP) {
        const int gy = y0 + p / TW;
        const int gx = x0 + p % TW;
        const bool pok = gy < H && gx < W;
        const bf16* src = g + (((size_t)b * H + gy) * W + gx) * Cout + co;
        bf16* dst = g_s + g_off(p, grp);
        if (g_vec) {
          const bool ok = pok && co < Cout;
          cp_async16(dst, ok ? src : g, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[i] = pok && co + i < Cout ? src[i] : zero;
        }
      }
    }
  };

  // acc[t]: tap tap0 + t, input channels 16 q .., 64 output channels
  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;

  // 16 pixels (tile row ry) on the tensor cores: each tap's shifted halo
  // window, transposed, into `afr`, then one wgmma group, left in flight
  // with at most one older group
  auto step = [&](const bf16* g_s, const bf16* x_s, int ry,
                  uint32_t (&afr)[3][4]) {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int tap = tap0 + t;
      ldmatrix_x4_trans(afr[t],
                        x_s + ((ry + tap / 3) * HALO_W + frag_t_row(lane) +
                               tap % 3) * XS +
                            q * 16 + frag_t_col(lane));
    }
    wgmma_fence();
    const uint64_t desc = wgmma_desc_sw128(g_s + ry * TW * BN);
#pragma unroll
    for (int t = 0; t < 3; ++t) wgmma_m64n64k16_rs(acc[t], afr[t], desc);
    wgmma_commit();
    wgmma_wait<1>();
  };

  const int nt = t_end - t_begin;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nt) load(s, t_begin + s);
    cp_async_commit();
  }
  // The stage loaded at step it is that of tile it - 2, whose wgmma
  // groups every warpgroup has waited for before this step's barrier. A
  // fragments alternate between two register sets, so a group in flight
  // keeps its own.
  uint32_t afr0[3][4], afr1[3][4];
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + AHEAD < nt) load((it + AHEAD) % STAGES, t_begin + it + AHEAD);
    cp_async_commit();
    const bf16* g_s = smem + (it % STAGES) * ELEMS;
    const bf16* x_s = g_s + G_ELEMS;
#pragma unroll
    for (int ry = 0; ry < TH; ry += 2) {
      step(g_s, x_s, ry, afr0);
      step(g_s, x_s, ry + 1, afr1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(acc[t][i]);
  }
  cp_async_wait<0>();

  // this split's partial (or, with one split, dw itself)
  float* out = ws + (size_t)split * 9 * Cin * Cout;
  if (Cout % 8 == 0) {
    __syncthreads();  // every warpgroup is done with the stages
    float* o_s = reinterpret_cast<float*>(smem) + (tid >> 5) * 16 * (BN + 4);
    const int c = ci0 + q * 16;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      store_tile<BN>(o_s, out + ((size_t)(tap0 + t) * Cin + c) * Cout + co0,
                     Cout, min(16, Cin - c), min(BN, Cout - co0), lane,
                     [&](int j, int r) { return acc[t][j * 4 + r]; });
    return;
  }
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = ci0 + q * 16 + lane / 4 + half * 8;
      if (c >= Cin) continue;
      const size_t row = (size_t)(tap0 + t) * Cin + c;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = co0 + j * 8 + (lane % 4) * 2;
        if (n >= Cout) continue;
        float* o = out + row * Cout + n;
        const float v0 = acc[t][j * 4 + half * 2];
        const float v1 = acc[t][j * 4 + half * 2 + 1];
        if (pairs) {
          store_pair(o, v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < Cout) o[1] = v1;
        }
      }
    }
}

int launch(const bf16* x, const bf16* g, float* partial, int B, int H, int W,
           int Cin, int Cout, int splits, cudaStream_t stream) {
  int err = (int)cudaFuncSetAttribute(
      dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_image = ((H + TH - 1) / TH) * tiles_w;
  const long long n_tiles = (long long)B * tiles_per_image;
  const int co_tiles = (Cout + BN - 1) / BN;
  const long long out_tiles = (long long)((Cin + CT - 1) / CT) * co_tiles;
  if (splits > n_tiles || n_tiles > INT32_MAX || out_tiles > INT32_MAX)
    return -1;
  const int g_vec = Cout % 8 == 0 && (uintptr_t)g % 16 == 0;
  const dim3 grid((unsigned)out_tiles, (unsigned)splits);
  dw_wgmma_kernel<<<grid, THREADS, BYTES, stream>>>(
      x, g, partial, H, W, Cin, Cout, tiles_w, tiles_per_image, (int)n_tiles,
      co_tiles, splits, g_vec);
  return (int)cudaGetLastError();
}

}  // namespace wg

int launch(const bf16* x, const bf16* g, float* partial, int B, int H, int W,
           int Cin, int Cout, int splits, cudaStream_t stream) {
  // 16-byte copies of the halo need 8-channel groups on 16-byte addresses
  if (Cin % 8 != 0)
    return gather::launch(x, g, partial, B, H, W, Cin, Cout, splits, stream);
  if ((uintptr_t)x % 16 != 0) return -1;
  return wg::launch(x, g, partial, B, H, W, Cin, Cout, splits, stream);
}

}  // namespace tc

// dw[i] = sum over s of ws[s, i], in split order
__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(const float* __restrict__ ws, float* __restrict__ dw, size_t n,
            int splits) {
  const size_t i = (size_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (i >= n) return;
  float v = ws[i];
#pragma unroll 8
  for (int s = 1; s < splits; ++s) v += ws[(size_t)s * n + i];
  dw[i] = v;
}

}  // namespace

// dtypes: 0 = x and g float32, 1 = x and g bfloat16. ws holds
// splits * 9 * Cin * Cout floats (unused when splits == 1). Returns the
// cudaError_t of the launches (0 = success), or -1 for an unknown dtypes
// code, a split count outside [1, number of pixel tiles] (8x8 tiles in
// float32, 8x16 in bf16) or a bf16 x whose halo cannot take 16-byte copies
// (Cin a multiple of 8 on an address that is not).
extern "C" int conv3x3_grad_weights_launch(const void* x, const void* g,
                                           void* ws, void* dw, int B, int H,
                                           int W, int Cin, int Cout,
                                           int splits, int dtypes,
                                           void* stream) {
  float* w = static_cast<float*>(ws);
  float* d = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > 65535) return -1;
  float* partial = splits == 1 ? d : w;
  int err;
  switch (dtypes) {
    case 0:
      err = f32::launch(static_cast<const float*>(x),
                        static_cast<const float*>(g), partial, B, H, W, Cin,
                        Cout, splits, st);
      break;
    case 1:
      err = tc::launch(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(g), partial, B, H, W,
                       Cin, Cout, splits, st);
      break;
    default:
      return -1;
  }
  if (err || splits == 1) return err;
  const size_t n = (size_t)9 * Cin * Cout;
  fold_kernel<<<(unsigned)((n + FOLD_THREADS - 1) / FOLD_THREADS),
                FOLD_THREADS, 0, st>>>(w, d, n, splits);
  return (int)cudaGetLastError();
}
