// Fused NHWC 3x3 SAME convolution + per-channel scale/bias (+ ReLU) for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/conv.py
//   conv3x3_bn_relu (kernel body _conv3x3_kernel): the folded
//   (conv -> BatchNorm -> ReLU) half-block of the U-Net's DoubleConv; also
//   the training conv's forward and dx (ops/conv.py _Conv3x3).
//
// What it computes: out[b,y,x,co] = cast(act(scale[co] * acc + bias[co]))
// with acc = sum over (dy, dx, ci) of x[b, y+dy-1, x+dx-1, ci] *
// w[dy, dx, ci, co] accumulated in float32, zero outside the image, and
// one rounding to the output type. Weights are HWIO, exactly as folded.
//
// Bound on one H100 SXM: max(2*B*H*W*9*Cin*Cout / 989 TFLOP/s (bf16 tensor
// cores), (input + weights + output bytes) / 3.35 TB/s). The U-Net's
// layers at B = 1 are bound by their operations (256^2 x 64 -> 64: 4.8
// GFLOP, 4.9 us) except the RGB layer (Cin = 3), which is bound by its
// bytes; the deep narrow maps carry little work per weight byte.
//
// Design against that bound, bf16 in (dtypes 1 and 2): an implicit GEMM on
// the tensor cores with Hopper's warpgroup MMA, M = B*H*W pixels, N =
// Cout, K = 9*Cin, with no im2col and no padded copy of the input. A block
// of two warpgroups owns an 8x16 tile of output pixels (one image) x 64
// output channels; warp q of warpgroup g owns pixel row 4g + q, so each
// warpgroup's 64 x 64 float32 accumulator is one wgmma.m64n64k16 tile.
// K is walked in chunks of 16 input channels: per chunk the block stages
// the 10x18 input halo and the 9x16x64 weight slice in shared memory as
// bf16 with 16-byte cp.async copies (zero-fill at the image border and
// past Cin), in a ring of 4 stages with two chunks' loads in flight while
// the tensor cores work. The nine taps are nine shifted windows of the one
// staged halo: ldmatrix takes a row address per lane, so each tap's A
// fragment is read straight from the shifted halo rows into registers
// (rows padded to 48 bytes: no bank conflicts), and wgmma takes A from
// registers and B (the weight slice, N-major, 128-byte rows in the
// 128-byte swizzle, so the tensor cores read it without bank conflicts)
// through a shared-memory descriptor. A chunk's nine wgmmas form one
// group, left in flight while the next chunk's fragments load (A
// fragments alternate between two register sets); the stage a load
// overwrites is that of a group both warpgroups have waited for. Each
// thread's copy addresses are computed once per block. An input with Cin
// not a multiple of 8 (the RGB layer) cannot take 16-byte copies of its
// pixels: it flattens (tap, ci) into K = 9*Cin in chunks of 32, gathered
// element by element into an im2col tile in shared memory (K = 27 is one
// chunk, padded to 32). Weights take 16-byte copies when Cout is a
// multiple of 8, else element loads. Two blocks fit on an SM. Where Cout
// is a multiple of 8 the epilogue passes each warp's 16 pixels x 64
// channels through shared memory and writes them with 16-byte stores.
//
// Narrow maps (16^2, 32^2) give too few blocks for the 132 SMs: K is then
// split over `splits` blocks (ops/conv.py fwd_splits, a function of H, W,
// Cin and Cout only). Each split writes its float32 partial to a
// workspace [splits, B*H*W, Cout]; a second kernel sums the partials in
// split order, with no atomics, and applies the epilogue. The epilogue is
// __fmul_rn then __fadd_rn (no contraction), ReLU, one rounding. Every
// output's sum order depends on (H, W, Cin, Cout) only, never on B or on
// the grid, so a frame gives the same bits alone and inside a batch, and
// two calls give the same bits.
//
// float32 (dtypes 0, off the main path): the first version's FMA implicit
// GEMM on the CUDA cores (8x8 pixels x 64 channels per block, a 4-pixel x
// 8-channel float32 accumulator per thread), kept so that a float32 model
// meets the float32 bar with TF32 off.

#include "conv_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

namespace f32 {

constexpr int TH = 8;                 // output rows per block
constexpr int TW = 8;                 // output columns per block
constexpr int BN = 64;                // output channels per block
constexpr int KC = 16;                // input channels staged per step
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;
constexpr int THREADS = 128;
constexpr int PX = 4;                 // pixels per thread (one row, adjacent)
constexpr int CX = 8;                 // output channels per thread

__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ out,
               int H, int W, int Cin, int Cout, int tiles_w,
               int tiles_per_image, int relu) {
  __shared__ float halo_s[KC][HALO];
  __shared__ __align__(16) float w_s[9][KC][BN];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles_per_image;
  const int tile = blockIdx.x % tiles_per_image;
  const int y0 = (tile / tiles_w) * TH;
  const int x0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;

  // thread -> 4 adjacent pixels of one output row x 8 adjacent channels
  const int pg = tid % 16;
  const int py = pg >> 1;
  const int px = (pg & 1) * PX;
  const int cc = (tid / 16) * CX;

  float acc[PX][CX];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < CX; ++k) acc[j][k] = 0.f;

  const float* xb = x + (size_t)b * H * W * Cin;
  for (int ci0 = 0; ci0 < Cin; ci0 += KC) {
    // input halo: neighbouring threads read neighbouring channels
    for (int e = tid; e < HALO * KC; e += THREADS) {
      const int c = e % KC;
      const int pos = e / KC;
      const int hy = y0 - 1 + pos / HALO_W;
      const int hx = x0 - 1 + pos % HALO_W;
      const int ci = ci0 + c;
      float v = 0.f;
      if (ci < Cin && hy >= 0 && hy < H && hx >= 0 && hx < W)
        v = xb[((size_t)hy * W + hx) * Cin + ci];
      halo_s[c][pos] = v;
    }
    // weight slice: neighbouring threads read neighbouring output channels
    for (int e = tid; e < 9 * KC * BN; e += THREADS) {
      const int n = e % BN;
      const int r = e / BN;
      const int c = r % KC;
      const int tap = r / KC;
      const int ci = ci0 + c;
      const int co = co0 + n;
      float v = 0.f;
      if (ci < Cin && co < Cout)
        v = w[((size_t)tap * Cin + ci) * Cout + co];
      w_s[tap][c][n] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      const float* hrow = &halo_s[0][(py + dy) * HALO_W + px + dx];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float a[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) a[j] = hrow[c * HALO + j];
        const float4 w0 = *reinterpret_cast<const float4*>(&w_s[tap][c][cc]);
        const float4 w1 =
            *reinterpret_cast<const float4*>(&w_s[tap][c][cc + 4]);
        const float wv[CX] = {w0.x, w0.y, w0.z, w0.w,
                              w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < PX; ++j)
#pragma unroll
          for (int k = 0; k < CX; ++k)
            acc[j][k] = fmaf(a[j], wv[k], acc[j][k]);
      }
    }
    __syncthreads();
  }

  // epilogue: y = acc * scale + bias (no contraction), ReLU, one rounding
  const int oy = y0 + py;
  if (oy >= H) return;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ox = x0 + px + j;
    if (ox >= W) continue;
    float* o = out + (((size_t)b * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int k = 0; k < CX; ++k) {
      const int co = co0 + cc + k;
      if (co >= Cout) continue;
      float v = __fadd_rn(__fmul_rn(acc[j][k], scale[co]), bias[co]);
      if (relu) v = fmaxf(v, 0.f);
      o[co] = v;
    }
  }
}

int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, int B, int H, int W, int Cin,
           int Cout, int relu, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_image = ((H + TH - 1) / TH) * tiles_w;
  const dim3 grid((unsigned)(B * tiles_per_image),
                  (unsigned)((Cout + BN - 1) / BN));
  conv3x3_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), scale,
      bias, static_cast<float*>(out), H, W, Cin, Cout, tiles_w, tiles_per_image,
      relu);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bf16 on the tensor cores -------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace conv_mma;

constexpr int TH = 8;                 // output rows per block
constexpr int TW = 16;                // output columns per block
constexpr int BM = TH * TW;           // output pixels per block
constexpr int BN = 64;                // output channels per block
constexpr int KC = 16;                // input channels per stage (halo)
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;
constexpr int HS = KC + 8;            // halo row: 48 bytes
constexpr int KG = 32;                // (tap, ci) per stage (gather)
constexpr int GS = KG + 8;            // im2col row: 80 bytes
constexpr int STAGES = 4;
constexpr int AHEAD = STAGES - 2;     // chunks whose loads are in flight
constexpr int THREADS = 256;          // two warpgroups
constexpr int FOLD_THREADS = 256;

// one stage of the ring: the weight slice first (its swizzle atoms are
// 1024-byte aligned), then the halo or the im2col tile
template <bool GATHER>
struct Stage {
  static constexpr int K_ROWS = GATHER ? KG : 9 * KC;
  static constexpr int STEPS = K_ROWS / 16;  // k16 steps per stage
  static constexpr int W = K_ROWS * BN;
  static constexpr int A = GATHER ? BM * GS : HALO * HS;
  static constexpr int ELEMS = (W + A + 511) / 512 * 512;
  static constexpr int BYTES = STAGES * ELEMS * 2;
};

// weight slice row r, channel group grp (8 channels): 128-byte rows, the
// 16-byte group grp of row r at grp ^ (r % 8)
__device__ __forceinline__ int w_off(int r, int grp) {
  return r * 64 + ((grp ^ (r & 7)) * 8);
}

__device__ __forceinline__ float epilogue(float acc, const float* scale,
                                          const float* bias, int co,
                                          int relu) {
  float v = __fadd_rn(__fmul_rn(acc, scale[co]), bias[co]);
  return relu ? fmaxf(v, 0.f) : v;
}

template <typename TO, bool GATHER>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, TO* __restrict__ out,
                   float* __restrict__ ws, int H, int W, int Cin, int Cout,
                   int tiles_w, int tiles_per_image, int relu, int n_chunks,
                   int splits, int w_vec) {
  using S = Stage<GATHER>;
  extern __shared__ __align__(1024) bf16 smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // warpgroup wg owns pixel rows 4 wg .. 4 wg + 3; its warp q row 4 wg + q
  const int py = tid >> 5;
  const int b = blockIdx.x / tiles_per_image;
  const int tile = blockIdx.x % tiles_per_image;
  const int y0 = (tile / tiles_w) * TH;
  const int x0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int c_begin = (int)(((long long)n_chunks * split) / splits);
  const int c_end = (int)(((long long)n_chunks * (split + 1)) / splits);
  const int K = 9 * Cin;
  const bf16* xb = x + (size_t)b * H * W * Cin;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // This thread's copies, fixed for the block: halo positions
  // tid / 2 + 128 k (channel group tid % 2), as offsets into the image (-1
  // outside it); weight rows tid / 8 + 32 k of the slice (channels
  // co0 + 8 (tid % 8) ..).
  constexpr int H_SLOTS = (HALO * (KC / 8) + THREADS - 1) / THREADS;
  constexpr int W_SLOTS = (S::K_ROWS * (BN / 8) + THREADS - 1) / THREADS;
  constexpr int W_STEP = THREADS / (BN / 8);  // slice rows per slot
  static_assert(W_STEP % KC == 0 && THREADS % (KC / 8) == 0, "");
  const int hgrp = tid % (KC / 8);
  int h_off[H_SLOTS];
  if constexpr (!GATHER) {
#pragma unroll
    for (int k = 0; k < H_SLOTS; ++k) {
      const int pos = tid / (KC / 8) + k * (THREADS / (KC / 8));
      const int hy = y0 - 1 + pos / HALO_W;
      const int hx = x0 - 1 + pos % HALO_W;
      h_off[k] = pos < HALO && hy >= 0 && hy < H && hx >= 0 && hx < W
                     ? (hy * W + hx) * Cin + hgrp * 8
                     : -1;
    }
  }
  const int wr = tid / (BN / 8);
  const int wgrp = tid % (BN / 8);
  const int co = co0 + wgrp * 8;
  // K rows between a thread's successive weight slots
  const size_t w_step = GATHER ? (size_t)W_STEP * Cout
                               : (size_t)(W_STEP / KC) * Cin * Cout;

  // stage `st` <- K chunk `chunk`: the input (halo or im2col) and the
  // weight rows of the chunk
  auto load = [&](int st, int chunk) {
    bf16* w_s = smem + st * S::ELEMS;
    bf16* a_s = w_s + S::W;
    if constexpr (!GATHER) {
      const int ci0 = chunk * KC;
      const bool cok = ci0 + hgrp * 8 < Cin;
#pragma unroll
      for (int k = 0; k < H_SLOTS; ++k) {
        const int pos = tid / (KC / 8) + k * (THREADS / (KC / 8));
        if (k + 1 < H_SLOTS || pos < HALO) {
          const bool ok = cok && h_off[k] >= 0;
          cp_async16(a_s + pos * HS + hgrp * 8, ok ? xb + h_off[k] + ci0 : x,
                     ok ? 16 : 0);
        }
      }
    } else {
      gather_im2col<BM, TW, KG>(a_s, GS, xb, H, W, Cin, y0, x0, chunk * KG,
                                tid, THREADS);
    }
    // slice row r: K row tap * Cin + ci (halo, r = 16 tap + ci - ci0), or
    // chunk * KG + r (gather)
    const int ci = chunk * KC + wr % KC;
    const bool cok = (GATHER || ci < Cin) && co < Cout;
    const bf16* src = w + (GATHER ? (size_t)(chunk * KG + wr)
                                  : (size_t)(wr / KC) * Cin + ci) * Cout + co;
#pragma unroll
    for (int k = 0; k < W_SLOTS; ++k) {
      const int r = wr + k * W_STEP;
      if (k + 1 < W_SLOTS || r < S::K_ROWS) {
        const bool ok = cok && (!GATHER || chunk * KG + r < K);
        const bf16* sk = src + k * w_step;
        bf16* dst = w_s + w_off(r, wgrp);
        if (w_vec) {
          cp_async16(dst, ok ? sk : w, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[i] = ok && co + i < Cout ? sk[i] : zero;
        }
      }
    }
  };

  // acc: pixel row py (16 pixels) x 64 channels, in the warpgroup's
  // 64-row accumulator
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // one chunk on the tensor cores: the A fragments of its k16 steps (the
  // taps' shifted halo windows, or the im2col tile's columns) into `afr`,
  // then the wgmma group, left in flight with at most one older group
  auto compute = [&](int it, uint32_t (&afr)[S::STEPS][4]) {
    const bf16* w_s = smem + (it % STAGES) * S::ELEMS;
    const bf16* a_s = w_s + S::W;
#pragma unroll
    for (int k = 0; k < S::STEPS; ++k)
      ldmatrix_x4(afr[k],
                  GATHER ? a_s + (py * TW + frag_row(lane)) * GS + k * 16 +
                               frag_col(lane)
                         : a_s + ((py + k / 3) * HALO_W + frag_row(lane) +
                                  k % 3) * HS +
                               frag_col(lane));
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < S::STEPS; ++k)
      wgmma_m64n64k16_rs(acc, afr[k], wgmma_desc_sw128(w_s + k * 16 * 64));
    wgmma_commit();
    wgmma_wait<1>();
  };

  const int nc = c_end - c_begin;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nc) load(s, c_begin + s);
    cp_async_commit();
  }
  // The stage loaded at step it is that of chunk it - 2, whose wgmma group
  // both warpgroups have waited for (wgmma_wait<1> at step it - 1, before
  // this step's barrier). A fragments alternate between two register sets,
  // so a group in flight keeps its own.
  uint32_t afr0[S::STEPS][4], afr1[S::STEPS][4];
  for (int it = 0; it < nc; ++it) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + AHEAD < nc) load((it + AHEAD) % STAGES, c_begin + it + AHEAD);
    cp_async_commit();
    if (it % 2 == 0)
      compute(it, afr0);
    else
      compute(it, afr1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) reg_fence(acc[i]);
  cp_async_wait<0>();

  // epilogue, or this split's float32 partial
  const size_t plane = (size_t)(gridDim.x / tiles_per_image) * H * W * Cout;
  const int y = y0 + py;
  if (Cout % 8 == 0) {
    __syncthreads();  // both warpgroups are done with the stages
    const int n_px = min(TW, W - x0), n_co = min(BN, Cout - co0);
    const size_t row = (((size_t)b * H + min(y, H - 1)) * W + x0) * Cout + co0;
    if (splits > 1) {
      store_tile<BN>(reinterpret_cast<float*>(smem) + py * 16 * (BN + 4),
                 ws + split * plane + row, Cout, y < H ? n_px : 0, n_co,
                 lane, [&](int j, int r) { return acc[j * 4 + r]; });
    } else {
      store_tile<BN>(reinterpret_cast<TO*>(smem) +
                     py * 16 * (BN + 16 / (int)sizeof(TO)),
                 out + row, Cout, y < H ? n_px : 0, n_co, lane,
                 [&](int j, int r) {
                   const int c = co0 + j * 8 + (lane % 4) * 2 + (r & 1);
                   return epilogue(acc[j * 4 + r], scale, bias,
                                   c < Cout ? c : Cout - 1, relu);
                 });
    }
    return;
  }
  const bool pairs = (Cout & 1) == 0;
  if (y >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int xx = x0 + lane / 4 + half * 8;
    if (xx >= W) continue;
    const size_t pix = ((size_t)b * H + y) * W + xx;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = co0 + j * 8 + (lane % 4) * 2;
      if (c >= Cout) continue;
      float v0 = acc[j * 4 + half * 2];
      float v1 = acc[j * 4 + half * 2 + 1];
      if (splits > 1) {
        float* o = ws + split * plane + pix * Cout + c;
        if (pairs) {
          store_pair(o, v0, v1);
        } else {
          o[0] = v0;
          if (c + 1 < Cout) o[1] = v1;
        }
      } else {
        TO* o = out + pix * Cout + c;
        v0 = epilogue(v0, scale, bias, c, relu);
        if (pairs) {
          store_pair(o, v0, epilogue(v1, scale, bias, c + 1, relu));
        } else {
          store_out(o, v0);
          if (c + 1 < Cout)
            store_out(o + 1, epilogue(v1, scale, bias, c + 1, relu));
        }
      }
    }
  }
}

// out[i] = epilogue(sum over s of ws[s, i]), the partials in split order
template <typename TO>
__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
            const float* __restrict__ bias, TO* __restrict__ out, size_t n,
            int Cout, int splits, int relu) {
  const size_t i = (size_t)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (i >= n) return;
  float v = ws[i];
  for (int s = 1; s < splits; ++s) v += ws[(size_t)s * n + i];
  store_out(out + i, epilogue(v, scale, bias, (int)(i % Cout), relu));
}

template <typename TO, bool GATHER>
int launch_kernel(const bf16* x, const bf16* w, const float* scale,
                  const float* bias, TO* out, float* ws, int B, int H, int W,
                  int Cin, int Cout, int relu, int n_chunks, int splits,
                  cudaStream_t stream) {
  auto kernel = conv3x3_mma_kernel<TO, GATHER>;
  const int smem = Stage<GATHER>::BYTES;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_image = ((H + TH - 1) / TH) * tiles_w;
  const dim3 grid((unsigned)(B * tiles_per_image),
                  (unsigned)((Cout + BN - 1) / BN), (unsigned)splits);
  const int w_vec = Cout % 8 == 0 && (uintptr_t)w % 16 == 0;
  kernel<<<grid, THREADS, smem, stream>>>(x, w, scale, bias, out, ws, H, W,
                                          Cin, Cout, tiles_w, tiles_per_image,
                                          relu, n_chunks, splits, w_vec);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch(const void* xv, const void* wv, const float* scale,
           const float* bias, void* outv, float* ws, int B, int H, int W,
           int Cin, int Cout, int relu, int splits, cudaStream_t stream) {
  const bf16* x = static_cast<const bf16*>(xv);
  const bf16* w = static_cast<const bf16*>(wv);
  TO* out = static_cast<TO*>(outv);
  // 16-byte copies of the halo need 8-channel groups on 16-byte addresses
  const bool gather = Cin % 8 != 0;
  if (!gather && (uintptr_t)x % 16 != 0) return -1;
  if ((long long)H * W * Cin >= INT32_MAX) return -1;
  const int n_chunks = gather ? (9 * Cin + KG - 1) / KG : (Cin + KC - 1) / KC;
  if (splits < 1 || splits > n_chunks || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return -1;
  int err = gather ? launch_kernel<TO, true>(x, w, scale, bias, out, ws, B, H,
                                             W, Cin, Cout, relu, n_chunks,
                                             splits, stream)
                   : launch_kernel<TO, false>(x, w, scale, bias, out, ws, B,
                                              H, W, Cin, Cout, relu, n_chunks,
                                              splits, stream);
  if (err || splits == 1) return err;
  const size_t n = (size_t)B * H * W * Cout;
  fold_kernel<TO><<<(unsigned)((n + FOLD_THREADS - 1) / FOLD_THREADS),
                    FOLD_THREADS, 0, stream>>>(ws, scale, bias, out, n, Cout,
                                               splits, relu);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtypes: 0 = f32 in / f32 out, 1 = bf16 in / bf16 out, 2 = bf16 in / f32
// out. ws holds splits * B*H*W*Cout floats (unused when splits == 1; the
// float32 path takes splits == 1 only). Returns the cudaError_t of the
// launches (0 = success), or -1 for an unknown dtypes code, a split count
// outside [1, number of K chunks], or a bf16 x whose halo cannot take
// 16-byte copies (Cin a multiple of 8 on an address that is not).
extern "C" int conv3x3_bn_relu_launch(const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      void* out, void* ws, int B, int H,
                                      int W, int Cin, int Cout, int relu,
                                      int splits, int dtypes, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* wsf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  switch (dtypes) {
    case 0:
      if (splits != 1) return -1;
      return f32::launch(x, w, s, bi, out, B, H, W, Cin, Cout,
                                       relu, st);
    case 1:
      return tc::launch<__nv_bfloat16>(x, w, s, bi, out, wsf, B, H, W, Cin,
                                       Cout, relu, splits, st);
    case 2:
      return tc::launch<float>(x, w, s, bi, out, wsf, B, H, W, Cin, Cout,
                               relu, splits, st);
    default:
      return -1;
  }
}
