// NHWC 2x2 stride-2 transposed convolution + per-channel float32 bias for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/conv.py:412
//   conv_transpose2x2 (kernel body _convt2x2_kernel :380): the
//   non-bilinear U-Net's upsampler. Each input pixel spawns a 2x2 output
//   patch, out[b, 2h+dy, 2w+dx, co] = bias[co] + sum over ci of
//   x[b, h, w, ci] * w[1-dy, 1-dx, ci, co] -- the spatially FLIPPED tap,
//   lax.conv_transpose's and Flax nn.ConvTranspose's convention; w is
//   [2, 2, Cin, Cout] (HWIO). Float32 accumulation, the bias added in
//   float32, one rounding to the output type.
//
// Bound on one H100 SXM: the work is one GEMM, M = B*H*W pixels x K = Cin
// x N = 4 taps * Cout, whose inputs and output move once. The
// non-bilinear ladder's four launches (16^2 * 1024 -> 512, 32^2 * 512 ->
// 256, 64^2 * 256 -> 128, 128^2 * 128 -> 64, bf16) are 1.07 GFLOP each
// per frame (1.09 us at 989 TFLOP/s). At B = 1 all four are bound by
// their bytes: 5.8, 4.2, 6.6 and 12.6 MB (1.72, 1.25, 1.96, 3.77 us at
// 3.35 TB/s); at B = 8 the 16^2 and 32^2 launches are bound by their
// operations (8.7 us each) and the 64^2 and 128^2 ones by their bytes
// (50.6 and 100.7 MB: 15.1 and 30.0 us). The 128^2 map writes 8.4 MB per
// frame and reads 4.2: there the output's stores decide.
//
// Design against that bound, bf16 in with Cin % 16 == 0 and Cout % 64 ==
// 0 (all four ladder shapes, and any base width that is a multiple of 64):
// an implicit GEMM on the tensor cores with Hopper's warpgroup MMA. A
// block of two warpgroups owns 64 input pixels x 64 output channels x all
// four taps, so each x tile is read once, not once per tap: warpgroup g
// computes the two taps of kernel row g (output row offset dy = 1 - g) as
// one 64 x 128 float32 accumulator of wgmma.m64n128k16 products, with A in
// registers; the first product of a tile sets the accumulator (scale-d 0),
// so nothing outside the asynchronous pipeline writes it and ptxas keeps
// the wgmmas of a chunk in flight together.
// x is [M, Cin] row-major, already K-contiguous: no halo and no im2col.
// K is walked in chunks of 32 input channels through a ring of 4 stages
// in shared memory, two chunks' 16-byte cp.async loads in flight while
// the tensor cores work: per stage the 64 x 32 x tile (rows padded to 80
// bytes, so ldmatrix reads them without bank conflicts) and the four
// taps' 32 x 64 weight slices (w[tap] is [Cin, Cout], Cout contiguous:
// N-major, 128-byte rows in the 128-byte swizzle, read by the tensor
// cores through a descriptor; the layout of conv3x3_bn_relu.cu's weight
// slices, helpers in conv_mma.cuh). Two blocks fit on an SM. The epilogue
// adds the bias in float32, rounds once, and stages each warp's 16 pixels
// x (dx = 0, 1) x 64 channels in shared memory; for one (pixel, dy) the
// two dx outputs are neighbouring output pixels, so each is written as
// 128-byte runs of 16-byte stores (one 256-byte run where Cout = 64).
// No split K: every output's sum runs over Cin in one fixed order that
// depends on neither B nor the grid, so a frame gives the same bits alone
// and inside a batch, and two calls give the same bits.
//
// Other shapes -- float32 (TF32 would break the float32 bar), and bf16
// with Cin % 16 or Cout % 64 nonzero -- take the first version's kernel
// on the CUDA cores (namespace fma_path): a block of 256 threads owns 64
// input pixels x 64 GEMM columns (column n is tap n / Cout, channel n %
// Cout) and walks Cin in steps of 16, staging both operand tiles in
// shared memory as float32; each thread keeps a 4 x 4 register tile. The
// C entry picks the path by dtype and shape (conv_transpose2x2_path, the
// rule ops/conv.convt_path mirrors).

#include "conv_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

namespace fma_path {

constexpr int THREADS = 256;
constexpr int BM = 64;  // input pixels per block
constexpr int BN = 64;  // GEMM columns (tap, output channel) per block
constexpr int BK = 16;  // input channels per shared-memory step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
conv_transpose2x2_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ bias,
                         TO* __restrict__ out, int H, int W, int Cin,
                         int Cout, long long M) {
  __shared__ float xs[BK][BM];
  __shared__ float ws[BK][BN];

  const int t = threadIdx.x;
  const int tr = t / 16, tc = t % 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int N = 4 * Cout;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    // x tile: BM pixels x BK channels, channels fastest in memory
    for (int i = t; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const long long gm = m0 + m;
      const int gk = k0 + k;
      xs[k][m] = (gm < M && gk < Cin) ? to_f32(x[gm * Cin + gk]) : 0.f;
    }
    // w tile: BK channels x BN columns; column n is w[tap / 2, tap % 2,
    // ci, co] with tap = n / Cout, co = n % Cout
    for (int i = t; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int gn = n0 + n, gk = k0 + k;
      float v = 0.f;
      if (gn < N && gk < Cin) {
        const int tap = gn / Cout, co = gn % Cout;
        v = to_f32(w[((size_t)tap * Cin + gk) * Cout + co]);
      }
      ws[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int W2 = 2 * W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + tr + 16 * i;
    if (gm >= M) continue;
    const int px = (int)(gm % W);
    const long long rest = gm / W;
    const int py = (int)(rest % H);
    const long long b = rest / H;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tc + 16 * j;
      if (gn >= N) continue;
      const int tap = gn / Cout, co = gn % Cout;
      // kernel tap (ty, tx) lands on output offset (1 - ty, 1 - tx)
      const int dy = 1 - tap / 2, dx = 1 - tap % 2;
      const size_t o =
          (((size_t)b * 2 * H + 2 * py + dy) * W2 + 2 * px + dx) * Cout + co;
      store_out(out + o, __fadd_rn(acc[i][j], bias[co]));
    }
  }
}

template <typename T, typename TO>
int launch(const void* x, const void* w, const float* bias, void* out, int B,
           int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const long long mblocks = (M + BM - 1) / BM;
  const int nblocks = (4 * Cout + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || nblocks > 65535) return -1;
  const dim3 grid((unsigned)mblocks, (unsigned)nblocks);
  conv_transpose2x2_kernel<T, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<TO*>(out), H, W, Cin, Cout, M);
  return (int)cudaGetLastError();
}


}  // namespace fma_path

// -- bf16 on the tensor cores -------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace conv_mma;

constexpr int BM = 64;              // input pixels per block
constexpr int BN = 64;              // output channels per block (four taps)
constexpr int KC = 32;              // input channels per stage
constexpr int KSTEPS = KC / 16;     // k16 steps per stage
constexpr int AS = KC + 8;          // x tile row: 80 bytes
constexpr int STAGES = 4;
constexpr int AHEAD = STAGES - 2;   // chunks whose loads are in flight
constexpr int THREADS = 256;        // two warpgroups
constexpr int W_ELEMS = 4 * KC * BN;  // the four taps' weight slices
constexpr int STAGE_ELEMS = (W_ELEMS + BM * AS + 511) / 512 * 512;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
static_assert(THREADS == BM * (KC / 8) && THREADS == KC * (BN / 8), "");

// weight slice row r, channel group grp (8 channels): 128-byte rows, the
// 16-byte group grp of row r at grp ^ (r % 8)
__device__ __forceinline__ int w_off(int r, int grp) {
  return r * 64 + ((grp ^ (r & 7)) * 8);
}

template <typename TO>
__global__ void __launch_bounds__(THREADS, 2)
convt_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, TO* __restrict__ out, int W,
                 int Cin, int Cout, int M) {
  extern __shared__ __align__(1024) bf16 smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // kernel row ty = wg: taps 2 wg (tx 0), 2 wg + 1
  const int q = warp & 3;    // pixels 16 q .. 16 q + 15 of the tile
  const int m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int n_chunks = (Cin + KC - 1) / KC;

  // This thread's copies, fixed for the block: x row tid / 4 (channel
  // group tid % 4) and weight row tid / 8 of each tap's slice (channels
  // co0 + 8 (tid % 8) ..)
  const int ar = tid >> 2, ag = tid & 3;
  const bool a_ok = m0 + ar < M;
  const bf16* a_src = x + (size_t)(a_ok ? m0 + ar : 0) * Cin + ag * 8;
  const int wr = tid >> 3, wgrp = tid & 7;
  const bf16* w_src = w + (size_t)wr * Cout + co0 + wgrp * 8;

  // stage `st` <- K chunk `chunk`, zero past Cin and past the last pixel
  auto load = [&](int st, int chunk) {
    bf16* w_s = smem + st * STAGE_ELEMS;
    bf16* a_s = w_s + W_ELEMS;
    const int k0 = chunk * KC;
    const bool ak = a_ok && k0 + ag * 8 < Cin;
    cp_async16(a_s + ar * AS + ag * 8, ak ? a_src + k0 : x, ak ? 16 : 0);
    const bool wk = k0 + wr < Cin;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      cp_async16(w_s + t * KC * BN + w_off(wr, wgrp),
                 wk ? w_src + ((size_t)t * Cin + k0) * Cout : w, wk ? 16 : 0);
  };

  // the warpgroup's 64 x 128 accumulator: n8 blocks 0-7 tap 2 wg, 8-15
  // tap 2 wg + 1, this warp's 16 pixels in its rows; set by the first
  // chunk's first product (scale-d 0)
  float acc[64];

  // one chunk on the tensor cores: the A fragments of its k16 steps into
  // `afr`, then the wgmma group (one m64n128k16 per k16 step over the two
  // taps' slices, 4 KB apart), left in flight with at most one older
  // group
  auto compute = [&](int it, uint32_t (&afr)[KSTEPS][4]) {
    const bf16* w_s = smem + (it % STAGES) * STAGE_ELEMS;
    const bf16* a_s = w_s + W_ELEMS;
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k)
      ldmatrix_x4(afr[k], a_s + (q * 16 + frag_row(lane)) * AS + k * 16 +
                              frag_col(lane));
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k)
      wgmma_m64n128k16_rs(
          acc, afr[k],
          wgmma_desc_sw128(w_s + 2 * wg * KC * BN + k * 16 * BN, KC * BN * 2),
          it > 0 || k > 0);
    wgmma_commit();
    wgmma_wait<1>();
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }
  // The stage loaded at step it is that of chunk it - 2, whose wgmma group
  // both warpgroups have waited for (wgmma_wait<1> at step it - 1, before
  // this step's barrier). A fragments alternate between two register sets,
  // so a group in flight keeps its own.
  uint32_t afr0[KSTEPS][4], afr1[KSTEPS][4];
  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + AHEAD < n_chunks) load((it + AHEAD) % STAGES, it + AHEAD);
    cp_async_commit();
    if (it % 2 == 0)
      compute(it, afr0);
    else
      compute(it, afr1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
  if (n_chunks == 0)  // Cin = 0: the bias alone
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();  // both warpgroups are done with the stages

  // epilogue: + bias in float32, one rounding, staged per warp as 16 rows
  // of (dx = 0, dx = 1) x 64 channels (+ 16 bytes of padding)
  constexpr int E = 16 / sizeof(TO);  // elements per 16 bytes
  constexpr int RS = 2 * BN + E;
  TO* o_s = reinterpret_cast<TO*>(smem) + warp * 16 * RS;
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // tap tx = j lands on dx = 1 - j
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8) {
        const int c = n8 * 8 + (lane % 4) * 2;
        store_pair(o_s + (lane / 4 + half * 8) * RS + (1 - j) * BN + c,
                   __fadd_rn(acc[j * 32 + n8 * 4 + half * 2], bias[co0 + c]),
                   __fadd_rn(acc[j * 32 + n8 * 4 + half * 2 + 1],
                             bias[co0 + c + 1]));
      }
  }
  __syncwarp();
  // pixel m = b*H*W + h*W + w of row i lands on output row 2 (m / W) + dy
  // (= b*2H + 2h + dy), columns 2 (m % W) + dx
  const int dy = 1 - wg;
  constexpr int CH = BN / E;  // 16-byte pieces of one (pixel, dx) run
#pragma unroll
  for (int k = 0; k < 16 * 2 * CH / 32; ++k) {
    const int e = lane + 32 * k;
    const int c = e % CH, run = e / CH, i = run / 2, dx = run % 2;
    const int m = m0 + q * 16 + i;
    if (m < M) {
      const unsigned rr = (unsigned)m / (unsigned)W;
      const unsigned px = (unsigned)m - rr * (unsigned)W;
      TO* dst = out + ((size_t)(2 * rr + dy) * (2 * W) + 2 * px + dx) * Cout +
                co0 + c * E;
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(o_s + i * RS + dx * BN + c * E);
    }
  }
}

template <typename TO>
int launch(const void* x, const void* w, const float* bias, void* out, int B,
           int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  if (M > INT32_MAX - BM || Cout / BN > 65535) return -1;
  // 16-byte copies and stores
  if ((uintptr_t)x % 16 || (uintptr_t)w % 16 || (uintptr_t)out % 16)
    return -1;
  auto kernel = convt_mma_kernel<TO>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err) return err;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(Cout / BN));
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias,
      static_cast<TO*>(out), W, Cin, Cout, (int)M);
  return (int)cudaGetLastError();
}

}  // namespace tc

// the C entry's rule: bf16 in (either output) with Cin % 16 == 0 and
// Cout % 64 == 0 takes the tensor cores
bool tensor_cores(int Cin, int Cout, int dtypes) {
  return (dtypes == 1 || dtypes == 2) && Cin % 16 == 0 && Cout % 64 == 0;
}

}  // namespace

// Which path conv_transpose2x2_launch takes for these widths and dtypes
// code: 1 = the tensor cores (wgmma), 0 = the CUDA cores (FMA), -1 = an
// unknown dtypes code.
extern "C" int conv_transpose2x2_path(int Cin, int Cout, int dtypes) {
  if (dtypes < 0 || dtypes > 2) return -1;
  return tensor_cores(Cin, Cout, dtypes) ? 1 : 0;
}

// x [B, H, W, Cin], w [2, 2, Cin, Cout] (x's dtype), bias [Cout] f32 ->
// out [B, 2H, 2W, Cout]. dtypes: 0 = f32 in / f32 out, 1 = bf16 in / bf16
// out, 2 = bf16 in / f32 out. Returns the cudaError_t of the launch (0 =
// success), or -1 for an unknown dtypes code, sizes past the grid, or (on
// the tensor cores) x, w or out not on a 16-byte address.
extern "C" int conv_transpose2x2_launch(const void* x, const void* w,
                                        const void* bias, void* out, int B,
                                        int H, int W, int Cin, int Cout,
                                        int dtypes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores(Cin, Cout, dtypes))
    return dtypes == 1 ? tc::launch<__nv_bfloat16>(x, w, bi, out, B, H, W,
                                                   Cin, Cout, st)
                       : tc::launch<float>(x, w, bi, out, B, H, W, Cin, Cout,
                                           st);
  switch (dtypes) {
    case 0:
      return fma_path::launch<float, float>(x, w, bi, out, B, H, W, Cin, Cout,
                                            st);
    case 1:
      return fma_path::launch<__nv_bfloat16, __nv_bfloat16>(
          x, w, bi, out, B, H, W, Cin, Cout, st);
    case 2:
      return fma_path::launch<__nv_bfloat16, float>(x, w, bi, out, B, H, W,
                                                    Cin, Cout, st);
    default:
      return -1;
  }
}
