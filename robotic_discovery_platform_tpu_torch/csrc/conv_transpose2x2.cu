// NHWC 2x2 stride-2 transposed convolution + per-channel float32 bias for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/conv.py
//   conv_transpose2x2 (kernel body _convt2x2_kernel): the non-bilinear
//   U-Net's upsampler. Each input pixel spawns a 2x2 output patch,
//   out[b, 2h+dy, 2w+dx, co] = bias[co] + sum over ci of
//   x[b, h, w, ci] * w[1-dy, 1-dx, ci, co] -- the spatially FLIPPED tap,
//   lax.conv_transpose's and Flax nn.ConvTranspose's convention; w is
//   [2, 2, Cin, Cout] (HWIO). Float32 accumulation in ci order, the bias
//   added in float32, one rounding to the output type.
//
// Bound on one H100 SXM: bytes. The work is one GEMM, [B*H*W, Cin] x
// [Cin, 4*Cout], whose inputs and output move once: at the non-bilinear
// ladder's four launches (16^2 * 1024 -> 512, 32^2 * 512 -> 256,
// 64^2 * 256 -> 128, 128^2 * 128 -> 64, bf16) 1.07 GFLOP each (1.09 us at
// 989 TFLOP/s) against 4.2-12.7 MB (1.25-3.78 us at 3.35 TB/s).
//
// Design: the GEMM on the CUDA cores, the first simple form. A block of
// 256 threads owns 64 input pixels x 64 GEMM columns (column n is tap
// n / Cout, channel n % Cout) and walks Cin in steps of 16, staging both
// operand tiles in shared memory as float32; each thread keeps a 4 x 4
// register tile (rows r + 16i, columns c + 16j, so a warp's shared-memory
// reads are broadcasts or consecutive words). The epilogue scatters each
// (pixel, tap) sum to its output position. Ragged edges (pixel count,
// Cin, 4*Cout) are masked with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

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

}  // namespace

// x [B, H, W, Cin], w [2, 2, Cin, Cout] (x's dtype), bias [Cout] f32 ->
// out [B, 2H, 2W, Cout]. dtypes: 0 = f32 in / f32 out, 1 = bf16 in / bf16
// out, 2 = bf16 in / f32 out. Returns the cudaError_t of the launch (0 =
// success), or -1 for an unknown dtypes code or sizes past the grid.
extern "C" int conv_transpose2x2_launch(const void* x, const void* w,
                                        const void* bias, void* out, int B,
                                        int H, int W, int Cin, int Cout,
                                        int dtypes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0:
      return launch<float, float>(x, w, bi, out, B, H, W, Cin, Cout, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, bi, out, B, H, W,
                                                  Cin, Cout, st);
    case 2:
      return launch<__nv_bfloat16, float>(x, w, bi, out, B, H, W, Cin, Cout,
                                          st);
    default:
      return -1;
  }
}
