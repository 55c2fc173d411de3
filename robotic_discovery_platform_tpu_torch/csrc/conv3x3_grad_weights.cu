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
// 256^2) the RGB layer (Cin = 3) is bound by its bytes and the others by
// their operations, 0.9 us to 39 us per launch.
//
// Design against that bound (the simple first version): an implicit GEMM
// with M = 9*Cin (tap x input channel), N = Cout and K = B*H*W, with no
// im2col and no padded copy of x. A block owns a 32 (Cin) x 64 (Cout)
// output tile for all nine taps and walks a contiguous range of 8x8 pixel
// tiles (in row-major order: a band of image rows). For each pixel tile it
// stages the 10x10 halo of x and the 8x8 tile of g in shared memory as
// float32, once, and reuses the halo for the nine taps, as the TPU kernel
// slices nine windows of one slab; zero padding comes from bounds checks
// while staging. Each of the 256 threads keeps 9 taps x 2 input channels
// x 4 output channels = 72 float32 accumulators in registers: per pixel it
// reads one float4 of g and nine float2 of the halo and issues 72 FMAs on
// the CUDA cores. K is split over blocks without float atomics: each
// (tile, split) block writes its float32 partial to a workspace
// [splits, 9, Cin, Cout], and a second small kernel folds the partials in
// split order, so one call gives the same bits every run. The caller
// picks the split count to fill the 132 SMs and caps the workspace. No
// tensor cores (mma.sync / wgmma), TMA or pipelining yet: later work, so
// its time sits well above the bound (measured figures in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TP = 8;                  // pixel tile: TP x TP
constexpr int HALO_W = TP + 2;
constexpr int HALO = HALO_W * HALO_W;  // staged input positions per tile
constexpr int CT = 32;                 // input channels per block
constexpr int NT = 64;                 // output channels per block
constexpr int THREADS = 256;
constexpr int FOLD_THREADS = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
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
    const T* xb = x + (size_t)b * H * W * Cin;
    const T* gb = g + (size_t)b * H * W * Cout;

    // x halo: neighbouring threads read neighbouring input channels
    for (int e = tid; e < HALO * CT; e += THREADS) {
      const int c = e % CT;
      const int pos = e / CT;
      const int hy = y0 - 1 + pos / HALO_W;
      const int hx = x0 - 1 + pos % HALO_W;
      const int ci = ci0 + c;
      float v = 0.f;
      if (ci < Cin && hy >= 0 && hy < H && hx >= 0 && hx < W)
        v = load_f32(xb + ((size_t)hy * W + hx) * Cin + ci);
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
        v = load_f32(gb + ((size_t)gy * W + gx) * Cout + co);
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

template <typename T>
int launch(const void* x, const void* g, float* ws, float* dw, int B, int H,
           int W, int Cin, int Cout, int splits, cudaStream_t stream) {
  const int tiles_w = (W + TP - 1) / TP;
  const int tiles_per_image = ((H + TP - 1) / TP) * tiles_w;
  const long long n_tiles = (long long)B * tiles_per_image;
  const int co_tiles = (Cout + NT - 1) / NT;
  const long long out_tiles = (long long)((Cin + CT - 1) / CT) * co_tiles;
  if (splits < 1 || splits > n_tiles || n_tiles > INT32_MAX ||
      out_tiles > INT32_MAX || splits > 65535)
    return -1;
  float* partial = splits == 1 ? dw : ws;
  const dim3 grid((unsigned)out_tiles, (unsigned)splits);
  dw_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, H, W, Cin,
      Cout, tiles_w, tiles_per_image, (int)n_tiles, co_tiles, splits);
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const size_t n = (size_t)9 * Cin * Cout;
  fold_kernel<<<(unsigned)((n + FOLD_THREADS - 1) / FOLD_THREADS),
                FOLD_THREADS, 0, stream>>>(ws, dw, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes: 0 = x and g float32, 1 = x and g bfloat16. ws holds
// splits * 9 * Cin * Cout floats (unused when splits == 1). Returns the
// cudaError_t of the launches (0 = success), or -1 for an unknown dtypes
// code or a split count outside [1, number of 8x8 pixel tiles].
extern "C" int conv3x3_grad_weights_launch(const void* x, const void* g,
                                           void* ws, void* dw, int B, int H,
                                           int W, int Cin, int Cout,
                                           int splits, int dtypes,
                                           void* stream) {
  float* w = static_cast<float*>(ws);
  float* d = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0:
      return launch<float>(x, g, w, d, B, H, W, Cin, Cout, splits, st);
    case 1:
      return launch<__nv_bfloat16>(x, g, w, d, B, H, W, Cin, Cout, splits,
                                   st);
    default:
      return -1;
  }
}
