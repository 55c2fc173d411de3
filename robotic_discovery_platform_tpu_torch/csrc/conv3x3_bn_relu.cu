// Fused NHWC 3x3 SAME convolution + per-channel scale/bias (+ ReLU) for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/conv.py
//   conv3x3_bn_relu (kernel body _conv3x3_kernel): the folded
//   (conv -> BatchNorm -> ReLU) half-block of the U-Net's DoubleConv.
//
// What it computes: out[b,y,x,co] = cast(act(scale[co] * acc + bias[co]))
// with acc = sum over (dy, dx, ci) of x[b, y+dy-1, x+dx-1, ci] *
// w[dy, dx, ci, co] accumulated in float32, zero outside the image, and
// one rounding to the output type. Weights are HWIO, exactly as folded.
//
// Bound on one H100 SXM: max(2*H*W*9*Cin*Cout / 989 TFLOP/s (bf16 tensor
// cores), (input + weights + output bytes) / 3.35 TB/s). On the U-Net's
// 256x256 bf16 forward the wide early layers sit at the byte bound
// (256^2 x 64 -> 64: 4.8 GFLOP, 16.8 MB) and the deep narrow-map layers
// are bounded by their weight bytes.
//
// Design against that bound (the simple first version): an implicit GEMM
// over K = 9*Cin with no im2col and no padded copy of the input. A block
// owns an 8x8 tile of output pixels x 64 output channels. For each chunk
// of 16 input channels it stages the (8+2)x(8+2) input halo and the
// 9x16x64 weight slice in shared memory as float32, so each input element
// is read from device memory once per chunk and reused nine times from
// shared memory; border taps read zeros from the halo. Each of the 128
// threads keeps a 4-pixel x 8-channel float32 accumulator in registers
// and runs on the CUDA cores (FMA). The epilogue applies scale/bias and
// ReLU and writes each output once. It does not use the tensor cores,
// TMA or a multi-stage pipeline; those are later work, so its time sits
// well above the bound (the measured figures are in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TH = 8;                 // output rows per block
constexpr int TW = 8;                 // output columns per block
constexpr int BN = 64;                // output channels per block
constexpr int KC = 16;                // input channels staged per step
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;
constexpr int THREADS = 128;
constexpr int PX = 4;                 // pixels per thread (one row, adjacent)
constexpr int CX = 8;                 // output channels per thread

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ bias, TO* __restrict__ out,
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

  const T* xb = x + (size_t)b * H * W * Cin;
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
        v = load_f32(xb + ((size_t)hy * W + hx) * Cin + ci);
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
        v = load_f32(w + ((size_t)tap * Cin + ci) * Cout + co);
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
    TO* o = out + (((size_t)b * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int k = 0; k < CX; ++k) {
      const int co = co0 + cc + k;
      if (co >= Cout) continue;
      float v = __fadd_rn(__fmul_rn(acc[j][k], scale[co]), bias[co]);
      if (relu) v = fmaxf(v, 0.f);
      store_out(o + co, v);
    }
  }
}

template <typename T, typename TO>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, int B, int H, int W, int Cin,
           int Cout, int relu, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_image = ((H + TH - 1) / TH) * tiles_w;
  const dim3 grid((unsigned)(B * tiles_per_image),
                  (unsigned)((Cout + BN - 1) / BN));
  conv3x3_kernel<T, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<TO*>(out), H, W, Cin, Cout, tiles_w, tiles_per_image,
      relu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes: 0 = f32 in / f32 out, 1 = bf16 in / bf16 out, 2 = bf16 in / f32 out.
// Returns the cudaError_t of the launch (0 = success), or -1 for an
// unknown dtypes code.
extern "C" int conv3x3_bn_relu_launch(const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      void* out, int B, int H, int W,
                                      int Cin, int Cout, int relu,
                                      int dtypes, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0:
      return launch<float, float>(x, w, s, bi, out, B, H, W, Cin, Cout,
                                  relu, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, s, bi, out, B, H, W,
                                                  Cin, Cout, relu, st);
    case 2:
      return launch<__nv_bfloat16, float>(x, w, s, bi, out, B, H, W, Cin,
                                          Cout, relu, st);
    default:
      return -1;
  }
}
