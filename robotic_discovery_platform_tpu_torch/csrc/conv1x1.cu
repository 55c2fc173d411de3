// Fused NHWC 1x1 convolution + per-channel scale/bias (+ ReLU) for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/conv.py:301 conv1x1,
//   both of its bodies: _conv1x1_squeeze_kernel :280 (Cout = 1, the
//   U-Net's OutConv head: bf16 features in, f32 logits out) and the
//   general _conv1x1_kernel :266.
//
// What it computes: out[p, co] = cast(act(scale[co] * acc + bias[co])),
// acc = sum over ci of x[p, ci] * w[ci, co] in float32, for every pixel p
// of the [B, H, W] grid; w is [Cin, Cout].
//
// Bound on one H100 SXM: max(2*P*Cin*Cout / 989 TFLOP/s, (P*Cin input
// + Cin*Cout weight + P*Cout output bytes) / 3.35 TB/s). The head
// ([1,256,256,64] bf16 -> f32: 8.4 MB for 8.4 MFLOP, 0.0026 ms; at B = 8
// 69.2 MB, 0.0207 ms) is bound by the bytes it reads; so is the general
// body at the widths a U-Net head has.
//
// Two paths; the C entry picks one from the dtypes, Cin, Cout and the
// 16-byte alignment of x (pick_path; ops/conv.conv1x1_path mirrors the
// rule):
// - head (Cout = 1, Cin a multiple of one 16-byte vector and at most 32
//   of them, x on a 16-byte address): a streaming reduction. G lanes
//   share a pixel (G the least power of two that covers its Cin / E
//   16-byte chunks, E = 8 bf16 or 4 float32), one chunk each, so a warp's
//   load covers 32 / G whole pixels of contiguous bytes (at Cin = 64 bf16:
//   8 lanes, 4 pixels, 512 bytes). Each lane keeps its chunk's weights in
//   registers (loaded once), has four loads in flight before its FMAs,
//   and sums its chunk's products in ascending ci; the G partials then
//   meet in a fixed xor butterfly (offsets G/2, .., 1; every lane of the
//   group ends with the same sum).
//   The grid is sized to the SMs and each warp strides over pixel runs.
// - FMA (Cout > 1 in either dtype; a head whose Cin fills no whole
//   vector or more than 32; a misaligned view): a register-tiled GEMM on
//   the CUDA cores, operand tiles staged through shared memory as float32
//   by scalar loads, a 4 x 4 tile per thread, fmaf in ascending ci. The
//   port's model has one class, so this body serves only other widths.
// Every path sums a pixel's products in an order fixed by Cin and Cout
// alone -- not by B, the pixel's place in a tile or the grid -- with no
// split of K and no atomics, so a frame gives the same bits alone and
// inside the batched dispatch's stack, on every call.

#include "conv_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

using conv_mma::store_out;

constexpr int PATH_FMA = 0;
constexpr int PATH_HEAD = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float epilogue(float acc, float s, float b,
                                          int relu) {
  const float v = __fadd_rn(__fmul_rn(acc, s), b);
  return relu ? fmaxf(v, 0.f) : v;
}

// -- head: Cout = 1 ---------------------------------------------------------

namespace head {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;        // 16-byte loads in flight per lane
constexpr int MAX_VECTORS = 32;  // 16-byte chunks of one pixel: a lane each
constexpr int BLOCKS_PER_SM = 4;

// the E values of one 16-byte vector as float32
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack2(uint32_t r, float& lo, float& hi) {
  lo = __uint_as_float(r << 16);  // little-endian: the low half comes first
  hi = __uint_as_float(r & 0xffff0000u);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  unpack2(v.x, f[0], f[1]);
  unpack2(v.y, f[2], f[3]);
  unpack2(v.z, f[4], f[5]);
  unpack2(v.w, f[6], f[7]);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
head_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            TO* __restrict__ out, long long P, int Cin, int G, int relu) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);  // lane within the pixel's group
  const int q = lane / G;        // the pixel within one load step
  const int ppw = 32 / G;        // pixels per warp and load step
  const int chunks = Cin / E;
  const bool has_chunk = g < chunks;  // G may exceed the chunks

  float wr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) wr[e] = has_chunk ? to_f32(w[g * E + e]) : 0.f;
  const float s = scale[0], b = bias[0];
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const long long step = (long long)ppw * UNROLL;  // pixels per warp pass
  const long long warp =
      ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const long long stride = (long long)gridDim.x * WARPS * step;

  for (long long p0 = warp * step; p0 < P; p0 += stride) {  // warp-uniform
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = p0 + u * ppw + q;
      v[u] = (p < P && has_chunk) ? __ldg(xv + p * chunks + g)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float f[E];
      unpack(v[u], f);
      acc[u] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[u] = fmaf(f[e], wr[e], acc[u]);
    }
    // offsets G/2 .. 1 (a constant trip count: acc stays in registers)
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      if (m >= G) continue;  // uniform over the warp
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(0xffffffffu, acc[u], m));
    }
    if (g == 0) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long p = p0 + u * ppw + q;
        if (p < P) store_out(out + p, epilogue(acc[u], s, b, relu));
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

template <typename T, typename TO>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, long long P, int Cin, int relu,
           cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = Cin / E;
  int G = 1;
  while (G < chunks) G *= 2;
  const long long per_block = (long long)(32 / G) * UNROLL * WARPS;
  const long long need = (P + per_block - 1) / per_block;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  head_kernel<T, TO><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<TO*>(out), P, Cin, G, relu);
  return (int)cudaGetLastError();
}

}  // namespace head

// -- FMA: every other case ----------------------------------------------------

namespace fma_path {

constexpr int THREADS = 256;
constexpr int BM = 64;  // pixels per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // input channels per shared-memory step
constexpr int R = BM / 4, NC = BN / 4;

// Thread (tr, tc) owns the 4 x 4 tile of pixels tr + R i and output
// channels tc + NC j.
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
fma_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ bias,
           TO* __restrict__ out, long long P, int Cin, int Cout, int relu) {
  __shared__ float xs[BK][BM];
  __shared__ float ws[BK][BN];

  const int t = threadIdx.x;
  const int tr = t / NC, tc = t % NC;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    for (int i = t; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const long long gm = m0 + m;
      xs[k][m] = (gm < P && k0 + k < Cin) ? to_f32(x[gm * Cin + k0 + k])
                                          : 0.f;
    }
    for (int i = t; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      ws[k][n] = (k0 + k < Cin && n0 + n < Cout)
                     ? to_f32(w[(size_t)(k0 + k) * Cout + n0 + n])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][tr + R * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tc + NC * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = m0 + tr + R * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tc + NC * j;
      if (co < Cout)
        store_out(out + p * Cout + co,
                  epilogue(acc[i][j], scale[co], bias[co], relu));
    }
  }
}

template <typename T, typename TO>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, long long P, int Cin, int Cout,
           int relu, cudaStream_t stream) {
  const long long mblocks = (P + BM - 1) / BM;
  const int nblocks = (Cout + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || nblocks > 65535) return -1;
  fma_kernel<T, TO><<<dim3((unsigned)mblocks, (unsigned)nblocks), THREADS,
                      0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<TO*>(out), P, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace fma_path

// The path rule (ops/conv.conv1x1_path mirrors it). e: elements of x per
// 16 bytes.
int pick_path(bool x16, int Cin, int Cout, int dtypes) {
  const int e = dtypes == 0 ? 4 : 8;
  if (x16 && Cout == 1 && Cin % e == 0 && Cin <= e * head::MAX_VECTORS)
    return PATH_HEAD;
  return PATH_FMA;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T, typename TO>
int launch(int path, const void* x, const void* w, const float* scale,
           const float* bias, void* out, long long P, int Cin, int Cout,
           int relu, cudaStream_t stream) {
  if (path == PATH_HEAD)
    return head::launch<T, TO>(x, w, scale, bias, out, P, Cin, relu, stream);
  return fma_path::launch<T, TO>(x, w, scale, bias, out, P, Cin, Cout, relu,
                                 stream);
}

}  // namespace

// Which path conv1x1_launch takes for x at this address, these widths and
// this dtypes code: 1 = the vector head, 0 = FMA; -1 for an unknown
// dtypes code.
extern "C" int conv1x1_path(const void* x, int Cin, int Cout, int dtypes) {
  if (dtypes < 0 || dtypes > 2) return -1;
  return pick_path(aligned16(x), Cin, Cout, dtypes);
}

// x [P, Cin], w [Cin, Cout] (x's dtype), scale/bias [Cout] f32 -> out [P,
// Cout]. dtypes: 0 = f32 in / f32 out, 1 = bf16 in / bf16 out, 2 = bf16 in
// / f32 out. Returns the cudaError_t of the launch (0 = success), or -1
// for an unknown dtypes code or sizes past the grid.
extern "C" int conv1x1_launch(const void* x, const void* w,
                              const void* scale, const void* bias, void* out,
                              long long P, int Cin, int Cout, int relu,
                              int dtypes, void* stream) {
  if (dtypes < 0 || dtypes > 2) return -1;
  if (P <= 0 || Cout <= 0) return 0;
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int path = pick_path(aligned16(x), Cin, Cout, dtypes);
  switch (dtypes) {
    case 0:
      return launch<float, float>(path, x, w, s, bi, out, P, Cin, Cout, relu,
                                  st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(path, x, w, s, bi, out, P,
                                                  Cin, Cout, relu, st);
    default:
      return launch<__nv_bfloat16, float>(path, x, w, s, bi, out, P, Cin,
                                          Cout, relu, st);
  }
}
