// Fused NHWC 1x1 convolution + per-channel scale/bias (+ ReLU) for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/conv.py conv1x1,
//   both of its bodies: _conv1x1_squeeze_kernel (Cout = 1, the U-Net's
//   OutConv head: bf16 features in, f32 logits out) and the general
//   _conv1x1_kernel. Here one kernel takes Cout as an argument.
//
// What it computes: out[p, co] = cast(act(scale[co] * acc + bias[co])),
// acc = sum over ci of x[p, ci] * w[ci, co] in float32 (in ci order), for
// every pixel p of the [B, H, W] grid; w is [Cin, Cout].
//
// Bound on one H100 SXM: max(2*P*Cin*Cout / 989 TFLOP/s, (P*Cin input
// + Cin*Cout weight + P*Cout output bytes) / 3.35 TB/s). At the head's
// shape ([1,256,256,64] bf16 -> [1,256,256,1] f32: 8.4 MFLOP, 8.6 MB)
// it is bound by the bytes it reads, by three orders of magnitude.
//
// Design against that bound: each input element is read from device
// memory once and each output written once. One thread owns one pixel and
// walks its Cin contiguous channels (one 128-byte line per pixel at
// Cin = 64 bf16, which L1 serves after the first touch); the weights are
// tiny and stay in L1/L2. No shared memory, no tensor cores: the work is
// a per-pixel reduction with an elementwise epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
conv1x1_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ bias, TO* __restrict__ out,
               long long P, int Cin, int Cout, int relu) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const T* xp = x + p * Cin;
  TO* op = out + p * Cout;
  for (int co = 0; co < Cout; ++co) {
    float acc = 0.f;
    for (int ci = 0; ci < Cin; ++ci)
      acc = fmaf(load_f32(xp + ci), load_f32(w + (size_t)ci * Cout + co),
                 acc);
    float v = __fadd_rn(__fmul_rn(acc, scale[co]), bias[co]);
    if (relu) v = fmaxf(v, 0.f);
    store_out(op + co, v);
  }
}

template <typename T, typename TO>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, void* out, long long P, int Cin, int Cout,
           int relu, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((P + THREADS - 1) / THREADS);
  conv1x1_kernel<T, TO><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<TO*>(out), P, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes: 0 = f32 in / f32 out, 1 = bf16 in / bf16 out, 2 = bf16 in / f32 out.
// Returns the cudaError_t of the launch (0 = success), or -1 for an
// unknown dtypes code.
extern "C" int conv1x1_launch(const void* x, const void* w,
                              const void* scale, const void* bias, void* out,
                              long long P, int Cin, int Cout, int relu,
                              int dtypes, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0:
      return launch<float, float>(x, w, s, bi, out, P, Cin, Cout, relu, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, s, bi, out, P, Cin,
                                                  Cout, relu, st);
    case 2:
      return launch<__nv_bfloat16, float>(x, w, s, bi, out, P, Cin, Cout,
                                          relu, st);
    default:
      return -1;
  }
}
