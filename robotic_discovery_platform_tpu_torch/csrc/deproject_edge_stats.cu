// Fused pinhole deprojection + masked edge statistics for Hopper (sm_90a),
// with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/geometry.py
//   deproject_edge_stats (kernel body _deproject_kernel): one pass over the
//   mask and depth that writes the x/y/z/valid maps and the masked x/y
//   min/max and valid count that seed the edge binning.
//
// What it computes, per pixel (r, c) of the [H, W] view at stride s:
//   v = r*s + (s-1)/2, u = c*s + (s-1)/2, z = depth*ds,
//   valid = mask > 0 && z > 0, x = (u - cx)*z/fx, y = (v - cy)*z/fy,
// each operation one IEEE float32 rounding in the order the port's
// ops/geometry.deproject writes it (__fmul_rn / __fsub_rn / __fdiv_rn, so
// nothing contracts into an FMA and the divide is round-to-nearest); and
// over the valid pixels x_min, x_max, y_min, y_max (the +-1e30 sentinels
// where none is valid) and the int32 count. The maps and the statistics
// are bitwise those of the plain version: min/max and an integer count do
// not depend on the order of the fold.
//
// Bound on one H100 SXM: bytes. Per pixel it reads 1 (mask) + 4 (depth)
// bytes and writes 3*4 + 1 bytes; at 480x640 that is 5.5 MB, 1.65 us at
// 3.35 TB/s, against some 10 flops per pixel.
//
// Design against that bound: one thread per pixel, neighbouring threads on
// neighbouring pixels, so every load and store is coalesced and each byte
// moves once. Each block folds its pixels' statistics with warp shuffles
// and writes one partial row; a second, one-block kernel folds the rows in
// order. The TPU kernel's per-tile partials, folded outside it, become the
// per-block partials here; no atomics, so the result does not depend on
// the order the blocks ran in.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float BIG = 1e30f;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Folds (xmin, xmax, ymin, ymax, n) over the block; thread 0 holds the
// result on return.
__device__ void block_fold(float s[4], int& n) {
  __shared__ float sf[4][WARPS];
  __shared__ int sn[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s[0] = warp_min(s[0]);
  s[1] = warp_max(s[1]);
  s[2] = warp_min(s[2]);
  s[3] = warp_max(s[3]);
  n = warp_sum(n);
  if (lane == 0) {
    for (int k = 0; k < 4; ++k) sf[k][warp] = s[k];
    sn[warp] = n;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < WARPS;
    s[0] = live ? sf[0][lane] : BIG;
    s[1] = live ? sf[1][lane] : -BIG;
    s[2] = live ? sf[2][lane] : BIG;
    s[3] = live ? sf[3][lane] : -BIG;
    n = live ? sn[lane] : 0;
    s[0] = warp_min(s[0]);
    s[1] = warp_max(s[1]);
    s[2] = warp_min(s[2]);
    s[3] = warp_max(s[3]);
    n = warp_sum(n);
  }
}

__global__ void __launch_bounds__(THREADS)
deproject_kernel(const uint8_t* __restrict__ mask,
                 const float* __restrict__ depth,
                 const float* __restrict__ params, float* __restrict__ x,
                 float* __restrict__ y, float* __restrict__ z,
                 uint8_t* __restrict__ valid, float* __restrict__ part_f,
                 int* __restrict__ part_n, int H, int W, int stride) {
  const float fx = params[0], fy = params[1];
  const float cx = params[2], cy = params[3], ds = params[4];
  const float off = (float)(stride - 1) * 0.5f;  // exact: 0, 0.5, 1, ...
  const long long P = (long long)H * W;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  float s[4] = {BIG, -BIG, BIG, -BIG};
  int n = 0;
  if (i < P) {
    const int r = (int)(i / W), c = (int)(i % W);
    const float vv = __fadd_rn(__fmul_rn((float)r, (float)stride), off);
    const float uu = __fadd_rn(__fmul_rn((float)c, (float)stride), off);
    const float zv = __fmul_rn(depth[i], ds);
    const bool ok = mask[i] > 0 && zv > 0.f;
    const float xv = __fdiv_rn(__fmul_rn(__fsub_rn(uu, cx), zv), fx);
    const float yv = __fdiv_rn(__fmul_rn(__fsub_rn(vv, cy), zv), fy);
    x[i] = xv;
    y[i] = yv;
    z[i] = zv;
    valid[i] = ok ? 1 : 0;
    if (ok) {
      s[0] = s[1] = xv;
      s[2] = s[3] = yv;
      n = 1;
    }
  }
  block_fold(s, n);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) part_f[(long long)blockIdx.x * 4 + k] = s[k];
    part_n[blockIdx.x] = n;
  }
}

__global__ void __launch_bounds__(THREADS)
fold_kernel(const float* __restrict__ part_f, const int* __restrict__ part_n,
            int blocks, float* __restrict__ stats_f,
            int* __restrict__ stats_n) {
  float s[4] = {BIG, -BIG, BIG, -BIG};
  int n = 0;
  for (int b = threadIdx.x; b < blocks; b += THREADS) {
    s[0] = fminf(s[0], part_f[b * 4 + 0]);
    s[1] = fmaxf(s[1], part_f[b * 4 + 1]);
    s[2] = fminf(s[2], part_f[b * 4 + 2]);
    s[3] = fmaxf(s[3], part_f[b * 4 + 3]);
    n += part_n[b];
  }
  block_fold(s, n);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) stats_f[k] = s[k];
    stats_n[0] = n;
  }
}

}  // namespace

// Blocks of partials the wrapper must allocate for an H x W view.
extern "C" int deproject_edge_stats_blocks(int H, int W) {
  return (int)(((long long)H * W + THREADS - 1) / THREADS);
}

// mask [H,W] u8, depth [H,W] f32, params [5] f32 (fx, fy, cx, cy,
// depth_scale) -> x, y, z [H,W] f32, valid [H,W] u8 (0/1), stats_f [4]
// f32 (x_min, x_max, y_min, y_max), stats_n [1] int32; part_f [blocks,4]
// and part_n [blocks] are scratch. Returns the cudaError_t of the launches.
extern "C" int deproject_edge_stats_launch(
    const void* mask, const void* depth, const void* params, void* x,
    void* y, void* z, void* valid, void* part_f, void* part_n,
    void* stats_f, void* stats_n, int H, int W, int stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = deproject_edge_stats_blocks(H, W);
  deproject_kernel<<<blocks, THREADS, 0, st>>>(
      static_cast<const uint8_t*>(mask), static_cast<const float*>(depth),
      static_cast<const float*>(params), static_cast<float*>(x),
      static_cast<float*>(y), static_cast<float*>(z),
      static_cast<uint8_t*>(valid), static_cast<float*>(part_f),
      static_cast<int*>(part_n), H, W, stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_kernel<<<1, THREADS, 0, st>>>(
      static_cast<const float*>(part_f), static_cast<const int*>(part_n),
      blocks, static_cast<float*>(stats_f), static_cast<int*>(stats_n));
  return (int)cudaGetLastError();
}
