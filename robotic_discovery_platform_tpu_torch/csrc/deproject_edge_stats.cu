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
// 3.35 TB/s, against some 10 flops per pixel. At that size a launch costs
// about as much as the bytes, so the design is one launch per call.
//
// Design against that bound:
// - One launch, no copy: the five parameters arrive as device pointers
//   (the caller's 0-d views of its intrinsics are read in place).
// - Each thread takes PIX = 4 consecutive pixels of one row: a 16-byte
//   load of depth, 16-byte stores of x, y and z, a 4-byte load of the mask
//   and a 4-byte store of valid. Row and column come from 32-bit index
//   arithmetic. Where W % 4 != 0 or a pointer is not aligned, the same
//   tiling runs with scalar loads and stores (VEC = false).
// - The fold runs inside the launch: each block writes its partial row
//   (x_min, x_max, y_min, y_max, n), fences, and takes a ticket from a
//   zeroed counter; the block that draws the last ticket folds every row
//   in block order, writes the statistics and sets the counter back to 0.
//   The wrapper keeps one counter per (device, stream), so concurrent
//   streams never share one and a captured graph replays with it. No float
//   atomics: the result does not depend on the order the blocks ran in.

#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIX = 4;  // consecutive pixels of one row per thread
constexpr int WARPS = THREADS / 32;
constexpr int PART = 5;  // x_min, x_max, y_min, y_max, n (as a float)
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
// result on return. Reuses its shared rows: a __syncthreads() must
// separate two calls.
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
deproject_kernel(const uint8_t* __restrict__ mask,
                 const float* __restrict__ depth,
                 const float* __restrict__ fx_p,
                 const float* __restrict__ fy_p,
                 const float* __restrict__ cx_p,
                 const float* __restrict__ cy_p,
                 const float* __restrict__ ds_p, float* __restrict__ x,
                 float* __restrict__ y, float* __restrict__ z,
                 uint8_t* __restrict__ valid, float* __restrict__ part,
                 float* __restrict__ stats_f, int* __restrict__ stats_n,
                 unsigned* __restrict__ ticket, int H, int W, int WQ,
                 int stride) {
  const float fx = __ldg(fx_p), fy = __ldg(fy_p);
  const float cx = __ldg(cx_p), cy = __ldg(cy_p), ds = __ldg(ds_p);
  const float off = (float)(stride - 1) * 0.5f;  // exact: 0, 0.5, 1, ...
  const float fs = (float)stride;
  const int q = blockIdx.x * THREADS + threadIdx.x;  // < H * WQ + THREADS
  float s[4] = {BIG, -BIG, BIG, -BIG};
  int n = 0;
  if (q < H * WQ) {
    const int r = q / WQ;
    const int c0 = (q - r * WQ) * PIX;
    const int i0 = r * W + c0;
    const float vv = __fadd_rn(__fmul_rn((float)r, fs), off);
    const float yo = __fsub_rn(vv, cy);
    float d[PIX], xs[PIX], ys[PIX], zs[PIX];
    uint8_t m[PIX], ok[PIX];
    if (VEC) {
      const float4 dv = __ldg(reinterpret_cast<const float4*>(depth + i0));
      const unsigned mv = __ldg(reinterpret_cast<const unsigned*>(mask + i0));
      d[0] = dv.x;
      d[1] = dv.y;
      d[2] = dv.z;
      d[3] = dv.w;
#pragma unroll
      for (int p = 0; p < PIX; ++p) m[p] = (uint8_t)(mv >> (8 * p));
    } else {
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        const bool in = c0 + p < W;
        d[p] = in ? depth[i0 + p] : 0.f;
        m[p] = in ? mask[i0 + p] : 0;
      }
    }
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      const float uu = __fadd_rn(__fmul_rn((float)(c0 + p), fs), off);
      zs[p] = __fmul_rn(d[p], ds);
      ok[p] = m[p] > 0 && zs[p] > 0.f;
      xs[p] = __fdiv_rn(__fmul_rn(__fsub_rn(uu, cx), zs[p]), fx);
      ys[p] = __fdiv_rn(__fmul_rn(yo, zs[p]), fy);
      // a pixel past the row's end is never valid: its mask reads as 0
      if (ok[p]) {
        s[0] = fminf(s[0], xs[p]);
        s[1] = fmaxf(s[1], xs[p]);
        s[2] = fminf(s[2], ys[p]);
        s[3] = fmaxf(s[3], ys[p]);
        ++n;
      }
    }
    if (VEC) {
      *reinterpret_cast<float4*>(x + i0) = make_float4(xs[0], xs[1], xs[2], xs[3]);
      *reinterpret_cast<float4*>(y + i0) = make_float4(ys[0], ys[1], ys[2], ys[3]);
      *reinterpret_cast<float4*>(z + i0) = make_float4(zs[0], zs[1], zs[2], zs[3]);
      *reinterpret_cast<unsigned*>(valid + i0) =
          (unsigned)ok[0] | ((unsigned)ok[1] << 8) | ((unsigned)ok[2] << 16) |
          ((unsigned)ok[3] << 24);
    } else {
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        if (c0 + p < W) {
          x[i0 + p] = xs[p];
          y[i0 + p] = ys[p];
          z[i0 + p] = zs[p];
          valid[i0 + p] = ok[p];
        }
      }
    }
  }

  __shared__ bool last;
  block_fold(s, n);
  if (threadIdx.x == 0) {
    float* row = part + (size_t)blockIdx.x * PART;
    for (int k = 0; k < 4; ++k) row[k] = s[k];
    row[4] = (float)n;  // at most THREADS * PIX: exact
    __threadfence();  // the row is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every other row was written before its ticket; read
  // them past L1, which is not coherent across SMs
  s[0] = s[2] = BIG;
  s[1] = s[3] = -BIG;
  n = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
    const float* row = part + (size_t)b * PART;
    s[0] = fminf(s[0], __ldcg(row + 0));
    s[1] = fmaxf(s[1], __ldcg(row + 1));
    s[2] = fminf(s[2], __ldcg(row + 2));
    s[3] = fmaxf(s[3], __ldcg(row + 3));
    n += (int)__ldcg(row + 4);
  }
  block_fold(s, n);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) stats_f[k] = s[k];
    stats_n[0] = n;
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// Blocks of the launch for an H x W view, each with one partial row of
// PART floats that the wrapper allocates; -1 past the kernel's 32-bit
// indexing.
extern "C" int deproject_edge_stats_blocks(int H, int W) {
  if (H < 0 || W < 0 || (long long)H * W > INT_MAX - THREADS * PIX)
    return -1;
  const long long quads = (long long)H * ((W + PIX - 1) / PIX);
  return quads == 0 ? 1 : (int)((quads + THREADS - 1) / THREADS);
}

// mask [H,W] u8, depth [H,W] f32, fx, fy, cx, cy, depth_scale: one f32
// each on the device -> x, y, z [H,W] f32, valid [H,W] u8 (0/1), stats_f
// [4] f32 (x_min, x_max, y_min, y_max), stats_n [1] int32; part [blocks,
// PART] f32 is scratch; ticket is a zeroed u32 that no other stream uses
// (the kernel leaves it 0). Returns the cudaError_t of the launch, or -1
// for sizes past the kernel's limits.
extern "C" int deproject_edge_stats_launch(
    const void* mask, const void* depth, const void* fx, const void* fy,
    const void* cx, const void* cy, const void* depth_scale, void* x,
    void* y, void* z, void* valid, void* part, void* stats_f,
    void* stats_n, void* ticket, int H, int W, int stride, void* stream) {
  const int blocks = deproject_edge_stats_blocks(H, W);
  if (blocks < 0) return -1;
  const bool vec = W % PIX == 0 && aligned(depth, 16) && aligned(x, 16) &&
                   aligned(y, 16) && aligned(z, 16) && aligned(mask, 4) &&
                   aligned(valid, 4);
  auto kernel = vec ? deproject_kernel<true> : deproject_kernel<false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const float*>(depth),
      static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(cx), static_cast<const float*>(cy),
      static_cast<const float*>(depth_scale), static_cast<float*>(x),
      static_cast<float*>(y), static_cast<float*>(z),
      static_cast<uint8_t*>(valid), static_cast<float*>(part),
      static_cast<float*>(stats_f), static_cast<int*>(stats_n),
      static_cast<unsigned*>(ticket), H, W, (W + PIX - 1) / PIX, stride);
  return (int)cudaGetLastError();
}
