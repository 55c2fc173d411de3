// Fused dequantize + 8x8 islow IDCT + level shift + clamp for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/decode.py
//   dequant_idct (kernel body _idct_kernel over _idct_math): [B, N, 64]
//   quantized int16 coefficients times the frame's [64] quant table, then
//   libjpeg's jpeg_idct_islow as two int32 [64, 64] products on the
//   flattened block, pass 1 = DESCALE(x @ m1, 11), pass 2 =
//   DESCALE(ws @ m2, 18) + 128, clamped to 0..255 -> [B, N, 64] int32.
//
// The separable form of those two matrices. With the block row-major
// (index 8*row + col), m1 = kron(A, I8)^T and m2 = kron(I8, A)^T for the
// 8x8 islow basis A (ISLOW_A below, ops/decode.islow_basis), so pass 1 is
// A applied to each column of the dequantized block, pass 2 A applied to
// each row of the workspace: the same nonzero products, and the zeros of
// the Kronecker products left out. Products and sums are taken in uint32,
// whose wrap is defined in C++ and is the two's-complement wrap of XLA's
// int32 dot; a sum modulo 2^32 does not depend on its order, so the output
// is bitwise that of the dense products. Each value is reinterpreted as
// int32 before an arithmetic right shift.
//
// Bound on one H100 SXM: bytes. One 480x640 4:2:0 frame is 7,200 blocks
// in three launches (Y, Cb, Cr): 0.92 MB of int16 in, 1.84 MB of int32 out,
// 0.00083 ms at 3.35 TB/s. The separable form does 2 * 8 * 64 = 1,024
// int32 multiply-adds per block (7.4 M per frame), under 0.5 us at the
// card's int32 rate. Three launches at the card's launch floor (about
// 1.4 us each) already exceed the byte bound: a frame cannot reach half
// of it while each plane is its own launch.
//
// Design: a warp owns 4 whole 8x8 blocks; lane l takes row l % 8 of block
// l / 8, so the warp's 32 16-byte loads are 512 consecutive bytes of
// coefficients. A lane dequantizes its row into a padded shared tile (row
// stride 9 words: conflict-free by rows and by columns), takes one column
// through pass 1 in place, then one row through pass 2, and stores its
// output row as two 16-byte stores. The warps of a block share nothing:
// __syncwarp() is the only barrier. The constants of A sit in __constant__
// memory, read at the same index by every lane. Misaligned coefficients
// take the same path with scalar loads and stores (VEC = false).

#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // per thread block
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCKS_PER_WARP = 4;  // 8x8 blocks a warp owns
constexpr int ROW = 9;  // padded row stride of a shared tile, in words
constexpr int TILE = 8 * ROW;

// jpeg_idct_islow's 8x8 basis, row-major: one pass is out = A @ in
// before its DESCALE (ops/decode.islow_basis computes the same matrix).
__constant__ int32_t ISLOW_A[64] = {
    8192,  11363,  10703,   9633,   8192,   6437,   4433,   2260,
    8192,   9633,   4433,  -2259,  -8192, -11362, -10704,  -6436,
    8192,   6437,  -4433, -11362,  -8192,   2261,  10704,   9633,
    8192,   2260, -10703,  -6436,   8192,   9633,  -4433, -11363,
    8192,  -2260, -10703,   6436,   8192,  -9633,  -4433,  11363,
    8192,  -6437,  -4433,  11362,  -8192,  -2261,  10704,  -9633,
    8192,  -9633,   4433,   2259,  -8192,  11362, -10704,   6436,
    8192, -11363,  10703,  -9633,   8192,  -6437,   4433,  -2260,
};

// One 8-point pass on v in place: v <- A @ v in uint32 (wrapping).
__device__ __forceinline__ void islow_pass(uint32_t v[8]) {
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t acc = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += (uint32_t)ISLOW_A[i * 8 + k] * v[k];
    o[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = o[i];
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dequant_idct_kernel(const int16_t* __restrict__ coefs,
                    const int32_t* __restrict__ q,
                    int32_t* __restrict__ out, int N, int total) {
  __shared__ uint32_t tiles[WARPS][BLOCKS_PER_WARP * TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = lane & 7;  // row at load, column in pass 1, row in pass 2
  const int blk = (blockIdx.x * WARPS + warp) * BLOCKS_PER_WARP + (lane >> 3);
  const bool live = blk < total;
  uint32_t* t = tiles[warp] + (lane >> 3) * TILE;
  const size_t row0 = (size_t)blk * 64 + k * 8;

  // row k of the block, dequantized against its frame's quant row
  int32_t c[8];
  if (live && VEC) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(coefs + row0));
    const int32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      c[2 * p] = (int16_t)(w[p] & 0xffff);  // little-endian pairs
      c[2 * p + 1] = w[p] >> 16;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = live ? coefs[row0 + j] : 0;
  }
  const int32_t* qr = q + (size_t)(live ? blk / N : 0) * 64 + k * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    t[k * ROW + j] = (uint32_t)c[j] * (uint32_t)__ldg(qr + j);
  __syncwarp();

  // pass 1: column k, DESCALE(., 11), written back over the column
  uint32_t v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = t[r * ROW + k];
  islow_pass(v);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    t[r * ROW + k] = (uint32_t)((int32_t)(v[r] + (1u << 10)) >> 11);
  __syncwarp();

  // pass 2: row k, DESCALE(., 18) + 128, clamped
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = t[k * ROW + j];
  islow_pass(v);
  int32_t o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int32_t s = ((int32_t)(v[j] + (1u << 17)) >> 18) + 128;
    o[j] = min(max(s, 0), 255);
  }
  if (!live) return;
  int32_t* dst = out + row0;
  if (VEC) {
    reinterpret_cast<int4*>(dst)[0] = make_int4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<int4*>(dst)[1] = make_int4(o[4], o[5], o[6], o[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = o[j];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// coefs [B, N, 64] int16, q [B, 64] int32 -> out [B, N, 64] int32.
// Returns the cudaError_t of the launch, or -1 for sizes past the
// kernel's 32-bit block index.
extern "C" int dequant_idct_launch(const void* coefs, const void* q,
                                   void* out, int B, int N, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const long long total = (long long)B * N;
  if (total > INT_MAX - THREADS) return -1;
  const int per_block = WARPS * BLOCKS_PER_WARP;
  const unsigned grid = (unsigned)((total + per_block - 1) / per_block);
  auto kernel = aligned16(coefs) && aligned16(out)
                    ? dequant_idct_kernel<true>
                    : dequant_idct_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), static_cast<const int32_t*>(q),
      static_cast<int32_t*>(out), N, (int)total);
  return (int)cudaGetLastError();
}
