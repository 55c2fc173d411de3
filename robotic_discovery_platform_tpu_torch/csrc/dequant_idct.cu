// Fused dequantize + 8x8 islow IDCT + level shift + clamp for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/decode.py
//   dequant_idct (kernel body _idct_kernel over _idct_math): [B, N, 64]
//   quantized int16 coefficients times the frame's [64] quant table, then
//   libjpeg's jpeg_idct_islow as two dense int32 [64, 64] products on the
//   flattened block, pass 1 = DESCALE(x @ m1, 11), pass 2 =
//   DESCALE(ws @ m2, 18) + 128, clamped to 0..255 -> [B, N, 64] int32.
//
// Integer only, and bitwise: products and sums are taken in uint32, whose
// wrap is defined in C++ and is the two's-complement wrap of XLA's int32
// dot (a sum modulo 2^32 does not depend on its order); each value is
// reinterpreted as int32 before an arithmetic right shift. This is the
// dense two-pass form of the TPU kernel, not libjpeg's butterfly: the same
// integer map, so the output is the same bit for bit.
//
// Bound on one H100 SXM: bytes. One 480x640 4:2:0 frame is 7,200 blocks:
// 0.92 MB of int16 in, 1.84 MB of int32 out (2.77 MB, 0.00083 ms at
// 3.35 TB/s), plus 32 KB of pass matrices per launch. The dense form does
// 2 * 64 * 64 = 8,192 int32 multiply-adds per block (59.0 M per frame),
// a few microseconds at the card's int32 rate: about 4x the byte bound, by
// design; the butterfly would need about 12x fewer operations.
//
// Design: a block of 256 threads owns a tile of 16 8x8 blocks of one
// frame (blockIdx.y = frame) and stages both pass matrices (32 KB), the
// frame's quant row and the tile's dequantized coefficients in shared
// memory; thread t computes column j = t % 64 of blocks t / 64, t / 64 + 4,
// ... (a warp reads 32 consecutive matrix words, and one broadcast input
// word, per step). Pass 1's DESCALEd result stays in shared memory for
// pass 2. A ragged last tile masks its missing blocks.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 16;  // 8x8 blocks per thread block
constexpr int ROWS = THREADS / 64;  // blocks a pass advances per step

__global__ void __launch_bounds__(THREADS)
dequant_idct_kernel(const int16_t* __restrict__ coefs,
                    const int32_t* __restrict__ q,
                    const int32_t* __restrict__ m1,
                    const int32_t* __restrict__ m2,
                    int32_t* __restrict__ out, int N) {
  __shared__ uint32_t s_m1[64 * 64];
  __shared__ uint32_t s_m2[64 * 64];
  __shared__ uint32_t s_x[TILE * 64];
  __shared__ uint32_t s_ws[TILE * 64];
  __shared__ uint32_t s_q[64];

  const int frame = blockIdx.y;
  const int n0 = blockIdx.x * TILE;
  const int nb = min(TILE, N - n0);
  const int t = threadIdx.x;

  for (int i = t; i < 64 * 64; i += THREADS) {
    s_m1[i] = (uint32_t)m1[i];
    s_m2[i] = (uint32_t)m2[i];
  }
  if (t < 64) s_q[t] = (uint32_t)q[(size_t)frame * 64 + t];
  __syncthreads();

  const size_t base = ((size_t)frame * N + n0) * 64;
  for (int i = t; i < nb * 64; i += THREADS)
    s_x[i] = (uint32_t)(int32_t)coefs[base + i] * s_q[i & 63];
  __syncthreads();

  const int j = t & 63;
  for (int b = t >> 6; b < nb; b += ROWS) {
    const uint32_t* x = s_x + b * 64;
    uint32_t acc = 0u;
#pragma unroll 16
    for (int k = 0; k < 64; ++k) acc += x[k] * s_m1[k * 64 + j];
    s_ws[b * 64 + j] = (uint32_t)((int32_t)(acc + (1u << 10)) >> 11);
  }
  __syncthreads();

  for (int b = t >> 6; b < nb; b += ROWS) {
    const uint32_t* x = s_ws + b * 64;
    uint32_t acc = 0u;
#pragma unroll 16
    for (int k = 0; k < 64; ++k) acc += x[k] * s_m2[k * 64 + j];
    const int32_t v = ((int32_t)(acc + (1u << 17)) >> 18) + 128;
    out[base + b * 64 + j] = min(max(v, 0), 255);
  }
}

}  // namespace

// coefs [B, N, 64] int16, q [B, 64] int32, m1/m2 [64, 64] int32 ->
// out [B, N, 64] int32. Returns the cudaError_t of the launch, or -1 for
// sizes past the grid's limits.
extern "C" int dequant_idct_launch(const void* coefs, const void* q,
                                   const void* m1, const void* m2, void* out,
                                   int B, int N, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535) return -1;
  const dim3 grid((unsigned)((N + TILE - 1) / TILE), (unsigned)B);
  dequant_idct_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), static_cast<const int32_t*>(q),
      static_cast<const int32_t*>(m1), static_cast<const int32_t*>(m2),
      static_cast<int32_t*>(out), N);
  return (int)cudaGetLastError();
}
