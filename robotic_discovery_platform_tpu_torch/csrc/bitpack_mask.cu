// Device-side mask bitpacking for the egress wire, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/pack.py bitpack_mask
//   (kernel body _pack_kernel over _pack_math): a [B, H, W] uint8 mask to
//   [B, H, ceil(W/8)] bytes, 8 pixels per byte, most significant bit first
//   (np.packbits order, so np.unpackbits is the exact inverse); a nonzero
//   pixel is a set bit, and a ragged tail of a row packs as zeros.
//
// What it computes is integer only, so the kernel and the plain version
// agree bitwise.
//
// Bound on one H100 SXM: bytes. It reads B*H*W bytes and writes an eighth
// of that; at the batched path's [8, 480, 640] that is 2.8 MB, 0.83 us at
// 3.35 TB/s.
//
// Design: one thread per output byte. Each thread reads its 8 neighbouring
// mask bytes (one 8-byte load where the row allows it), so a warp reads
// 256 consecutive bytes and writes 32: every byte moves once, coalesced.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bitpack_kernel(const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
               long long rows, int W, int WB) {
  const long long o = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (o >= rows * WB) return;
  const long long row = o / WB;
  const int c0 = (int)(o % WB) * 8;
  const uint8_t* m = mask + row * W + c0;
  unsigned v = 0;
  if (c0 + 8 <= W && ((uintptr_t)m & 7) == 0) {
    const uint64_t px = *reinterpret_cast<const uint64_t*>(m);
    for (int k = 0; k < 8; ++k)  // little-endian: byte k is pixel c0 + k
      v = (v << 1) | (((px >> (8 * k)) & 0xffu) != 0);
  } else {
    for (int k = 0; k < 8; ++k)
      v = (v << 1) | (c0 + k < W && m[k] != 0);
  }
  out[o] = (uint8_t)v;
}

}  // namespace

// mask [rows, W] u8 (rows = B*H) -> out [rows, ceil(W/8)] u8. Returns the
// cudaError_t of the launch.
extern "C" int bitpack_mask_launch(const void* mask, void* out,
                                   long long rows, int W, void* stream) {
  const int WB = (W + 7) / 8;
  const long long total = rows * WB;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  bitpack_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(out), rows, W,
      WB);
  return (int)cudaGetLastError();
}
