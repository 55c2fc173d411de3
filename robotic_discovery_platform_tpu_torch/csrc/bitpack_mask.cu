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
// of that: at the batched path's [8, 480, 640] 2.76 MB, 0.83 us at
// 3.35 TB/s; at the direct frame's [1, 480, 640] 0.35 MB, 0.10 us, far
// below one launch's cost (about 1.4 us), so there only the launch counts.
//
// Design: words, not bytes. Where every row is whole words (W % 32 == 0)
// and the addresses allow it, the batch is one flat stream of 32-pixel
// groups: a thread reads its 32 mask bytes in two 16-byte read-only loads
// and writes one 32-bit word of bits (a warp reads 1 KiB and writes 128
// bytes, both contiguous). Nonzero bytes become bits without a branch:
// __vcmpne4 sets each nonzero byte to 0xff, the low bit of each byte is
// kept, and one multiply gathers the four bits of a 4-pixel word into a
// nibble in MSB-first order. One thread per unit (a 32-pixel group, or
// an output byte on the per-byte path), one launch per call: at the
// server's shapes (B <= 8 at 480x640, at most 600 blocks of 128 words)
// the grid is smaller than what the SMs hold at once.
//
// The output may be a strided view: frame f's H * ceil(W/8) bytes start at
// out + f * out_stride (the packed payload row of ops/pipeline.py, whose
// mask bytes start at a multiple of 4 but not of 16: the word store is 4
// bytes wide). Ragged widths and misaligned addresses take the per-byte
// path of the same kernel (one output byte a thread, one 8-byte load where
// the row allows it).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// the four pixels of a little-endian word (byte k = pixel k) as a nibble,
// pixel 0 in its top bit: the bits sit at 0, 8, 16, 24 after the compare,
// and the multiplier 2^31 + 2^22 + 2^13 + 2^4 moves them to 31, 30, 29,
// 28 with no two partial products on one bit (no carries)
__device__ __forceinline__ unsigned nibble(unsigned px) {
  const unsigned bits = __vcmpne4(px, 0u) & 0x01010101u;
  return (bits * 0x80402010u) >> 28;
}

// 32 pixels (8 little-endian words) -> one 32-bit word whose byte j (in
// memory order) packs pixels 8j .. 8j + 7, MSB first
__device__ __forceinline__ unsigned pack32(uint4 a, uint4 b) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out |= ((nibble(w[2 * j]) << 4) | nibble(w[2 * j + 1])) << (8 * j);
  return out;
}

// Indices are 32-bit (a 32-bit division by a runtime divisor costs a
// fraction of a 64-bit one; the C entry refuses a batch of 2^30 pixels or
// more); byte offsets into the output are 64-bit.
__global__ void __launch_bounds__(THREADS)
bitpack_kernel(const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
               unsigned units, unsigned H, int W, int WB,
               long long out_stride, int words) {
  const unsigned i = (unsigned)blockIdx.x * THREADS + threadIdx.x;
  if (i >= units) return;
  if (words) {
    // one 32-pixel group; a frame is H * W / 32 groups
    const unsigned per_frame = H * (unsigned)(W / 32);
    const uint4* src = reinterpret_cast<const uint4*>(mask) + 2 * i;
    const unsigned v = pack32(__ldg(src), __ldg(src + 1));
    const unsigned f = i / per_frame;
    *reinterpret_cast<unsigned*>(
        out + (long long)f * out_stride + 4 * (long long)(i - f * per_frame)) =
        v;
    return;
  }
  const unsigned row = i / WB;  // over the whole batch
  const int c0 = (int)(i - row * WB) * 8;
  const uint8_t* m = mask + (long long)row * W + c0;
  unsigned v = 0;
  if (c0 + 8 <= W && ((uintptr_t)m & 7) == 0) {
    const unsigned long long px =
        __ldg(reinterpret_cast<const unsigned long long*>(m));
    for (int k = 0; k < 8; ++k)  // little-endian: byte k is pixel c0 + k
      v = (v << 1) | (((px >> (8 * k)) & 0xffu) != 0);
  } else {
    for (int k = 0; k < 8; ++k)
      v = (v << 1) | (c0 + k < W && m[k] != 0);
  }
  const unsigned f = row / H;
  out[(long long)f * out_stride + (long long)(row - f * H) * WB + c0 / 8] =
      (uint8_t)v;
}

}  // namespace

// mask [frames, H, W] u8, contiguous -> frame f's [H, ceil(W/8)] u8 bytes
// at out + f * out_stride. Returns the cudaError_t of the launch.
extern "C" int bitpack_mask_launch(const void* mask, void* out,
                                   long long frames, int H, int W,
                                   long long out_stride, void* stream) {
  const int WB = (W + 7) / 8;
  const long long frame_px = (long long)H * W;
  const long long per_frame_out = (long long)H * WB;
  if (frames == 0 || per_frame_out == 0) return 0;
  // every unit index stays below frames * H * W < 2^30
  if (frames * frame_px >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int words = W % 32 == 0 && ((uintptr_t)mask & 15) == 0 &&
                    ((uintptr_t)out & 3) == 0 && out_stride % 4 == 0;
  const long long units = frames * (words ? frame_px / 32 : per_frame_out);
  const unsigned blocks = (unsigned)((units + THREADS - 1) / THREADS);
  bitpack_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(out),
      (unsigned)units, (unsigned)H, W, WB, out_stride, words);
  return (int)cudaGetLastError();
}
