// Tensor-core building blocks shared by the bf16 paths of
// conv3x3_bn_relu.cu, conv3x3_grad_weights.cu and conv_transpose2x2.cu
// (sm_90a): 16-byte async copies into shared memory, ldmatrix fragment
// loads, the mma.sync.m16n8k16 bf16 product (the weight gradient) and the
// wgmma.m64n64k16 (the 3x3 forward) and m64n128k16 (the transposed conv)
// warpgroup products with A in registers, each with float32
// accumulation.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for
// lane l of a warp: A (16x16, row-major) a0..a3 hold rows l/4 and l/4 + 8
// at columns 2*(l%4) + {0, 1} and + 8; B (16x8, column-major) b0, b1 hold
// rows 2*(l%4) + {0, 1} and + 8 of column l/4; the accumulator c0, c1 row
// l/4, c2, c3 row l/4 + 8, at columns 2*(l%4) + {0, 1}.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace conv_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l/8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16) * b (16x8 bf16), float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- wgmma (sm_90a): a warpgroup of 4 warps multiplies a 64-row A held in
// registers (warp w holds rows 16w.., each in the mma.m16n8k16 A layout)
// by a B read from shared memory through a descriptor.

// Shared-memory descriptor of an N-major B tile of 64-column atoms in the
// 128-byte swizzle: 128-byte rows (64 bf16), the 16-byte group g of row r
// stored at group g ^ (r % 8), 8-row atoms of 1024 bytes, 1024-byte
// aligned, one after the other along K (the stride byte offset); the
// leading byte offset `atoms` is the distance between 64-column atoms
// along N (unused at N = 64).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p,
                                                     int atoms = 1024) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(atoms >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// Orders the shared-memory writes of this thread (cp.async included) before
// later reads by the tensor cores' asynchronous proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous region (after wgmma_wait, before the first wgmma).
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64x64 f32, 32 per thread: n8 block j in d[4j..4j+3], in the
// mma.m16n8k16 accumulator layout) += a (64x16 bf16, registers) * b (16x64
// bf16, shared memory, N-major: trans-b = 1)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1)
      : "memory");
}

// d (64x128 f32, 64 per thread: n8 block j in d[4j..4j+3]) = a (64x16
// bf16, registers) * b (16x128 bf16, shared memory, N-major: two 64-column
// atoms `atoms` bytes apart in the descriptor) + (scale_d ? d : 0): the
// first product of a tile passes scale_d = 0, so no instruction outside
// the pipeline has to zero the accumulator
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// Lane l's row and column in a 16x16 tile stored with rows of 16-byte
// groups, for ldmatrix_x4 (matrix j = l/8):
// - frag_*: the A operand from an [m][k] tile (matrix j is rows
//   8*(j%2).., columns 8*(j/2)..), or transposed from a [k][n] tile, the
//   B operands of two n8 tiles (r[0], r[1] and r[2], r[3]);
// - frag_t_*: transposed from a [k][m] tile, the A operand (matrix j is
//   k rows 8*(j/2).., m columns 8*(j%2)..).
__device__ __forceinline__ int frag_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int frag_t_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int frag_t_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// A warp's 16 rows x N columns of output from an accumulator in the
// mma / wgmma layout (value(j, r): n8 block j, element r), through shared
// memory `o_s` (16 rows of N + 16 bytes), then out with 16-byte stores:
// row i's first n_col columns at dst + i * stride, for i < n_row. Stores
// straight from the accumulators are 4 or 8 bytes each, scattered over
// 16 rows; these write each row's bytes in one piece.
template <int N, typename V, typename F>
__device__ __forceinline__ void store_tile(V* o_s, V* dst, int stride,
                                           int n_row, int n_col, int lane,
                                           F value) {
  constexpr int E = 16 / sizeof(V);  // elements per 16 bytes
  constexpr int RS = N + E;          // row stride: 16 bytes of padding
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      store_pair(o_s + (lane / 4 + half * 8) * RS + j * 8 + (lane % 4) * 2,
                 value(j, half * 2), value(j, half * 2 + 1));
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * N / E / 32; ++k) {
    const int q = lane + 32 * k;
    const int i = q / (N / E);
    const int c = (q % (N / E)) * E;
    if (i < n_row && c < n_col)
      *reinterpret_cast<uint4*>(dst + (size_t)i * stride + c) =
          *reinterpret_cast<const uint4*>(o_s + i * RS + c);
  }
  __syncwarp();
}

// The im2col tile of a 3x3 SAME conv over NP pixels of a tile TW wide at
// (y0, x0): a_s[p * stride + kk] = x[y0 + p / TW + tap / 3 - 1,
// x0 + p % TW + tap % 3 - 1, ci] for k = k0 + kk = tap * Cin + ci in
// [k0, k0 + KW), zero outside the image and past K = 9 * Cin. For inputs
// whose pixels cannot take 16-byte copies (Cin not a multiple of 8): each
// thread of `threads` walks (pixel, tap) pairs and copies their Cin values
// that fall in the chunk.
template <int NP, int TW, int KW>
__device__ __forceinline__ void gather_im2col(
    __nv_bfloat16* a_s, int stride, const __nv_bfloat16* __restrict__ xb,
    int H, int W, int Cin, int y0, int x0, int k0, int tid, int threads) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < NP * 9; e += threads) {
    const int p = e / 9;
    const int tap = e % 9;
    const int kb = tap * Cin - k0;
    if (kb >= KW || kb + Cin <= 0) continue;
    const int hy = y0 + p / TW + tap / 3 - 1;
    const int hx = x0 + p % TW + tap % 3 - 1;
    const bool ok = hy >= 0 && hy < H && hx >= 0 && hx < W;
    const __nv_bfloat16* src = xb + ((size_t)hy * W + hx) * Cin;
    const int c_lo = kb < 0 ? -kb : 0;
    const int c_hi = kb + Cin > KW ? KW - kb : Cin;
    for (int c = c_lo; c < c_hi; ++c)
      a_s[p * stride + kb + c] = ok ? src[c] : zero;
  }
  const int pad = 9 * Cin - k0;  // columns past K
  if (pad < KW)
    for (int e = tid; e < NP * (KW - pad); e += threads)
      a_s[(e / (KW - pad)) * stride + pad + e % (KW - pad)] = zero;
}

}  // namespace conv_mma
