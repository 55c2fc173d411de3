// Fused B-spline curvature profile for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/geometry.py
//   bspline_curvature (kernel body _curvature_kernel): the spline r, its
//   derivatives r' and r'' from the basis and the static derivative
//   matrices, and kappa = ||r' x r''|| / ||r'||^3 with the degenerate-
//   tangent guard, in one launch instead of three design products and an
//   elementwise chain.
//
// What it computes, in float32, per sample u[n]: the degree-p, p-1 and
// p-2 basis rows by the Cox-de Boor recursion of ops/bspline._basis_columns
// (the lower degrees are the recursion's intermediate rows; the roundings
// are the plain version's, __fsub_rn / __fdiv_rn / __fmul_rn / __fadd_rn);
// r = B_p ctrl, r' = (B_{p-1} m1) ctrl, r'' = (B_{p-2} m2) ctrl; then
// num = ||r' x r''||, den = ||r'||, valid = den > 1e-6 and
// kappa = valid ? num / (d*d*d) : 0 with d = max(den, 1e-6), d*d*d as
// ops/bspline._curvature_formula writes it. The products sum in another
// order than the plain version's matrix products, so the two agree to a
// few float32 ulps, not bitwise.
//
// Bound on one H100 SXM: the bytes, under 3 KB at the main path's
// N = 100 samples, C = 16 (counting the nonzero bands of the derivative
// matrices), against about 10 KFLOP from the basis nonzeros; its time is
// the latency of one launch.
//
// Design: one thread per sample, the knots, control points and derivative
// matrices staged in shared memory, the basis rows in registers.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAXC = 32;
constexpr int MAXDEG = 5;
constexpr int MAXK = MAXC + MAXDEG + 1;
constexpr int D = 3;

__global__ void __launch_bounds__(THREADS)
curvature_kernel(const float* __restrict__ ctrl, const float* __restrict__ u,
                 const float* __restrict__ knots,
                 const float* __restrict__ m1, const float* __restrict__ m2,
                 int N, int K, int degree, float* __restrict__ kappa,
                 uint8_t* __restrict__ valid, float* __restrict__ r) {
  __shared__ float kn[MAXK];
  __shared__ float sc[MAXC * D];
  __shared__ float sm1[(MAXC + 1) * MAXC];
  __shared__ float sm2[(MAXC + 2) * MAXC];
  const int C = K - degree - 1;
  for (int k = threadIdx.x; k < K; k += THREADS) kn[k] = knots[k];
  for (int k = threadIdx.x; k < C * D; k += THREADS) sc[k] = ctrl[k];
  for (int k = threadIdx.x; k < (C + 1) * C; k += THREADS) sm1[k] = m1[k];
  for (int k = threadIdx.x; k < (C + 2) * C; k += THREADS) sm2[k] = m2[k];
  __syncthreads();
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;

  // Cox-de Boor, keeping the rows of degree p-2 and p-1 on the way to p
  const float un = u[n];
  const float last = kn[K - 1];
  float b[MAXK], b1[MAXK], b2[MAXK];
  for (int s = 0; s < K - 1; ++s) {
    const float lo = kn[s], hi = kn[s + 1];
    const bool in_span = un >= lo && (un < hi || (hi >= last && un <= hi));
    b[s] = (__fsub_rn(hi, lo) > 0.f && in_span) ? 1.f : 0.f;
  }
  if (degree == 2)
    for (int i = 0; i < K - 1; ++i) b2[i] = b[i];
  for (int d = 1; d <= degree; ++d) {
    const int nb = K - 1 - d;
    for (int i = 0; i < nb; ++i) {
      const float dl = __fsub_rn(kn[i + d], kn[i]);
      const float dr = __fsub_rn(kn[i + d + 1], kn[i + 1]);
      const float left = dl > 0.f ? __fdiv_rn(__fsub_rn(un, kn[i]), dl) : 0.f;
      const float right =
          dr > 0.f ? __fdiv_rn(__fsub_rn(kn[i + d + 1], un), dr) : 0.f;
      b[i] = __fadd_rn(__fmul_rn(left, b[i]), __fmul_rn(right, b[i + 1]));
    }
    if (d == degree - 2)
      for (int i = 0; i < nb; ++i) b2[i] = b[i];
    if (d == degree - 1)
      for (int i = 0; i < nb; ++i) b1[i] = b[i];
  }
  float r0[D] = {0.f, 0.f, 0.f}, r1[D] = {0.f, 0.f, 0.f},
        r2[D] = {0.f, 0.f, 0.f};
  for (int c = 0; c < C; ++c) {
    float d1 = 0.f, d2 = 0.f;
    for (int k = 0; k < C + 1; ++k) d1 = fmaf(b1[k], sm1[k * C + c], d1);
    for (int k = 0; k < C + 2; ++k) d2 = fmaf(b2[k], sm2[k * C + c], d2);
    for (int j = 0; j < D; ++j) {
      const float cj = sc[c * D + j];
      r0[j] = fmaf(b[c], cj, r0[j]);
      r1[j] = fmaf(d1, cj, r1[j]);
      r2[j] = fmaf(d2, cj, r2[j]);
    }
  }
  const float cx = __fsub_rn(__fmul_rn(r1[1], r2[2]), __fmul_rn(r1[2], r2[1]));
  const float cy = __fsub_rn(__fmul_rn(r1[2], r2[0]), __fmul_rn(r1[0], r2[2]));
  const float cz = __fsub_rn(__fmul_rn(r1[0], r2[1]), __fmul_rn(r1[1], r2[0]));
  const float num = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz)));
  const float den = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(r1[0], r1[0]), __fmul_rn(r1[1], r1[1])),
      __fmul_rn(r1[2], r1[2])));
  const bool ok = den > 1e-6f;
  const float dd = fmaxf(den, 1e-6f);
  kappa[n] = ok ? __fdiv_rn(num, __fmul_rn(__fmul_rn(dd, dd), dd)) : 0.f;
  valid[n] = ok ? 1 : 0;
  for (int j = 0; j < D; ++j) r[n * D + j] = r0[j];
}

}  // namespace

// ctrl [C,3] f32, u [N] f32, knots [K] f32, m1 [C+1,C] f32, m2 [C+2,C]
// f32 with C = K - degree - 1 -> kappa [N] f32, valid [N] u8 (0/1),
// r [N,3] f32. Returns -1 for sizes past the kernel's limits (degree 2 to
// 5, C up to 32), else the cudaError_t of the launch.
extern "C" int bspline_curvature_launch(const void* ctrl, const void* u,
                                        const void* knots, const void* m1,
                                        const void* m2, void* kappa,
                                        void* valid, void* r, int N, int K,
                                        int degree, void* stream) {
  const int C = K - degree - 1;
  if (N < 1 || C < 1 || C > MAXC || degree < 2 || degree > MAXDEG) return -1;
  const int blocks = (N + THREADS - 1) / THREADS;
  curvature_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ctrl), static_cast<const float*>(u),
      static_cast<const float*>(knots), static_cast<const float*>(m1),
      static_cast<const float*>(m2), N, K, degree,
      static_cast<float*>(kappa), static_cast<uint8_t*>(valid),
      static_cast<float*>(r));
  return (int)cudaGetLastError();
}
