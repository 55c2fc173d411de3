// Fused B-spline curvature profile for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/geometry.py:266
//   bspline_curvature (kernel body _curvature_kernel :242): the spline r,
//   its derivatives r' and r'' from the basis and the static derivative
//   matrices, and kappa = ||r' x r''|| / ||r'||^3 with the degenerate-
//   tangent guard, in one launch instead of three design products and an
//   elementwise chain.
//
// What it computes, in float32, per sample u[n]: the degree-p, p-1 and
// p-2 basis rows of the Cox-de Boor recursion of ops/bspline._basis_columns
// (the lower degrees are the recursion's intermediate rows; the roundings
// are the plain version's, __fsub_rn / __fdiv_rn / __fmul_rn / __fadd_rn);
// r = B_p ctrl, r' = (B_{p-1} m1) ctrl, r'' = (B_{p-2} m2) ctrl, each sum
// by fmaf in ascending order; then num = ||r' x r''||, den = ||r'||,
// valid = den > 1e-6 and kappa = valid ? num / (d*d*d) : 0 with
// d = max(den, 1e-6), d*d*d as ops/bspline._curvature_formula writes it.
// The plain version's matrix products sum in another order, so the two
// agree to a few float32 ulps, not bitwise.
//
// Bound on one H100 SXM: the bytes, under 3 KB at the main path's
// N = 100 samples, C = 16, against about 10 KFLOP from the basis
// nonzeros: under 1 ns. Its time is the latency of one launch, of the
// staging load and of one sample's chain of divides.
//
// Design against that latency: one thread per sample; the knots, the
// control points (read through their strides: the fit's solve leaves them
// column-major, and a copy would be a second launch per frame) and the
// derivative matrices' bands staged in shared memory; only the entries
// that can be nonzero computed, all in registers (the kernel is a
// template on the degree p, so every per-sample array has constant
// indices):
// - The windowed basis (as basis_window in bspline_design.cu, in float32).
//   The sample's knot span s, then the recursion over the p + 1 entries
//   s - p .. s only; degree d's window is s - d .. s, and the degree p - 2
//   and p - 1 windows are kept on the way. Every term the full recursion
//   adds outside the window is left * 0 or right * 0, an exact zero, so
//   the windows equal the full rows value for value (a zero's sign aside):
//   p (p + 1) divides instead of about 2 p K.
// - The banded derivative rows. m1 [C+1, C] is nonzero only at rows c and
//   c + 1 of column c, m2 [C+2, C] at rows c .. c + 2 (products of
//   two-banded matrices), and the caller passes those bands alone:
//   m1b [C, 2], m2b [C, 3]. (B_{p-1} m1)[c] and (B_{p-2} m2)[c] can be
//   nonzero only for c in s - p .. s, so the kernel sums only those c,
//   each over its band in ascending row order, keeping the association
//   (B m) ctrl. The terms skipped are exact zeros, so for finite inputs
//   the sums equal those of the full products in the same order.
// A non-finite u makes the full recursion's rows NaN (inf * 0, NaN * 0),
// so r is NaN, the tangent's norm NaN, the sample invalid and kappa 0: the
// kernel writes exactly that.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAXC = 32;
constexpr int MAXDEG = 5;
constexpr int MAXK = MAXC + MAXDEG + 1;
constexpr int D = 3;

template <int P>
__global__ void __launch_bounds__(THREADS)
curvature_kernel(const float* __restrict__ ctrl, const float* __restrict__ u,
                 const float* __restrict__ knots,
                 const float* __restrict__ m1b, const float* __restrict__ m2b,
                 int N, int K, int cs0, int cs1, float* __restrict__ kappa,
                 uint8_t* __restrict__ valid, float* __restrict__ r) {
  __shared__ float kn[MAXK];
  __shared__ float sc[MAXC * D];
  __shared__ float sm1[MAXC * 2];
  __shared__ float sm2[MAXC * 3];
  const int C = K - P - 1;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const float un = n < N ? u[n] : 0.f;  // in flight during the staging
  for (int k = threadIdx.x; k < K; k += THREADS) kn[k] = knots[k];
  for (int k = threadIdx.x; k < C * D; k += THREADS)
    sc[k] = ctrl[(k / D) * cs0 + (k % D) * cs1];
  for (int k = threadIdx.x; k < C * 2; k += THREADS) sm1[k] = m1b[k];
  for (int k = threadIdx.x; k < C * 3; k += THREADS) sm2[k] = m2b[k];
  __syncthreads();
  if (n >= N) return;

  if (!isfinite(un)) {
    kappa[n] = 0.f;
    valid[n] = 0;
    for (int j = 0; j < D; ++j) r[n * D + j] = __int_as_float(0x7fffffff);
    return;
  }

  // the span: knots[s] <= u < knots[s + 1], closed at the top for the last
  // nonempty span (the degree-0 rule of _basis_columns); -1 when no span
  // holds u (every row is then zero)
  const float last = kn[K - 1];
  int s = -1;
  for (int t = 0; t < K - 1; ++t) {
    const float lo = kn[t], hi = kn[t + 1];
    const bool in_span = un >= lo && (un < hi || (hi >= last && un <= hi));
    if (__fsub_rn(hi, lo) > 0.f && in_span) s = t;
  }

  float r0[D] = {0.f, 0.f, 0.f}, r1[D] = {0.f, 0.f, 0.f},
        r2[D] = {0.f, 0.f, 0.f};
  if (s >= 0) {
    // b[a] holds entry s - P + a of the current degree's row
    float b[P + 1], b1[P], b2[P - 1];
#pragma unroll
    for (int a = 0; a < P; ++a) b[a] = 0.f;
    b[P] = 1.f;
    if (P == 2) b2[0] = b[2];
#pragma unroll
    for (int d = 1; d <= P; ++d) {
      // entries s - d .. s in ascending order (b[a + 1] is still degree
      // d - 1's when b[a] reads it)
#pragma unroll
      for (int a = 0; a <= P; ++a) {  // constant trip count: registers
        if (a < P - d) continue;
        const int i = s - P + a;
        float v = 0.f;
        if (i >= 0 && i <= K - 2 - d) {
          if (a > P - d) {
            const float dl = __fsub_rn(kn[i + d], kn[i]);
            const float left =
                dl > 0.f ? __fdiv_rn(__fsub_rn(un, kn[i]), dl) : 0.f;
            v = __fmul_rn(left, b[a]);
          }
          if (a < P) {
            const float dr = __fsub_rn(kn[i + d + 1], kn[i + 1]);
            const float right =
                dr > 0.f ? __fdiv_rn(__fsub_rn(kn[i + d + 1], un), dr) : 0.f;
            const float rt = __fmul_rn(right, b[a + 1]);
            v = a > P - d ? __fadd_rn(v, rt) : rt;
          }
        }
        b[a] = v;
      }
      if (d == P - 2)
#pragma unroll
        for (int t = 0; t < P - 1; ++t) b2[t] = b[t + 2];  // s-P+2 .. s
      if (d == P - 1)
#pragma unroll
        for (int t = 0; t < P; ++t) b1[t] = b[t + 1];  // s-P+1 .. s
    }
    // column c = s - P + a of each product, over its band: m1 rows c and
    // c + 1 (b1 index a - 1, a), m2 rows c .. c + 2 (b2 index a - 2 .. a)
#pragma unroll
    for (int a = 0; a <= P; ++a) {
      const int c = s - P + a;
      if (c < 0 || c >= C) continue;
      float d1 = 0.f, d2 = 0.f;
      if (a >= 1) d1 = fmaf(b1[a - 1], sm1[2 * c], d1);
      if (a <= P - 1) d1 = fmaf(b1[a], sm1[2 * c + 1], d1);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int k = a + t - 2;
        if (k >= 0 && k <= P - 2) d2 = fmaf(b2[k], sm2[3 * c + t], d2);
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float cj = sc[c * D + j];
        r0[j] = fmaf(b[a], cj, r0[j]);
        r1[j] = fmaf(d1, cj, r1[j]);
        r2[j] = fmaf(d2, cj, r2[j]);
      }
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
#pragma unroll
  for (int j = 0; j < D; ++j) r[n * D + j] = r0[j];
}

template <int P>
void launch(const void* ctrl, const void* u, const void* knots,
            const void* m1b, const void* m2b, void* kappa, void* valid,
            void* r, int N, int K, int cs0, int cs1, cudaStream_t stream) {
  curvature_kernel<P><<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(ctrl), static_cast<const float*>(u),
      static_cast<const float*>(knots), static_cast<const float*>(m1b),
      static_cast<const float*>(m2b), N, K, cs0, cs1,
      static_cast<float*>(kappa),
      static_cast<uint8_t*>(valid), static_cast<float*>(r));
}

}  // namespace

// ctrl [C,3] f32 (element (c, j) at ctrl[c * cs0 + j * cs1]), u [N] f32,
// knots [K] f32, the bands of the derivative matrices m1b [C,2] f32
// (m1[c][c], m1[c+1][c]) and m2b [C,3] f32 (m2[c+t][c], t = 0..2),
// C = K - degree - 1 -> kappa [N] f32, valid [N] u8 (0/1), r [N,3] f32.
// Returns -1 for sizes past the kernel's limits (degree 2 to 5, C up to
// 32), else the cudaError_t of the launch.
extern "C" int bspline_curvature_launch(const void* ctrl, const void* u,
                                        const void* knots, const void* m1b,
                                        const void* m2b, void* kappa,
                                        void* valid, void* r, int N, int K,
                                        int degree, int cs0, int cs1,
                                        void* stream) {
  const int C = K - degree - 1;
  if (N < 1 || C < 1 || C > MAXC || degree < 2 || degree > MAXDEG) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 2:
      launch<2>(ctrl, u, knots, m1b, m2b, kappa, valid, r, N, K, cs0, cs1,
                st);
      break;
    case 3:
      launch<3>(ctrl, u, knots, m1b, m2b, kappa, valid, r, N, K, cs0, cs1,
                st);
      break;
    case 4:
      launch<4>(ctrl, u, knots, m1b, m2b, kappa, valid, r, N, K, cs0, cs1,
                st);
      break;
    default:
      launch<5>(ctrl, u, knots, m1b, m2b, kappa, valid, r, N, K, cs0, cs1,
                st);
      break;
  }
  return (int)cudaGetLastError();
}
