// Fused B-spline design contractions for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/geometry.py
//   bspline_design (kernel body _design_kernel): the Cox-de Boor basis
//   B [N, C] of the edge points' chord parameters, contracted straight into
//   the weighted Gram matrix B^T W B [C, C] and the right-hand side
//   B^T W X [C, D] of the penalized least-squares fit; B never reaches
//   device memory.
//
// What it computes, in float64 (the port fits the spline in float64, see
// ops/bspline.fit_bspline): each point's basis row by the recursion of
// ops/bspline._basis_columns, with the same IEEE roundings in the same
// order (__dsub_rn / __ddiv_rn / __dmul_rn / __dadd_rn, nothing
// contracted into an FMA), so the rows equal the plain version's bit for
// bit; then gram[i][j] = sum_n (b[n][i] * w[n]) * b[n][j] and
// rhs[i][d] = sum_n (b[n][i] * w[n]) * x[n][d]. Those sums run in another
// order than the plain version's matrix products, so the two agree to a
// few float64 ulps of the sums of the terms' magnitudes, not bitwise.
//
// Bound on one H100 SXM: the bytes. At the main path's N = 6400, C = 16,
// D = 3 it reads 6400 * 5 * 8 = 256 KB (77 ns at 3.35 TB/s); a basis row
// has p + 1 = 4 nonzeros, so the function needs 2 * 6400 * (4 * 4 + 4 * 3)
// = 0.36 MFLOP of float64 (5 ns at 67 TFLOP/s). This kernel sums all C
// columns, zeros included, and its time is the latency of two launches
// and of the basis recursion.
//
// Design: one block of 64 threads per 64 points. Each thread builds its
// point's basis row in registers and stages it in shared memory; then each
// thread owns a few of the C*C + C*D outputs and sums them over the
// block's 64 rows, and the block writes one row of partials. A second,
// one-block kernel folds the partial rows in block order. No float atomics,
// so one frame gives the same bits on every run.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;  // 34 KB of static shared memory
constexpr int MAXC = 32;                   // control points
constexpr int MAXD = 4;                    // point dimensions
constexpr int MAXDEG = 5;                  // spline degree
constexpr int MAXK = MAXC + MAXDEG + 1;    // knots
constexpr int MAXO = MAXC * MAXC + MAXC * MAXD;
constexpr int PER_THREAD = (MAXO + THREADS - 1) / THREADS;

// Cox-de Boor on one parameter: b[0 .. K-degree-2] on return.
__device__ void basis_row(double u, const double* kn, int K, int degree,
                          double* b) {
  const double last = kn[K - 1];
  for (int s = 0; s < K - 1; ++s) {
    const double lo = kn[s], hi = kn[s + 1];
    const bool in_span = u >= lo && (u < hi || (hi >= last && u <= hi));
    b[s] = (__dsub_rn(hi, lo) > 0.0 && in_span) ? 1.0 : 0.0;
  }
  for (int d = 1; d <= degree; ++d) {
    const int nb = K - 1 - d;
    for (int i = 0; i < nb; ++i) {
      const double dl = __dsub_rn(kn[i + d], kn[i]);
      const double dr = __dsub_rn(kn[i + d + 1], kn[i + 1]);
      const double left = dl > 0.0 ? __ddiv_rn(__dsub_rn(u, kn[i]), dl) : 0.0;
      const double right =
          dr > 0.0 ? __ddiv_rn(__dsub_rn(kn[i + d + 1], u), dr) : 0.0;
      b[i] = __dadd_rn(__dmul_rn(left, b[i]), __dmul_rn(right, b[i + 1]));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
design_partial_kernel(const double* __restrict__ pts,
                      const double* __restrict__ w,
                      const double* __restrict__ u,
                      const double* __restrict__ knots, int N, int D, int K,
                      int degree, double* __restrict__ part) {
  __shared__ double kn[MAXK];
  __shared__ double sb[THREADS][MAXC];   // b * w, the weighted row
  __shared__ double sr[THREADS][MAXC];   // b
  __shared__ double sx[THREADS][MAXD];
  const int C = K - degree - 1;
  const int O = C * C + C * D;
  const int t = threadIdx.x;
  for (int k = t; k < K; k += THREADS) kn[k] = knots[k];
  __syncthreads();

  const int n = blockIdx.x * THREADS + t;
  double b[MAXK];
  if (n < N) {
    basis_row(u[n], kn, K, degree, b);
    const double wn = w[n];
    for (int c = 0; c < C; ++c) {
      sr[t][c] = b[c];
      sb[t][c] = __dmul_rn(b[c], wn);
    }
    for (int d = 0; d < D; ++d) sx[t][d] = pts[(long long)n * D + d];
  } else {  // past the end: a zero-weight row adds nothing
    for (int c = 0; c < C; ++c) sr[t][c] = sb[t][c] = 0.0;
    for (int d = 0; d < D; ++d) sx[t][d] = 0.0;
  }
  __syncthreads();

  double acc[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) acc[k] = 0.0;
  const int rows = min(THREADS, N - (int)blockIdx.x * THREADS);
  for (int r = 0; r < rows; ++r) {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int o = t + k * THREADS;
      if (o < C * C) {
        acc[k] = fma(sb[r][o / C], sr[r][o % C], acc[k]);
      } else if (o < O) {
        const int q = o - C * C;
        acc[k] = fma(sb[r][q / D], sx[r][q % D], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int o = t + k * THREADS;
    if (o < O) part[(long long)blockIdx.x * O + o] = acc[k];
  }
}

__global__ void __launch_bounds__(THREADS)
design_fold_kernel(const double* __restrict__ part, int blocks, int O,
                   int CC, double* __restrict__ gram,
                   double* __restrict__ rhs) {
  for (int o = threadIdx.x; o < O; o += THREADS) {
    double s = 0.0;
    for (int b = 0; b < blocks; ++b) s = __dadd_rn(s, part[(long long)b * O + o]);
    if (o < CC)
      gram[o] = s;
    else
      rhs[o - CC] = s;
  }
}

}  // namespace

// Blocks of partials the wrapper must allocate (rows of C*C + C*D doubles).
extern "C" int bspline_design_blocks(int N) {
  return (N + THREADS - 1) / THREADS;
}

// pts [N,D] f64, w [N] f64, u [N] f64, knots [K] f64 -> gram [C,C] f64,
// rhs [C,D] f64 with C = K - degree - 1; part is scratch
// [bspline_design_blocks(N), C*C + C*D] f64. Returns -1 for sizes past the
// kernel's limits, else the cudaError_t of the launches.
extern "C" int bspline_design_launch(const void* pts, const void* w,
                                     const void* u, const void* knots,
                                     void* gram, void* rhs, void* part, int N,
                                     int D, int K, int degree, void* stream) {
  const int C = K - degree - 1;
  if (N < 1 || C < 1 || C > MAXC || D < 1 || D > MAXD || degree < 0 ||
      degree > MAXDEG)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = bspline_design_blocks(N);
  design_partial_kernel<<<blocks, THREADS, 0, st>>>(
      static_cast<const double*>(pts), static_cast<const double*>(w),
      static_cast<const double*>(u), static_cast<const double*>(knots), N, D,
      K, degree, static_cast<double*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  design_fold_kernel<<<1, THREADS, 0, st>>>(
      static_cast<const double*>(part), blocks, C * C + C * D, C * C,
      static_cast<double*>(gram), static_cast<double*>(rhs));
  return (int)cudaGetLastError();
}
