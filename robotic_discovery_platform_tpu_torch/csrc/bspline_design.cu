// Fused B-spline design contractions for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces: robotic_discovery_platform_tpu/ops/pallas/geometry.py:198
//   bspline_design (kernel body _design_kernel :179): the Cox-de Boor
//   basis B [N, C] of the edge points' chord parameters, contracted
//   straight into the weighted Gram matrix B^T W B [C, C] and the
//   right-hand side B^T W X [C, D] of the penalized least-squares fit; B
//   never reaches device memory.
//
// What it computes, in float64 (the port fits the spline in float64, see
// ops/bspline.fit_bspline): each point's basis row with the same IEEE
// roundings in the same order as ops/bspline._basis_columns
// (__dsub_rn / __ddiv_rn / __dmul_rn / __dadd_rn, nothing contracted into
// an FMA), then gram[i][j] = sum_n (b[n][i] * w[n]) * b[n][j] and
// rhs[i][d] = sum_n (b[n][i] * w[n]) * x[n][d]. Those sums run in another
// order than the plain version's matrix products, so the two agree to a
// few float64 ulps of the sums of the terms' magnitudes, not bitwise.
//
// Bound on one H100 SXM: the bytes. At the main path's N = 6400, C = 16,
// degree p = 3, D = 3 it reads 6400 * 5 * 8 = 256 KB (77 ns at 3.35 TB/s);
// a basis row has p + 1 = 4 nonzeros, so the function needs
// 2 * 6400 * (4 * 4 + 4 * 3) = 0.36 MFLOP of float64 (5 ns at 67 TFLOP/s).
// Either is far below a launch's own cost: the time is latency -- of the
// launch, of the basis recursion's divides, and of the reduction.
//
// Design against that latency: one launch of one thread-block cluster of
// 16 blocks x 512 threads (Hopper's distributed shared memory; 16 is past
// the portable cluster size, which the launch allows), one point per
// thread, one pass at N = 6400.
// - The windowed basis. A thread finds its point's knot span s (knots[s]
//   <= u < knots[s+1], closed at the top for the last nonempty span: the
//   degree-0 rule of _basis_columns) and runs the recursion only over the
//   p + 1 entries b[s-p .. s] that can be nonzero, in registers with
//   static indices (the kernel is a template on p), skipping the two
//   terms per degree whose factor lies outside the window. Every term the
//   full recursion adds outside the window is left * 0 or right * 0, an
//   exact zero, so the window's values equal the full row's value for
//   value (at most a zero's sign differs, which no sum sees); the entries
//   outside the window are zero. 2d divides at degree d instead of
//   2 (K - 1 - d), and no local-memory array (degrees 4 and 5, off the
//   main path, hold two sums per lane and spill a few registers).
// - Banded accumulation. A point adds a (p+1) x (p+1) Gram block and a
//   (p+1) x D rhs block at offset s - p, so the Gram matrix is banded
//   (|i - j| <= p). A warp's 32 points (consecutive, so nearly always one
//   span: the points arrive sorted along the edge) sum their blocks span
//   by span, lowest leading lane first, by recursive halving over the
//   lanes (31 shuffles for the 32 values of a cubic's blocks at D <= 4;
//   each lane ends with one sum) -- a fixed tree, the same on every call
//   -- into the warp's own band in shared memory; the block sums its
//   warps' bands in warp order, and after a cluster barrier rank 0 folds
//   the blocks' bands in rank order through map_shared_rank and writes
//   every entry of gram (0.0 outside the band) and rhs. No float atomics
//   and no scratch in device memory, so a frame gives the same bits on
//   every call.
// - Why a cluster and not a last-block fold: the fold then needs neither a
//   partial-row buffer in device memory nor a ticket counter that has to
//   start at zero (a memset, or a counter shared by callers on other
//   streams). Each point's recursion is a chain of divides whose latency
//   a thread cannot hide, so the time goes with the points per thread:
//   16 blocks give one pass where the portable 8 give two.
// A non-finite u (p >= 1) or weight makes the full basis row contribute NaN
// to every entry; a flag per block reproduces that (every output NaN). A
// non-finite point coordinate reaches only the rhs entries of its
// window.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 16;                // blocks: one cluster
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAXC = 32;                   // control points
constexpr int MAXD = 4;                    // point dimensions
constexpr int MAXDEG = 5;                  // spline degree
constexpr int MAXK = MAXC + MAXDEG + 1;    // knots

// The nonzero window of one parameter's basis row: b[a] = entry s - P + a
// of the degree-P row (entries outside the knot vector's range are 0);
// returns the span s, or -1 (no span holds u: the row is all zeros).
// Knots non-decreasing, so at most one span holds u.
template <int P>
__device__ __forceinline__ int basis_window(double u, const double* kn, int K,
                                            double (&b)[P + 1]) {
  const double last = kn[K - 1];
  int s = -1;
  for (int t = 0; t < K - 1; ++t) {
    const double lo = kn[t], hi = kn[t + 1];
    const bool in_span = u >= lo && (u < hi || (hi >= last && u <= hi));
    if (__dsub_rn(hi, lo) > 0.0 && in_span) s = t;
  }
#pragma unroll
  for (int a = 0; a < P; ++a) b[a] = 0.0;
  b[P] = 1.0;
  if (s < 0) return -1;
#pragma unroll
  for (int d = 1; d <= P; ++d) {
    // entries s - d .. s, in ascending order (b[a + 1] is still degree
    // d - 1's when b[a] reads it); degree d - 1's window is s - d + 1 .. s
#pragma unroll
    for (int a = 0; a <= P; ++a) {  // constant trip count: b in registers
      if (a < P - d) continue;
      const int i = s - P + a;
      double v = 0.0;
      if (i >= 0 && i <= K - 2 - d) {
        if (a > P - d) {
          const double dl = __dsub_rn(kn[i + d], kn[i]);
          const double left =
              dl > 0.0 ? __ddiv_rn(__dsub_rn(u, kn[i]), dl) : 0.0;
          v = __dmul_rn(left, b[a]);
        }
        if (a < P) {
          const double dr = __dsub_rn(kn[i + d + 1], kn[i + 1]);
          const double right =
              dr > 0.0 ? __ddiv_rn(__dsub_rn(kn[i + d + 1], u), dr) : 0.0;
          const double rt = __dmul_rn(right, b[a + 1]);
          v = a > P - d ? __dadd_rn(v, rt) : rt;
        }
      }
      b[a] = v;
    }
  }
  return s;
}

// Sums over a warp's lanes of 32 * NR values per lane: on return r[k]
// (k < NR) of lane l holds the sum of value 32 k + l. Recursive halving:
// at each step a lane keeps half of its values and sends the other half
// to its partner (31 shuffles per 32 values, not 5 * 32); each sum runs in
// a fixed tree, the same on every call.
template <int NR>
__device__ __forceinline__ void transpose_reduce(double (&r)[32 * NR],
                                                 int lane) {
#pragma unroll
  for (int k = 0; k < NR; ++k) {
#pragma unroll
    for (int step = 0; step < 5; ++step) {
      const int off = 16 >> step;  // partner lane, and half the values left
      const bool up = lane & off;
      // (a constant trip count, so that the inner loop unrolls before the
      // outer one does: a loop left rolled would index r at run time and
      // put it in local memory)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i >= off) continue;
        const double lo = r[32 * k + i], hi = r[32 * k + i + off];
        r[32 * k + i] = __dadd_rn(
            up ? hi : lo, __shfl_xor_sync(0xffffffffu, up ? lo : hi, off));
      }
    }
    r[k] = r[32 * k];
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
design_kernel(const double* __restrict__ pts, const double* __restrict__ w,
              const double* __restrict__ u,
              const double* __restrict__ knots, int N, int D, int K,
              double* __restrict__ gram, double* __restrict__ rhs) {
  constexpr int Q = P + 1;              // nonzeros of a basis row
  constexpr int NV = Q * Q + Q * MAXD;  // a point's Gram and rhs blocks
  constexpr int NR = (NV + 31) / 32;    // values per lane after the sums
  constexpr int BW = 2 * P + 1;         // band width
  __shared__ double kn[MAXK];
  __shared__ int bad;
  extern __shared__ double dyn[];  // each warp's band, then the block's

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = K - P - 1;
  // band entry (i, j) at i * BW + j - i + P; rhs entry (i, d) at GB + i D + d
  const int GB = C * BW;
  const int O = GB + C * D;
  double* band = dyn + warp * O;
  double* part = dyn + WARPS * O;  // read by rank 0
  for (int k = tid; k < K; k += THREADS) kn[k] = knots[k];
  for (int e = lane; e < O; e += 32) band[e] = 0.0;
  __syncthreads();

  // the band entry of this lane's value 32 k + lane for span s, or -1
  auto entry = [&](int e, int s) {
    if (e >= NV) return -1;
    if (e < Q * Q) {
      const int a = e / Q, c = e % Q;
      const int i = s - P + a, j = s - P + c;
      return i >= 0 && i < C && j >= 0 && j < C ? i * BW + c - a + P : -1;
    }
    const int a = (e - Q * Q) / MAXD, d = (e - Q * Q) % MAXD;
    const int i = s - P + a;
    return i >= 0 && i < C && d < D ? GB + i * D + d : -1;
  };

  bool nonfinite = false;
  for (int n0 = (rank * WARPS + warp) * 32; n0 < N;
       n0 += CLUSTER * THREADS) {
    const int n = n0 + lane;
    double b[Q] = {}, bw[Q] = {}, xv[MAXD] = {};
    int s = -1;
    if (n < N) {
      const double un = u[n], wn = w[n];
      nonfinite |= (P >= 1 && !isfinite(un)) || !isfinite(wn);
      s = basis_window<P>(un, kn, K, b);
#pragma unroll
      for (int a = 0; a < Q; ++a) bw[a] = __dmul_rn(b[a], wn);
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        xv[d] = d < D ? pts[(long long)n * D + d] : 0.0;
    }
    // the warp's points, span by span (lowest leading lane first): their
    // blocks summed over the lanes of that span into the warp's band
    unsigned todo = __ballot_sync(0xffffffffu, s >= 0);
    while (todo) {
      const int sv = __shfl_sync(0xffffffffu, s, __ffs(todo) - 1);
      const bool mine = s == sv;
      todo &= ~__ballot_sync(0xffffffffu, mine);
      double r[32 * NR];
#pragma unroll
      for (int e = 0; e < 32 * NR; ++e) r[e] = 0.0;
      if (mine) {
#pragma unroll
        for (int a = 0; a < Q; ++a) {
#pragma unroll
          for (int c = 0; c < Q; ++c) r[a * Q + c] = __dmul_rn(bw[a], b[c]);
#pragma unroll
          for (int d = 0; d < MAXD; ++d)
            r[Q * Q + a * MAXD + d] = __dmul_rn(bw[a], xv[d]);
        }
      }
      transpose_reduce<NR>(r, lane);
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int idx = entry(32 * k + lane, sv);
        if (idx >= 0) band[idx] = __dadd_rn(band[idx], r[k]);
      }
      __syncwarp();
    }
  }

  const int block_bad = __syncthreads_or(nonfinite);
  for (int e = tid; e < O; e += THREADS) {
    double t = dyn[e];
    for (int k = 1; k < WARPS; ++k) t = __dadd_rn(t, dyn[k * O + e]);
    part[e] = t;
  }
  if (tid == 0) bad = block_bad;
  cluster.sync();
  if (rank == 0) {
    int any_bad = 0;
    for (int r = 0; r < CLUSTER; ++r)
      any_bad |= *cluster.map_shared_rank(&bad, r);
    for (int e = tid; e < C * C + C * D; e += THREADS) {
      int idx = -1;
      if (e < C * C) {
        const int i = e / C, j = e % C;
        if (j - i >= -P && j - i <= P) idx = i * BW + j - i + P;
      } else {
        idx = GB + e - C * C;
      }
      double t = 0.0;
      if (idx >= 0) {
        double v[CLUSTER];
#pragma unroll
        for (int r = 0; r < CLUSTER; ++r)
          v[r] = *cluster.map_shared_rank(&part[idx], r);
        t = v[0];
#pragma unroll
        for (int r = 1; r < CLUSTER; ++r) t = __dadd_rn(t, v[r]);
      }
      if (any_bad) t = __longlong_as_double(0x7ff8000000000000LL);  // NaN
      if (e < C * C)
        gram[e] = t;
      else
        rhs[e - C * C] = t;
    }
  }
  cluster.sync();  // every block's bands stay until rank 0 has read them
}

template <int P>
int launch(const void* pts, const void* w, const void* u, const void* knots,
           void* gram, void* rhs, int N, int D, int K, cudaStream_t stream) {
  const int C = K - P - 1;
  const int smem = (WARPS + 1) * (C * (2 * P + 1) + C * D) * 8;
  auto kernel = design_kernel<P>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  // 16 blocks are past the portable cluster size of 8: Hopper takes them
  // when the kernel allows it
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CLUSTER;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const double*>(pts),
      static_cast<const double*>(w), static_cast<const double*>(u),
      static_cast<const double*>(knots), N, D, K, static_cast<double*>(gram),
      static_cast<double*>(rhs));
}

}  // namespace

// pts [N,D] f64, w [N] f64, u [N] f64, knots [K] f64 (non-decreasing) ->
// gram [C,C] f64, rhs [C,D] f64 with C = K - degree - 1, in one launch.
// Returns -1 for sizes past the kernel's limits, else the cudaError_t of
// the launch.
extern "C" int bspline_design_launch(const void* pts, const void* w,
                                     const void* u, const void* knots,
                                     void* gram, void* rhs, int N, int D,
                                     int K, int degree, void* stream) {
  const int C = K - degree - 1;
  if (N < 1 || C < 1 || C > MAXC || D < 1 || D > MAXD || degree < 0 ||
      degree > MAXDEG)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: return launch<0>(pts, w, u, knots, gram, rhs, N, D, K, st);
    case 1: return launch<1>(pts, w, u, knots, gram, rhs, N, D, K, st);
    case 2: return launch<2>(pts, w, u, knots, gram, rhs, N, D, K, st);
    case 3: return launch<3>(pts, w, u, knots, gram, rhs, N, D, K, st);
    case 4: return launch<4>(pts, w, u, knots, gram, rhs, N, D, K, st);
    default: return launch<5>(pts, w, u, knots, gram, rhs, N, D, K, st);
  }
}
