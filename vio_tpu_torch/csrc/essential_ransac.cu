// Essential-matrix RANSAC for Hopper (sm_90a), float32 and float64: the
// 8-point hypothesis sweep, the consensus refit, and the refit of the best
// hypothesis with its selection folded in.
//
// There is no Pallas kernel to replace: the JAX package leaves this to XLA,
// which compiles the vmapped `jnp.linalg.svd` inside the jitted
// `vio_tpu/init/sfm.py::essential_ransac` (all 256 hypotheses in one
// program).  In PyTorch the same batch goes to cuSOLVER, which runs it
// matrix by matrix and synchronises the host to check `info`, so the
// tracker's RANSAC could not be captured into a CUDA graph.  These kernels
// are the port's counterpart of that compiled sweep.
//
// What they compute.  The sweep, for each hypothesis h: the null vector e
// of the 8 x 9 design matrix A of its sampled correspondences (row
// [x1 x0, x1 y0, x1, y1 x0, y1 y0, y1, x0, y0, 1]), E = e as a 3 x 3
// matrix, E projected onto the essential manifold, E' = u1 v1^T + u2 v2^T
// of E's SVD, and the number of valid rows whose Sampson error under E' is
// below thr^2.  The refit computes the same for one weighted N x 9 system
// (the consensus set), with the smallest right singular vector in place
// of the null vector, and writes the inlier mask too.  refit_best first
// takes the first hypothesis with the most inliers (torch.argmax's rule)
// and weighs each valid row by whether its Sampson error under that
// hypothesis's E is below thr^2, in the input type, as
// init/sfm.py::essential_ransac_from_samples did between the two
// launches.  The SVD parts run in double for both input types (E is the
// float64 answer rounded); the inputs, E and the Sampson scoring stay in
// the input type.  A^T A is never formed: squaring a minimal sample's
// condition number (kappa ~1e5 at frame-to-frame baselines) in float32
// would leave the null vector to round-off.
//
// What bounds them on this card.  Neither bytes (~30 KB in and out) nor
// operations (~0.8 MFLOP for 256 hypotheses at N = 150, 60 rows valid;
// ~0.02 MFLOP for a refit): each is a chain of dependent double-precision
// steps (shuffle reductions, square roots, divisions), so its time is the
// latency of one warp's chain plus the launch.  The design keeps every
// chain in one warp's registers, makes it as short as the algorithm
// allows, and puts barriers only where warps must meet:
//
// - Sweep: a warp per hypothesis, kSweepWarps hypotheses a block (256
//   hypotheses: 64 blocks, one warp on each SM sub-partition), no block
//   barrier.  The null vector is the last column of Q in the Householder
//   QR of the sample's 9 x 8 transpose, q9 = H1 ... H8 e9: lane i holds
//   row i of [A^T | I], each reflection is one 16-lane shuffle reduction of
//   all the columns' dot products at once plus one sqrt, and after the 8
//   reflections lane 8 holds row 8 of Q^T [A^T | I]'s right block, q9^T.
//   Eight steps, no sweeps, no convergence test.  q9 is orthogonal to A's
//   rows whatever A's rank: a sample of rank < 8 (a row outside `valid`,
//   which the 1e-9 weight in sfm.ransac_samples makes rare) gets one unit
//   vector of its null space where the plain SVD returns another; both are
//   exact (chip_smoke.py phase 23 leaves such samples, kappa = inf, out of
//   the E check and holds them by backward error).  Every lane then runs
//   the same 3 x 3 one-sided Jacobi of the projection from registers, so
//   every lane has E' for the scoring; the lanes score the N rows (read
//   through L1: every hypothesis reads the same rows), and the count is one
//   __reduce_add_sync.  No atomics: the output is the same bit for bit
//   from run to run.
// - Refit: one block of kRefitWarps warps.  Each warp reduces its slab of
//   the weighted rows to a 9 x 9 triangle R by Householder QR in double,
//   kChunk new rows at a time below the triangle it holds (lanes 0-8 the
//   triangle, lanes 9-31 the new rows; a chunk of zero rows is skipped);
//   the stacked triangles are reduced again, three at a time (TSQR), so the
//   block meets at log3(kRefitWarps) barriers.  R has A's right singular
//   vectors, so warp 0 runs the one-sided Jacobi on R instead of A: lane j
//   holds column j of R and of V, the 5 disjoint pairs of a round-robin
//   order on 10 slots (9 columns and an empty one) rotate at once, and a
//   sweep is 9 steps.  Every nonzero pair is rotated while
//   |a_p . a_q| > sqrt(9) eps |a_p| |a_q| (LAPACK gesvj's tolerance): the
//   column that becomes the null vector is rotated however small it gets
//   (a cut-off there tilts the null vector by ~eps |A| / sigma_8).  Then the
//   block scores the rows, one barrier for E' and one for the count.  The
//   Jacobi's ~7 sweeps are two thirds of the refit's time
//   (scripts/torch_ransac_ablation.py times the pieces).
//
// The refit takes at most kMaxRefitN rows (ops/ransac.py: MAX_REFIT_N):
// one block walks every row, and above that a warp's slab is more than
// ten chunks.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSweepWarps = 4;
constexpr int kRefitWarps = 9;
constexpr int kFanIn = 3;                  // triangles a warp stacks in the tree
constexpr int kMaxSweeps = 30;
constexpr int kMaxRefitN = 2048;
constexpr int kCols = 9;
constexpr int kChunk = 32 - kCols;         // new rows under a warp's triangle
constexpr double kEps = 2.220446049250313e-16;

static_assert(kFanIn * kCols <= 32, "a warp stacks kFanIn triangles");

// The SVDs' arithmetic, whatever the input type: a float32 Jacobi of a
// minimal sample lands a median 2.7x further from the float64 answer than
// cuSOLVER's float32 SVD (chip_smoke.py phase 23); in double, E is the
// float64 answer rounded.
using Work = double;

// The rotation (c, s) that makes columns p and q orthogonal, given
// alpha = |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q; false where the pair
// is orthogonal to `tol` (|gamma| <= tol sqrt(alpha beta)) or a column is
// zero (also where any of them is NaN).  Rutishauser's angle, t = s / c =
// sign(zeta) / (|zeta| + sqrt(1 + zeta^2)), zeta = (beta - alpha) / 2 gamma,
// with zeta's denominator multiplied through: one sqrt and one rsqrt, no
// division (the division and hypot form made the refit 1.5x as long:
// scripts/torch_ransac_ablation.py).
__device__ __forceinline__ bool rotation(Work alpha, Work beta, Work gamma, Work tol, Work& c,
                                         Work& s) {
  if (!(alpha > 0 && beta > 0)) return false;
  if (!(gamma * gamma > (tol * tol) * (alpha * beta))) return false;
  const Work d = beta - alpha, g2 = 2 * gamma;
  const Work den = fabs(d) + sqrt(fma(d, d, g2 * g2));
  const Work h = rsqrt(fma(den, den, g2 * g2));
  c = den * h;
  s = copysign(Work(1), d) * g2 * h;
  return true;
}

// E (row-major 3 x 3) projected onto the essential manifold:
// out = u1 v1^T + u2 v2^T, the two largest singular pairs of E, by a
// one-sided Jacobi of E's columns, from registers.
__device__ __forceinline__ void project_essential(const Work (&e)[9], Work (&out)[9]) {
  Work b[9], v[9];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      b[c * 3 + r] = e[r * 3 + c];     // column c of E
      v[c * 3 + r] = r == c ? Work(1) : Work(0);
    }
  const Work tol = sqrt(Work(3)) * kEps;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = p + 1; q < 3; ++q) {
        Work alpha = 0, beta = 0, gamma = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          alpha += b[p * 3 + i] * b[p * 3 + i];
          beta += b[q * 3 + i] * b[q * 3 + i];
          gamma += b[p * 3 + i] * b[q * 3 + i];
        }
        Work c, s;
        if (!rotation(alpha, beta, gamma, tol, c, s)) continue;
        rotated = true;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const Work bp = b[p * 3 + i], bq = b[q * 3 + i];
          b[p * 3 + i] = c * bp - s * bq;
          b[q * 3 + i] = s * bp + c * bq;
          const Work vp = v[p * 3 + i], vq = v[q * 3 + i];
          v[p * 3 + i] = c * vp - s * vq;
          v[q * 3 + i] = s * vp + c * vq;
        }
      }
    if (!rotated) break;
  }
  Work n2[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    n2[j] = b[j * 3] * b[j * 3] + b[j * 3 + 1] * b[j * 3 + 1] + b[j * 3 + 2] * b[j * 3 + 2];
  int k = 0;                             // the smallest column (the first on a tie)
  Work least = n2[0];
#pragma unroll
  for (int j = 1; j < 3; ++j)
    if (n2[j] < least) {
      least = n2[j];
      k = j;
    }
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j == k) continue;
    const Work sigma = sqrt(n2[j]);
    if (!(sigma > 0)) continue;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) out[r * 3 + c] += b[j * 3 + r] / sigma * v[j * 3 + c];
  }
}

// The design row of one correspondence times w (E = e.reshape(3, 3),
// row-major).
__device__ __forceinline__ void design_row(Work x0, Work y0, Work x1, Work y1, Work w,
                                           Work (&a)[kCols]) {
  a[0] = x1 * x0 * w;
  a[1] = x1 * y0 * w;
  a[2] = x1 * w;
  a[3] = y1 * x0 * w;
  a[4] = y1 * y0 * w;
  a[5] = y1 * w;
  a[6] = x0 * w;
  a[7] = y0 * w;
  a[8] = w;
}

// Sampson error of (x0, y0) <-> (x1, y1) under E (row-major), as
// ops/ransac.py's plain version computes it.
template <typename T>
__device__ __forceinline__ T sampson(const T (&E)[9], T x0, T y0, T x1, T y1) {
  const T ex0 = E[0] * x0 + E[1] * y0 + E[2];
  const T ex1 = E[3] * x0 + E[4] * y0 + E[5];
  const T ex2 = E[6] * x0 + E[7] * y0 + E[8];
  const T etx0 = x1 * E[0] + y1 * E[3] + E[6];
  const T etx1 = x1 * E[1] + y1 * E[4] + E[7];
  const T r = x1 * ex0 + y1 * ex1 + ex2;
  T den = ex0 * ex0 + ex1 * ex1 + etx0 * etx0 + etx1 * etx1;
  den = den > T(1e-30) ? den : T(1e-30);
  return r * r / den;
}

// Whether valid row n is an inlier of E.
template <typename T>
__device__ __forceinline__ bool inlier(const T (&E)[9], const T* x0, const T* x1,
                                       const uint8_t* valid, int n, T thr2) {
  return valid[n] && sampson(E, x0[2 * n], x0[2 * n + 1], x1[2 * n], x1[2 * n + 1]) < thr2;
}

// ---------------------------------------------------------------------------
// Householder QR of a matrix held by a warp, row `lane` in m of each lane.
// ---------------------------------------------------------------------------

// The reflection H = I - beta v v^T that zeroes column K below row K (rows
// below the warp's last row are zero), applied to the columns K..NC-1.
// One shuffle reduction over WIDTH lanes gives every lane s_j = x . m_j
// for all j >= K at once (x = column K from row K down; s_K = |x|^2); with
// alpha = -sign(x_K) |x|, v = x - alpha e_K and v . m_j = s_j - alpha m_Kj,
// lane K's row broadcast.  The xor butterfly leaves the same bits in every
// lane of a WIDTH group, so the branch on |x|^2 is uniform across the
// rows; a zero column is left as it is (H = I).
template <int NC, int K, int WIDTH>
__device__ __forceinline__ void householder_step(Work (&m)[NC], int lane) {
  const Work x = lane >= K ? m[K] : Work(0);
  Work s[NC - K], r[NC - K];
#pragma unroll
  for (int j = K; j < NC; ++j) s[j - K] = lane >= K ? x * m[j] : Work(0);
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < NC - K; ++j) s[j] += __shfl_xor_sync(kFull, s[j], o, WIDTH);
#pragma unroll
  for (int j = K; j < NC; ++j) r[j - K] = __shfl_sync(kFull, m[j], K);
  const Work nrm2 = s[0];
  if (!(nrm2 > 0)) return;
  const Work xk = r[0];
  const Work nrm = sqrt(nrm2);
  const Work alpha = xk >= 0 ? -nrm : nrm;
  const Work beta = 1 / (nrm * (nrm + fabs(xk)));
  const Work v = lane == K ? xk - alpha : x;
#pragma unroll
  for (int j = K + 1; j < NC; ++j) m[j] -= beta * (s[j - K] - alpha * r[j - K]) * v;
  m[K] = lane == K ? alpha : (lane > K ? Work(0) : m[K]);
}

template <int NC, int WIDTH, int... K>
__device__ __forceinline__ void householder_steps(Work (&m)[NC], int lane,
                                                  std::integer_sequence<int, K...>) {
  (householder_step<NC, K, WIDTH>(m, lane), ...);
}

// Reflections 0..STEPS-1: the first STEPS columns of the warp's rows
// reduced to upper-triangular form.
template <int STEPS, int NC, int WIDTH>
__device__ __forceinline__ void householder_qr(Work (&m)[NC], int lane) {
  householder_steps<NC, WIDTH>(m, lane, std::make_integer_sequence<int, STEPS>{});
}

// ---------------------------------------------------------------------------
// The hypothesis sweep: a warp per hypothesis.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kSweepWarps * 32)
sweep_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
             const uint8_t* __restrict__ valid, const int64_t* __restrict__ idx, int N,
             int n_hyp, T thr2, T* __restrict__ E_out, int64_t* __restrict__ count_out,
             T* __restrict__ null_out) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  if (h >= n_hyp) return;                  // the whole warp; no barrier follows
  // lanes 0-7: their sample's correspondence; a row outside `valid` (or
  // out of range) is a zero row, as the plain version's zero weight makes it
  Work px0 = 0, py0 = 0, px1 = 0, py1 = 0;
  int use = 0;
  if (lane < 8) {
    const int64_t n = idx[static_cast<int64_t>(h) * 8 + lane];
    use = n >= 0 && n < N && valid[n];
    if (use) {
      px0 = x0[2 * n];
      py0 = x0[2 * n + 1];
      px1 = x1[2 * n];
      py1 = x1[2 * n + 1];
    }
  }
  // lane i < 9: row i of [A^T | I].  Component i = 3a + b of a design row
  // is u_a w_b, u = (x1, y1, 1), w = (x0, y0, 1).
  const int ca = lane / 3, cb = lane % 3;
  Work m[8 + kCols];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const Work sx0 = __shfl_sync(kFull, px0, r), sy0 = __shfl_sync(kFull, py0, r);
    const Work sx1 = __shfl_sync(kFull, px1, r), sy1 = __shfl_sync(kFull, py1, r);
    const int su = __shfl_sync(kFull, use, r);
    const Work u = ca == 0 ? sx1 : (ca == 1 ? sy1 : Work(1));
    const Work w = cb == 0 ? sx0 : (cb == 1 ? sy0 : Work(1));
    m[r] = lane < kCols && su ? u * w : Work(0);
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) m[8 + i] = lane == i ? Work(1) : Work(0);
  householder_qr<8, 8 + kCols, 16>(m, lane);
  Work e[9], Ew[9];
#pragma unroll
  for (int i = 0; i < kCols; ++i) e[i] = __shfl_sync(kFull, m[8 + i], 8);
  project_essential(e, Ew);
  T E[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) E[i] = static_cast<T>(Ew[i]);
  unsigned cnt = 0;
  for (int n = lane; n < N; n += 32) cnt += inlier(E, x0, x1, valid, n, thr2);
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) {
    count_out[h] = cnt;
#pragma unroll
    for (int i = 0; i < 9; ++i) E_out[static_cast<int64_t>(h) * 9 + i] = E[i];
    if (null_out)
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        null_out[static_cast<int64_t>(h) * kCols + i] = static_cast<T>(e[i]);
  }
}

// ---------------------------------------------------------------------------
// The refit: row-block QR to a 9 x 9 triangle, a warp's Jacobi on it.
// ---------------------------------------------------------------------------

// a . b over the 9 entries as a tree of pairs (shorter than a chain of
// fmas); dot9(a, b) and dot9(b, a) are the same bits.
__device__ __forceinline__ Work dot9(const Work (&a)[kCols], const Work (&b)[kCols]) {
  const Work p01 = fma(a[1], b[1], a[0] * b[0]), p23 = fma(a[3], b[3], a[2] * b[2]);
  const Work p45 = fma(a[5], b[5], a[4] * b[4]), p67 = fma(a[7], b[7], a[6] * b[6]);
  return fma(a[8], b[8], (p01 + p23) + (p45 + p67));
}

// Lane `lane` of the calling warp takes column `lane` of R (row-major in
// shared memory) and of V = I; lane 9 is the empty slot of the round-robin
// order.  Rotates to convergence, then returns the column of V under the
// smallest column of R V (the first on a tie), in every lane.
__device__ __forceinline__ void jacobi_null(const Work (*R)[kCols], int lane, Work (&e)[kCols]) {
  Work a[kCols], v[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    a[i] = lane < kCols ? R[i][lane] : Work(0);
    v[i] = lane == i ? Work(1) : Work(0);
  }
  const Work tol = sqrt(Work(kCols)) * kEps;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int round = 0; round < kCols; ++round) {
      // the circle method on slots 0-9: slot 9 meets `round`, the others
      // pair up as (round + i, round - i) mod 9
      const int partner = lane > kCols ? lane
                          : lane == kCols ? round
                          : lane == round ? kCols
                                          : (2 * round - lane + kCols) % kCols;
      Work aq[kCols], vq[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        aq[i] = __shfl_sync(kFull, a[i], partner);
        vq[i] = __shfl_sync(kFull, v[i], partner);
      }
      // both lanes of a pair compute the same norms, product and (c, s):
      // the lower is p
      const Work na = dot9(a, a), nq = dot9(aq, aq), gamma = dot9(a, aq);
      const bool first = lane < partner;
      Work c, s;
      if (partner != lane && rotation(first ? na : nq, first ? nq : na, gamma, tol, c, s)) {
        rotated = true;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          a[i] = first ? c * a[i] - s * aq[i] : s * aq[i] + c * a[i];
          v[i] = first ? c * v[i] - s * vq[i] : s * vq[i] + c * v[i];
        }
      }
    }
    if (!__any_sync(kFull, rotated)) break;
  }
  const Work n2 = dot9(a, a);
  int k = 0;
  Work least = __shfl_sync(kFull, n2, 0);
#pragma unroll
  for (int j = 1; j < kCols; ++j) {
    const Work nj = __shfl_sync(kFull, n2, j);
    if (nj < least) {
      least = nj;
      k = j;
    }
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) e[i] = __shfl_sync(kFull, v[i], k);
}

// BEST = false: the rows weigh w[n] (refit).  BEST = true: the first
// hypothesis of Es / counts with the most inliers, and the rows weigh 1
// where they are its inliers, else 0 (refit_best).  Rows outside `valid`
// are zero rows.
template <typename T, bool BEST>
__global__ void __launch_bounds__(kRefitWarps * 32)
refit_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
             const uint8_t* __restrict__ valid, const T* __restrict__ w,
             const T* __restrict__ Es, const int64_t* __restrict__ counts, int n_hyp, int N,
             T thr2, T* __restrict__ E_out, uint8_t* __restrict__ inl_out,
             int64_t* __restrict__ count_out, T* __restrict__ null_out) {
  __shared__ Work Rs[kRefitWarps][kCols][kCols];   // each warp's triangle, row-major
  __shared__ T E_s[9];
  __shared__ unsigned warp_cnt[kRefitWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  T E0[9];
  if constexpr (BEST) {
    // every warp takes the argmax itself: the first of the largest counts
    long long best_c = LLONG_MIN;
    int best_h = INT_MAX;
    for (int h = lane; h < n_hyp; h += 32)
      if (counts[h] > best_c) {
        best_c = counts[h];
        best_h = h;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long oc = __shfl_xor_sync(kFull, best_c, o);
      const int oh = __shfl_xor_sync(kFull, best_h, o);
      if (oc > best_c || (oc == best_c && oh < best_h)) {
        best_c = oc;
        best_h = oh;
      }
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) E0[i] = Es[static_cast<int64_t>(best_h) * 9 + i];
  }

  // the warp's slab of rows, kChunk at a time under its triangle
  Work m[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) m[j] = 0;
  const int slab = (N + kRefitWarps - 1) / kRefitWarps;
  const int lo = warp * slab, hi = min(N, lo + slab);
  for (int base = lo; base < hi; base += kChunk) {
    bool nz = false;
    if (lane >= kCols) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) m[j] = 0;
      const int n = base + lane - kCols;
      if (n < hi && valid[n]) {
        const T ax0 = x0[2 * n], ay0 = x0[2 * n + 1], ax1 = x1[2 * n], ay1 = x1[2 * n + 1];
        T om;
        if constexpr (BEST)
          om = sampson(E0, ax0, ay0, ax1, ay1) < thr2 ? T(1) : T(0);
        else
          om = w[n];
        if (om != T(0)) {
          design_row(ax0, ay0, ax1, ay1, om, m);
          nz = true;
        }
      }
    }
    if (__any_sync(kFull, nz)) householder_qr<kCols, kCols, 32>(m, lane);
  }
  if (lane < kCols)
#pragma unroll
    for (int j = 0; j < kCols; ++j) Rs[warp][lane][j] = m[j];

  // the tree: a warp stacks the triangles of kFanIn warps and reduces them
  for (int stride = 1; stride < kRefitWarps; stride *= kFanIn) {
    __syncthreads();
    if (warp % (kFanIn * stride) == 0) {
      const int src = warp + (lane / kCols) * stride, row = lane % kCols;
      const bool take = lane < kFanIn * kCols && src < kRefitWarps;
      bool nz = false;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        m[j] = take ? Rs[src][row][j] : Work(0);
        nz |= lane >= kCols && m[j] != 0;
      }
      if (__any_sync(kFull, nz)) householder_qr<kCols, kCols, 32>(m, lane);
      if (lane < kCols)
#pragma unroll
        for (int j = 0; j < kCols; ++j) Rs[warp][lane][j] = m[j];
    }
  }

  if (warp == 0) {
    __syncwarp();
    Work e[kCols], Ew[9];
    jacobi_null(Rs[0], lane, e);
    project_essential(e, Ew);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) E_s[i] = static_cast<T>(Ew[i]);
      if (null_out)
#pragma unroll
        for (int i = 0; i < kCols; ++i) null_out[i] = static_cast<T>(e[i]);
    }
  }
  __syncthreads();
  T E[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) E[i] = E_s[i];
  unsigned cnt = 0;
  for (int n = threadIdx.x; n < N; n += kRefitWarps * 32) {
    const bool in = inlier(E, x0, x1, valid, n, thr2);
    inl_out[n] = in;
    cnt += in;
  }
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int k = 0; k < kRefitWarps; ++k) total += warp_cnt[k];
    count_out[0] = total;
#pragma unroll
    for (int i = 0; i < 9; ++i) E_out[i] = E[i];
  }
}

template <typename T>
int launch_sweep(const T* x0, const T* x1, const uint8_t* valid, const int64_t* idx, int N,
                 int n_hyp, T thr2, T* E, int64_t* count, T* null, cudaStream_t stream) {
  if (N < 1 || n_hyp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_hyp + kSweepWarps - 1) / kSweepWarps;
  sweep_kernel<T><<<blocks, kSweepWarps * 32, 0, stream>>>(x0, x1, valid, idx, N, n_hyp, thr2,
                                                           E, count, null);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BEST>
int launch_refit(const T* x0, const T* x1, const uint8_t* valid, const T* w, const T* Es,
                 const int64_t* counts, int n_hyp, int N, T thr2, T* E, uint8_t* inl,
                 int64_t* count, T* null, cudaStream_t stream) {
  if (N < 1 || N > kMaxRefitN || (BEST && n_hyp < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  refit_kernel<T, BEST><<<1, kRefitWarps * 32, 0, stream>>>(x0, x1, valid, w, Es, counts, n_hyp,
                                                            N, thr2, E, inl, count, null);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x0, x1 (N, 2), valid (N,) bytes, idx (n_hyp, 8) int64, contiguous on
// the device; E (n_hyp, 3, 3), count (n_hyp,) int64 and, when not null,
// null (n_hyp, 9) (each sample's unit null vector before the projection,
// so that a caller can hold its backward error) are written.  Launches
// on `stream`, does not synchronise.  Returns the CUDA error code of the
// launch (0 on success).
int essential_sweep_f32(const float* x0, const float* x1, const uint8_t* valid,
                        const int64_t* idx, int N, int n_hyp, float thr2, float* E,
                        int64_t* count, float* null, void* stream) {
  return launch_sweep<float>(x0, x1, valid, idx, N, n_hyp, thr2, E, count, null,
                             static_cast<cudaStream_t>(stream));
}

int essential_sweep_f64(const double* x0, const double* x1, const uint8_t* valid,
                        const int64_t* idx, int N, int n_hyp, double thr2, double* E,
                        int64_t* count, double* null, void* stream) {
  return launch_sweep<double>(x0, x1, valid, idx, N, n_hyp, thr2, E, count, null,
                              static_cast<cudaStream_t>(stream));
}

// x0, x1 (N, 2), valid (N,) bytes, w (N,) the rows' weights; E (3, 3),
// inl (N,) bytes, count (1,) int64 and, when not null, null (9,) (the
// system's unit null vector before the projection) are written.
// 1 <= N <= kMaxRefitN (ops/ransac.py: MAX_REFIT_N).
int essential_refit_f32(const float* x0, const float* x1, const uint8_t* valid, const float* w,
                        int N, float thr2, float* E, uint8_t* inl, int64_t* count,
                        float* null, void* stream) {
  return launch_refit<float, false>(x0, x1, valid, w, nullptr, nullptr, 0, N, thr2, E, inl,
                                    count, null, static_cast<cudaStream_t>(stream));
}

int essential_refit_f64(const double* x0, const double* x1, const uint8_t* valid,
                        const double* w, int N, double thr2, double* E, uint8_t* inl,
                        int64_t* count, double* null, void* stream) {
  return launch_refit<double, false>(x0, x1, valid, w, nullptr, nullptr, 0, N, thr2, E, inl,
                                     count, null, static_cast<cudaStream_t>(stream));
}

// The refit on the consensus set of the best hypothesis: Es (n_hyp, 3, 3)
// and counts (n_hyp,) int64 as the sweep wrote them; the rest as the
// refit's.
int essential_refit_best_f32(const float* x0, const float* x1, const uint8_t* valid,
                             const float* Es, const int64_t* counts, int n_hyp, int N,
                             float thr2, float* E, uint8_t* inl, int64_t* count, float* null,
                             void* stream) {
  return launch_refit<float, true>(x0, x1, valid, nullptr, Es, counts, n_hyp, N, thr2, E, inl,
                                   count, null, static_cast<cudaStream_t>(stream));
}

int essential_refit_best_f64(const double* x0, const double* x1, const uint8_t* valid,
                             const double* Es, const int64_t* counts, int n_hyp, int N,
                             double thr2, double* E, uint8_t* inl, int64_t* count,
                             double* null, void* stream) {
  return launch_refit<double, true>(x0, x1, valid, nullptr, Es, counts, n_hyp, N, thr2, E, inl,
                                    count, null, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
