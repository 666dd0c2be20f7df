// Essential-matrix RANSAC for Hopper (sm_90a), float32 and float64: the
// 8-point hypothesis sweep and the consensus refit.
//
// There is no Pallas kernel to replace: the JAX package leaves this to XLA,
// which compiles the vmapped `jnp.linalg.svd` inside the jitted
// `vio_tpu/init/sfm.py::essential_ransac` (all 256 hypotheses in one
// program).  In PyTorch the same batch goes to cuSOLVER, which runs it
// matrix by matrix and synchronises the host to check `info`, so the
// tracker's RANSAC could not be captured into a CUDA graph.  These kernels
// are the port's counterpart of that compiled sweep.
//
// What the sweep computes, for each hypothesis h (one block each): the
// null vector e of the 8 x 9 design matrix of its sampled correspondences
// (row [x1 x0, x1 y0, x1, y1 x0, y1 y0, y1, x0, y0, 1]), E = e as a 3 x 3
// matrix, E projected onto the essential manifold, E' = u1 v1^T + u2 v2^T
// of E's SVD, and the number of valid rows whose Sampson error under E'
// is below thr^2.  The refit computes the same for one weighted N x 9
// system (the consensus set) and writes the inlier mask too.
//
// Both SVDs are one-sided (Hestenes) Jacobi: plane rotations from the
// right make the columns of A mutually orthogonal, A V = B; the column of
// V under the smallest column of B is the null vector.  A^T A is never
// formed: squaring a minimal sample's condition number in float32 would
// leave the null vector to round-off.  A pair (p, q) is rotated while
// |a_p . a_q| > sqrt(M) eps |a_p| |a_q| (LAPACK's gesvj tolerance, above
// the round-off of an M-row dot product) and both columns are nonzero,
// at most kMaxSweeps sweeps.  The column that becomes the null vector is
// rotated against the others however small it gets: leaving it once it is
// below ~eps |A|_F keeps the backward error small but lets the null vector
// tilt by ~eps |A| / sigma_8 toward the others (9x the plain SVD's median
// error on the tracker's samples, 150x on run_sim's bootstrap refit).
//
// What bounds it on this card: neither bytes (~30 KB in and out) nor
// operations (the function needs ~0.8 MFLOP for 256 hypotheses at
// N = 150, 60 rows valid: a Householder null vector of each 8 x 9 sample, its 3 x 3
// projection and the Sampson errors; this kernel's Jacobi makes ~10
// MFLOP of it): it is a chain of dependent rotations.  The sweep keeps it
// simple: one thread of each block runs the 8 x 9 Jacobi out of shared
// memory (36 pairs a sweep, ~7-9 sweeps), then the block's 128 threads
// score the N rows and reduce the count.  256 blocks fill the 132 SMs
// twice.  The refit, one block of 256 threads, holds the N x 9 matrix
// column-major in dynamic shared memory (N <= kMaxRefitN doubles a
// column) and reduces each pair's three dot products over the block.
// Making either fast (a warp per sweep, the rotations of disjoint pairs
// in parallel) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSweepThreads = 128;
constexpr int kRefitThreads = 256;
constexpr int kMaxSweeps = 30;
constexpr int kMaxRefitN = 2048;
constexpr int kCols = 9;

// The SVDs' arithmetic, whatever the input type: a float32 Jacobi of a
// minimal sample (kappa ~1e5 at frame-to-frame baselines) lands a median
// 2.7x further from the float64 answer than cuSOLVER's float32 SVD
// (chip_smoke.py phase 23); in double, E is the float64 answer rounded.
// The inputs, E and the Sampson scoring stay in the input type.
using Work = double;

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float hypot_(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double hypot_(double a, double b) { return hypot(a, b); }
__device__ __forceinline__ float copysign_(float a, float b) { return copysignf(a, b); }
__device__ __forceinline__ double copysign_(double a, double b) { return copysign(a, b); }

template <typename T> __device__ __forceinline__ T eps_();
template <> __device__ __forceinline__ float eps_<float>() { return 1.1920928955078125e-07f; }
template <> __device__ __forceinline__ double eps_<double>() { return 2.220446049250313e-16; }

// The rotation (c, s) that makes columns p and q orthogonal, given
// alpha = |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q; false where the pair
// is orthogonal to `tol` or a column is zero (also where any of them is
// NaN).
template <typename T>
__device__ __forceinline__ bool rotation(T alpha, T beta, T gamma, T tol, T& c, T& s) {
  if (!(alpha > T(0) && beta > T(0))) return false;
  if (!(abs_(gamma) > tol * sqrt_(alpha) * sqrt_(beta))) return false;
  const T zeta = (beta - alpha) / (T(2) * gamma);
  const T t = copysign_(T(1), zeta) / (abs_(zeta) + hypot_(T(1), zeta));
  c = T(1) / hypot_(T(1), t);
  s = c * t;
  return true;
}

// a_p <- c a_p - s a_q, a_q <- s a_p + c a_q
template <typename T>
__device__ __forceinline__ void rotate(T& ap, T& aq, T c, T s) {
  const T p = ap, q = aq;
  ap = c * p - s * q;
  aq = s * p + c * q;
}

// One-sided Jacobi on the columns of a (column j at a[j * M .. j * M + M))
// with V (column j at v[j * NC ..]), run by one thread, until a sweep
// rotates nothing or kMaxSweeps sweeps.
template <typename T, int M, int NC>
__device__ void jacobi_serial(T* a, T* v) {
  const T tol = sqrt_(T(M)) * eps_<T>();
  int sweep = 0;
  while (sweep < kMaxSweeps) {
    ++sweep;
    bool rotated = false;
    for (int p = 0; p < NC - 1; ++p) {
      for (int q = p + 1; q < NC; ++q) {
        T* ap = a + p * M;
        T* aq = a + q * M;
        T alpha = 0, beta = 0, gamma = 0;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          alpha += ap[i] * ap[i];
          beta += aq[i] * aq[i];
          gamma += ap[i] * aq[i];
        }
        T c, s;
        if (!rotation(alpha, beta, gamma, tol, c, s)) continue;
        rotated = true;
#pragma unroll
        for (int i = 0; i < M; ++i) rotate(ap[i], aq[i], c, s);
        T* vp = v + p * NC;
        T* vq = v + q * NC;
#pragma unroll
        for (int i = 0; i < NC; ++i) rotate(vp[i], vq[i], c, s);
      }
    }
    if (!rotated) break;
  }
}

// Index of the smallest of n column norms (the first on a tie).
template <typename T>
__device__ __forceinline__ int argmin(const T* norm2, int n) {
  int k = 0;
  for (int j = 1; j < n; ++j)
    if (norm2[j] < norm2[k]) k = j;
  return k;
}

// E (row-major 3 x 3) projected onto the essential manifold:
// out = u1 v1^T + u2 v2^T, the two largest singular pairs of E.
template <typename T>
__device__ void project_essential(const T* e, T* out) {
  T b[9], v[9], n2[3];
  for (int c = 0; c < 3; ++c)
    for (int r = 0; r < 3; ++r) {
      b[c * 3 + r] = e[r * 3 + c];     // column c of E
      v[c * 3 + r] = r == c ? T(1) : T(0);
    }
  jacobi_serial<T, 3, 3>(b, v);
  for (int j = 0; j < 3; ++j)
    n2[j] = b[j * 3] * b[j * 3] + b[j * 3 + 1] * b[j * 3 + 1] + b[j * 3 + 2] * b[j * 3 + 2];
  const int k = argmin(n2, 3);
  for (int i = 0; i < 9; ++i) out[i] = 0;
  for (int j = 0; j < 3; ++j) {
    if (j == k) continue;
    const T sigma = sqrt_(n2[j]);
    if (!(sigma > T(0))) continue;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) out[r * 3 + c] += b[j * 3 + r] / sigma * v[j * 3 + c];
  }
}

// The design row of one correspondence (E = e.reshape(3, 3), row-major).
template <typename T>
__device__ __forceinline__ void design_row(T x0, T y0, T x1, T y1, T w, T* a, int stride) {
  a[0 * stride] = x1 * x0 * w;
  a[1 * stride] = x1 * y0 * w;
  a[2 * stride] = x1 * w;
  a[3 * stride] = y1 * x0 * w;
  a[4 * stride] = y1 * y0 * w;
  a[5 * stride] = y1 * w;
  a[6 * stride] = x0 * w;
  a[7 * stride] = y0 * w;
  a[8 * stride] = w;
}

// Sampson error of (x0, y0) <-> (x1, y1) under E (row-major), as
// ops/ransac.py's plain version computes it.
template <typename T>
__device__ __forceinline__ T sampson(const T* E, T x0, T y0, T x1, T y1) {
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

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Count the valid rows under E whose Sampson error is below thr2, over
// the block; rows n = tid, tid + blockDim, ...  Writes each row's flag to
// `inl` when given.  Returns the block's total (valid in thread 0).
template <typename T, int THREADS>
__device__ int score(const T* E, const T* x0, const T* x1, const uint8_t* valid, int N,
                     T thr2, uint8_t* inl, int* scratch) {
  int cnt = 0;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    bool in = false;
    if (valid[n]) in = sampson(E, x0[2 * n], x0[2 * n + 1], x1[2 * n], x1[2 * n + 1]) < thr2;
    if (inl) inl[n] = in;
    cnt += in;
  }
  cnt = warp_sum(cnt);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = cnt;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
  return total;
}

// ---------------------------------------------------------------------------
// The hypothesis sweep: one block per hypothesis.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
             const uint8_t* __restrict__ valid, const int64_t* __restrict__ idx, int N,
             T thr2, T* __restrict__ E_out, int64_t* __restrict__ count_out,
             T* __restrict__ null_out) {
  __shared__ Work a[kCols * 8];       // column-major 8 x 9
  __shared__ Work v[kCols * kCols];
  __shared__ T E[9];
  __shared__ int scratch[kSweepThreads / 32];
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 8) {
    const int64_t n = idx[static_cast<int64_t>(h) * 8 + tid];
    // a row outside `valid` (or out of range) is a zero row, as the plain
    // version's zero weight makes it
    const bool use = n >= 0 && n < N && valid[n];
    if (use)
      design_row<Work>(x0[2 * n], x0[2 * n + 1], x1[2 * n], x1[2 * n + 1], Work(1), a + tid, 8);
    else
      for (int j = 0; j < kCols; ++j) a[j * 8 + tid] = 0;
  }
  if (tid < kCols * kCols) v[tid] = (tid / kCols == tid % kCols) ? Work(1) : Work(0);
  __syncthreads();
  if (tid == 0) {
    jacobi_serial<Work, 8, kCols>(a, v);
    Work n2[kCols];
    for (int j = 0; j < kCols; ++j) {
      Work s = 0;
      for (int i = 0; i < 8; ++i) s += a[j * 8 + i] * a[j * 8 + i];
      n2[j] = s;
    }
    const Work* e = v + argmin(n2, kCols) * kCols;
    Work Ew[9];
    project_essential<Work>(e, Ew);
    for (int i = 0; i < 9; ++i) E[i] = static_cast<T>(Ew[i]);
    if (null_out)
      for (int i = 0; i < kCols; ++i)
        null_out[static_cast<int64_t>(h) * kCols + i] = static_cast<T>(e[i]);
  }
  __syncthreads();
  const int total = score<T, kSweepThreads>(E, x0, x1, valid, N, thr2, nullptr, scratch);
  if (tid == 0) {
    count_out[h] = total;
    for (int i = 0; i < 9; ++i) E_out[static_cast<int64_t>(h) * 9 + i] = E[i];
  }
}

// ---------------------------------------------------------------------------
// The refit: one block, the weighted N x 9 system in shared memory.
// ---------------------------------------------------------------------------

// Sum of `val` over the block, in every thread.  `red` holds one value a
// warp; two barriers.
template <typename T>
__device__ __forceinline__ T block_sum(T val, T* red) {
  val = warp_sum(val);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = val;
  __syncthreads();
  T total = 0;
#pragma unroll
  for (int w = 0; w < kRefitThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kRefitThreads)
refit_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
             const uint8_t* __restrict__ valid, const T* __restrict__ w, int N, T thr2,
             T* __restrict__ E_out, uint8_t* __restrict__ inl_out,
             int64_t* __restrict__ count_out, T* __restrict__ null_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Work* a = reinterpret_cast<Work*>(smem_raw);    // column j at a[j * N]
  __shared__ Work v[kCols * kCols];
  __shared__ Work red[3][kRefitThreads / 32];
  __shared__ T E[9];
  __shared__ int scratch[kRefitThreads / 32];
  const int tid = threadIdx.x;
  for (int n = tid; n < N; n += kRefitThreads) {
    if (valid[n])
      design_row<Work>(x0[2 * n], x0[2 * n + 1], x1[2 * n], x1[2 * n + 1], w[n], a + n, N);
    else
      for (int j = 0; j < kCols; ++j) a[j * N + n] = 0;
  }
  if (tid < kCols * kCols) v[tid] = (tid / kCols == tid % kCols) ? Work(1) : Work(0);
  __syncthreads();
  const Work tol = sqrt_(Work(N)) * eps_<Work>();

  int sweep = 0;
  while (sweep < kMaxSweeps) {
    ++sweep;
    bool rotated = false;                          // the same in every thread
    for (int p = 0; p < kCols - 1; ++p) {
      for (int q = p + 1; q < kCols; ++q) {
        Work* ap = a + p * N;
        Work* aq = a + q * N;
        Work al = 0, be = 0, ga = 0;
        for (int n = tid; n < N; n += kRefitThreads) {
          al += ap[n] * ap[n];
          be += aq[n] * aq[n];
          ga += ap[n] * aq[n];
        }
        al = warp_sum(al);
        be = warp_sum(be);
        ga = warp_sum(ga);
        if ((tid & 31) == 0) {
          red[0][tid >> 5] = al;
          red[1][tid >> 5] = be;
          red[2][tid >> 5] = ga;
        }
        __syncthreads();
        al = be = ga = 0;
#pragma unroll
        for (int k = 0; k < kRefitThreads / 32; ++k) {
          al += red[0][k];
          be += red[1][k];
          ga += red[2][k];
        }
        __syncthreads();
        Work c, s;
        if (!rotation(al, be, ga, tol, c, s)) continue;
        rotated = true;
        for (int n = tid; n < N; n += kRefitThreads) rotate(ap[n], aq[n], c, s);
        if (tid < kCols) rotate(v[p * kCols + tid], v[q * kCols + tid], c, s);
        // each thread touches only its own rows of a; v is read after the
        // next barrier
      }
    }
    if (!rotated) break;
  }
  __syncthreads();
  // column norms -> the null vector -> E'
  Work n2[kCols];
  for (int j = 0; j < kCols; ++j) {
    Work s = 0;
    for (int n = tid; n < N; n += kRefitThreads) s += a[j * N + n] * a[j * N + n];
    n2[j] = block_sum(s, red[0]);
  }
  if (tid == 0) {
    const Work* e = v + argmin(n2, kCols) * kCols;
    Work Ew[9];
    project_essential<Work>(e, Ew);
    for (int i = 0; i < 9; ++i) E[i] = static_cast<T>(Ew[i]);
    if (null_out)
      for (int i = 0; i < kCols; ++i) null_out[i] = static_cast<T>(e[i]);
  }
  __syncthreads();
  const int total = score<T, kRefitThreads>(E, x0, x1, valid, N, thr2, inl_out, scratch);
  if (tid == 0) {
    count_out[0] = total;
    for (int i = 0; i < 9; ++i) E_out[i] = E[i];
  }
}

template <typename T>
int launch_sweep(const T* x0, const T* x1, const uint8_t* valid, const int64_t* idx, int N,
                 int n_hyp, T thr2, T* E, int64_t* count, T* null, cudaStream_t stream) {
  if (N < 1 || n_hyp < 1) return static_cast<int>(cudaErrorInvalidValue);
  sweep_kernel<T><<<n_hyp, kSweepThreads, 0, stream>>>(x0, x1, valid, idx, N, thr2, E, count,
                                                        null);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_refit(const T* x0, const T* x1, const uint8_t* valid, const T* w, int N, T thr2,
                 T* E, uint8_t* inl, int64_t* count, T* null, cudaStream_t stream) {
  if (N < 1 || N > kMaxRefitN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(N) * kCols * sizeof(Work);
  refit_kernel<T><<<1, kRefitThreads, smem, stream>>>(x0, x1, valid, w, N, thr2, E, inl, count,
                                                      null);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Let the refit take the dynamic shared memory its largest N needs, on
// the current device.  Not a stream operation: call it before the first
// refit on a device, outside any graph capture.  Returns the CUDA error.
int essential_ransac_prepare() {
  cudaError_t err = cudaFuncSetAttribute(refit_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxRefitN * kCols * static_cast<int>(sizeof(Work)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(refit_kernel<double>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxRefitN * kCols * static_cast<int>(sizeof(Work)));
  return static_cast<int>(err);
}

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
  return launch_refit<float>(x0, x1, valid, w, N, thr2, E, inl, count, null,
                             static_cast<cudaStream_t>(stream));
}

int essential_refit_f64(const double* x0, const double* x1, const uint8_t* valid,
                        const double* w, int N, double thr2, double* E, uint8_t* inl,
                        int64_t* count, double* null, void* stream) {
  return launch_refit<double>(x0, x1, valid, w, N, thr2, E, inl, count, null,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
