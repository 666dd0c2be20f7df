// Gauss-Jordan SPD solve A x = b for Hopper (sm_90a), float32 and float64,
// 1 <= P <= 1024, one right-hand side.
//
// Replaces the TPU kernel vio_tpu/ops/linsolve.py::_gj_solve_pallas, which
// runs the same elimination with the whole augmented system resident in
// VMEM.  The caller is the LM loop of the sliding-window estimator: one
// solve of the damped reduced camera system per lambda-attempt, P = 171 at
// W = 10.  Every system is J^T W J + lambda I with lambda >= 1e-5 max|diag|,
// so elimination without pivoting is safe (vio_tpu/ops/linsolve.py:12-15).
//
// What bounds it: neither bytes nor operations.  The work (~5 MFLOP over
// 118 KB at P = 171) is nothing for the card; it is a chain of P dependent
// elimination steps, so the time is P times the latency of one step, and
// the design is about what a step costs.  Tensor cores are out: TF32 keeps
// about three digits and the estimator needs true float32.
//
// Regime 1, the system fits one SM's register file (float32 P <= 176, which
// covers the estimator's P = 171; float64 P <= 127): one block of 16 x 32
// threads holds [A | b] in registers, dealt cyclically -- element (i, j)
// belongs to thread (i mod 16, j mod 32) -- so that the work stays balanced
// as columns left of the pivot die.  Each thread's RY x RX tile is a
// statically indexed array: the pivot loop is unrolled over the tile's row
// index, which also makes "columns left of the pivot's block" a
// compile-time skip.  A row's threads are one warp, so column k never
// leaves the warp: each thread takes its RY column values by shuffle from
// the lane that owns column k, with no shared memory and no barrier.  Row
// k does cross warps: the warp that owns it fetches the pivot by shuffle,
// scales the row by its reciprocal and publishes it into a double-buffered
// stash in shared memory; every thread reads up to RX row values
// (conflict-free) and does its FMAs from registers: no division, no index
// arithmetic, ~0.1 shared accesses per FMA.  The step's one barrier is
// split (an mbarrier): within step k a thread first updates the next
// pivot's row, the owner publishes it, all arrive, and only then comes
// the rest of the FMAs, so that the next pivot's shuffle, reciprocal and
// stores are not behind them.
//
// Regime 2, larger systems (up to P = 1024, the sizes global bundle
// adjustment sends): blocked Gauss-Jordan over many SMs on a zero-padded
// working copy in device memory (L2-resident; the wrapper allocates it).
// For each panel of 32 pivots, (a) one block per 64-column tile of the live
// columns eliminates inside the panel's 32 rows -- the 32 x 32 diagonal
// block redundantly, its own tile for real -- in registers with a
// one-barrier stash, and writes back the normalised pivot rows R; (b) a
// grid of 64 x 64 tiles over all other rows does the rank-32 update
// M[i, rest] -= M[i, panel] R[:, rest] from shared-memory tiles with a 4 x 4
// register block per thread.  2 P / 32 + 2 short launches on one stream in
// place of P single-SM passes over the whole system.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py; back-to-back solves from Python): float32 P = 171
// 0.058 ms, P = 1024 0.37 ms; float64 P = 171 0.088 ms, P = 1024 0.53 ms.
// A register-regime step costs ~620 clocks at P = 171, of which the FMAs
// are under 200: the rest is the barrier round trip, the column's
// shuffles, the stash's latency and the pivot's shuffle and reciprocal,
// each paid once per pivot and one after the other
// (scripts/torch_gj_step_cost.py takes the step apart).  The blocked
// regime is bound by its launches (~5 us each) up to P ~ 500.  PERF.md
// keeps the full table.

#include <cuda_runtime.h>

#include <utility>

namespace {

// ---------------------------------------------------------------------------
// Regime 1: register-resident, one block.
// ---------------------------------------------------------------------------

constexpr int kTY = 16;                 // thread grid: rows
constexpr int kTX = 32;                 // thread grid: columns (= one warp)
constexpr int kRegThreads = kTY * kTX;

template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };

// Correctly rounded reciprocal: what T(1) / x gives, in fewer instructions.
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// A split block-wide barrier (an mbarrier in shared memory): a warp arrives
// as soon as its part of the next step is in the stash and goes on
// working; it waits only where it needs the others' parts.  Arriving
// releases the warp's earlier loads and stores, waiting acquires them.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))), "r"(count));
}

__device__ __forceinline__ void mbar_arrive_warp(unsigned long long* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::
                 "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}" ::
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))), "r"(parity) : "memory");
}

// Publish the row of pivot step k = II * kTY + t, scaled by the pivot's
// reciprocal.  Row k belongs to the warp ty == t and the pivot to its lane
// txk; both tile indices (II, JJ) are compile-time constants.
template <typename T, int RY, int RX, int II>
__device__ __forceinline__ void gj_reg_publish(T (&m)[RY][RX], T* row,
                                               int t, int tx, int ty) {
  constexpr int JJ = II / 2;            // kTX == 2 * kTY
  if (ty == t) {
    const T inv = rcp(__shfl_sync(0xffffffffu, m[II][JJ], (II % 2) * kTY + t));
#pragma unroll
    for (int jj = JJ; jj < RX; ++jj) {
      m[II][jj] *= inv;
      row[jj * kTX + tx] = m[II][jj];
    }
  }
}

// The step's update of the live columns (tile columns >= JJ): with FIRST,
// only tile row RW, which holds the next pivot's row; without, the rest.
template <typename T, int RY, int RX, int JJ, int RW, bool FIRST>
__device__ __forceinline__ void gj_reg_update(T (&m)[RY][RX], const T (&c)[RY],
                                              const T (&r)[RX]) {
#pragma unroll
  for (int ii = 0; ii < RY; ++ii)
#pragma unroll
    for (int jj = JJ; jj < RX; ++jj)
      if ((ii == RW) == FIRST) m[ii][jj] -= c[ii] * r[jj];
}

// The kTY pivot steps whose row lives at tile index II.  A step takes its
// column from the owning lane of each warp by shuffle (a row's threads are
// one warp, so the column never leaves it) and its row from the stash;
// it updates the next pivot's row first, publishes that into the stash's
// other half and arrives, and only then does the rest of its update: the
// next pivot's shuffle, reciprocal and stores overlap with the other
// warps' FMAs.
template <typename T, int RY, int RX, int II>
__device__ __forceinline__ void gj_reg_rows(T (&m)[RY][RX], T* rowst,
                                            unsigned long long* bar,
                                            int P, int tx, int ty) {
  constexpr int JJ = II / 2;
  constexpr int IN = II + 1;            // the next tile row
  constexpr int kRow = RX * kTX;
  const int steps = min(kTY, P - II * kTY);
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    T c[RY], r[RX];
#pragma unroll
    for (int ii = 0; ii < RY; ++ii)
      c[ii] = __shfl_sync(0xffffffffu, m[ii][JJ], (II % 2) * kTY + t);
    if (ty == t) c[II] = T(0);          // row k itself is not updated
    mbar_wait(bar, buf);                // step k's row is in the stash
#pragma unroll
    for (int jj = JJ; jj < RX; ++jj) r[jj] = rowst[buf * kRow + jj * kTX + tx];

    T* nrow = rowst + (buf ^ 1) * kRow;
    const bool more = II * kTY + t + 1 < P;
    if (t + 1 < kTY) {
      gj_reg_update<T, RY, RX, JJ, II, true>(m, c, r);
      if (more) gj_reg_publish<T, RY, RX, II>(m, nrow, t + 1, tx, ty);
      mbar_arrive_warp(bar);
      gj_reg_update<T, RY, RX, JJ, II, false>(m, c, r);
    } else if constexpr (IN < RY) {
      gj_reg_update<T, RY, RX, JJ, IN, true>(m, c, r);
      if (more) gj_reg_publish<T, RY, RX, IN>(m, nrow, 0, tx, ty);
      mbar_arrive_warp(bar);
      gj_reg_update<T, RY, RX, JJ, IN, false>(m, c, r);
    } else {
      gj_reg_update<T, RY, RX, JJ, -1, false>(m, c, r);
    }
  }
}

template <typename T, int RY, int RX, int... II>
__device__ __forceinline__ void gj_reg_all(T (&m)[RY][RX], T* rowst,
                                           unsigned long long* bar,
                                           int P, int tx, int ty,
                                           std::integer_sequence<int, II...>) {
  (gj_reg_rows<T, RY, RX, II>(m, rowst, bar, P, tx, ty), ...);
}

template <typename T, int RY, int RX>
__global__ void __launch_bounds__(kRegThreads, 1)
gj_reg_kernel(const T* __restrict__ A, const T* __restrict__ b,
              T* __restrict__ x, int P) {
  static_assert(2 * RX >= RY, "the pivot column's tile index must exist");
  __shared__ T rowst[2 * RX * kTX];
  __shared__ unsigned long long bar;
  if (threadIdx.x == 0) mbar_init(&bar, kRegThreads / 32);
  __syncthreads();
  const int tx = threadIdx.x & (kTX - 1);
  const int ty = threadIdx.x / kTX;

  T m[RY][RX];
#pragma unroll
  for (int ii = 0; ii < RY; ++ii) {
    const int i = ii * kTY + ty;
#pragma unroll
    for (int jj = 0; jj < RX; ++jj) {
      const int j = jj * kTX + tx;
      T v = T(0);
      if (i < P) {
        if (j < P) v = A[i * P + j];
        else if (j == P) v = b[i];
      }
      m[ii][jj] = v;
    }
  }

  gj_reg_publish<T, RY, RX, 0>(m, rowst, 0, tx, ty);
  mbar_arrive_warp(&bar);
  gj_reg_all<T, RY, RX>(m, rowst, &bar, P, tx, ty,
                        std::make_integer_sequence<int, RY>{});

  if (tx == P % kTX) {                  // the owners of the b column
    const int jjP = P / kTX;
#pragma unroll
    for (int ii = 0; ii < RY; ++ii) {
      T v = T(0);
#pragma unroll
      for (int jj = 0; jj < RX; ++jj)
        if (jj == jjP) v = m[ii][jj];
      const int i = ii * kTY + ty;
      if (i < P) x[i] = v;
    }
  }
}

template <typename T, int RY, int RX>
void launch_reg(const T* A, const T* b, T* x, int P, cudaStream_t stream) {
  gj_reg_kernel<T, RY, RX><<<1, kRegThreads, 0, stream>>>(A, b, x, P);
}

// Largest P the register file holds (a tile of RY x RX covers P <= 16 RY
// and P + 1 <= 32 RX): 11 x 6 floats, 8 x 4 doubles per thread.
template <typename T> constexpr int kRegMaxP = 0;
template <> constexpr int kRegMaxP<float> = 176;
template <> constexpr int kRegMaxP<double> = 127;

template <typename T>
void launch_registers(const T* A, const T* b, T* x, int P, cudaStream_t stream) {
  if (P <= 127) launch_reg<T, 8, 4>(A, b, x, P, stream);
  else if constexpr (kRegMaxP<T> > 127) launch_reg<T, 11, 6>(A, b, x, P, stream);
}

// ---------------------------------------------------------------------------
// Regime 2: blocked over many SMs on a padded working copy M (nr x ld):
// the system padded with an identity block to n = a multiple of kNB, b in
// column n, zeros elsewhere, so that no tile needs a mask.
// ---------------------------------------------------------------------------

constexpr int kNB = 32;                 // pivots per panel
constexpr int kTN = 64;                 // column tile
constexpr int kTM = 64;                 // row tile of the update
constexpr int kPanelW = kNB + kTN;      // diagonal block + one column tile
constexpr int kPanelRows = 8;           // rows per thread in the panel kernel
constexpr int kPanelThreads = kPanelW * (kNB / kPanelRows);
constexpr int kUpdateThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each

struct Blocked { int n, nr, ld; };

Blocked blocked_shape(int P) {
  Blocked s;
  s.n = (P + kNB - 1) / kNB * kNB;
  s.nr = (s.n + kTM - 1) / kTM * kTM;
  s.ld = s.n + kTN;
  return s;
}

template <typename T>
__global__ void gj_blk_prep(const T* __restrict__ A, const T* __restrict__ b,
                            T* __restrict__ M, int P, int n, int ld) {
  const int i = blockIdx.x;
  for (int j = threadIdx.x; j < ld; j += blockDim.x) {
    T v = T(0);
    if (i < P) {
      if (j < P) v = A[static_cast<size_t>(i) * P + j];
      else if (j == n) v = b[i];
    } else if (i < n && j == i) {
      v = T(1);
    }
    M[static_cast<size_t>(i) * ld + j] = v;
  }
}

// Panel kb: block t eliminates [D | M[kb:kb+32, c0:c0+64]] with D the
// diagonal block, and writes the normalised rows back over its tile.
// Thread (rg, j) holds rows rg*8 .. rg*8+7 of column j in registers.
template <typename T>
__global__ void __launch_bounds__(kPanelThreads)
gj_blk_panel(T* __restrict__ M, int ld, int kb) {
  __shared__ T colst[2][kNB];
  __shared__ T rowst[2][kPanelW];
  const int j = threadIdx.x % kPanelW;
  const int rg = threadIdx.x / kPanelW;
  const int c0 = kb + kNB + kTN * blockIdx.x;
  const int gj = j < kNB ? kb + j : c0 + (j - kNB);
  T* base = M + static_cast<size_t>(kb + rg * kPanelRows) * ld + gj;

  T m[kPanelRows];
#pragma unroll
  for (int rr = 0; rr < kPanelRows; ++rr) m[rr] = base[static_cast<size_t>(rr) * ld];

#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    const int buf = k & 1;
    if (rg == k / kPanelRows) rowst[buf][j] = m[k % kPanelRows];
    if (j == k) {
#pragma unroll
      for (int rr = 0; rr < kPanelRows; ++rr) colst[buf][rg * kPanelRows + rr] = m[rr];
    }
    __syncthreads();
    const T r = rowst[buf][j] * (T(1) / colst[buf][k]);
#pragma unroll
    for (int rr = 0; rr < kPanelRows; ++rr) {
      const T c = colst[buf][rg * kPanelRows + rr];
      m[rr] = (rg * kPanelRows + rr == k) ? r : m[rr] - c * r;
    }
  }

  if (j >= kNB) {
#pragma unroll
    for (int rr = 0; rr < kPanelRows; ++rr) base[static_cast<size_t>(rr) * ld] = m[rr];
  }
}

// Rank-32 update of one 64 x 64 tile: C -= M[i0:i0+64, kb:kb+32] R, with
// R = M[kb:kb+32, c0:c0+64] the panel's normalised rows.  The panel's own
// rows keep R.
template <typename T>
__global__ void __launch_bounds__(kUpdateThreads)
gj_blk_update(T* __restrict__ M, int ld, int kb) {
  __shared__ T As[kTM][kNB + 1];
  __shared__ Vec4<T> Rs[kNB][kTN / 4];
  const int c0 = kb + kNB + kTN * blockIdx.x;
  const int i0 = kTM * blockIdx.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  for (int e = threadIdx.x; e < kTM * kNB; e += kUpdateThreads) {
    const int row = e / kNB, kk = e % kNB;
    As[row][kk] = M[static_cast<size_t>(i0 + row) * ld + kb + kk];
  }
  for (int e = threadIdx.x; e < kNB * (kTN / 4); e += kUpdateThreads) {
    const int kk = e / (kTN / 4), q = e % (kTN / 4);
    Rs[kk][q] = *reinterpret_cast<const Vec4<T>*>(
        M + static_cast<size_t>(kb + kk) * ld + c0 + 4 * q);
  }
  __syncthreads();

  const int r0 = i0 + 4 * ty;
  if (r0 >= kb && r0 < kb + kNB) return;   // the panel's own rows

  T acc[4][4] = {};
#pragma unroll 8
  for (int kk = 0; kk < kNB; ++kk) {
    const Vec4<T> rv = Rs[kk][tx];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T av = As[4 * ty + a][kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] += av * rv.v[c];
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    Vec4<T>* p = reinterpret_cast<Vec4<T>*>(
        M + static_cast<size_t>(r0 + a) * ld + c0 + 4 * tx);
    Vec4<T> cv = *p;
#pragma unroll
    for (int c = 0; c < 4; ++c) cv.v[c] -= acc[a][c];
    *p = cv;
  }
}

template <typename T>
__global__ void gj_blk_extract(const T* __restrict__ M, T* __restrict__ x,
                               int P, int n, int ld) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P) x[i] = M[static_cast<size_t>(i) * ld + n];
}

template <typename T>
cudaError_t launch_blocked(const T* A, const T* b, T* x, T* M, int P,
                           cudaStream_t stream) {
  if (M == nullptr) return cudaErrorInvalidValue;
  const Blocked s = blocked_shape(P);
  gj_blk_prep<T><<<s.nr, 256, 0, stream>>>(A, b, M, P, s.n, s.ld);
  cudaError_t err = cudaGetLastError();
  for (int kb = 0; kb < s.n && err == cudaSuccess; kb += kNB) {
    const int tiles = (s.n + 1 - (kb + kNB) + kTN - 1) / kTN;
    gj_blk_panel<T><<<tiles, kPanelThreads, 0, stream>>>(M, s.ld, kb);
    gj_blk_update<T><<<dim3(tiles, s.nr / kTM), kUpdateThreads, 0, stream>>>(M, s.ld, kb);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  gj_blk_extract<T><<<(P + 255) / 256, 256, 0, stream>>>(M, x, P, s.n, s.ld);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* A, const T* b, T* x, T* work, int P, cudaStream_t stream) {
  if (P < 1 || P > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (P <= kRegMaxP<T>) {
    launch_registers<T>(A, b, x, P, stream);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(launch_blocked<T>(A, b, x, work, P, stream));
}

}  // namespace

extern "C" {

// A (P, P) and b (P,) contiguous on the device, x (P,) output, work the
// scratch of gj_solve_work_elems(P, sizeof element) values (may be null
// when that is 0).  Launches on `stream`, does not synchronise.  Returns
// the CUDA error code of the launch (0 on success).
int gj_solve_f32(const float* A, const float* b, float* x, float* work,
                 int P, void* stream) {
  return launch<float>(A, b, x, work, P, static_cast<cudaStream_t>(stream));
}

int gj_solve_f64(const double* A, const double* b, double* x, double* work,
                 int P, void* stream) {
  return launch<double>(A, b, x, work, P, static_cast<cudaStream_t>(stream));
}

// Number of scratch values gj_solve_* needs for a P-sized system of
// `elem_bytes`-wide values: 0 in regime 1 (registers, one block), the
// padded working copy in regime 2 (blocked, many blocks).
long long gj_solve_work_elems(int P, int elem_bytes) {
  const int reg_max = elem_bytes == 4 ? kRegMaxP<float> : kRegMaxP<double>;
  if (P <= reg_max) return 0;
  const Blocked s = blocked_shape(P);
  return static_cast<long long>(s.nr) * s.ld;
}

const char* gj_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
