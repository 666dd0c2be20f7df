// IMU preintegration for Hopper (sm_90a), float32 and float64: the masked
// M-step midpoint recurrence of vio_tpu_torch/imu.py (the plain version,
// preintegrate_reference with midpoint_step; integration_base.h:54-128)
// for B independent intervals in one launch.  It returns the same leaves:
// the mean (delta p, q, v), the bias Jacobian J, the covariance C, sum dt,
// the linearisation biases and the last sample.
//
// Replaces no Pallas kernel: vio_tpu/imu.py's preintegrate is a lax.scan
// that XLA fuses into one loop.  The port's plain version is a Python loop
// over the bucket's M slots, masked ones included, of ~245 small kernels
// a slot: in the estimator's head graph ~11,500 graph nodes a frame at the
// benchmark cell's M ~ 47, the largest single block of the frame's device
// time.  The estimator calls it once a frame on the window's W intervals,
// and the initialiser eagerly on its own interval count.
//
// What bounds it: neither bytes nor operations.  One live step of the
// block-structured recurrence below is 12,112 operations (a multiply or an
// add each) with the exact noise model and 9,187 without: the mean 152
// (one thread), the step's F and V blocks 467, F J and F C 2,025 each
// (rows 0-8 only: F's rows 9-14 are identity rows), (F C) F^T 2,025,
// V N V^T 2,268 over V's nonzero blocks, the sums 225; with the exact
// model also F X 810, F X V^T and its transpose 1,620, their sums 450 and
// the next X 45.  On ~60 bytes of input a step, W = 10 intervals of 48
// steps are ~6 MFLOP, ~0.2 us of the card's float64 peak.  The time is
// the chain: the rotation, J and C of a step each need the step before,
// so a call costs M times the latency of one step, and the design is about
// that latency.
//
// Design.  One block of 384 threads per interval (leading dims flattened);
// a loop over the live steps inside the block, with J, C (15 x 15) and the
// shared-sample correlation X (15 x 18, of which columns 0-5 are nonzero:
// stored 15 x 6) in shared memory across steps.  F and V are never formed:
// each step keeps their nonzero 3 x 3 blocks (seven of F and six of V;
// the rest are I, dt I, 0.5 dt I or 0), and every product reads them by
// block.  A live step is two phases and two barriers, the fewest for
// C <- F C F^T: (1) F C and F J, rows 0-8, one output a thread (270
// threads), and F X (54 threads); (2) C' = (F C) F^T + V N V^T
// [+ F X V^T + (F X V^T)^T], one output a thread (225), and X for the next
// step from this step's V.  J and C are double-buffered by step parity,
// so no phase reads what it writes.  The mean and the blocks run one step
// ahead, beside the products, on warp 11, which the products leave idle:
// in phase (1) of step i its lane 0 advances the mean through step i + 1
// (the rotation's chain, one thread), and in phase (2) nine lanes build
// step i + 1's F and V blocks from it, each one entry of every block.
// Masked steps are skipped (the carry is left exactly as it was); the mask
// need not be a prefix: __syncthreads_count gives the block its live-step
// count, and the lead lane walks the mask.  The lead lane's sample loads
// are on the chain, so the interval's inputs are first prefetched into L1.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 384;   // 12 warps; products use warps 0-9
constexpr int kLead = 352;      // warp 11: lane 0 the mean, lanes 0-8 the blocks

// One live step's coefficients.
template <typename T> struct Step {
  T dt, hdt;                     // dt and 0.5 dt
  T q0[4], q1[4];                // the rotation before and after the step
  T a0[3], a1[3], w[3];          // acc0 - ba, acc1 - ba, midpoint gyro - bg
  // F's blocks other than I and dt I, row-major: F[0:3, 3:6], F[0:3, 9:12],
  // F[0:3, 12:15], F[3:6, 3:6], F[6:9, 3:6], F[6:9, 9:12], F[6:9, 12:15]
  T f01[9], f03[9], f04[9], f11[9], f21[9], f23[9], f24[9];
  // V's blocks other than multiples of I: V[0:3, 0:3], V[0:3, 3:6]
  // (= V[0:3, 9:12]), V[0:3, 6:9], V[6:9, 0:3], V[6:9, 3:6] (= V[6:9, 9:12]),
  // V[6:9, 6:9]
  T v00[9], v01[9], v02[9], v20[9], v21[9], v22[9];
};

template <typename T> struct Shared {
  T J[2][225];      // d(preint)/d(bias at start), by step parity
  T C[2][225];      // covariance, by step parity
  T FC[135];        // rows 0-8 of F C; rows 9-14 are C's
  T FX[54];         // rows 0-8 of F X; rows 9-14 are 0
  T X[90];          // columns 0-5 of X (15 x 6); the rest are 0
  T n[18];          // the noise diagonal
  Step<T> st[2];    // coefficients, by step parity
  // the mean, advanced by the lead lane one step ahead of J and C
  T p[3], v[3], q[4], sum_dt, acc[3], gyr[3], ba[3], bg[3];
  int next;         // the first sample the lead lane has not looked at
};

template <typename T> struct Args {
  const T* dts;                  // (B, M)
  const T* accs;                 // (B, M, 3)
  const T* gyrs;                 // (B, M, 3)
  const unsigned char* mask;     // (B, M) bool
  const T *acc0, *gyr0, *ba, *bg;  // (B, 3)
  const T* noise;                // (18,)
  T *delta_p, *delta_q, *delta_v, *jacobian, *covariance, *sum_dt;
  T *lin_ba, *lin_bg, *acc_last, *gyr_last;
  int M;
  int exact;                     // propagate X (the exact noise model)
};

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// v rotated by the unit quaternion q (x, y, z, w): lie.quat_rotate.
template <typename T>
__device__ __forceinline__ void quat_rotate(const T* q, const T* v, T* o) {
  T t[3], u[3];
  cross3(q, v, t);
  for (int l = 0; l < 3; ++l) t[l] *= T(2);
  cross3(q, t, u);
  for (int l = 0; l < 3; ++l) o[l] = v[l] + q[3] * t[l] + u[l];
}

// The Hamilton product q (x) p: lie.quat_mul.
template <typename T>
__device__ __forceinline__ void quat_mul(const T* q, const T* p, T* o) {
  o[0] = q[3] * p[0] + q[0] * p[3] + q[1] * p[2] - q[2] * p[1];
  o[1] = q[3] * p[1] - q[0] * p[2] + q[1] * p[3] + q[2] * p[0];
  o[2] = q[3] * p[2] + q[0] * p[1] - q[1] * p[0] + q[2] * p[3];
  o[3] = q[3] * p[3] - q[0] * p[0] - q[1] * p[1] - q[2] * p[2];
}

// lie.quat_to_mat, row-major.
template <typename T>
__device__ __forceinline__ void quat_to_mat(const T* q, T* m) {
  const T x = q[0], y = q[1], z = q[2], w = q[3];
  const T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  m[0] = T(1) - T(2) * (yy + zz); m[1] = T(2) * (xy - wz); m[2] = T(2) * (xz + wy);
  m[3] = T(2) * (xy + wz); m[4] = T(1) - T(2) * (xx + zz); m[5] = T(2) * (yz - wx);
  m[6] = T(2) * (xz - wy); m[7] = T(2) * (yz + wx); m[8] = T(1) - T(2) * (xx + yy);
}

// Entry (r, c) of the skew matrix [v]x = [[0, -v2, v1], [v2, 0, -v0],
// [-v1, v0, 0]]: lie.so3_hat.
template <typename T>
__device__ __forceinline__ T hat(const T* v, int r, int c) {
  if (r == c) return T(0);
  const T x = v[3 - r - c];
  return (c - r + 3) % 3 == 1 ? -x : x;
}

// v[k] for k in 0-2 by selects, so that an array indexed by a lane's row
// or column stays in registers (an indexed local array goes to the stack).
template <typename T>
__device__ __forceinline__ T pick3(const T* v, int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : v[2];
}

template <typename T>
__device__ __forceinline__ T dot3(const T* f, const T* x, int sx) {
  return f[0] * x[0] + f[1] * x[sx] + f[2] * x[2 * sx];
}

// sum_l F(i, l) x[l sx]: row i of the step's F against a 15-vector read
// with stride sx, by F's blocks.
template <typename T>
__device__ __forceinline__ T f_row(const Step<T>& st, int i, const T* x, int sx) {
  const int r = i % 3, o = 3 * r;
  switch (i / 3) {
    case 0:
      return x[r * sx] + dot3(st.f01 + o, x + 3 * sx, sx) + st.dt * x[(6 + r) * sx]
             + dot3(st.f03 + o, x + 9 * sx, sx) + dot3(st.f04 + o, x + 12 * sx, sx);
    case 1:
      return dot3(st.f11 + o, x + 3 * sx, sx) - st.dt * x[(12 + r) * sx];
    case 2:
      return dot3(st.f21 + o, x + 3 * sx, sx) + x[(6 + r) * sx]
             + dot3(st.f23 + o, x + 9 * sx, sx) + dot3(st.f24 + o, x + 12 * sx, sx);
    default:
      return x[i * sx];
  }
}

// Row i of V over its column block cb, three values; false where that
// block of V is zero.
template <typename T>
__device__ __forceinline__ bool v_row(const Step<T>& st, int i, int cb, T* o) {
  const int r = i % 3, rb = i / 3;
  if (rb == 0 || rb == 2) {
    const T* blk;
    if (cb == 0) blk = rb == 0 ? st.v00 : st.v20;
    else if (cb == 1 || cb == 3) blk = rb == 0 ? st.v01 : st.v21;
    else if (cb == 2) blk = rb == 0 ? st.v02 : st.v22;
    else return false;
    o[0] = blk[3 * r]; o[1] = blk[3 * r + 1]; o[2] = blk[3 * r + 2];
    return true;
  }
  T d;   // rows 3-5: 0.5 dt I in column blocks 1 and 3; rows 9-14: dt I
  if (rb == 1 && (cb == 1 || cb == 3)) d = st.hdt;
  else if (rb >= 3 && cb == rb + 1) d = st.dt;
  else return false;
  o[0] = r == 0 ? d : T(0);
  o[1] = r == 1 ? d : T(0);
  o[2] = r == 2 ? d : T(0);
  return true;
}

// (V N V^T)(i, j) over the column blocks both rows have.
template <typename T>
__device__ __forceinline__ T vnv(const Step<T>& st, const T* n, int i, int j) {
  T acc = T(0), a[3], b[3];
#pragma unroll
  for (int cb = 0; cb < 6; ++cb)
    if (v_row(st, i, cb, a) && v_row(st, j, cb, b))
      acc += a[0] * n[3 * cb] * b[0] + a[1] * n[3 * cb + 1] * b[1]
             + a[2] * n[3 * cb + 2] * b[2];
  return acc;
}

// (F X V^T)(i, j): X's nonzero columns 0-5 meet V's column blocks 0 and 1.
template <typename T>
__device__ __forceinline__ T fxv(const Step<T>& st, const T* FX, int i, int j) {
  if (i >= 9) return T(0);
  T acc = T(0), b[3];
#pragma unroll
  for (int cb = 0; cb < 2; ++cb)
    if (v_row(st, j, cb, b))
      acc += FX[6 * i + 3 * cb] * b[0] + FX[6 * i + 3 * cb + 1] * b[1]
             + FX[6 * i + 3 * cb + 2] * b[2];
  return acc;
}

// The fresh carry (imu.init_state), X = 0, the noise diagonal.
template <typename T>
__device__ void init(Shared<T>& s, const Args<T>& a, int b, int t) {
  for (int e = t; e < 225; e += kThreads) {
    const T id = e / 15 == e % 15 ? T(1) : T(0);
    s.J[0][e] = id;
    s.J[1][e] = id;    // rows 9-14 of J never change: F's are identity rows
    s.C[0][e] = T(0);
  }
  if (t < 90) s.X[t] = T(0);
  if (t < 18) s.n[t] = a.noise[t];
  if (t == kLead) {
    for (int l = 0; l < 3; ++l) {
      s.p[l] = s.v[l] = s.q[l] = T(0);
      s.acc[l] = a.acc0[3 * b + l];
      s.gyr[l] = a.gyr0[3 * b + l];
      s.ba[l] = a.ba[3 * b + l];
      s.bg[l] = a.bg[3 * b + l];
    }
    s.q[3] = T(1);
    s.sum_dt = T(0);
    s.next = 0;
  }
}

// The lead lane: the mean through live step i (the next unmasked sample),
// into the carry and into step i's coefficients.
template <typename T>
__device__ void mean_step(Shared<T>& s, const Args<T>& a, int b, int i) {
  const size_t base = static_cast<size_t>(b) * a.M;
  int k = s.next;
  while (!a.mask[base + k]) ++k;      // the caller counted i < live steps
  s.next = k + 1;
  Step<T>& st = s.st[i & 1];
  const T dt = a.dts[base + k];
  T acc1[3], gyr1[3], ua0[3], ua1[3], dq[4];
  for (int l = 0; l < 3; ++l) {
    acc1[l] = a.accs[3 * (base + k) + l];
    gyr1[l] = a.gyrs[3 * (base + k) + l];
  }
  for (int l = 0; l < 3; ++l) {
    st.a0[l] = s.acc[l] - s.ba[l];
    st.a1[l] = acc1[l] - s.ba[l];
    st.w[l] = T(0.5) * (s.gyr[l] + gyr1[l]) - s.bg[l];
  }
  for (int l = 0; l < 4; ++l) st.q0[l] = s.q[l];
  quat_rotate(st.q0, st.a0, ua0);
  const T h = T(0.5) * dt;
  for (int l = 0; l < 3; ++l) dq[l] = st.w[l] * h;
  dq[3] = T(1);
  quat_mul(st.q0, dq, st.q1);
  const T inv = T(1) / sqrt_(st.q1[0] * st.q1[0] + st.q1[1] * st.q1[1]
                             + st.q1[2] * st.q1[2] + st.q1[3] * st.q1[3]);
  for (int l = 0; l < 4; ++l) st.q1[l] *= inv;
  quat_rotate(st.q1, st.a1, ua1);
  for (int l = 0; l < 3; ++l) {
    const T ua = T(0.5) * (ua0[l] + ua1[l]);
    s.p[l] = s.p[l] + s.v[l] * dt + T(0.5) * ua * dt * dt;
    s.v[l] = s.v[l] + ua * dt;
    s.acc[l] = acc1[l];
    s.gyr[l] = gyr1[l];
  }
  for (int l = 0; l < 4; ++l) s.q[l] = st.q1[l];
  s.sum_dt += dt;
  st.dt = dt;
  st.hdt = T(0.5) * dt;
}

// Entry e = 3 r + c of every F and V block of a step whose mean is in st
// (nine lanes, one entry each).
template <typename T>
__device__ void build_blocks(Step<T>& st, int e) {
  const int r = e / 3, c = e % 3;
  T R0[9], R1[9], r0[3], r1[3], r1a1[3];
  quat_to_mat(st.q0, R0);
  quat_to_mat(st.q1, R1);
  for (int l = 0; l < 3; ++l) {          // row r of each
    r0[l] = r == 0 ? R0[l] : r == 1 ? R0[3 + l] : R0[6 + l];
    r1[l] = r == 0 ? R1[l] : r == 1 ? R1[3 + l] : R1[6 + l];
  }
  const T dt = st.dt, dt2 = dt * dt;
  for (int m = 0; m < 3; ++m) {          // row r of R1 [a1]x
    T acc = T(0);
    for (int l = 0; l < 3; ++l) acc += r1[l] * hat(st.a1, l, m);
    r1a1[m] = acc;
  }
  T r0a0 = T(0), g = T(0);               // (R0 [a0]x)(r, c), (R1 [a1]x (I - [w]x dt))(r, c)
  for (int l = 0; l < 3; ++l) {
    r0a0 += r0[l] * hat(st.a0, l, c);
    g += r1a1[l] * ((l == c ? T(1) : T(0)) - hat(st.w, l, c) * dt);
  }
  const T R0e = pick3(r0, c), R1e = pick3(r1, c), b1 = pick3(r1a1, c);
  const T s01 = R0e + R1e;
  st.f01[e] = T(-0.25) * r0a0 * dt2 - T(0.25) * g * dt2;
  st.f03[e] = T(-0.25) * s01 * dt2;
  st.f04[e] = T(0.25) * b1 * dt2 * dt;
  st.f11[e] = (r == c ? T(1) : T(0)) - hat(st.w, r, c) * dt;
  st.f21[e] = T(-0.5) * r0a0 * dt - T(0.5) * g * dt;
  st.f23[e] = T(-0.5) * s01 * dt;
  st.f24[e] = T(0.5) * b1 * dt2;
  st.v00[e] = T(0.25) * R0e * dt2;
  st.v01[e] = T(-0.125) * b1 * dt2 * dt;
  st.v02[e] = T(0.25) * R1e * dt2;
  st.v20[e] = T(0.5) * R0e * dt;
  st.v21[e] = T(-0.25) * b1 * dt2;
  st.v22[e] = T(0.5) * R1e * dt;
}

// Phase (1) of live step i: F C and F J (rows 0-8), F X.
template <typename T>
__device__ void phase_f(Shared<T>& s, int i, int t, int exact) {
  const Step<T>& st = s.st[i & 1];
  if (t < 135) {
    s.FC[t] = f_row(st, t / 15, s.C[i & 1] + t % 15, 15);
  } else if (t < 270) {
    const int u = t - 135;
    s.J[(i + 1) & 1][u] = f_row(st, u / 15, s.J[i & 1] + u % 15, 15);
  } else if (exact && t < 324) {
    const int u = t - 270;
    s.FX[u] = f_row(st, u / 6, s.X + u % 6, 6);
  }
}

// Phase (2) of live step i: C' = (F C) F^T + V N V^T [+ F X V^T + its
// transpose], and the next step's X = [V[:, 6:9] n0, V[:, 9:12] n3].
template <typename T>
__device__ void phase_cov(Shared<T>& s, int i, int t, int exact) {
  const Step<T>& st = s.st[i & 1];
  if (t < 225) {
    const int r = t / 15, c = t % 15;
    const T* fc = r < 9 ? s.FC + 15 * r : s.C[i & 1] + 15 * r;   // row r of F C
    T x = f_row(st, c, fc, 1) + vnv(st, s.n, r, c);
    if (exact) x += fxv(st, s.FX, r, c) + fxv(st, s.FX, c, r);
    s.C[(i + 1) & 1][t] = x;
  } else if (exact && t < 315) {
    const int u = t - 225, m = u % 6;
    T o[3];
    s.X[u] = v_row(st, u / 6, m < 3 ? 2 : 3, o) ? (m < 3 ? s.n[0] : s.n[3]) * pick3(o, m % 3)
                                                 : T(0);
  }
}

// The carry after n_live steps to the outputs.
template <typename T>
__device__ void store(const Shared<T>& s, const Args<T>& a, int b, int t, int n_live) {
  const T* J = s.J[n_live & 1];
  const T* C = s.C[n_live & 1];
  const size_t o = static_cast<size_t>(b) * 225;
  for (int e = t; e < 225; e += kThreads) {
    a.jacobian[o + e] = J[e];
    a.covariance[o + e] = C[e];
  }
  if (t == kLead) {
    for (int l = 0; l < 3; ++l) {
      a.delta_p[3 * b + l] = s.p[l];
      a.delta_v[3 * b + l] = s.v[l];
      a.lin_ba[3 * b + l] = s.ba[l];
      a.lin_bg[3 * b + l] = s.bg[l];
      a.acc_last[3 * b + l] = s.acc[l];
      a.gyr_last[3 * b + l] = s.gyr[l];
    }
    for (int l = 0; l < 4; ++l) a.delta_q[4 * b + l] = s.q[l];
    a.sum_dt[b] = s.sum_dt;
  }
}

// Ask for the lines of [p, p + bytes) in L1, spread over the block.
__device__ __forceinline__ void prefetch_l1(const void* p, size_t bytes, int t) {
  const char* c = static_cast<const char*>(p);
  for (size_t o = static_cast<size_t>(t) * 128; o < bytes; o += kThreads * 128)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(c + o));
  if (t == 0 && bytes > 0) asm volatile("prefetch.global.L1 [%0];" ::"l"(c + bytes - 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) preintegrate_kernel(const Args<T> a) {
  __shared__ Shared<T> s;
  const int t = threadIdx.x, b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * a.M;
  prefetch_l1(a.dts + base, a.M * sizeof(T), t);
  prefetch_l1(a.accs + 3 * base, 3 * a.M * sizeof(T), t);
  prefetch_l1(a.gyrs + 3 * base, 3 * a.M * sizeof(T), t);
  prefetch_l1(a.mask + base, a.M, t);
  init(s, a, b, t);
  int n_live = 0;
  for (int k0 = 0; k0 < a.M; k0 += kThreads) {
    const int k = k0 + t;
    n_live += __syncthreads_count(k < a.M && a.mask[base + k]);
  }
  __syncthreads();
  if (n_live > 0) {
    if (t == kLead) mean_step(s, a, b, 0);
    __syncthreads();
    if (t >= kLead && t < kLead + 9) build_blocks(s.st[0], t - kLead);
    __syncthreads();
  }
  for (int i = 0; i < n_live; ++i) {
    phase_f(s, i, t, a.exact);
    if (t == kLead && i + 1 < n_live) mean_step(s, a, b, i + 1);
    __syncthreads();
    phase_cov(s, i, t, a.exact);
    if (t >= kLead && t < kLead + 9 && i + 1 < n_live)
      build_blocks(s.st[(i + 1) & 1], t - kLead);
    __syncthreads();
  }
  store(s, a, b, t, n_live);
}

template <typename T>
int launch(const T* dts, const T* accs, const T* gyrs, const unsigned char* mask,
           const T* acc0, const T* gyr0, const T* ba, const T* bg, const T* noise,
           T* delta_p, T* delta_q, T* delta_v, T* jacobian, T* covariance, T* sum_dt,
           T* lin_ba, T* lin_bg, T* acc_last, T* gyr_last, int B, int M, int exact,
           cudaStream_t stream) {
  const Args<T> a{dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise,
                  delta_p, delta_q, delta_v, jacobian, covariance, sum_dt,
                  lin_ba, lin_bg, acc_last, gyr_last, M, exact};
  preintegrate_kernel<T><<<B, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B intervals of M samples, every array contiguous on the device: dts
// (B, M), accs and gyrs (B, M, 3), mask (B, M) of bytes 0/1, acc0, gyr0,
// ba, bg (B, 3), noise (18,); outputs delta_p, delta_v, lin_ba, lin_bg,
// acc_last, gyr_last (B, 3), delta_q (B, 4), jacobian and covariance
// (B, 15, 15), sum_dt (B,).  exact != 0 propagates the shared-sample noise
// correlation.  B >= 1, M >= 0.  Launches on `stream`, does not
// synchronise.  Returns the CUDA error code of the launch (0 on success).
int preintegrate_f32(const float* dts, const float* accs, const float* gyrs,
                     const unsigned char* mask, const float* acc0, const float* gyr0,
                     const float* ba, const float* bg, const float* noise,
                     float* delta_p, float* delta_q, float* delta_v, float* jacobian,
                     float* covariance, float* sum_dt, float* lin_ba, float* lin_bg,
                     float* acc_last, float* gyr_last, int B, int M, int exact,
                     void* stream) {
  return launch<float>(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise, delta_p,
                       delta_q, delta_v, jacobian, covariance, sum_dt, lin_ba, lin_bg,
                       acc_last, gyr_last, B, M, exact,
                       static_cast<cudaStream_t>(stream));
}

int preintegrate_f64(const double* dts, const double* accs, const double* gyrs,
                     const unsigned char* mask, const double* acc0, const double* gyr0,
                     const double* ba, const double* bg, const double* noise,
                     double* delta_p, double* delta_q, double* delta_v, double* jacobian,
                     double* covariance, double* sum_dt, double* lin_ba, double* lin_bg,
                     double* acc_last, double* gyr_last, int B, int M, int exact,
                     void* stream) {
  return launch<double>(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise, delta_p,
                        delta_q, delta_v, jacobian, covariance, sum_dt, lin_ba, lin_bg,
                        acc_last, gyr_last, B, M, exact,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
