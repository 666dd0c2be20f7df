// The IMU factors' block of the window's normal equations for Hopper
// (sm_90a), float32 and float64: what vio_tpu_torch/solver/window.py's
// plain version (imu_factor_reference) adds to Hpp, bp and chi, in one
// launch an assembly.  For every interval k -> k+1 of the window it
// evaluates the 15-dim residual with first-order bias correction
// (imu.evaluate; integration_base.h:160-186), the four Jacobians
// (factors.imu_jacobians; edge_imu.cc:38-157) and their products with the
// interval's information Omega, and adds J^T Omega J into Hpp's band at
// the frames' offsets 6 + 15 k, -J^T Omega r into bp and r^T Omega r into
// chi.  An interval whose imu_valid is false adds nothing.  Hpp, bp and
// chi are updated in place.
//
// Replaces no Pallas kernel: vio_tpu/solver/window.py's IMU block is a
// vmap of the factor and a few einsums that XLA fuses.  The port's plain
// version is ~450 small kernels (the residual's and the Jacobians'
// elementwise ops, the concatenations, a dense (W, 15, P) Jacobian and two
// einsums over it), a graph node each in every LM attempt's assembly.
//
// What bounds it: neither bytes nor operations.  At the benchmark cell's
// W = 10 it is ~0.4 MFLOP (per interval Omega J 13,050 operations,
// J^T (Omega J) 26,100, the residual, Omega r, J^T Omega r and r^T Omega r
// ~2,000) on ~160 KB read and written (Hpp's band twice, Omega, the
// preintegrated terms): ~0.05 us of the card's memory rate.  The time is
// the launch and four dependent phases, each a few hundred dependent
// instructions at most, so the design is about latency and barriers.
//
// Design.  A grid of W + 2 blocks of 256 threads.  Block k (0 <= k <= W)
// owns frame k's 15 rows of the band: the diagonal block (J_j^T Omega J_j
// of interval k - 1 plus J_i^T Omega J_i of interval k), the two
// off-diagonal blocks beside it and frame k's 15 entries of bp.  It
// evaluates the at most two intervals it touches into shared memory:
// (1) one lane an interval computes the rotations, the residual and the
// three 3 x 3 corner products, while the other lanes stage Omega;
// (2) every lane fills entries of J (15 x 30); (3) Omega J and Omega r;
// (4) each output entry is one lane's dot product over the 15 rows, the
// two intervals' terms summed in a fixed order, then added into Hpp or
// subtracted from bp.  Every entry has exactly one writer: no atomics, the
// same bits on every replay, and no cap on W.  Block W + 1 sums chi: each
// lane one interval's r^T Omega r, the lanes' terms added in interval order
// by one lane.  Each interval is evaluated by the two blocks that share it
// (and by the chi block); the work is tiny, and a second launch or a
// grid-wide barrier would cost more than the repeats.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Args {
  const T *delta_p, *delta_q, *delta_v;   // (W, 3), (W, 4), (W, 3)
  const T* jacobian;                      // (W, 15, 15) d(preint)/d(bias)
  const T* sum_dt;                        // (W,)
  const T *lin_ba, *lin_bg;               // (W, 3)
  const T* g;                             // (3,)
  const T *Ps, *Qs, *Vs, *Bas, *Bgs;      // (W + 1, 3), Qs (W + 1, 4)
  const unsigned char* valid;             // (W,) bool
  const T* info;                          // (W, 15, 15) Omega
  T *Hpp, *bp, *chi;                      // (P, P), (P,), () in place
  int W;
};

// One interval's coefficients: what J needs beyond the preintegration's
// Jacobian, and the residual.
template <typename T> struct Interval {
  T Rinv[9];      // R(Qi)^T, row-major
  T a[3];         // Qi^-1 (0.5 g sdt^2 + Pj - Pi - Vi sdt)
  T b[3];         // Qi^-1 (g sdt + Vj - Vi)
  T L1[9];        // -(Qleft(Qj^-1 Qi) Qright(corrected q)): J_pose_i[3:6, 3:6]
  T L2[9];        // -(Qleft(Qj^-1 Qi dq) dq/dbg): J_sb_i[3:6, 6:9]
  T L3[9];        // Qleft(corrected q^-1 Qi^-1 Qj): J_pose_j[3:6, 3:6]
  T sdt;
  T r[15];        // the residual
};

template <typename T> struct Shared {
  Interval<T> iv[2];   // side 0: interval k - 1; side 1: interval k
  T Om[2][225];        // Omega of each side
  T J[2][450];         // 15 x 30: [pose_i | sb_i | pose_j | sb_j]
  T OJ[2][450];        // Omega J
  T Or[2][15];         // Omega r
  T e[kThreads];       // the chi block's terms
};

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// v rotated by q (x, y, z, w): lie.quat_rotate.
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

template <typename T>
__device__ __forceinline__ void quat_conj(const T* q, T* o) {
  o[0] = -q[0]; o[1] = -q[1]; o[2] = -q[2]; o[3] = q[3];
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

// Entry (r, c) of [v]x = [[0, -v2, v1], [v2, 0, -v0], [-v1, v0, 0]]:
// lie.so3_hat.
template <typename T>
__device__ __forceinline__ T hat(const T* v, int r, int c) {
  if (r == c) return T(0);
  const T x = v[3 - r - c];
  return (c - r + 3) % 3 == 1 ? -x : x;
}

// Entry (r, c) of lie.q_left_corner(q) = w I + [v]x (sign +1) or of
// lie.q_right_corner(q) = w I - [v]x (sign -1).
template <typename T>
__device__ __forceinline__ T corner(const T* q, int r, int c, int sign) {
  const T h = hat(q, r, c);
  return (r == c ? q[3] : T(0)) + (sign > 0 ? h : -h);
}

// The residual of interval w and, with the Jacobians' coefficients, into
// iv (one lane).  jac false computes the residual alone.
template <typename T>
__device__ void evaluate(const Args<T>& a, int w, Interval<T>& iv, bool jac) {
  const T* Jp = a.jacobian + static_cast<size_t>(w) * 225;
  const T *Pi = a.Ps + 3 * w, *Pj = a.Ps + 3 * (w + 1);
  const T *Qi = a.Qs + 4 * w, *Qj = a.Qs + 4 * (w + 1);
  const T *Vi = a.Vs + 3 * w, *Vj = a.Vs + 3 * (w + 1);
  const T *Bai = a.Bas + 3 * w, *Baj = a.Bas + 3 * (w + 1);
  const T *Bgi = a.Bgs + 3 * w, *Bgj = a.Bgs + 3 * (w + 1);
  const T sdt = a.sum_dt[w];
  T dba[3], dbg[3], th[3], cp[3], cv[3], dq[4], cq[4], Qi_inv[4], Qj_inv[4];
  for (int l = 0; l < 3; ++l) {
    dba[l] = Bai[l] - a.lin_ba[3 * w + l];
    dbg[l] = Bgi[l] - a.lin_bg[3 * w + l];
  }
  for (int r = 0; r < 3; ++r) {
    // dq/dbg dbg; dp/dba dba + dp/dbg dbg; dv/dba dba + dv/dbg dbg
    T t = T(0), p1 = T(0), p2 = T(0), v1 = T(0), v2 = T(0);
    for (int c = 0; c < 3; ++c) {
      t += Jp[15 * (3 + r) + 12 + c] * dbg[c];
      p1 += Jp[15 * r + 9 + c] * dba[c];
      p2 += Jp[15 * r + 12 + c] * dbg[c];
      v1 += Jp[15 * (6 + r) + 9 + c] * dba[c];
      v2 += Jp[15 * (6 + r) + 12 + c] * dbg[c];
    }
    th[r] = T(0.5) * t;
    cp[r] = a.delta_p[3 * w + r] + (p1 + p2);
    cv[r] = a.delta_v[3 * w + r] + (v1 + v2);
  }
  for (int l = 0; l < 4; ++l) dq[l] = a.delta_q[4 * w + l];
  const T dth[4] = {th[0], th[1], th[2], T(1)};      // lie.delta_q, unnormalised
  quat_mul(dq, dth, cq);                               // the corrected rotation
  quat_conj(Qi, Qi_inv);
  quat_conj(Qj, Qj_inv);

  T va[3], vb[3];
  for (int l = 0; l < 3; ++l) {
    va[l] = T(0.5) * a.g[l] * sdt * sdt + Pj[l] - Pi[l] - Vi[l] * sdt;
    vb[l] = a.g[l] * sdt + Vj[l] - Vi[l];
  }
  quat_rotate(Qi_inv, va, iv.a);
  quat_rotate(Qi_inv, vb, iv.b);

  T cq_inv[4], qij[4], q_cij[4];
  quat_conj(cq, cq_inv);
  quat_mul(Qi_inv, Qj, qij);
  quat_mul(cq_inv, qij, q_cij);
  for (int l = 0; l < 3; ++l) {
    iv.r[l] = iv.a[l] - cp[l];
    iv.r[3 + l] = T(2) * q_cij[l];
    iv.r[6 + l] = iv.b[l] - cv[l];
    iv.r[9 + l] = Baj[l] - Bai[l];
    iv.r[12 + l] = Bgj[l] - Bgi[l];
  }
  if (!jac) return;

  iv.sdt = sdt;
  quat_to_mat(Qi_inv, iv.Rinv);
  T q_ji[4], q_jid[4];
  quat_mul(Qj_inv, Qi, q_ji);
  quat_mul(q_ji, dq, q_jid);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      T l1 = T(0), l2 = T(0);
      for (int m = 0; m < 3; ++m) {
        l1 += corner(q_ji, r, m, 1) * corner(cq, m, c, -1);
        l2 += corner(q_jid, r, m, 1) * Jp[15 * (3 + m) + 12 + c];
      }
      iv.L1[3 * r + c] = -l1;
      iv.L2[3 * r + c] = -l2;
      iv.L3[3 * r + c] = corner(q_cij, r, c, 1);
    }
}

// Entry (rr, cc) of the interval's 15 x 30 Jacobian [J_pose_i (6) | J_sb_i
// (9) | J_pose_j (6) | J_sb_j (9)] (factors.imu_jacobians).
template <typename T>
__device__ T jac_entry(const Interval<T>& iv, const T* Jp, int rr, int cc) {
  const int rb = rr / 3, ri = rr % 3;
  if (cc < 6) {                                  // pose i
    const int cb = cc / 3, ci = cc % 3;
    if (rb == 0 && cb == 0) return -iv.Rinv[3 * ri + ci];
    if (rb == 0 && cb == 1) return hat(iv.a, ri, ci);
    if (rb == 1 && cb == 1) return iv.L1[3 * ri + ci];
    if (rb == 2 && cb == 1) return hat(iv.b, ri, ci);
    return T(0);
  }
  if (cc < 15) {                                 // speed and biases i
    const int cb = (cc - 6) / 3, ci = (cc - 6) % 3;
    if (rb == 0 && cb == 0) return -iv.Rinv[3 * ri + ci] * iv.sdt;
    if (rb == 0 && cb == 1) return -Jp[15 * ri + 9 + ci];
    if (rb == 0 && cb == 2) return -Jp[15 * ri + 12 + ci];
    if (rb == 1 && cb == 2) return iv.L2[3 * ri + ci];
    if (rb == 2 && cb == 0) return -iv.Rinv[3 * ri + ci];
    if (rb == 2 && cb == 1) return -Jp[15 * (6 + ri) + 9 + ci];
    if (rb == 2 && cb == 2) return -Jp[15 * (6 + ri) + 12 + ci];
    if ((rb == 3 && cb == 1) || (rb == 4 && cb == 2)) return ri == ci ? T(-1) : T(0);
    return T(0);
  }
  if (cc < 21) {                                 // pose j
    const int cb = (cc - 15) / 3, ci = (cc - 15) % 3;
    if (rb == 0 && cb == 0) return iv.Rinv[3 * ri + ci];
    if (rb == 1 && cb == 1) return iv.L3[3 * ri + ci];
    return T(0);
  }
  const int cb = (cc - 21) / 3, ci = (cc - 21) % 3;   // speed and biases j
  if (rb == 2 && cb == 0) return iv.Rinv[3 * ri + ci];
  if ((rb == 3 && cb == 1) || (rb == 4 && cb == 2)) return ri == ci ? T(1) : T(0);
  return T(0);
}

// Block W + 1: chi += sum over the valid intervals, in interval order, of
// r^T (Omega r).
template <typename T>
__device__ void chi_block(Shared<T>& s, const Args<T>& a, int t) {
  T total = T(0);
  for (int w0 = 0; w0 < a.W; w0 += kThreads) {
    const int w = w0 + t;
    T e = T(0);
    if (w < a.W && a.valid[w]) {
      Interval<T> iv;
      evaluate(a, w, iv, false);
      const T* Om = a.info + static_cast<size_t>(w) * 225;
      for (int r = 0; r < 15; ++r) {
        T o = T(0);
        for (int c = 0; c < 15; ++c) o += Om[15 * r + c] * iv.r[c];
        e += iv.r[r] * o;
      }
    }
    s.e[t] = e;
    __syncthreads();
    if (t == 0) {
      const int n = min(kThreads, a.W - w0);
      for (int l = 0; l < n; ++l) total += s.e[l];
    }
    __syncthreads();
  }
  if (t == 0) a.chi[0] = a.chi[0] + total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) imu_factor_kernel(const Args<T> a) {
  __shared__ Shared<T> s;
  const int t = threadIdx.x, k = blockIdx.x;
  if (k == a.W + 1) {
    chi_block(s, a, t);
    return;
  }
  // side 0 is interval k - 1 (frame k its j), side 1 interval k (its i)
  const bool live0 = k >= 1 && a.valid[k - 1];
  const bool live1 = k < a.W && a.valid[k];
  if (!live0 && !live1) return;
  const int wi[2] = {k - 1, k};
  const bool live[2] = {live0, live1};

  // (1) the coefficients, one lane a side; the others stage Omega
  if (t < 2) {
    if (live[t]) evaluate(a, wi[t], s.iv[t], true);
  } else {
    for (int e = t - 2; e < 450; e += kThreads - 2) {
      const int side = e / 225;
      if (live[side]) s.Om[side][e % 225] = a.info[static_cast<size_t>(wi[side]) * 225 + e % 225];
    }
  }
  __syncthreads();
  // (2) J
  for (int e = t; e < 900; e += kThreads) {
    const int side = e / 450, u = e % 450;
    if (live[side])
      s.J[side][u] = jac_entry(s.iv[side], a.jacobian + static_cast<size_t>(wi[side]) * 225,
                               u / 30, u % 30);
  }
  __syncthreads();
  // (3) Omega J and Omega r
  for (int e = t; e < 930; e += kThreads) {
    const int side = e / 465, u = e % 465;
    if (!live[side]) continue;
    const T* Om = s.Om[side];
    T acc = T(0);
    if (u < 450) {
      const int r = u / 30, c = u % 30;
      for (int l = 0; l < 15; ++l) acc += Om[15 * r + l] * s.J[side][30 * l + c];
      s.OJ[side][u] = acc;
    } else {
      const int r = u - 450;
      for (int l = 0; l < 15; ++l) acc += Om[15 * r + l] * s.iv[side].r[l];
      s.Or[side][r] = acc;
    }
  }
  __syncthreads();
  // (4) frame k's rows: columns of frames k - 1, k, k + 1, then bp.  Frame
  // k's parameters are columns 15-29 of side 0's J and 0-14 of side 1's.
  const int P = 6 + 15 * (a.W + 1);
  const int row0 = 6 + 15 * k;
  for (int e = t; e < 690; e += kThreads) {
    const int i = e / 46, cc = e % 46;      // row i of the frame; 45 columns and bp
    T acc = T(0);
    if (cc < 15) {                          // frame k - 1: interval k - 1 alone
      if (!live0) continue;
      for (int r = 0; r < 15; ++r) acc += s.J[0][30 * r + 15 + i] * s.OJ[0][30 * r + cc];
      const size_t o = static_cast<size_t>(row0 + i) * P + row0 - 15 + cc;
      a.Hpp[o] = a.Hpp[o] + acc;
    } else if (cc < 30) {                   // frame k: both intervals
      const int c = cc - 15;
      T acc1 = T(0);
      if (live0)
        for (int r = 0; r < 15; ++r) acc += s.J[0][30 * r + 15 + i] * s.OJ[0][30 * r + 15 + c];
      if (live1)
        for (int r = 0; r < 15; ++r) acc1 += s.J[1][30 * r + i] * s.OJ[1][30 * r + c];
      const size_t o = static_cast<size_t>(row0 + i) * P + row0 + c;
      a.Hpp[o] = a.Hpp[o] + (acc + acc1);
    } else if (cc < 45) {                   // frame k + 1: interval k alone
      if (!live1) continue;
      const int c = cc - 30;
      for (int r = 0; r < 15; ++r) acc += s.J[1][30 * r + i] * s.OJ[1][30 * r + 15 + c];
      const size_t o = static_cast<size_t>(row0 + i) * P + row0 + 15 + c;
      a.Hpp[o] = a.Hpp[o] + acc;
    } else {                                // bp
      T acc1 = T(0);
      if (live0)
        for (int r = 0; r < 15; ++r) acc += s.J[0][30 * r + 15 + i] * s.Or[0][r];
      if (live1)
        for (int r = 0; r < 15; ++r) acc1 += s.J[1][30 * r + i] * s.Or[1][r];
      a.bp[row0 + i] = a.bp[row0 + i] - (acc + acc1);
    }
  }
}

template <typename T>
int launch(const T* delta_p, const T* delta_q, const T* delta_v, const T* jacobian,
           const T* sum_dt, const T* lin_ba, const T* lin_bg, const T* g, const T* Ps,
           const T* Qs, const T* Vs, const T* Bas, const T* Bgs, const unsigned char* valid,
           const T* info, T* Hpp, T* bp, T* chi, int W, cudaStream_t stream) {
  const Args<T> a{delta_p, delta_q, delta_v, jacobian, sum_dt, lin_ba, lin_bg, g,
                  Ps, Qs, Vs, Bas, Bgs, valid, info, Hpp, bp, chi, W};
  imu_factor_kernel<T><<<W + 2, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// W >= 1 intervals, every array contiguous on the device: delta_p,
// delta_v, lin_ba, lin_bg (W, 3), delta_q (W, 4), jacobian and info
// (W, 15, 15), sum_dt (W,), g (3,), Ps, Vs, Bas, Bgs (W + 1, 3), Qs
// (W + 1, 4), valid (W,) of bytes 0/1; Hpp (P, P) and bp (P,) with
// P = 6 + 15 (W + 1), and chi (), all three updated in place.  Launches on
// `stream`, does not synchronise.  Returns the CUDA error code of the
// launch (0 on success).
int imu_factor_f32(const float* delta_p, const float* delta_q, const float* delta_v,
                   const float* jacobian, const float* sum_dt, const float* lin_ba,
                   const float* lin_bg, const float* g, const float* Ps, const float* Qs,
                   const float* Vs, const float* Bas, const float* Bgs,
                   const unsigned char* valid, const float* info, float* Hpp, float* bp,
                   float* chi, int W, void* stream) {
  return launch<float>(delta_p, delta_q, delta_v, jacobian, sum_dt, lin_ba, lin_bg, g, Ps,
                       Qs, Vs, Bas, Bgs, valid, info, Hpp, bp, chi, W,
                       static_cast<cudaStream_t>(stream));
}

int imu_factor_f64(const double* delta_p, const double* delta_q, const double* delta_v,
                   const double* jacobian, const double* sum_dt, const double* lin_ba,
                   const double* lin_bg, const double* g, const double* Ps, const double* Qs,
                   const double* Vs, const double* Bas, const double* Bgs,
                   const unsigned char* valid, const double* info, double* Hpp, double* bp,
                   double* chi, int W, void* stream) {
  return launch<double>(delta_p, delta_q, delta_v, jacobian, sum_dt, lin_ba, lin_bg, g, Ps,
                        Qs, Vs, Bas, Bgs, valid, info, Hpp, bp, chi, W,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
