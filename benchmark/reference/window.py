"""Plain reference for one frame of the sliding-window estimator.

It takes what the program's frame step was handed (the window's states
before the solve, the raw IMU samples of each interval, the feature
observations, the marginalization prior) and what it returned (the
solved, gauge-fixed states, the prior's right-hand side and the
marginalization block), and works out
again, in float64, what the program derived from the inputs:

- the IMU preintegration of every interval (midpoint integration, the
  bias Jacobian and the noise covariance, VINS-Mono's
  integration_base.h, with the correlated-noise recursion where the
  configuration asks for it);
- the normal equations of the window at the program's solution: the
  inverse-depth reprojection factors under the Cauchy kernel, the IMU
  factors, the prior (VINS-Mono's problem.cc, edge_imu.cc,
  edge_reprojection.cc);
- the window's solve: Levenberg-Marquardt from the input states, with
  the landmarks eliminated by their Schur complement, the damping on the
  pose block, Nielsen's update of it, the first-order update of the
  prior's right-hand side and its cost as the reference problem.cc
  computes it (the prior's norm unsquared), then the yaw re-fix;
- the marginalization block of the oldest frame (its Hessian and its
  right-hand side) at the program's solution.

The cost that the reference's LM accepts its steps by is not the one its
steps minimise (the prior enters the cost as a norm and the normal
equations as a square), so its fixed point is the algorithm's and not a
least-squares optimum: the reference follows the algorithm step by step,
from the program's input state.  ``judge`` turns the comparison into the
numbers that decide ``correct``:

- the window's least-squares cost (the factors' and the prior's
  quadratic about the input states) at the program's solution and at
  the input, each less its cost at the reference's solution: ``check``
  takes the median over the sampled frames of their ratio,
  ``window_cost_left``, the share of the frame's reducible cost that the
  program's solve left.  A solve that stops short, does nothing (1) or
  lands off through its arithmetic reads high; two paths of the
  unfinished LM that end at points of nearly one cost read close;
- ``marg_H_gap``: the program's marginalization block against the
  reference's at the program's solution, as a share of the reference's
  factor part (Frobenius); ``marg_b_gap`` the same of its right-hand
  side, with the prior's right-hand side that the program returned;
- ``prior_shift_gap``: the prior's right-hand side that the program
  returned (moved by H_prior times each accepted step, problem.cc's
  first-order update) against the reference's, over the reference's
  shift;
- ``refix_gap``: how far the program moved frame 0 off its input
  position (m) and yaw (rad); the re-fix holds both.

``solve`` returns the reference's frame as the program returns its own.

Nothing here imports the program.  Quaternions are (x, y, z, w).
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64


# --------------------------------------------------------------------------
# rotations
# --------------------------------------------------------------------------

def hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1],
                        v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], -1).reshape(v.shape[:-1] + (3, 3))


def qmul(q, p):
    qv, qw = q[..., :3], q[..., 3:]
    pv, pw = p[..., :3], p[..., 3:]
    v = qw * pv + pw * qv + torch.cross(qv, pv, dim=-1)
    w = qw * pw - (qv * pv).sum(-1, keepdim=True)
    return torch.cat([v, w], -1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def qnormalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qmat(q):
    """Rotation matrix of a (possibly unnormalised) quaternion."""
    q = qnormalize(q)
    x, y, z, w = q.unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                     2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                     2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def qexp(phi):
    """Unit quaternion of the rotation vector ``phi``."""
    th = torch.linalg.norm(phi, dim=-1, keepdim=True)
    small = th < 1e-12
    s = torch.where(small, 0.5 - th * th / 48.0, torch.sin(0.5 * th) / torch.where(small, 1.0, th))
    return torch.cat([phi * s, torch.cos(0.5 * th)], -1)


def qlog(q):
    """Rotation vector of a unit quaternion (shortest way round)."""
    q = torch.where(q[..., 3:] < 0, -q, q)
    v, w = q[..., :3], q[..., 3:]
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    ang = 2.0 * torch.atan2(n, w)
    return v * torch.where(n < 1e-12, 2.0 / w, ang / torch.where(n < 1e-12, 1.0, n))


def left_corner(q):
    """w·I + [v]x: the lower 3 × 3 of the left-product matrix of ``q``."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return q[..., 3, None, None] * eye + hat(q[..., :3])


def right_corner(q):
    """w·I − [v]x: the lower 3 × 3 of the right-product matrix of ``q``."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return q[..., 3, None, None] * eye - hat(q[..., :3])


def yaw(R):
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


# --------------------------------------------------------------------------
# IMU preintegration
# --------------------------------------------------------------------------

def preintegrate(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise, exact: bool):
    """Midpoint preintegration of W intervals at once: dts (W, M), accs
    and gyrs (W, M, 3), mask (W, M), acc0/gyr0/ba/bg (W, 3), noise (18,)
    the diagonal of the continuous noise [an0, gn0, an1, gn1, baw, bgw].
    Masked samples are skipped.  Returns dp, dq, dv, the Jacobian J (W,
    15, 15) of the deltas by the start biases, the covariance C and the
    summed dt."""
    Wn, M = dts.shape
    kw = dict(dtype=dts.dtype, device=dts.device)
    eye3 = torch.eye(3, **kw)
    dp = torch.zeros(Wn, 3, **kw)
    dv = torch.zeros(Wn, 3, **kw)
    dq = torch.zeros(Wn, 4, **kw)
    dq[:, 3] = 1.0
    J = torch.eye(15, **kw).repeat(Wn, 1, 1)
    C = torch.zeros(Wn, 15, 15, **kw)
    X = torch.zeros(Wn, 15, 18, **kw)
    sdt = torch.zeros(Wn, **kw)
    a0, g0 = acc0, gyr0
    for k in range(M):
        dt = dts[:, k]
        a1, g1 = accs[:, k], gyrs[:, k]
        d1 = dt[:, None]
        d3 = dt[:, None, None]
        R0 = qmat(dq)
        w = 0.5 * (g0 + g1) - bg
        q1 = qnormalize(qmul(dq, torch.cat([w * d1 / 2.0, torch.ones_like(d1)], -1)))
        R1 = qmat(q1)
        ua = 0.5 * (_mv(R0, a0 - ba) + _mv(R1, a1 - ba))
        p_n = dp + dv * d1 + 0.5 * ua * d1 * d1
        v_n = dv + ua * d1

        wx, a0x, a1x = hat(w), hat(a0 - ba), hat(a1 - ba)
        R0a0, R1a1 = R0 @ a0x, R1 @ a1x
        ImW = eye3 - wx * d3
        R1a1ImW = R1a1 @ ImW
        d2 = d3 * d3
        Fm = torch.zeros(Wn, 15, 15, **kw)
        Fm[:, 0:3, 0:3] = eye3
        Fm[:, 0:3, 3:6] = -0.25 * R0a0 * d2 - 0.25 * R1a1ImW * d2
        Fm[:, 0:3, 6:9] = eye3 * d3
        Fm[:, 0:3, 9:12] = -0.25 * (R0 + R1) * d2
        Fm[:, 0:3, 12:15] = 0.25 * R1a1 * d2 * d3
        Fm[:, 3:6, 3:6] = ImW
        Fm[:, 3:6, 12:15] = -eye3 * d3
        Fm[:, 6:9, 3:6] = -0.5 * R0a0 * d3 - 0.5 * R1a1ImW * d3
        Fm[:, 6:9, 6:9] = eye3
        Fm[:, 6:9, 9:12] = -0.5 * (R0 + R1) * d3
        Fm[:, 6:9, 12:15] = 0.5 * R1a1 * d2
        Fm[:, 9:12, 9:12] = eye3
        Fm[:, 12:15, 12:15] = eye3
        V = torch.zeros(Wn, 15, 18, **kw)
        V[:, 0:3, 0:3] = 0.25 * R0 * d2
        V[:, 0:3, 3:6] = -0.125 * R1a1 * d2 * d3
        V[:, 0:3, 6:9] = 0.25 * R1 * d2
        V[:, 0:3, 9:12] = -0.125 * R1a1 * d2 * d3
        V[:, 3:6, 3:6] = 0.5 * eye3 * d3
        V[:, 3:6, 9:12] = 0.5 * eye3 * d3
        V[:, 6:9, 0:3] = 0.5 * R0 * d3
        V[:, 6:9, 3:6] = -0.25 * R1a1 * d2
        V[:, 6:9, 6:9] = 0.5 * R1 * d3
        V[:, 6:9, 9:12] = -0.25 * R1a1 * d2
        V[:, 9:12, 12:15] = eye3 * d3
        V[:, 12:15, 15:18] = eye3 * d3
        Ft, Vt = Fm.transpose(1, 2), V.transpose(1, 2)
        C_n = Fm @ C @ Ft + (V * noise) @ Vt
        if exact:
            cross = Fm @ X @ Vt
            C_n = C_n + cross + cross.transpose(1, 2)
            X_n = torch.zeros_like(X)
            X_n[:, :, 0:3] = V[:, :, 6:9] * noise[0]
            X_n[:, :, 3:6] = V[:, :, 9:12] * noise[3]
        else:
            X_n = X
        m = mask[:, k]
        m1, m2 = m[:, None], m[:, None, None]
        dp, dv, dq = torch.where(m1, p_n, dp), torch.where(m1, v_n, dv), torch.where(m1, q1, dq)
        J = torch.where(m2, Fm @ J, J)
        C = torch.where(m2, C_n, C)
        X = torch.where(m2, X_n, X)
        sdt = torch.where(m, sdt + dt, sdt)
        a0, g0 = torch.where(m1, a1, a0), torch.where(m1, g1, g0)
    return dict(dp=dp, dq=dq, dv=dv, J=J, C=C, sdt=sdt, ba=ba, bg=bg)


# --------------------------------------------------------------------------
# factors
# --------------------------------------------------------------------------

def imu_terms(pre, g, P, Q, V, Ba, Bg):
    """Residuals (W, 15) of the IMU factors between frames k and k+1 and
    their Jacobians by the local parameters of the two frames (W, 15, 15)
    each, with the first-order bias correction of the deltas."""
    J = pre["J"]
    sdt = pre["sdt"][:, None]
    Pi, Qi, Vi, Bai, Bgi = P[:-1], Q[:-1], V[:-1], Ba[:-1], Bg[:-1]
    Pj, Qj, Vj, Baj, Bgj = P[1:], Q[1:], V[1:], Ba[1:], Bg[1:]
    dp_dba, dp_dbg = J[:, 0:3, 9:12], J[:, 0:3, 12:15]
    dq_dbg = J[:, 3:6, 12:15]
    dv_dba, dv_dbg = J[:, 6:9, 9:12], J[:, 6:9, 12:15]
    dba, dbg = Bai - pre["ba"], Bgi - pre["bg"]
    one = torch.ones_like(sdt)
    cq = qmul(pre["dq"], torch.cat([0.5 * _mv(dq_dbg, dbg), one], -1))
    cv = pre["dv"] + _mv(dv_dba, dba) + _mv(dv_dbg, dbg)
    cp = pre["dp"] + _mv(dp_dba, dba) + _mv(dp_dbg, dbg)
    RiT = qmat(Qi).transpose(1, 2)
    tp = _mv(RiT, 0.5 * g * sdt * sdt + Pj - Pi - Vi * sdt)
    tv = _mv(RiT, g * sdt + Vj - Vi)
    r = torch.cat([tp - cp,
                   2.0 * qmul(qconj(cq), qmul(qconj(Qi), Qj))[:, :3],
                   tv - cv, Baj - Bai, Bgj - Bgi], -1)

    Wn = P.shape[0] - 1
    kw = dict(dtype=P.dtype, device=P.device)
    eye3 = torch.eye(3, **kw)
    Ji = torch.zeros(Wn, 15, 15, **kw)
    Ji[:, 0:3, 0:3] = -RiT
    Ji[:, 0:3, 3:6] = hat(tp)
    Ji[:, 3:6, 3:6] = -(left_corner(qmul(qconj(Qj), Qi)) @ right_corner(cq))
    Ji[:, 6:9, 3:6] = hat(tv)
    Ji[:, 0:3, 6:9] = -RiT * sdt[:, :, None]
    Ji[:, 0:3, 9:12] = -dp_dba
    Ji[:, 0:3, 12:15] = -dp_dbg
    Ji[:, 3:6, 12:15] = -(left_corner(qmul(qmul(qconj(Qj), Qi), pre["dq"])) @ dq_dbg)
    Ji[:, 6:9, 6:9] = -RiT
    Ji[:, 6:9, 9:12] = -dv_dba
    Ji[:, 6:9, 12:15] = -dv_dbg
    Ji[:, 9:12, 9:12] = -eye3
    Ji[:, 12:15, 12:15] = -eye3
    Jj = torch.zeros(Wn, 15, 15, **kw)
    Jj[:, 0:3, 0:3] = RiT
    Jj[:, 3:6, 3:6] = left_corner(qmul(qconj(cq), qmul(qconj(Qi), Qj)))
    Jj[:, 6:9, 6:9] = RiT
    Jj[:, 9:12, 9:12] = eye3
    Jj[:, 12:15, 12:15] = eye3
    return r, Ji, Jj


def reproj_terms(lam, Pi, Qi, Pj, Qj, tic, qic, pi, pj):
    """Residuals (n, 2) of the inverse-depth reprojection factors and their
    Jacobians by the inverse depth (n, 2), the two frames' poses (n, 2, 6)
    and the extrinsic (n, 2, 6)."""
    Ri, Rj, Ric = qmat(Qi), qmat(Qj), qmat(qic)
    RjT, RicT = Rj.transpose(-1, -2), Ric.transpose(-1, -2)
    pci = pi / lam[:, None]
    pbi = _mv(Ric, pci) + tic
    pw = _mv(Ri, pbi) + Pi
    pbj = _mv(RjT, pw - Pj)
    pcj = _mv(RicT, pbj - tic)
    z = pcj[:, 2]
    r = pcj[:, :2] / z[:, None] - pj[:, :2]
    red = torch.zeros(lam.shape + (2, 3), dtype=lam.dtype, device=lam.device)
    red[:, 0, 0] = 1.0 / z
    red[:, 1, 1] = 1.0 / z
    red[:, 0, 2] = -pcj[:, 0] / (z * z)
    red[:, 1, 2] = -pcj[:, 1] / (z * z)
    A = RicT @ RjT
    Jpi = red @ torch.cat([A, -(A @ Ri @ hat(pbi))], -1)
    Jpj = red @ torch.cat([-A, RicT @ hat(pbj)], -1)
    tmp = A @ Ri @ Ric
    Jd = _mv(red, _mv(tmp, pi)) * (-1.0 / (lam * lam))[:, None]
    eye3 = torch.eye(3, dtype=lam.dtype, device=lam.device)
    Jex = red @ torch.cat([
        RicT @ (RjT @ Ri - eye3),
        -tmp @ hat(pci) + hat(_mv(tmp, pci)) + hat(_mv(RicT, _mv(RjT, _mv(Ri, tic) + Pi - Pj) - tic)),
    ], -1)
    return r, Jd, Jpi, Jpj, Jex


# --------------------------------------------------------------------------
# the window at a state
# --------------------------------------------------------------------------

def as_tensors(rec: dict, dtype, device="cpu") -> dict:
    """A recorded frame's inputs as tensors of ``dtype`` (masks and
    indices keep theirs)."""
    def t(x, dt=dtype):
        return torch.as_tensor(x, device=device).to(dt)
    inp = rec["inputs"]
    out = dict(states={k: t(v) for k, v in inp["states"].items()})
    for k in ("dts", "accs", "gyrs", "acc0", "gyr0", "pts_i", "pts_j", "H_prior",
              "b_prior", "err_prior", "Jt_prior_inv", "g", "noise"):
        out[k] = t(inp[k])
    out["sqrt_info"] = float(inp["sqrt_info"])
    for k in ("mask", "imu_valid", "obs_mask", "feat_valid"):
        out[k] = t(inp[k], torch.bool)
    out["start"] = t(inp["start"], torch.int64)
    out["exact"] = bool(inp["exact_noise"])
    out["fix_ext"] = bool(inp["fix_ext"])
    return out


class Window:
    """The factors of one recorded frame, preintegrated once at the input
    states' biases, in the dtype of ``w``'s tensors."""

    def __init__(self, w: dict):
        self.w = w
        s = w["states"]
        W1 = s["Ps"].shape[0]
        self.W1 = W1
        self.P = 6 + 15 * W1
        self.pre = preintegrate(w["dts"], w["accs"], w["gyrs"], w["mask"], w["acc0"],
                                w["gyr0"], s["Bas"][:W1 - 1], s["Bgs"][:W1 - 1],
                                w["noise"], w["exact"])
        eye15 = torch.eye(15, dtype=w["dts"].dtype, device=w["dts"].device)
        C = torch.where(w["imu_valid"][:, None, None], self.pre["C"], eye15)
        self.info = torch.linalg.inv(C.to(torch.float64)).to(C.dtype)

    def system(self, s: dict, b_prior, err_prior, marg: bool = False):
        """Normal equations (H, b) over [ext 6 | frames 15·W1 | inverse
        depths F] and the cost ½ (Σ Cauchy + Σ IMU χ² + ‖err_prior‖) at
        states ``s``.  ``marg``: only the factors of the oldest frame
        (features that start there, the first IMU interval), the extrinsic
        free, as the marginalization takes them."""
        w = self.w
        W1, P = self.W1, self.P
        dtype, dev = s["Ps"].dtype, s["Ps"].device
        Fn = s["inv_dep"].shape[0]
        feat = w["feat_valid"] & ((w["start"] == 0) if marg else True)
        live = w["obs_mask"] & feat[:, None]
        fo, jo = torch.nonzero(live, as_tuple=True)
        io = w["start"][fo]
        lam = torch.where(feat, s["inv_dep"], torch.ones_like(s["inv_dep"]))
        r, Jd, Jpi, Jpj, Jex = reproj_terms(
            lam[fo], s["Ps"][io], s["Qs"][io], s["Ps"][jo], s["Qs"][jo],
            s["ext_t"], s["ext_q"], w["pts_i"][fo], w["pts_j"][fo, jo])
        n = r.shape[0]
        s2 = w["sqrt_info"] ** 2
        e2 = s2 * (r * r).sum(-1)
        aux = e2 + 1.0
        rho0, rho1 = torch.log(aux), 1.0 / aux
        rho2 = -rho1 * rho1
        we = w["sqrt_info"] * r
        guard = ((rho1 + 2.0 * rho2 * e2) > 0).to(dtype)
        eye2 = torch.eye(2, dtype=dtype, device=dev)
        rinfo = (rho1[:, None, None] * eye2
                 + (guard * 2.0 * rho2)[:, None, None] * we[:, :, None] * we[:, None, :]) * s2

        N = P + Fn
        Jrow = torch.zeros(n, 2, N, dtype=dtype, device=dev)
        ar = torch.arange(n, device=dev)
        if marg or not w["fix_ext"]:
            Jrow[:, :, 0:6] = Jex
        ci = 6 + 15 * io
        cj = 6 + 15 * jo
        for c in range(6):
            Jrow[ar, :, ci + c] += Jpi[:, :, c]
            Jrow[ar, :, cj + c] += Jpj[:, :, c]
        Jrow[ar, :, P + fo] = Jd
        Jf = Jrow.reshape(2 * n, N)
        H = Jf.T @ (rinfo @ Jrow).reshape(2 * n, N)
        b = -(Jf.T @ ((s2 * rho1)[:, None] * r).reshape(2 * n))
        chi = rho0.sum()

        ri, Ji, Jj = imu_terms(self.pre, w["g"], s["Ps"], s["Qs"], s["Vs"], s["Bas"], s["Bgs"])
        valid = w["imu_valid"].clone()
        if marg:
            valid[1:] = False
        Wn = W1 - 1
        Jimu = torch.zeros(Wn, 15, N, dtype=dtype, device=dev)
        for k in range(Wn):
            Jimu[k, :, 6 + 15 * k:21 + 15 * k] = Ji[k]
            Jimu[k, :, 21 + 15 * k:36 + 15 * k] = Jj[k]
        Jimu = Jimu * valid[:, None, None].to(dtype)
        Ji2 = Jimu.reshape(15 * Wn, N)
        H = H + Ji2.T @ (self.info @ Jimu).reshape(15 * Wn, N)
        ir = _mv(self.info, ri) * valid[:, None].to(dtype)
        b = b - Ji2.T @ ir.reshape(15 * Wn)
        chi = chi + (ri * ir).sum()

        free = torch.ones(P, dtype=dtype, device=dev)
        if not marg and w["fix_ext"]:
            free[0:6] = 0.0
        H[:P, :P] = H[:P, :P] + w["H_prior"] * free[:, None] * free[None, :]
        b[:P] = b[:P] + b_prior * free
        chi = chi + torch.linalg.norm(err_prior)
        return H, b, 0.5 * chi

    def prior_delta(self, s: dict):
        """The state's difference from the input states, packed like the
        prior (ext 6, then p, θ, v, ba, bg per frame)."""
        x0 = self.w["states"]
        d = torch.zeros(self.P, dtype=s["Ps"].dtype, device=s["Ps"].device)
        d[0:3] = s["ext_t"] - x0["ext_t"]
        d[3:6] = qlog(qmul(qconj(x0["ext_q"]), s["ext_q"]))
        fr = torch.cat([s["Ps"] - x0["Ps"], qlog(qmul(qconj(x0["Qs"]), s["Qs"])),
                        s["Vs"] - x0["Vs"], s["Bas"] - x0["Bas"], s["Bgs"] - x0["Bgs"]], -1)
        d[6:] = fr.reshape(-1)
        return d

    def cost(self, s: dict):
        """The window's least-squares cost at ``s``: ½ (Σ Cauchy + Σ IMU
        χ²) + the prior's quadratic about the input states."""
        w = self.w
        z = torch.zeros_like(w["b_prior"])
        _, _, c = self.system(s, z, z)
        d = self.prior_delta(s)
        free = torch.ones_like(d)
        if w["fix_ext"]:
            free[0:6] = 0.0
        d = d * free
        return c - w["b_prior"] @ d + 0.5 * d @ w["H_prior"] @ d

    def marg_block(self, s: dict, b_prior):
        """The marginalization block at ``s``: the oldest frame's factors
        and the prior (its right-hand side ``b_prior``, as the solve left
        it), the inverse depths eliminated.  Returns (Hpp, bp)."""
        w = self.w
        H, b, _ = self.system(s, b_prior, w["err_prior"], marg=True)
        P = self.P
        Hpp, Hpm, Hmm = H[:P, :P], H[:P, P:], torch.diagonal(H[P:, P:])
        feat = w["feat_valid"] & (w["start"] == 0)
        T = Hpm * _inverse_where(Hmm, feat)[None, :]
        return Hpp - T @ Hpm.T, b[:P] - T @ b[P:]


def _inverse_where(d, ok):
    ok = ok & (d.abs() > 1e-30)
    return torch.where(ok, 1.0 / torch.where(ok, d, torch.ones_like(d)), torch.zeros_like(d))


def _apply(s: dict, dp, dm, P: int) -> dict:
    """States moved by the pose update ``dp`` (P,) and the inverse-depth
    update ``dm`` (F,)."""
    W1 = s["Ps"].shape[0]
    fr = dp[6:P].reshape(W1, 15)
    return dict(
        ext_t=s["ext_t"] + dp[0:3],
        ext_q=qnormalize(qmul(s["ext_q"], qexp(dp[3:6]))),
        Ps=s["Ps"] + fr[:, 0:3],
        Qs=qnormalize(qmul(s["Qs"], qexp(fr[:, 3:6]))),
        Vs=s["Vs"] + fr[:, 6:9], Bas=s["Bas"] + fr[:, 9:12], Bgs=s["Bgs"] + fr[:, 12:15],
        inv_dep=s["inv_dep"] + dm)


def lm(win: Window, max_iter: int):
    """Levenberg-Marquardt (problem.cc) from the window's input states;
    returns the solved states and the prior's right-hand side as the
    accepted steps moved it."""
    w, P = win.w, win.P
    s, bpr, err = w["states"], w["b_prior"], w["err_prior"]
    feat = w["feat_valid"]

    def reduced(H, b):
        Hpp, Hpm, Hmm = H[:P, :P], H[:P, P:], torch.diagonal(H[P:, P:])
        inv = _inverse_where(Hmm, feat)
        tmp = Hpm * inv[None, :]
        return (dict(bp=b[:P], Hpm=Hpm, bm=b[P:], inv=inv),
                Hpp - tmp @ Hpm.T, b[:P] - tmp @ b[P:])

    H, b, chi = win.system(s, bpr, err)
    nrm, S, rhs = reduced(H, b)
    lam = 1e-5 * min(max(float(torch.diagonal(H[:P, :P]).abs().max()),
                         float(torch.diagonal(H[P:, P:]).abs().max())), 5e10)
    ni, last_chi, it, false_cnt = 2.0, 1e20, 0, 0
    eye = torch.eye(P, dtype=S.dtype, device=S.device)
    while it < max_iter:
        dxp = torch.linalg.solve(S + lam * eye, rhs)
        dxm = nrm["inv"] * (nrm["bm"] - nrm["Hpm"].T @ dxp)
        cand = _apply(s, dxp, dxm, P)
        c_b = bpr - w["H_prior"] @ dxp
        c_err = -(w["Jt_prior_inv"] @ c_b)
        Hc, bc, c_chi = win.system(cand, c_b, c_err)
        dot = dxp @ nrm["bp"] + dxm @ (lam * dxm + nrm["bm"])
        scale = 0.5 * (lam * float(dxp @ dxp) + float(dot)) + 1e-6
        rho = (float(chi) - float(c_chi)) / scale
        if rho > 0 and math.isfinite(float(c_chi)):
            alpha = min(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
            lam *= max(alpha, 1.0 / 3.0)
            ni = 2.0
            stop = (last_chi - float(c_chi)) < 1e-5
            last_chi = float(c_chi)
            s, bpr, err, chi = cand, c_b, c_err, c_chi
            nrm, S, rhs = reduced(Hc, bc)
            it += 1
            false_cnt = 0
        else:
            lam *= ni
            ni *= 2.0
            stop = False
            if false_cnt + 1 >= 10:
                stop = (last_chi - float(chi)) < 1e-5
                last_chi = float(chi)
                it += 1
                false_cnt = 0
            else:
                false_cnt += 1
        if stop:
            break
    return s, bpr


def refix(x0: dict, s: dict) -> dict:
    """Rotate the solved window about the world's z so that frame 0 keeps
    its input yaw and position (VINS-Mono's double2vector)."""
    R0, R1 = qmat(x0["Qs"][0]), qmat(s["Qs"][0])
    d = yaw(R0) - yaw(R1)
    c, sn = torch.cos(d), torch.sin(d)
    zero, one = torch.zeros_like(d), torch.ones_like(d)
    Rz = torch.stack([c, -sn, zero, sn, c, zero, zero, zero, one]).reshape(3, 3)
    qz = torch.stack([zero, zero, torch.sin(d / 2), torch.cos(d / 2)])
    out = dict(s)
    out["Ps"] = (s["Ps"] - s["Ps"][0]) @ Rz.T + x0["Ps"][0]
    out["Qs"] = qnormalize(qmul(qz.expand(s["Qs"].shape), s["Qs"]))
    out["Vs"] = s["Vs"] @ Rz.T
    return out


def solve(rec: dict, device="cpu") -> dict:
    """The reference's frame in float64: the LM, the re-fix and the
    marginalization block, as host arrays like the program's outputs."""
    w = as_tensors(rec, F64, device)
    win = Window(w)
    s, bpr = lm(win, rec["inputs"]["max_iter"])
    s = refix(w["states"], s)
    Hpp, bp = win.marg_block(s, bpr) if rec["inputs"]["marg_old"] else (None, None)
    return dict(states={k: v.cpu().numpy() for k, v in s.items()},
                b_prior=bpr.cpu().numpy(),
                marg_Hpp=None if Hpp is None else Hpp.cpu().numpy(),
                marg_bp=None if bp is None else bp.cpu().numpy())


def judge(rec: dict, device="cpu") -> dict:
    """The numbers of one recorded frame: the program's outputs against
    the reference's frame in float64."""
    w = as_tensors(rec, F64, device)
    win = Window(w)
    ref, b_ref = lm(win, rec["inputs"]["max_iter"])
    ref = refix(w["states"], ref)
    out = rec["outputs"]

    def t(x):
        return torch.as_tensor(x, dtype=F64, device=device)
    s_out = {k: t(v) for k, v in out["states"].items()}
    c_ref = win.cost(ref)
    gap_out = float(win.cost(s_out) - c_ref)
    gap_in = float(win.cost(w["states"]) - c_ref)
    b_out = t(out["b_prior"])
    shift = float(torch.linalg.norm(w["b_prior"] - b_ref))
    shift_gap = float(torch.linalg.norm(b_out - b_ref)) / \
        (shift + 1e-12 * float(torch.linalg.norm(w["b_prior"])) + 1e-300)
    if rec["inputs"]["marg_old"]:
        Hpp, bp = win.marg_block(s_out, b_out)
        fac = Hpp - w["H_prior"]
        marg_gap = float(torch.linalg.norm(t(out["marg_Hpp"]) - Hpp) / torch.linalg.norm(fac))
        marg_b_gap = float(torch.linalg.norm(t(out["marg_bp"]) - bp)
                           / torch.linalg.norm(bp - b_out))
    else:
        marg_gap = marg_b_gap = None
    x0 = w["states"]
    dyaw = (float(yaw(qmat(s_out["Qs"][0])) - yaw(qmat(x0["Qs"][0]))) + math.pi) \
        % (2 * math.pi) - math.pi
    p_gap = float(torch.linalg.norm(s_out["Ps"][0] - x0["Ps"][0]))
    return dict(cost_gap_out=gap_out, cost_gap_in=gap_in, marg_H_gap=marg_gap,
                marg_b_gap=marg_b_gap, prior_shift_gap=shift_gap,
                refix_gap=max(p_gap, abs(dyaw)))
