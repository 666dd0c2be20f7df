"""Plain reference for one solve of the loop closer's pose graph.

It takes what the program's pose-graph solve was handed (the keyframes'
positions and unit quaternions, the relative-pose edges, their weights,
whether pose 0 is held, the iteration cap) and what it returned (the
solved poses), and solves the same problem again, in float64 on the
problem as it is (unpadded), by its definition (the loop closer's
``loop/posegraph.py``):

- an edge (i, j, ΔP, Δq) of weight w has the residual
  w · [log(Δq⁻¹ qᵢ⁻¹ qⱼ), Rᵢᵀ(Pⱼ − Pᵢ) − ΔP], and the cost is half the
  squared sum of all edges' residuals;
- the parameters are a local [dθ, dp] per pose about the input guess
  (q = q₀ exp(dθ), P = P₀ + dp), pose 0 held where the solve says so;
- the normal equations are dense: the residuals' Jacobian by all the
  parameters at once (forward mode), H = JᵀJ, b = −Jᵀr;
- Levenberg-Marquardt with Nielsen's update of the damping (the generic
  dense solver's, problem.cc's): λ₀ = 1e-5 · min(max |diag H|, 5e10), a
  step accepted where the gain ratio ρ > 0 and the cost is finite, an
  iteration ended by an accepted step or by the tenth rejected one, the
  loop ended where an iteration lowers the cost by less than
  ``STOP_DELTA_CHI`` or at the recorded cap; the damped system solved
  by ``torch.linalg.solve``.

The LM stops short of the optimum by design, so the reference follows it
step by step from the program's input, as the window's reference does.
``judge`` turns the comparison into the numbers that decide ``correct``:

- the cost at the program's solution and at the input, each less the
  cost at the reference's solution: the judge takes the median over the
  sampled solves of their ratio, ``posegraph_cost_left``, the share of
  the reducible cost that the program's solve left.  Doing nothing
  reads 1.  The cost is quadratic about its optimum, so a solution off
  by a share s of the correction leaves about s² of it: a solve cut
  short after one step, or one that dropped a loop edge, can leave under
  1e-4 and still be off by a hundredth of the correction, and a float32
  solve that stops an iteration apart can read below 0;
- ``pose_gap``: the widest gap of a pose between the program's solution
  and the reference's, over the widest move that the reference made of
  a pose off the input (a pose's gap and move: the norm of its
  [rotation (rad), position (m)]): the share s itself;
- ``fix_gap``: how far the program moved pose 0 off its input (the
  norm of its [rotation (rad), position (m)]), where the solve holds
  it.

Nothing here imports the program.  Quaternions are (x, y, z, w).
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64
STOP_DELTA_CHI = 1e-5     # the generic dense solver's stop threshold
MAX_REJECTS = 10          # rejected attempts that end an iteration
SMALL = 1e-18             # squared angles under this take the series


def qmul(q, p):
    qv, qw = q[..., :3], q[..., 3:]
    pv, pw = p[..., :3], p[..., 3:]
    return torch.cat([qw * pv + pw * qv + torch.cross(qv, pv, dim=-1),
                      qw * pw - (qv * pv).sum(-1, keepdim=True)], -1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def qrotate(q, v):
    """v rotated by the unit quaternion q."""
    qv, qw = q[..., :3], q[..., 3:]
    t = 2.0 * torch.cross(qv, v, dim=-1)
    return v + qw * t + torch.cross(qv, t, dim=-1)


def qexp(phi):
    """Unit quaternion of the rotation vector ``phi``.  The angle's root
    is taken only off zero, so forward-mode tangents stay finite there."""
    th2 = (phi * phi).sum(-1, keepdim=True)
    small = th2 < SMALL
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    s = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    c = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return torch.cat([phi * s, c], -1)


def qlog(q):
    """Rotation vector of a unit quaternion, the shortest way round."""
    q = torch.where(q[..., 3:] < 0, -q, q)
    v, w = q[..., :3], q[..., 3:]
    n2 = (v * v).sum(-1, keepdim=True)
    small = n2 < SMALL
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    k = torch.where(small, 2.0 / w, 2.0 * torch.atan2(n, w) / n)
    return v * k


class Graph:
    """One recorded solve's problem, as tensors in float64."""

    def __init__(self, inp: dict, device="cpu"):
        def t(x, dtype=F64):
            return torch.as_tensor(x, dtype=dtype, device=device)
        self.P0, self.q0 = t(inp["Ps0"]), t(inp["qs0"])
        self.ei, self.ej = t(inp["ei"], torch.int64), t(inp["ej"], torch.int64)
        self.dP, self.dq, self.w = t(inp["dP"]), t(inp["dq"]), t(inp["w"])
        self.N = self.P0.shape[0]
        self.free = torch.ones(self.N, 1, dtype=F64, device=device)
        if inp["fix_first"]:
            self.free[0] = 0.0

    def poses(self, x):
        """The poses at the local parameters ``x`` (6N,)."""
        d = x.reshape(self.N, 6) * self.free
        return self.P0 + d[:, 3:], qmul(self.q0, qexp(d[:, :3]))

    def residuals(self, P, q):
        """Every edge's weighted residual, flat (6M,)."""
        qi, qj = q[self.ei], q[self.ej]
        r_rot = qlog(qmul(qconj(self.dq), qmul(qconj(qi), qj)))
        r_t = qrotate(qconj(qi), P[self.ej] - P[self.ei]) - self.dP
        return (torch.cat([r_rot, r_t], -1) * self.w[:, None]).reshape(-1)

    def cost(self, P, q) -> float:
        r = self.residuals(P, q)
        return 0.5 * float(r @ r)

    def system(self, x):
        """Dense normal equations at ``x``: H = JᵀJ, b = −Jᵀr, and the cost."""
        def res(y):
            return self.residuals(*self.poses(y))
        r = res(x)
        J = torch.func.jacfwd(res)(x)
        return J.T @ J, -(J.T @ r), 0.5 * float(r @ r)


def lm(g: Graph, max_iter: int):
    """The LM from the input guess; returns the solved local parameters."""
    x = torch.zeros(6 * g.N, dtype=F64, device=g.P0.device)
    H, b, chi = g.system(x)
    lam = 1e-5 * min(float(torch.diagonal(H).abs().max()), 5e10)
    ni, last_chi, it, false_cnt = 2.0, 1e20, 0, 0
    eye = torch.eye(6 * g.N, dtype=F64, device=x.device)
    while it < max_iter:
        dx = torch.linalg.solve(H + lam * eye, b)
        scale = 1e-6 + 0.5 * float(dx @ (lam * dx + b))
        Hc, bc, chi_c = g.system(x + dx)
        rho = (chi - chi_c) / scale
        if rho > 0 and math.isfinite(chi_c):
            alpha = min(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
            lam *= max(alpha, 1.0 / 3.0)
            ni = 2.0
            x, H, b, chi = x + dx, Hc, bc, chi_c
            false_cnt, end = 0, True
        else:
            lam *= ni
            ni *= 2.0
            false_cnt += 1
            end = false_cnt >= MAX_REJECTS
        if end:
            it += 1
            false_cnt = 0
            stop = (last_chi - chi) < STOP_DELTA_CHI
            last_chi = chi
            if stop:
                break
    return x


def solve(rec: dict, device="cpu") -> dict:
    """The reference's solution in float64, as host arrays like the
    program's: {"Ps": (N, 3), "qs": (N, 4)}."""
    g = Graph(rec["inputs"], device)
    P, q = g.poses(lm(g, rec["inputs"]["max_iter"]))
    return dict(Ps=P.cpu().numpy(), qs=q.cpu().numpy())


def _moves(P, q, P_to, q_to):
    """Each pose's move from (P, q) to (P_to, q_to): the norm of its
    [rotation (rad), position (m)]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q_to = q_to / torch.linalg.norm(q_to, dim=-1, keepdim=True)
    return torch.linalg.norm(torch.cat([qlog(qmul(qconj(q), q_to)), P_to - P], -1), dim=-1)


def judge(rec: dict, device="cpu") -> dict:
    """The numbers of one recorded solve: the program's solution against
    the reference's in float64."""
    inp, out = rec["inputs"], rec["outputs"]
    g = Graph(inp, device)
    P_ref, q_ref = g.poses(lm(g, inp["max_iter"]))
    P_out = torch.as_tensor(out["Ps"], dtype=F64, device=device)
    q_out = torch.as_tensor(out["qs"], dtype=F64, device=device)
    c_ref = g.cost(P_ref, q_ref)
    gap = float(_moves(P_ref, q_ref, P_out, q_out).max())
    move = float(_moves(g.P0, g.q0, P_ref, q_ref).max())
    fix = float(_moves(g.P0[:1], g.q0[:1], P_out[:1], q_out[:1]).max()) if inp["fix_first"] \
        else 0.0
    return dict(cost_gap_out=g.cost(P_out, q_out) - c_ref, cost_gap_in=g.cost(g.P0, g.q0) - c_ref,
                pose_gap=gap / move if move > 0 else (0.0 if gap == 0 else math.inf),
                fix_gap=fix, poses=g.N, edges=int(g.ei.shape[0]))
