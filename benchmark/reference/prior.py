"""Plain reference for the estimator's marginalization prior chain.

After each frame step the estimator folds what the step returned into
the prior that the next step is handed (problem.cc's Marginalize and
the estimator's MargOldFrame / MargNewFrame): a keyframe step's
marginalization block (``marg_Hpp``, ``marg_bp``: the oldest frame's
factors and the old prior, the landmarks eliminated), or, after any
other frame, the old prior with its right-hand side as the solve moved
it.  The chain eliminates one frame's 15 pose and speed-bias parameters
by their Schur complement (an eigendecomposed pseudo-inverse, values
under 1e-8 dropped), takes the square-root form of what is left (``Jt``
with ``JtᵀJt`` the pseudo-inverse, ``err = −Jt b``, the Hessian rebuilt
from the kept eigenpairs with entries under 1e-9 cleared), pads it back
to the window's size and scales it by the configuration's forgetting
factor λ (H, b by λ, err by √λ, Jt by 1/√λ).

Eigenvectors are unique only up to sign, and which eigenvalues near the
cut are kept is an eigensolver's own, so ``judge`` compares what every
sound chain agrees on: H, b, H·Jtᵀ·err (= −H·H⁺·b) and H·JtᵀJt·H (= H),
each as the gap to the reference's over the reference's norm.  The
control computes the chain in a narrower dtype in the place of the
prior that the program handed on.

Nothing here imports the program.
"""
from __future__ import annotations

import torch

EPS = 1e-8
CLEAR = 1e-9


def eliminate(H, b, k: int):
    """The prior after frame ``k``'s block of (H, b) is eliminated, in
    H's dtype: (H', b', err', Jt'), padded to H's size with zeros at the
    end (the window slides by one frame)."""
    P = H.shape[0]
    i0 = 6 + 15 * k
    m = torch.arange(i0, i0 + 15, device=H.device)
    keep = torch.cat([torch.arange(0, i0, device=H.device),
                      torch.arange(i0 + 15, P, device=H.device)])
    Amm = H[m][:, m]
    w, V = torch.linalg.eigh(0.5 * (Amm + Amm.T))
    w_inv = torch.where(w > EPS, 1.0 / torch.where(w > EPS, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    Hkm = H[keep][:, m]
    T = Hkm @ ((V * w_inv) @ V.T)
    Hn = H[keep][:, keep] - T @ Hkm.T
    bn = b[keep] - T @ b[m]
    w, V = torch.linalg.eigh(Hn)
    kept = w > EPS
    s = torch.where(kept, w, torch.zeros_like(w))
    s_inv = torch.where(kept, 1.0 / torch.where(kept, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    Jt = torch.sqrt(s_inv)[:, None] * V.T
    err = -(Jt @ bn)
    Hc = (V * s) @ V.T
    Hc = torch.where(Hc.abs() > CLEAR, Hc, torch.zeros_like(Hc))
    n = P - 15
    Hp, Jtp = H.new_zeros((P, P)), H.new_zeros((P, P))
    bp, errp = b.new_zeros(P), b.new_zeros(P)
    Hp[:n, :n], Jtp[:n, :n], bp[:n], errp[:n] = Hc, Jt, bn, err
    return Hp, bp, errp, Jtp


def forget(Hp, bp, errp, Jtp, lam: float):
    """The configuration's per-frame forgetting of the prior."""
    if lam == 0.0:
        return tuple(torch.zeros_like(x) for x in (Hp, bp, errp, Jtp))
    if lam < 1.0:
        r = lam ** 0.5
        return Hp * lam, bp * lam, errp * r, Jtp / r
    return Hp, bp, errp, Jtp


def _invariants(Hp, bp, errp, Jtp):
    return dict(H=Hp, b=bp, Herr=Hp @ (Jtp.T @ errp), HJJH=Hp @ (Jtp.T @ Jtp) @ Hp)


def _gap(a, ref) -> float:
    d, n = float(torch.linalg.norm(a - ref)), float(torch.linalg.norm(ref))
    if n == 0.0:
        return 0.0 if d == 0.0 else float("inf")
    return d / n


def judge(rec: dict, lam: float, device="cpu", dtype=None) -> float | None:
    """The widest gap between the prior the program handed the step after
    ``rec`` and the reference's chain from ``rec``'s outputs; None where
    the window closed before that step.  With ``dtype`` the reference's
    chain in that dtype stands in for the program's prior."""
    nxt = rec.get("next_prior")
    if nxt is None:
        return None

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)
    inp, out = rec["inputs"], rec["outputs"]
    P = t(inp["H_prior"]).shape[0]
    if inp["marg_old"]:
        H, b, k = t(out["marg_Hpp"]), t(out["marg_bp"]), 0
    else:
        H, b, k = t(inp["H_prior"]), t(out["b_prior"]), (P - 6) // 15 - 2
    ref = _invariants(*forget(*eliminate(H, b, k), lam))
    if dtype is None:
        handed = [t(nxt[key]) for key in ("H_prior", "b_prior", "err_prior", "Jt_prior_inv")]
    else:
        handed = [x.to(torch.float64) for x in forget(*eliminate(H.to(dtype), b.to(dtype), k),
                                                      lam)]
    prog = _invariants(*handed)
    return max(_gap(prog[key], ref[key]) for key in ref)
