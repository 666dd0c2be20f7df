"""Generic camera-point block bundle-adjustment engine.

Port of ``vio_tpu/solver/blockba.py``: the shared machinery behind BAL BA
(solver/bal.py) and photometric direct BA (features/direct.py).
Per-observation residual/Jacobian batches are scatter-added with
``index_add_`` (``jax.ops.segment_sum`` in the JAX package) into block
normal equations — a block-diagonal camera Hessian (DC*C, DC*C), batched
3x3 point blocks and a dense (C, M, DC, 3) coupling tensor — then the
point blocks are Schur-eliminated and the damped reduced camera system is
solved by ``linsolve.spd_solve``: the Gauss-Jordan kernel on a CUDA
tensor (the blocked regime above 176 unknowns in float32), its plain
version on a CPU tensor.  A host-side Nielsen-LM drives it, as in the JAX
package.  Every function works on its input tensors' device and dtype.

(reference: 07-backend-optimization/01-bal-g2o/src/bal_g2o.cpp and
02-direct-ba/direct_ba.cpp; block solve structure as in
vins-mono/src/backend/problem.cc:394-451.)
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops import linsolve


class BlockNormal(NamedTuple):
    Hcc: torch.Tensor   # (DC*C, DC*C)
    bc: torch.Tensor    # (DC*C,)
    Hpp: torch.Tensor   # (M, 3, 3)
    bp: torch.Tensor    # (M, 3)
    Wcp: torch.Tensor   # (C, M, DC, 3)
    chi2: torch.Tensor  # ()


def _segment_sum(x, idx, n: int):
    """Rows of x summed into n segments by idx (jax.ops.segment_sum).  On
    a CUDA tensor the order of the sums is not fixed (atomics)."""
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add_(0, idx, x)


def assemble_blocks(r, Jc, Jp, cam_idx, pt_idx, w, rho, C: int, M: int,
                    fixed_diag=None) -> BlockNormal:
    """Build block normal equations from per-observation batches.

    r (O, R) residuals; Jc (O, R, DC), Jp (O, R, 3) Jacobians (already
    zeroed for fixed cameras); w (O,) combined validity+robust weight;
    rho (O,) robust chi contribution.  fixed_diag: optional (DC*C,) vector
    added to the camera diagonal (1.0 on fixed/disabled parameters keeps
    the reduced system SPD)."""
    DC = Jc.shape[-1]
    Jc_w = Jc * w[:, None, None]
    rw = r * w[:, None]

    Hcc_d = _segment_sum(torch.einsum("ori,orj->oij", Jc_w, Jc), cam_idx, C)
    bc_d = _segment_sum(-torch.einsum("ori,or->oi", Jc, rw), cam_idx, C)
    Hcc = torch.zeros((C, DC, C, DC), dtype=r.dtype, device=r.device)
    c = torch.arange(C, device=r.device)
    Hcc[c, :, c, :] = Hcc_d                          # block diagonal
    Hcc = Hcc.reshape(DC * C, DC * C)
    bc = bc_d.reshape(DC * C)
    if fixed_diag is not None:
        Hcc = Hcc + torch.diag(fixed_diag)

    Hpp = _segment_sum(torch.einsum("ori,orj->oij", Jp * w[:, None, None], Jp),
                       pt_idx, M)
    bp = _segment_sum(-torch.einsum("ori,or->oi", Jp, rw), pt_idx, M)

    Wcp = _segment_sum(torch.einsum("ori,orj->oij", Jc_w, Jp),
                       cam_idx * M + pt_idx, C * M).reshape(C, M, DC, 3)
    chi2 = 0.5 * torch.sum(rho)
    return BlockNormal(Hcc=Hcc, bc=bc, Hpp=Hpp, bp=bp, Wcp=Wcp, chi2=chi2)


def schur_solve(n: BlockNormal, lam, C: int, M: int):
    """Point-block Schur elimination -> damped reduced camera solve ->
    back-substitution.  Returns (dxc (C, DC), dxp (M, 3)).  The 3x3 point
    blocks are inverted by ``torch.linalg.inv`` (``jnp.linalg.inv`` in the
    JAX package, outside any Pallas kernel there too)."""
    DC = n.Wcp.shape[2]
    eye3 = torch.eye(3, dtype=n.bc.dtype, device=n.bc.device)
    Hpp_d = n.Hpp + lam * eye3[None]
    Hpp_inv = torch.linalg.inv(Hpp_d + 1e-12 * eye3[None])          # (M,3,3)
    WHinv = torch.einsum("cmij,mjk->cmik", n.Wcp, Hpp_inv)          # (C,M,DC,3)
    S = (n.Hcc + lam * torch.eye(DC * C, dtype=n.bc.dtype, device=n.bc.device)
         - torch.einsum("cmik,dmjk->cidj", WHinv, n.Wcp).reshape(DC * C, DC * C))
    rhs = n.bc - torch.einsum("cmik,mk->ci", WHinv, n.bp).reshape(DC * C)
    dxc = linsolve.spd_solve(S, rhs)
    dxc_b = dxc.reshape(C, DC)
    rp = n.bp - torch.einsum("cmik,ci->mk", n.Wcp, dxc_b)
    dxp = torch.einsum("mij,mj->mi", Hpp_inv, rp)
    return dxc_b, dxp


def lm_loop(p0, assemble_fn: Callable, apply_fn: Callable, C: int, M: int,
            max_iter: int = 30, lam0_scale: float = 1e-4,
            verbose: bool = False):
    """Host-side Nielsen LM over the block-Schur system, as in the JAX
    package: λ, ν and the chi² history are host floats, one device read
    for chi² per assembly and one for the gain ratio per attempt.

    assemble_fn(p) -> BlockNormal; apply_fn(p, dxc, dxp) -> p."""
    p = p0
    n = assemble_fn(p)
    lam = lam0_scale * float(torch.max(torch.abs(torch.diagonal(n.Hcc))))
    ni = 2.0
    chi = float(n.chi2)
    history = [chi]
    for _ in range(max_iter):
        dxc, dxp = schur_solve(n, lam, C, M)
        cand = apply_fn(p, dxc, dxp)
        n_cand = assemble_fn(cand)
        chi_cand = float(n_cand.chi2)
        dx = torch.cat([dxc.reshape(-1), dxp.reshape(-1)])
        b = torch.cat([n.bc, n.bp.reshape(-1)])
        scale = 0.5 * float(torch.dot(dx, lam * dx + b)) + 1e-12
        rho = (chi - chi_cand) / scale
        if rho > 0 and math.isfinite(chi_cand):
            alpha = min(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
            lam *= max(1.0 / 3.0, alpha)
            ni = 2.0
            stop = (chi - chi_cand) < 1e-8 * max(chi, 1.0)
            p, n, chi = cand, n_cand, chi_cand
            history.append(chi)
            if verbose:
                print(f"iter chi2={chi:.6e} lam={lam:.3e}")
            if stop:
                break
        else:
            lam *= ni
            ni *= 2.0
            if lam > 1e16:
                break
    return p, history
