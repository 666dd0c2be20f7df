"""Generic dense LM solver with Nielsen and ALPHA λ-strategies.

Port of ``vio_tpu/solver/generic.py`` (reference: 13-vio-bundle-adjustment/
src/curve_fitting/src/backend/problem.cc:307-395), in two forms.

``lm_solve_dense`` is the JAX package's loop as it is: the caller's
functions may return torch tensors on any device; the loop itself and its
dense solve run on the host in float64 numpy.  The SfM bootstrap BA and
the calibrations use it (either strategy).

The device form (``start``, ``attempt``, ``graph_fns``) runs the same
Nielsen loop with no host read inside it, for the pose
graph (``loop/posegraph.py``): one λ-attempt is a transition of the
device-resident ``LMState``, its accept/reject turned into ``torch.where``
selects and every update gated by the loop's condition, so an attempt
made after the loop has ended changes no bit (as ``solver/lm.py``'s and
``parallel/global_ba.py``'s).  The normal equations are re-linearised at
every candidate and selected on accept; the damped solve (H + λI) dx = b
(H + λI is SPD, its contract) is the library's Cholesky on a CUDA tensor
(``linsolve.cholesky_solve``, captured with the rest) and
``torch.linalg.solve`` on the CPU, ``vio_tpu``'s own ``np.linalg.solve``.
``graph_fns`` gives the loop's head, chunk and tail, the program that
``solver/graph.py``'s executors run.  The ALPHA strategy stays on the
host loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import linsolve
from ..utils.tree import select
from . import graph


class LMLog(NamedTuple):
    chi2: list
    lam: list


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def lm_solve_dense(normal_fn: Callable, chi2_fn: Callable, plus_fn: Callable,
                   x0, max_iter: int = 50, strategy: str = "nielsen",
                   stop_delta_chi: float = 1e-5, verbose: bool = False,
                   log_csv: str | None = None):
    """Minimize 0.5·Σ chi² with LM.

    normal_fn(x) -> (H, b, chi2)   — assembled normal equations (chi2 already
                                     0.5-scaled like the reference's Solve)
    chi2_fn(x)   -> chi2           — residual-only evaluation
    plus_fn(x, dx) -> x            — local update; dx is a float64 CPU tensor
    """
    x = x0
    H, b, chi = normal_fn(x)
    H = _host(H)
    b = _host(b)
    chi = float(chi)

    max_diag = min(float(np.max(np.abs(np.diag(H)))), 5e10)
    lam = 1e-5 * max_diag
    ni = 2.0
    last_chi = 1e20
    log = LMLog(chi2=[chi], lam=[lam])

    it = 0
    stop = False
    while not stop and it < max_iter:
        one_step_success = False
        false_cnt = 0
        while not one_step_success and false_cnt < 10:
            dx = np.linalg.solve(H + lam * np.eye(H.shape[0]), b)

            def chi_and_rho(alpha):
                scale = 1e-6 + 0.5 * float((alpha * dx) @ (lam * (alpha * dx) + b))
                x_new = plus_fn(x, torch.as_tensor(alpha * dx))
                c = float(chi2_fn(x_new))
                return x_new, c, (chi - c) / scale

            if strategy == "nielsen":
                x_new, temp_chi, rho = chi_and_rho(1.0)
                if rho > 0 and np.isfinite(temp_chi):
                    alpha = min(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
                    lam *= max(1.0 / 3.0, alpha)
                    ni = 2.0
                    x, chi = x_new, temp_chi
                    one_step_success = True
                else:
                    lam *= ni
                    ni *= 2.0
                    false_cnt += 1
            elif strategy == "alpha":
                # (13-.../problem.cc:364-395 IsGoodStepInLMAlpha), with
                # alpha clamped into (1e-3, 1] as in the JAX package
                _, proposed_chi, _ = chi_and_rho(1.0)
                product = float(b @ dx)
                alpha = 1.0 / ((proposed_chi - chi) / product + 2.0)
                alpha = min(1.0, max(alpha, 1e-3))
                x_new, temp_chi, rho = chi_and_rho(alpha)
                if rho > 0 and np.isfinite(temp_chi):
                    lam = max(lam / (1.0 + alpha), 1e-7)
                    x, chi = x_new, temp_chi
                    one_step_success = True
                else:
                    lam += abs(temp_chi - chi) / (2.0 * alpha)
                    false_cnt += 1
            else:
                raise ValueError(f"unknown strategy {strategy}")

            if one_step_success:
                H, b, chi = normal_fn(x)
                H = _host(H)
                b = _host(b)
                chi = float(chi)
        it += 1
        log.chi2.append(chi)
        log.lam.append(lam)
        if verbose:
            print(f"iter {it}: chi2={chi:.6e} lambda={lam:.3e}")
        if last_chi - chi < stop_delta_chi:
            stop = True
        last_chi = chi
    if log_csv:
        with open(log_csv, "w") as fh:
            fh.write("iter,chi2,lambda\n")
            for i, (c, l) in enumerate(zip(log.chi2, log.lam)):
                fh.write(f"{i},{c},{l}\n")
    return x, dict(chi2=chi, iterations=it, log=log)


# ---------------------------------------------------------------------------
# The Nielsen loop on the device
# ---------------------------------------------------------------------------

MAX_REJECTS = 10          # rejected attempts that end an iteration


class DenseProblem(NamedTuple):
    """What every attempt of one device solve reads and never changes."""
    normal_fn: Callable      # x -> (H, b, chi2) on the device, chi2 0.5-scaled
    plus_fn: Callable        # (x, dx) -> x
    max_iter: int
    stop_delta_chi: float


class LMState(NamedTuple):
    """The loop's carry, all on the device: the point and its normal
    equations, the damping and Nielsen's ν, the rejections in the current
    iteration, the iterations made, the last iteration's chi², the stop
    flag, and the chi²/λ log (entry k after iteration k; entry 0 the
    start's)."""
    x: torch.Tensor
    H: torch.Tensor
    b: torch.Tensor
    chi: torch.Tensor
    lam: torch.Tensor
    ni: torch.Tensor
    false_cnt: torch.Tensor  # int64
    it: torch.Tensor         # int64
    last_chi: torch.Tensor
    stop: torch.Tensor       # bool
    log_chi: torch.Tensor    # (max_iter + 1,)
    log_lam: torch.Tensor    # (max_iter + 1,)


def damped_solve(H, b, lam):
    """(H + λI) dx = b: the library's Cholesky (``linsolve.cholesky_solve``,
    no host read, so the captured graphs hold it) on a CUDA tensor at
    every size, ``torch.linalg.solve`` on the CPU."""
    A = H.clone()
    A.diagonal().add_(lam)
    if A.is_cuda:
        return linsolve.cholesky_solve(A, b)
    return torch.linalg.solve(A, b)


def start(q: DenseProblem, x0) -> LMState:
    """The first linearisation and λ0 = 1e-5 · min(max |diag H|, 5e10)."""
    H, b, chi = q.normal_fn(x0)
    lam = 1e-5 * torch.clamp(torch.max(torch.abs(torch.diagonal(H))), max=5e10)
    def count():
        return torch.zeros((), dtype=torch.int64, device=chi.device)

    pad = chi.new_zeros(q.max_iter)
    return LMState(x=x0, H=H, b=b, chi=chi, lam=lam, ni=torch.full_like(lam, 2.0),
                   false_cnt=count(), it=count(), last_chi=torch.full_like(chi, 1e20),
                   stop=torch.zeros((), dtype=torch.bool, device=chi.device),
                   log_chi=torch.cat([chi[None], pad]), log_lam=torch.cat([lam[None], pad]))


def live(s: LMState, max_iter: int):
    """The outer loop's condition, a 0-d bool: not stopped and under the
    iteration cap."""
    return ~s.stop & (s.it < max_iter)


def attempt(s: LMState, q: DenseProblem) -> LMState:
    """One λ-attempt of ``lm_solve_dense``'s Nielsen rule with no host
    read: the candidate is linearised, accepted where ρ > 0 and its chi²
    is finite, and the iteration ends on accept or at the MAX_REJECTS-th
    rejection (its count, log entry, stop test and last chi²).  Everything
    is masked by ``live``."""
    go = live(s, q.max_iter)
    dx = damped_solve(s.H, s.b, s.lam)
    scale = 1e-6 + 0.5 * torch.dot(dx, s.lam * dx + s.b)
    x_c = q.plus_fn(s.x, dx)
    H_c, b_c, chi_c = q.normal_fn(x_c)
    rho = (s.chi - chi_c) / scale
    good = (rho > 0) & torch.isfinite(chi_c)
    acc = go & good
    rej = go & ~good

    alpha = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, max=2.0 / 3.0)
    x, H, b, chi = select(acc, (x_c, H_c, b_c, chi_c), (s.x, s.H, s.b, s.chi))
    lam = torch.where(acc, s.lam * torch.clamp(alpha, min=1.0 / 3.0),
                      torch.where(rej, s.lam * s.ni, s.lam))
    ni = torch.where(acc, torch.full_like(s.ni, 2.0), torch.where(rej, s.ni * 2.0, s.ni))
    false_cnt = s.false_cnt + rej.to(s.false_cnt.dtype)
    end = acc | (rej & (false_cnt >= MAX_REJECTS))
    it = s.it + end.to(s.it.dtype)
    at = end & (torch.arange(q.max_iter + 1, device=it.device) == it)
    return LMState(x=x, H=H, b=b, chi=chi, lam=lam, ni=ni,
                   false_cnt=torch.where(end, torch.zeros_like(false_cnt), false_cnt),
                   it=it, last_chi=torch.where(end, chi, s.last_chi),
                   stop=torch.where(end, (s.last_chi - chi) < q.stop_delta_chi, s.stop),
                   log_chi=torch.where(at, chi, s.log_chi),
                   log_lam=torch.where(at, lam, s.log_lam))


def attempts(s: LMState, q: DenseProblem, k: int) -> LMState:
    """``k`` attempts in a row, with no host read."""
    for _ in range(k):
        s = attempt(s, q)
    return s


def device_stats(chi, it, log_chi, log_lam, attempts: int, reads: int) -> dict:
    """``lm_solve_dense``'s stats from the device loop's results, read back
    to the host: chi2, iterations and the log cut to the iterations made,
    with the attempts made and the host reads of the loop's condition."""
    it = int(it)
    return dict(chi2=float(chi), iterations=it,
                log=LMLog(chi2=np.asarray(log_chi, np.float64)[:it + 1].tolist(),
                          lam=np.asarray(log_lam, np.float64)[:it + 1].tolist()),
                attempts=attempts, reads=reads)


def graph_fns(make: Callable):
    """The head, chunk and tail of a device solve's loop.
    ``make(views)`` builds the solve from the graph's input views:
    (DenseProblem, x0, outputs), ``outputs(x)`` the tensors the caller
    wants of the solution.  The tail gives those, then chi², the
    iterations and the chi²/λ log."""
    def begin(views):
        q, x0, outputs = make(views)
        return start(q, x0), (q, outputs)

    return graph.loop_fns(begin, lambda s, aux, k: attempts(s, aux[0], k),
                          lambda s, aux: live(s, aux[0].max_iter),
                          lambda s, aux: [*aux[1](s.x), s.chi, s.it, s.log_chi, s.log_lam])
