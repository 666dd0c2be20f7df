"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``.  It needs a
CUDA device and nvcc, and exits non-zero, printing no result, without
them.  Phases, each of which raises on failure:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles vio_tpu_torch/csrc/*.cu for sm_90a (nvcc, at first use);
3. kernel against plain: the Gauss-Jordan kernel against its plain torch
   version on the card, on seeded random SPD systems in float32 (the main
   path's type) and float64, at P ∈ {17, 171, 300, 1024}, at both sides of
   the size where the kernel leaves the registers for the blocked regime,
   and at P ∈ {1, 2, 33, 1023}; times the kernel, the plain version and
   the faster of two library routes (``torch.linalg.solve``,
   ``torch.linalg.cholesky`` + ``torch.cholesky_solve``) with CUDA events,
   and computes the roofline bound from the shapes.  The library call is
   a yardstick only: nothing in the package calls it;
4. ill-conditioned case: a seeded SPD system at P = 171 with eigenvalues
   spread over 1e5 and the estimator's damping λ = 1e-5·max|diag|, kernel
   against plain by backward error and by |Δx|;
5. main path: vio_tpu_torch.runner.run_sim over 150 noise-free frames of
   the simulator at sim_config() (W=10, F=256, P=171) in float32 on the
   card (the default device), held to tests/test_e2e_sim.py's bounds,
   counting the kernel's launches.

Times are printed and recorded, never asserted.  The line before the last
is the kernels' JSON record; the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SIZES = (1, 2, 17, 33, 171, 300, 1023, 1024)
MAIN_P = 171
N_FRAMES = 150
# float32: tests/test_ops.py's bound for float32 elimination; float64:
# round-off of a well-conditioned system (condition number ~10).
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4, residual=1e-4),
       torch.float64: dict(rtol=1e-9, atol=1e-9, residual=1e-12)}
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory,
# float32 and float64 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 33.5e12}


def spd(P: int, dtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    M = torch.randn((P, P), generator=gen, dtype=torch.float64)
    A = M @ M.T + P * torch.eye(P, dtype=torch.float64)
    b = torch.randn((P,), generator=gen, dtype=torch.float64)
    return A.to("cuda", dtype), b.to("cuda", dtype)


def ill_conditioned(P: int, dtype, seed: int):
    """An SPD system of the kind the LM loop solves when the window is
    poorly constrained: eigenvalues log-spaced over 1e5, damped with
    λ = 1e-5·max|diag| (problem.cc:434-436).  Returns A, b on the card
    and A's condition number."""
    gen = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn((P, P), generator=gen, dtype=torch.float64))
    eig = torch.logspace(0, -5, P, dtype=torch.float64)
    A = (Q * eig) @ Q.T
    A = 0.5 * (A + A.T)
    A = A + 1e-5 * A.diagonal().abs().max() * torch.eye(P, dtype=torch.float64)
    b = torch.randn((P,), generator=gen, dtype=torch.float64)
    return A.to("cuda", dtype), b.to("cuda", dtype), float(torch.linalg.cond(A))


def backward_error(A, b, x) -> float:
    """Normwise backward error ‖Ax − b‖ / (‖A‖·‖x‖ + ‖b‖), in float64."""
    A, b, x = A.double(), b.double(), x.double()
    return float(torch.linalg.norm(A @ x - b) /
                 (torch.linalg.norm(A) * torch.linalg.norm(x) + torch.linalg.norm(b)))


def bound_ms(P: int, dtype) -> tuple[float, str]:
    """The least time the card could take for one solve: A and b read
    once and x written once over the memory rate, against the
    elimination's operations (per pivot k, one scaled row and P − 1
    updated rows of P + 1 − k live columns, 2 operations per update) over
    the peak rate of the type.  Returns (milliseconds, which side)."""
    elem = torch.finfo(dtype).bits // 8
    t_bytes = (P * P + 2 * P) * elem / PEAK_BYTES_S
    t_ops = (2 * P - 1) * P * (P + 3) / 2 / PEAK_FLOP_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_solve_ms(A, b) -> float:
    """The faster of PyTorch's two library routes for the same function."""
    lu = cuda_ms(lambda: torch.linalg.solve(A, b), reps=20, warmup=3)
    chol = cuda_ms(lambda: torch.cholesky_solve(b[:, None], torch.linalg.cholesky(A)),
                   reps=20, warmup=3)
    return min(lu, chol)


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Mean milliseconds per call over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    # ---- 1. environment ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    from vio_tpu_torch import metrics, runner, sim
    from vio_tpu_torch.config import sim_config
    from vio_tpu_torch.ops import _build, linsolve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    print(smi)
    tag = f"[{smi.splitlines()[0]}]"

    # ---- 2. build ----
    info = _build.build()
    lib = _build.load()
    print(f"build: {'compiled' if info['built'] else 'up to date'} "
          f"{_build.LIB.name}, nvcc {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 3. kernel against plain, on the card ----
    rec = {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        edge = linsolve.REGISTER_MAX_P[dtype]   # last P held in registers
        for P in sorted(SIZES + (edge, edge + 1)):
            A, b = spd(P, dtype, seed=P)
            x = linsolve.gj_solve(A, b)
            torch.cuda.synchronize()
            x_ref = linsolve.gj_solve_reference(A, b)
            torch.cuda.synchronize()
            torch.testing.assert_close(x, x_ref, rtol=tol["rtol"], atol=tol["atol"])
            err = float((x - x_ref).abs().max())
            res = float(torch.linalg.norm(A @ x - b) / torch.linalg.norm(b))
            if not res <= tol["residual"]:
                raise AssertionError(f"gj_solve residual {res:.3e} at P={P} {dtype}")
            in_registers = lib.gj_solve_work_elems(P, A.element_size()) == 0
            if in_registers != (P <= edge):
                raise AssertionError(f"the kernel's regime at P={P} {dtype} is not "
                                     f"the plain version's (REGISTER_MAX_P {edge})")
            # back-to-back solves from Python: below P ~ 64 this is the
            # host's cost of enqueueing a solve, not the card's time
            ms = cuda_ms(lambda: linsolve.gj_solve(A, b), reps=50, warmup=5)
            plain_ms = cuda_ms(lambda: linsolve.gj_solve_reference(A, b),
                               reps=3 if P > 300 else 10, warmup=1)
            library_ms = library_solve_ms(A, b)
            least_ms, bound_by = bound_ms(P, dtype)
            print(f"gj_solve {str(dtype)[6:]} P={P} "
                  f"({'registers' if in_registers else 'blocked'}): "
                  f"max|x-x_ref| {err:.3e} residual {res:.3e} kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms "
                  f"bound {least_ms:.3e} ms ({bound_by}) {tag}")
            rec[(dtype, P)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                   library_ms=library_ms, bound_ms=least_ms,
                                   bound_by=bound_by)

    # ---- 4. an ill-conditioned system of the estimator's kind ----
    for dtype in (torch.float32, torch.float64):
        eps = torch.finfo(dtype).eps
        A, b, cond = ill_conditioned(MAIN_P, dtype, seed=7)
        x = linsolve.gj_solve(A, b)
        torch.cuda.synchronize()
        x_ref = linsolve.gj_solve_reference(A, b)
        eta, eta_ref = backward_error(A, b, x), backward_error(A, b, x_ref)
        # elimination without growth (A is SPD) is backward stable to a
        # modest multiple of eps; P·eps is the bound held here
        if not (eta <= MAIN_P * eps and eta <= 10 * eta_ref):
            raise AssertionError(f"ill-conditioned {dtype}: backward error {eta:.3e} "
                                 f"(plain {eta_ref:.3e}, bound {MAIN_P * eps:.3e})")
        # two backward-stable solves of one system differ by at most
        # ~cond·eps relative to the solution: that is the bound
        dx = float((x - x_ref).abs().max())
        dx_tol = cond * eps * float(x_ref.abs().max())
        if not (bool(torch.isfinite(x).all()) and dx <= dx_tol):
            raise AssertionError(f"ill-conditioned {dtype}: max|dx| {dx:.3e} > {dx_tol:.3e}")
        print(f"gj_solve {str(dtype)[6:]} P={MAIN_P} ill-conditioned (cond {cond:.3e}): "
              f"backward error kernel {eta:.3e} plain {eta_ref:.3e} "
              f"(bound {MAIN_P * eps:.3e}), max|x-x_ref| {dx:.3e} (bound {dx_tol:.3e}) {tag}")

    # ---- 5. the main path on the card (the default device) ----
    cfg = sim_config()
    data = sim.generate(noise=False)
    linsolve.gj_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, traj = runner.run_sim(data, cfg, n_frames=N_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = linsolve.gj_solve.launches

    iters = sum(t["iterations"] for t in est.telemetry)
    solve_ms = [t["solve_ms"] for t in est.telemetry]
    if not est.initialized:
        raise AssertionError("estimator did not initialize")
    if est.failure_count != 0:
        raise AssertionError(f"failure_count {est.failure_count}")
    if len(traj["t"]) < 130:
        raise AssertionError(f"{len(traj['t'])} poses < 130")
    if not np.all(np.isfinite(traj["p"])) or traj["p"].shape != (len(traj["t"]), 3):
        raise AssertionError("trajectory not finite or misshapen")
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape = metrics.ape_rmse(traj["p"], gt_p)["rmse"]
    if not ape < 0.01:
        raise AssertionError(f"APE {ape} m >= 0.01 m")
    if est.device.type != "cuda" or est.dtype != torch.float32:
        raise AssertionError(f"the main path ran on {est.device} in {est.dtype}")
    if not (launches > 0 and launches >= iters):
        raise AssertionError(f"gj_solve launches {launches}, LM iterations {iters}")
    print(f"main path: {N_FRAMES} frames, {len(traj['t'])} poses, "
          f"{len(est.telemetry)} window solves, {iters} LM iterations {tag}")
    print(f"main path APE rmse {ape:.6f} m {tag}")
    print(f"main path wall {N_FRAMES / wall:.3f} frames/s ({wall:.2f} s) {tag}")
    print(f"main path median solve_ms {statistics.median(solve_ms):.3f} {tag}")
    print(f"main path gj_solve launches {launches} {tag}")

    main = rec[(torch.float32, MAIN_P)]
    print(json.dumps({"kernels": [{
        "name": "gj_solve", "route": "cuda",
        "source": "vio_tpu_torch/csrc/gj_solve.cu",
        "replaces": "vio_tpu/ops/linsolve.py:34",
        "launches": launches, "max_abs_err": main["err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
