"""What the bootstrap's RANSAC does to the float32 main path of the PyTorch
port: ``runner.run_sim`` over the noise-free simulator (``sim_config()``,
the estimator in float32 on the card) with the init's ``essential_ransac``
on the RANSAC kernel (``ops/ransac.py`` on CUDA tensors) and on its plain
version (``torch.linalg.svd`` on the card), for several seeds of the
samples' draw (``sfm.solve_relative_rt``'s ``seed``).

For every bootstrap call of the kernel's runs it prints how far the
kernel's and the plain float32 version's E (up to sign), inlier set and
relative pose (``recover_pose`` in float32, as the estimator runs it) are
from the plain version run in float64 on the same float32 inputs; for
every run, the APE.  So it says which of the two is nearer the float64
answer, and how much of the APE's spread the bootstrap explains.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_bootstrap_ransac.py [--seeds 0 1 2] [--frames 150]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_tpu_torch import metrics, runner, sim  # noqa: E402
from vio_tpu_torch.config import sim_config  # noqa: E402
from vio_tpu_torch.init import sfm  # noqa: E402
from vio_tpu_torch.ops import ransac  # noqa: E402


def _up_to_sign(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(min((a - b).abs().max(), (a + b).abs().max()))


def _angle_deg(R) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def _pose(E, x0, x1, inl):
    R, t, _ = sfm.recover_pose(E, x0, x1, inl)
    return R.double().cpu().numpy(), t.double().cpu().numpy()


def _plain(fn):
    """Run ``fn`` with ``ops.ransac``'s kernels replaced by their plain
    versions (which take CUDA tensors too)."""
    kernels = ransac.sweep, ransac.refit, ransac.refit_best
    ransac.sweep, ransac.refit, ransac.refit_best = (
        ransac.sweep_reference, ransac.refit_reference, ransac.refit_best_reference)
    try:
        return fn()
    finally:
        ransac.sweep, ransac.refit, ransac.refit_best = kernels


def compare(call) -> dict:
    """The kernel's and the plain float32 version's bootstrap against the
    plain version in float64 on the same inputs."""
    x0, x1, valid, idx, thresh = call
    E_k, inl_k, _ = sfm.essential_ransac_from_samples(x0, x1, valid, idx, thresh)
    E_p, inl_p, _ = _plain(lambda: sfm.essential_ransac_from_samples(x0, x1, valid, idx,
                                                                      thresh))
    w0, w1 = x0.double(), x1.double()
    E_r, inl_r, _ = _plain(lambda: sfm.essential_ransac_from_samples(w0, w1, valid, idx,
                                                                      thresh))
    R_r, t_r = _pose(E_r, w0, w1, inl_r)
    row = dict(rows=int(valid.sum()), inliers64=int(inl_r.sum()))
    for name, E, inl in (("kernel", E_k, inl_k), ("plain32", E_p, inl_p)):
        R, t = _pose(E, x0, x1, inl)
        row[name] = dict(
            dE=_up_to_sign(E, E_r), inlier_flips=int((inl != inl_r).sum()),
            dR_deg=_angle_deg(R @ R_r.T),
            dt_deg=float(np.degrees(np.arccos(np.clip(
                t @ t_r / (np.linalg.norm(t) * np.linalg.norm(t_r)), -1.0, 1.0)))))
    return row


def run(data, cfg, frames: int, seed: int, plain: bool) -> tuple[float, list]:
    """One run_sim in float32 on the card; returns its APE and the inputs
    of every bootstrap RANSAC it made."""
    calls, solve, from_samples = [], sfm.solve_relative_rt, sfm.essential_ransac_from_samples

    def seeded(*args, **kw):
        kw["seed"] = seed
        return solve(*args, **kw)

    def recording(x0, x1, valid, idx, thresh=0.3 / 460.0):
        calls.append((x0.clone(), x1.clone(), valid.clone(), idx.clone(), thresh))
        return from_samples(x0, x1, valid, idx, thresh)

    sfm.solve_relative_rt, sfm.essential_ransac_from_samples = seeded, recording
    try:
        go = lambda: runner.run_sim(data, cfg, n_frames=frames, device="cuda",  # noqa: E731
                                    dtype=torch.float32)
        est, traj = _plain(go) if plain else go()
    finally:
        sfm.solve_relative_rt, sfm.essential_ransac_from_samples = solve, from_samples
    if not est.initialized or est.failure_count != 0:
        raise AssertionError(f"seed {seed} {'plain' if plain else 'kernel'}: initialized "
                             f"{est.initialized}, failure_count {est.failure_count}")
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    return metrics.ape_rmse(traj["p"], gt_p)["rmse"], calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--frames", type=int, default=150)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bootstrap_ransac: needs a CUDA device", file=sys.stderr)
        return 1
    cfg, data = sim_config(), sim.generate(noise=False)
    apes = {}
    for seed in args.seeds:
        ape_k, calls = run(data, cfg, args.frames, seed, plain=False)
        ape_p, _ = run(data, cfg, args.frames, seed, plain=True)
        apes[seed] = (ape_k, ape_p)
        print(f"seed {seed}: APE kernel {ape_k:.6f} m, plain float32 {ape_p:.6f} m; "
              f"{len(calls)} bootstrap calls")
        for i, call in enumerate(calls):
            r = compare(call)
            parts = [f"{name} |dE| {r[name]['dE']:.3e}, {r[name]['inlier_flips']} inlier "
                     f"flags differ, R {r[name]['dR_deg']:.3e} deg, t {r[name]['dt_deg']:.3e} "
                     f"deg" for name in ("kernel", "plain32")]
            print(f"  call {i}: {r['rows']} rows, {r['inliers64']} float64 inliers; against "
                  f"float64: " + "; ".join(parts))
    k, p = (np.array([a[i] for a in apes.values()]) for i in (0, 1))
    print(f"APE over seeds {args.seeds}: kernel mean {k.mean():.6f} m (min {k.min():.6f}, "
          f"max {k.max():.6f}); plain float32 mean {p.mean():.6f} m (min {p.min():.6f}, "
          f"max {p.max():.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
