"""The sliding-window LM solve with its feature axis split over the ranks
of a ``torch.distributed`` process group.

Port of ``vio_tpu/parallel/sharded.py``.  There the reprojection-factor
axis F is sharded over a ``factor`` mesh axis and GSPMD partitions
``lm.solve_window`` (reference hot-spot notes: vins-mono/src/backend/
problem.cc:311-313,420,696, "TODO:: use openMP" at Hessian assembly and
landmark-block inversion).  Here the split is written out:

- each rank holds F/world features (``shard_problem``) and assembles their
  reprojection terms; its landmark Schur step is local (the landmark
  block is diagonal);
- IMU factors and the marginalization prior are assembled once, on rank
  0: the other ranks hold them masked off (``imu_valid`` False, zero prior
  tensors);
- each λ-attempt makes ONE all_reduce, in float64 on the wire: the reduced
  pose system, its right-hand side, chi² and the landmark terms of the
  gain ratio (``global_ba.all_reduce_system``);
- the damped pose solve is replicated on every rank and goes through
  ``linsolve.spd_solve`` (the Gauss-Jordan kernel on a CUDA tensor); the
  landmark back-substitution stays local.

The loop is ``solver/lm.py::solve_window``'s, given the group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import move, resolve
from ..solver import lm, window as W


def make_mesh(n_devices: int | None = None):
    """The factor axis: the process group of the first ``n_devices`` ranks
    of the default group (all of them when None).  Every rank of the
    default group must call it, as ``torch.distributed.new_group``
    requires."""
    world = dist.get_world_size()
    n = n_devices or world
    return dist.group.WORLD if n == world else dist.new_group(list(range(n)))


def shard_problem(states: W.WindowStates, f: W.WindowFactors, rank: int,
                  world: int):
    """Rank ``rank``'s part of a window problem: features
    [rank·F/world, (rank+1)·F/world) with their inverse depths; poses,
    speed-biases and extrinsics replicated; IMU factors and prior on rank 0
    only.  F must divide by ``world``."""
    F = states.inv_dep.shape[0]
    if F % world:
        raise ValueError(f"{F} feature slots do not divide by {world} ranks")
    sl = slice(rank * (F // world), (rank + 1) * (F // world))
    states = states._replace(inv_dep=states.inv_dep[sl])
    f = f._replace(pts_i=f.pts_i[sl], pts_j=f.pts_j[sl], start=f.start[sl],
                   obs_mask=f.obs_mask[sl], feat_valid=f.feat_valid[sl])
    if rank != 0:
        z = torch.zeros_like
        f = f._replace(imu_valid=torch.zeros_like(f.imu_valid),
                       H_prior=z(f.H_prior), b_prior=z(f.b_prior),
                       err_prior=z(f.err_prior), Jt_prior_inv=z(f.Jt_prior_inv))
    return states, f


def solve_window_sharded(states: W.WindowStates, f: W.WindowFactors,
                         group=None, max_iter: int = 10, fix_ext: bool = True,
                         loss_delta: float = 1.0, device=None, dtype=None):
    """``lm.solve_window`` of this rank's ``shard_problem`` part over the
    ranks of ``group`` (None: the default group).  The problem is moved to
    ``device`` and ``dtype`` first (without them, the card in float32).
    Returns (this rank's states, b_prior, err_prior, stats) as
    ``solve_window`` does, stats with the all_reduce count and bytes."""
    device, dtype = resolve(device, dtype)
    return lm.solve_window(move(states, device, dtype), move(f, device, dtype),
                           max_iter=max_iter, fix_ext=fix_ext, loss_delta=loss_delta,
                           group=dist.group.WORLD if group is None else group)


def training_step(states, f, group=None, max_iter: int = 10, device=None,
                  dtype=None):
    """One estimator device-step at scale: the LM solve of this rank's
    part of the window.  Returns the updated states and the final chi²."""
    new_states, _, _, stats = solve_window_sharded(
        states, f, group, max_iter=max_iter, device=device, dtype=dtype)
    return new_states, stats["chi2"]
