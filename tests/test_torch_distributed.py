"""The port's distributed solvers over torch.distributed with gloo on the
CPU: ``global_ba.solve_sharded`` and ``sharded.solve_window_sharded`` on
2 and 4 ranks, and the window solve over ``sharded.make_mesh(2)``'s group
of the first 2 ranks in each run, each rank a child process
on a free localhost port with a 60 s collective timeout, against the
port's single-process solvers and the JAX package's.

Bounds: float32 poses ≤ 1e-4 (tests/test_distributed.py's), float64
≤ 1e-8 m; the window solve ≤ 1e-3 in float32 (tests/test_sharding.py's)
and ≤ 1e-8 in float64.  Final chi² across rank counts: in float64 equal
to 1e-9 relative, the parity SCALING.md shows for the JAX package's
float64 reduction (185.785009 at 1 and 2 processes); in float32 the LM
ends at chi² ~2e-6 of its start, below what float32 resolves of chi² at
the start, so the bound there is that resolution: eps·chi²₀.  Every rank
returns the same poses to the bit: the ranks took the same decisions."""
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import testing as jt
from vio_tpu.parallel import global_ba as jg
from vio_tpu.solver import lm as jlm
from vio_tpu_torch import testing as tt
from vio_tpu_torch.parallel import global_ba as tg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL = dict(N=16, M=64, obs_per_lm=4)
PERTURB = dict(pose_sigma=0.02, rot_sigma=0.005)
WINDOW = dict(window_size=4, max_features=32, imu_per_interval=4)
TYPES = {"float32": torch.float32, "float64": torch.float64}

WORKER = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from vio_tpu_torch import testing
from vio_tpu_torch.parallel import global_ba, sharded
res = {}
cpu = dict(device="cpu", dtype=torch.float64)
gt, _ = testing.make_global_problem(N=16, M=64, obs_per_lm=4, **cpu)
noisy = testing.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)
part = global_ba.prepare_sharded(noisy, rank, world)
for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
    o, s = global_ba.solve_sharded(part, max_iter=6, fix_frames=2, device="cpu", dtype=dtype)
    res[f"global_{name}_Ps"] = o.Ps.double().numpy()
    res[f"global_{name}_inv_dep"] = o.inv_dep.double().numpy()
    res[f"global_{name}_stats"] = np.array([float(s["chi2"]), float(s["chi2_init"]),
                                            s["iterations"], s["allreduces"],
                                            s["allreduce_bytes"]])
states, f, _ = testing.make_window_problem(window_size=4, max_features=32,
                                           imu_per_interval=4, **cpu)
ls, lf = sharded.shard_problem(states, f, rank, world)
for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
    ns, _, _, s = sharded.solve_window_sharded(ls, lf, max_iter=2, device="cpu",
                                               dtype=dtype)
    res[f"window_{name}_Ps"] = ns.Ps.double().numpy()
    res[f"window_{name}_stats"] = np.array([float(s["chi2"]), s["iterations"]])
# the window split over the group of the first 2 ranks; the others idle
mesh = sharded.make_mesh(2)
if rank < 2:
    ls, lf = sharded.shard_problem(states, f, rank, 2)
    ns, _, _, s = sharded.solve_window_sharded(ls, lf, mesh, max_iter=2, **cpu)
    res["mesh2_window"] = ns.Ps.numpy()
    res["mesh2_allreduces"] = np.array(s["allreduces"])
dist.barrier()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    """Each rank's results of one run over ``world`` gloo ranks."""
    world = request.param
    out = tmp_path_factory.mktemp(f"ranks{world}")
    env = dict(os.environ, PYTHONPATH=ROOT)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), port,
                               str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in so, f"stdout:{so[-800:]}\nstderr:{se[-2000:]}"
    return world, [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def global_refs():
    """The port's and the JAX package's single-process solves, by type."""
    gj, _ = jt.make_global_problem(**GLOBAL)
    nj = jt.perturb_global(gj, **PERTURB)
    nt = tt.perturb_global(tt.make_global_problem(**GLOBAL, device="cpu",
                                                  dtype=torch.float64)[0], **PERTURB)
    refs = {}
    for name, dtype in TYPES.items():
        cast = jg.GlobalBA(*(jnp.asarray(np.asarray(v).astype(name))
                             if np.asarray(v).dtype.kind == "f" else v for v in nj))
        oj, _ = jg.solve(cast, max_iter=6, fix_frames=2)
        ot, st = tg.solve(nt, max_iter=6, fix_frames=2, device="cpu", dtype=dtype)
        refs[name] = dict(jax=np.asarray(oj.Ps, np.float64), port=ot.Ps.double().numpy(),
                          stats=st)
    return refs


def test_every_rank_ends_with_the_same_poses(ranks):
    world, res = ranks
    for key in [k for k in res[0] if k.endswith("_Ps") or k.endswith("_stats")]:
        for r in range(1, world):
            np.testing.assert_array_equal(res[r][key], res[0][key], err_msg=key)


@pytest.mark.parametrize("dtype", list(TYPES))
def test_solve_sharded_matches_the_single_process_solves(ranks, global_refs, dtype):
    world, res = ranks
    Ps = res[0][f"global_{dtype}_Ps"]
    tol = 1e-4 if dtype == "float32" else 1e-8
    ref = global_refs[dtype]
    for name in ("port", "jax"):
        err = np.abs(Ps - ref[name]).max()
        assert err < tol, (world, dtype, name, err)
    chi2, chi2_init, iters, n_reduce, n_bytes = res[0][f"global_{dtype}_stats"]
    assert iters == ref["stats"]["iterations"]
    # one all_reduce before the loop, one per attempt: the packed
    # float64 (96, 96) system, rhs, chi² and one gain-ratio term
    assert n_reduce == iters + 1 and n_bytes == 8 * (96 * 96 + 96 + 2)


def test_inverse_depths_are_the_single_process_ones(ranks):
    """Each rank's landmark block, put back together, is the single-process
    solve's inverse depths (float64)."""
    world, res = ranks
    nt = tt.perturb_global(tt.make_global_problem(**GLOBAL, device="cpu",
                                                  dtype=torch.float64)[0], **PERTURB)
    ref, _ = tg.solve(nt, max_iter=6, fix_frames=2, device="cpu")
    got = np.concatenate([res[r]["global_float64_inv_dep"] for r in range(world)])
    assert np.abs(got - ref.inv_dep.numpy()).max() < 1e-8


@pytest.mark.parametrize("dtype", list(TYPES))
def test_final_chi2_equal_across_rank_counts(ranks, global_refs, dtype):
    world, res = ranks
    chi2, chi2_init = res[0][f"global_{dtype}_stats"][:2]
    one = float(global_refs[dtype]["stats"]["chi2"])
    if dtype == "float64":
        assert abs(chi2 - one) <= 1e-9 * one, (world, chi2, one)
    else:
        eps = float(torch.finfo(torch.float32).eps)
        assert abs(chi2 - one) <= eps * chi2_init, (world, chi2, one, chi2_init)


@pytest.mark.parametrize("dtype", list(TYPES))
def test_solve_window_sharded_matches_solve_window(ranks, dtype):
    world, res = ranks
    sj, fj, _ = jt.make_window_problem(**WINDOW, dtype=jnp.float64)
    cast = lambda nt: type(nt)(*(cast(v) if hasattr(v, "_fields") else  # noqa: E731
                                 (v.astype(dtype) if v.dtype.kind == "f" else v)
                                 for v in nt))
    ref, _, _, stats = jlm.solve_window(cast(sj), cast(fj), max_iter=2)
    err = np.abs(res[0][f"window_{dtype}_Ps"] - np.asarray(ref.Ps, np.float64)).max()
    assert err < (1e-3 if dtype == "float32" else 1e-8), err
    assert res[0][f"window_{dtype}_stats"][1] == int(stats["iterations"])


def test_make_mesh_groups_the_first_ranks(ranks):
    """Over make_mesh(2), ranks 0 and 1 solve the window of a 2-way split
    as solve_window does (float64, ≤ 1e-8); the other ranks take no part."""
    world, res = ranks
    sj, fj, _ = jt.make_window_problem(**WINDOW, dtype=jnp.float64)
    ref, _, _, stats = jlm.solve_window(sj, fj, max_iter=2)
    for r in range(2):
        err = np.abs(res[r]["mesh2_window"] - np.asarray(ref.Ps)).max()
        assert err < 1e-8, (world, r, err)
        assert int(res[r]["mesh2_allreduces"]) == 1 + int(stats["iterations"]) > 1
    assert all("mesh2_window" not in res[r] for r in range(2, world))
