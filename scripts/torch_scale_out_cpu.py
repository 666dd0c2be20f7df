"""CPU yardsticks behind chip_smoke.py's scale-out bounds (phases 11, 13).

    python scripts/torch_scale_out_cpu.py jax    # needs JAX: vio_tpu's float32 run
    python scripts/torch_scale_out_cpu.py ranks  # torch only: 1 against 2 gloo ranks

``jax``: bench.py's scale-out problem (100 keyframes, 400 landmarks, 8
observations each, max_iter=10, loss_delta=50) solved in float32 by
``vio_tpu`` (64-bit mode off, as a float32 TPU run is) and by the port on
the CPU: chi² and the largest pose error against the ground truth, and the
chi² of each float32 result recomputed in float64 by the port's
``global_ba.assemble``.  At loss_delta=50 the Cauchy cost
δ²·log(e²/δ² + 1) rounds to 0 in float32 once e² < ~1.5e-4, so the float32
run's own chi² reads 0 near the solution; the float64 recomputation is
the reading that says how far the run got.

``ranks``: ``global_ba.solve_sharded`` at SCALING.md's second row (64
keyframes, 8,192 landmarks, 65,536 observations, 8 iterations) on 1 and
on 2 gloo ranks on the CPU, in float64 and float32: how far apart the two
end, in poses and in chi².

Prints one line per run; every number is a CPU number, no device's.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BENCH = dict(N=100, M=400, obs_per_lm=8)
DIST = dict(N=64, M=8192, obs_per_lm=8)
PERTURB = dict(pose_sigma=0.02, rot_sigma=0.005)


def jax_part():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from vio_tpu import testing as jt
    from vio_tpu.parallel import global_ba as jg
    from vio_tpu_torch import convert, testing as tt
    from vio_tpu_torch.parallel import global_ba as tg

    torch.set_num_threads(1)

    def chi2_64(p):
        """chi² of a result, recomputed in float64 (the port's assembly)."""
        p = convert.global_ba_from_numpy({k: np.asarray(v) for k, v in p._asdict().items()},
                                         device="cpu", dtype=torch.float64)
        return float(tg.assemble(p, BENCH["N"], BENCH["M"], 2, 50.0).chi2)

    gt, _ = jt.make_global_problem(**BENCH, dtype=jnp.float32)
    noisy = jt.perturb_global(gt, **PERTURB)
    c0 = chi2_64(noisy)
    out, st = jg.solve(noisy, max_iter=10, fix_frames=2, loss_delta=50.0)
    err = np.linalg.norm(np.asarray(out.Ps - gt.Ps), axis=1).max()
    print(f"vio_tpu float32 (CPU): {int(st['iterations'])} iterations, chi2 "
          f"{float(st['chi2']):.6e} of {float(st['chi2_init']):.6e}, max pose error {err:.6e} m; "
          f"float64 chi2 {chi2_64(out):.6e} of {c0:.6e} (ratio {chi2_64(out) / c0:.3e})")
    gt, _ = tt.make_global_problem(**BENCH, device="cpu", dtype=torch.float32)
    out, st = tg.solve(tt.perturb_global(gt, **PERTURB), max_iter=10, fix_frames=2,
                       loss_delta=50.0, device="cpu")
    err = float(torch.linalg.norm(out.Ps - gt.Ps, dim=1).max())
    print(f"vio_tpu_torch float32 (CPU): {st['iterations']} iterations, chi2 "
          f"{float(st['chi2']):.6e} of {float(st['chi2_init']):.6e}, max pose error {err:.6e} m; "
          f"float64 chi2 {chi2_64(out):.6e} of {c0:.6e} (ratio {chi2_64(out) / c0:.3e})")


def rank_worker(rank, world, port, queue):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    from vio_tpu_torch import testing
    from vio_tpu_torch.parallel import global_ba
    gt, _ = testing.make_global_problem(**DIST, device="cpu", dtype=torch.float64)
    part = global_ba.prepare_sharded(testing.perturb_global(gt, **PERTURB), rank, world)
    res = {}
    for dtype in (torch.float64, torch.float32):
        out, st = global_ba.solve_sharded(part, max_iter=8, fix_frames=2, device="cpu",
                                          dtype=dtype)
        res[str(dtype)[6:]] = (out.Ps.double().numpy(), float(st["chi2"]), st["iterations"])
    dist.destroy_process_group()
    queue.put((rank, res))


def run(world):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=rank_worker, args=(r, world, port, queue)) for r in range(world)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=900) for _ in range(world))
    for p in procs:
        p.join(timeout=60)
    return got[0]


def ranks_part():
    one, two = run(1), run(2)
    for name in ("float64", "float32"):
        (P1, c1, i1), (P2, c2, i2) = one[name], two[name]
        print(f"solve_sharded {name} (CPU, gloo): 1 rank chi2 {c1:.9e} ({i1} iterations), "
              f"2 ranks chi2 {c2:.9e} ({i2}); |dchi2|/chi2 {abs(c2 - c1) / c1:.3e}, "
              f"max |dP| {np.abs(P2 - P1).max():.3e} m")


if __name__ == "__main__":
    {"jax": jax_part, "ranks": ranks_part}[sys.argv[1]]()
