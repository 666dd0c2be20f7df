"""How far round-off alone moves vio_tpu, beside how far the port is from
it, on the CPU in float64: the yardsticks behind the tolerances of
tests/test_torch_td_extrinsic.py and tests/test_torch_marginalize.py.

    python scripts/torch_round_off_spread.py td [--frames 50] [--dtype float32]
    python scripts/torch_round_off_spread.py handover [--frames 300]
    python scripts/torch_round_off_spread.py marginalize

``td``: tests/test_td.py's online-td stream (true lag 6 ms, td from 0):
vio_tpu against itself with its accelerometer samples scaled by
(1 + 1e-14), and the port against vio_tpu; max |Δtd| and |Δp| frame by
frame and the first frame either passes 1e-9 s / 1e-6 m; then each run's
last td and its APE as tests/test_td.py measures them (``--dtype``: the
port's, float64 unless named).
``handover``: tests/test_ex_calib_online.py's run (estimate_extrinsic=2
from an identity R_ic): the handover frame and the R_ic angles there and
at the end, the same three runs.
``marginalize``: make_window_problem's priors: vio_tpu's device chain
against its host chain (H_prior, b_prior, JtᵀJt, H·JtᵀJt·H, errᵀerr),
the port's device and host chains against vio_tpu's, and the float32
device chains against the float64 host chain.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vio_tpu import runner as jrunner  # noqa: E402
from vio_tpu import sim as jsim  # noqa: E402
from vio_tpu import testing as jtesting  # noqa: E402
from vio_tpu.config import sim_config as jsim_config  # noqa: E402
from vio_tpu.estimator import Estimator as JEstimator  # noqa: E402
from vio_tpu.solver import marginalize as jmarg  # noqa: E402
from vio_tpu_torch import convert, metrics, runner  # noqa: E402
from vio_tpu_torch.config import sim_config  # noqa: E402
from vio_tpu_torch.estimator import Estimator  # noqa: E402
from vio_tpu_torch.solver import marginalize as tmarg  # noqa: E402

IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def online_td(est, feed, data, true_td, n):
    """tests/test_td.py::_run_online_td's stream; (td, p, t) after each
    frame (p and t NaN before the first pose)."""
    lagged_t = data.cam_t - true_td
    imu_i, t_prev = 0, lagged_t[0] + est.td
    tds, ps, ts = [], [], []
    for k in range(n):
        t = lagged_t[k] + est.td
        if k:
            imu_i = feed(est, data.imu_t, data.acc, data.gyr, t_prev, t, imu_i)
        t_prev = t
        dt = data.cam_t[k] - data.cam_t[k - 1] if k else 1.0
        feats = {}
        for lid in np.where(data.obs_valid[k])[0]:
            xy = data.obs_xy[k, lid]
            vel = ((xy - data.obs_xy[k - 1, lid]) / dt
                   if k and data.obs_valid[k - 1, lid] else np.zeros(2))
            feats[int(lid)] = (np.array([xy[0], xy[1], 1.0]), data.obs_uv[k, lid], vel)
        est.process_image(feats, t)
        tds.append(est.td)
        ps.append(est.latest_pose()[1] if est.initialized else np.full(3, np.nan))
        ts.append(est.latest_pose()[0] if est.initialized else np.nan)
    return np.asarray(tds), np.asarray(ps), np.asarray(ts)


def first_over(d, bound):
    over = np.nonzero(np.nan_to_num(d) > bound)[0]
    return int(over[0]) if len(over) else None


def spread_td(frames, dtype):
    data = jsim.generate(noise=False)
    bumped = dataclasses.replace(data, acc=data.acc * (1 + 1e-14))
    cfg = dict(td=0.0, estimate_td=True)
    ref = online_td(JEstimator(jsim_config(**cfg)), jrunner.feed_interval, data, 0.006, frames)
    runs = {"vio_tpu, acc·(1+1e-14)": online_td(JEstimator(jsim_config(**cfg)),
                                                jrunner.feed_interval, bumped, 0.006, frames),
            "port": online_td(Estimator(sim_config(**cfg), device="cpu", dtype=dtype),
                              runner.feed_interval, data, 0.006, frames)}
    for name, (tds, ps, ts) in [("vio_tpu", ref)] + list(runs.items()):
        ok = np.isfinite(ts)
        gt_p, _ = runner.sim_ground_truth_at(data, ts[ok] + (0.006 - tds[-1]))
        print(f"online td, {frames} frames, {name}: td {tds[-1] * 1e3:.4f} ms, APE rmse "
              f"{metrics.ape_rmse(ps[ok], gt_p)['rmse']:.6f} m over {int(ok.sum())} poses")
    for name, (tds, ps, _) in runs.items():
        dtd = np.abs(tds - ref[0])
        dp = np.nanmax(np.abs(ps - ref[1]), axis=1)
        print(f"online td, {frames} frames, {name} against vio_tpu: max |dtd| {dtd.max():.3e} s "
              f"(first > 1e-9 at frame {first_over(dtd, 1e-9)}), max |dp| {np.nanmax(dp):.3e} m "
              f"(first > 1e-6 at frame {first_over(dp, 1e-6)})")


def angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1) / 2, -1, 1)))


def spread_handover(frames):
    data = jsim.generate(noise=False)
    bumped = dataclasses.replace(data, acc=data.acc * (1 + 1e-14))

    def run(fn, cfg, d, **kw):
        rec = []
        fn(d, cfg, n_frames=frames, **kw, on_frame=lambda est, t, f: rec.append(
            (est.estimate_extrinsic, np.array(est.ric))))
        return rec

    ref = run(jrunner.run_sim, jsim_config(estimate_extrinsic=2, ric=IDENTITY), data)
    runs = {"vio_tpu, acc·(1+1e-14)": run(jrunner.run_sim, jsim_config(
                estimate_extrinsic=2, ric=IDENTITY), bumped),
            "port": run(runner.run_sim, sim_config(estimate_extrinsic=2, ric=IDENTITY), data,
                        device="cpu")}
    k0 = [m for m, _ in ref].index(1)
    for name, rec in runs.items():
        k = [m for m, _ in rec].index(1) if 1 in [m for m, _ in rec] else None
        print(f"extrinsic handover, {frames} frames, {name} against vio_tpu: handover at frame "
              f"{k} ({k0}), R_ic apart there {angle(rec[k0][1], ref[k0][1]):.3e} rad, at the end "
              f"{angle(rec[-1][1], ref[-1][1]):.3e} rad")


def spread_marginalize():
    def as_dict(nt):
        return {k: as_dict(v) if hasattr(v, "_fields") else np.asarray(v)
                for k, v in zip(nt._fields, nt)}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b).max() / np.abs(b).max()

    def inv(o):
        H, b, e, J = (np.asarray(x, np.float64) for x in o)
        return dict(H=H, b=b, JJ=J.T @ J, HJJH=H @ J.T @ J @ H, ee=e @ e)

    for W, F, M in ((4, 32, 4), (10, 64, 8), (10, 256, 8)):
        kw = dict(window_size=W, max_features=F, imu_per_interval=M, perturb=0.0)
        s, f, _ = jtesting.make_window_problem(**kw, dtype=jnp.float64)
        ts = convert.window_states_from_numpy(as_dict(s), device="cpu", dtype=torch.float64)
        tf = convert.window_factors_from_numpy(as_dict(f), device="cpu", dtype=torch.float64)
        jh = inv(jmarg.marginalize_old_host(s, f))
        pairs = {"vio_tpu device": inv(jmarg.marginalize_old(s, f)),
                 "port device": inv([x.numpy() for x in tmarg.marginalize_old(ts, tf)]),
                 "port host": inv(tmarg.marginalize_old_host(ts, tf))}
        for name, o in pairs.items():
            print(f"marginalize_old W={W} F={F}, {name} against vio_tpu host: " +
                  ", ".join(f"{k} {rel(o[k], jh[k]):.3e}" for k in o))
        s32, f32, _ = jtesting.make_window_problem(**kw, dtype=jnp.float32)
        ts32 = convert.window_states_from_numpy(as_dict(s32), device="cpu", dtype=torch.float32)
        tf32 = convert.window_factors_from_numpy(as_dict(f32), device="cpu", dtype=torch.float32)
        for name, o in (("vio_tpu float32 device", jmarg.marginalize_old(s32, f32)),
                        ("port float32 device", [x.numpy() for x in
                                                 tmarg.marginalize_old(ts32, tf32)])):
            o = inv(o)
            print(f"marginalize_old W={W} F={F}, {name} against vio_tpu float64 host: "
                  f"H {rel(o['H'], jh['H']):.3e}, b {rel(o['b'], jh['b']):.3e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["td", "handover", "marginalize"])
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.what == "td":
        spread_td(args.frames or 50, getattr(torch, args.dtype))
    elif args.what == "handover":
        spread_handover(args.frames or 300)
    else:
        spread_marginalize()


if __name__ == "__main__":
    main()
