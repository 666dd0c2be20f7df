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
5. simulation main path: vio_tpu_torch.runner.run_sim over 150 noise-free
   frames of the simulator at sim_config() (W=10, F=256, P=171) in float32
   on the card (the default device), held to tests/test_e2e_sim.py's
   bounds, counting the kernel's launches;
6. frontend functions, card against CPU: ``klt.track_fb``,
   ``klt.sample_templates`` + ``klt.refine_on_templates``,
   ``detect.detect`` and ``clahe.clahe`` on one rendered 640×640 frame
   pair with the ground-truth blob centres as features, on the card in
   float32 against the same functions on the CPU with float64 positions
   (images are float32 on both).  This checks plain torch code on the
   card, not a kernel, so it adds nothing to the kernels' record;
7. image main path: vio_tpu_torch.runner.run_images over 155 rendered
   640×640 frames at sim_images_config() (150 feature slots, W=10, F=256,
   P=171) on the default device: images → FeatureTracker (float32) →
   Estimator → frame_step → the Gauss-Jordan kernel, held to
   tests/test_image_pipeline.py::test_images_to_estimator_end_to_end's
   bounds, counting the kernel's launches.  The estimator runs in float64
   here: this configuration weights the IMU position residual at a few
   micrometres per frame interval, which float32 cannot evaluate at
   |P| ~ 16 m, and in float32 both this package and the JAX package miss
   the bound (scripts/torch_image_path_precision.py measures both);
8. CLAHE and distortion, tracker only: 30 frames rendered through a radtan
   camera of EuRoC magnitude, ``equalize=True``, through
   ``FeatureTracker.read_image``; enough live tracks at the end, and every
   published bearing the undistorted projection of some landmark.

Times are printed and recorded, never asserted.  The line before the last
is the kernels' JSON record, whose ``launches`` sums phases 5 and 7 (the
count is set to 0 just before each and read just after); the last line is
``{"ok": true, "device": {...}}``.
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
N_IMAGE_FRAMES = 155
N_CLAHE_FRAMES = 30
# EuRoC-magnitude radial-tangential distortion (the reference's MH-05
# camera, config/euroc_config.yaml), as tests/test_image_pipeline.py has it
DISTORT = dict(k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
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


def frontend_on_card_against_cpu(device, tag: str) -> None:
    """Phase 6.  The card runs positions in float32, the CPU side in
    float64; a track whose gate value sits on its threshold may pass on
    one side only, so the ``ok`` masks may differ in a stated handful."""
    from vio_tpu_torch import sim
    from vio_tpu_torch.features import clahe, detect, klt

    MAX_OK_FLIPS = 3      # of the ~85 blobs in view
    POS_TOL = 1e-2        # px
    data = sim.generate(noise=False)
    img0, img1 = (sim.render_image(data, k) for k in (0, 1))
    both = data.obs_valid[0] & data.obs_valid[1]
    p0, p1_gt = data.obs_uv[0][both], data.obs_uv[1][both]
    valid = np.ones(len(p0), bool)

    def sides(a, pos=False):
        """(card tensor, CPU tensor) of one host array."""
        a = np.asarray(a)
        if pos:
            return (torch.as_tensor(a, dtype=torch.float32, device=device),
                    torch.as_tensor(a, dtype=torch.float64))
        return torch.as_tensor(a, device=device), torch.as_tensor(a)

    def same_tracks(name, card, cpu):
        (p_c, ok_c, _), (p_h, ok_h, _) = card, cpu
        p_c, ok_c = p_c.cpu().double(), ok_c.cpu()
        flips = int((ok_c != ok_h).sum())
        agree = ok_c & ok_h
        err = float((p_c - p_h)[agree].abs().max())
        print(f"frontend {name}: {int(agree.sum())} of {len(ok_h)} tracks ok on both "
              f"sides, {flips} ok on one side only, max |dp| {err:.3e} px {tag}")
        if flips > MAX_OK_FLIPS or int(agree.sum()) < 0.7 * len(ok_h) or not err <= POS_TOL:
            raise AssertionError(f"{name}: the card disagrees with the CPU")

    (i0c, i0h), (i1c, i1h) = sides(img0), sides(img1)
    (p0c, p0h), (vc, vh) = sides(p0, pos=True), sides(valid)
    same_tracks("track_fb", klt.track_fb(i0c, i1c, p0c, vc),
                klt.track_fb(i0h, i1h, p0h, vh))

    # birth templates at frame 0, stored in float32 as the tracker stores
    # them, then refined in frame 1 from seeded guesses within 0.7 px
    T_c = klt.sample_templates(i0c, p0c)
    T_h = klt.sample_templates(i0h, p0h)
    err = max(float((c.cpu().double() - h).abs().max()) for c, h in zip(T_c, T_h))
    print(f"frontend sample_templates: max |dT| {err:.3e} grey levels {tag}")
    if not err <= 1e-2:
        raise AssertionError("sample_templates: the card disagrees with the CPU")
    rng = np.random.default_rng(0)
    gc, gh = sides(p1_gt + rng.uniform(-0.7, 0.7, p1_gt.shape), pos=True)
    same_tracks("refine_on_templates",
                klt.refine_on_templates(i1c, *(t.float() for t in T_c), gc, vc),
                klt.refine_on_templates(i1h, *(t.float() for t in T_h), gh, vh))

    def peaks(xy, score, ok):
        xy = xy.cpu().double()[ok.cpu()]
        return xy[np.lexsort((xy[:, 0].numpy(), xy[:, 1].numpy()))]

    pk_c = peaks(*detect.detect(i0c, None, max_corners=150, min_dist=15))
    pk_h = peaks(*detect.detect(i0h, None, max_corners=150, min_dist=15))
    if pk_c.shape != pk_h.shape or not float((pk_c - pk_h).abs().max()) <= POS_TOL:
        raise AssertionError(f"detect: {len(pk_c)} peaks on the card, {len(pk_h)} on the CPU, "
                             "or not the same ones")
    print(f"frontend detect: the same {len(pk_h)} peaks, max |dxy| "
          f"{float((pk_c - pk_h).abs().max()):.3e} px {tag}")

    noise = (255.0 * rng.random((480, 752))).astype(np.float32)   # EuRoC's frame size
    for name, img in (("rendered frame", img0), ("random 480x752 image", noise)):
        ic, ih = sides(img)
        err = float((clahe.clahe(ic).cpu() - clahe.clahe(ih)).abs().max())
        print(f"frontend clahe, {name}: max |d| {err:.3e} grey levels {tag}")
        if not err <= 1e-3:
            raise AssertionError("clahe: the card disagrees with the CPU")


def image_main_path(device, tag: str) -> int:
    """Phase 7.  The tracker keeps the device's dtype rule (float32); the
    estimator is asked for float64 (see the module's docstring).  Returns
    the Gauss-Jordan kernel's launches."""
    from vio_tpu_torch import metrics, runner, sim
    from vio_tpu_torch.config import sim_images_config
    from vio_tpu_torch.ops import linsolve

    cfg = sim_images_config()
    data = sim.generate(noise=False)
    trk = runner.make_tracker(cfg, device=device)
    read_image = trk.read_image
    tracker_ms, live = [], []

    def timed_read_image(img, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = read_image(img, t)
        torch.cuda.synchronize()
        tracker_ms.append(1e3 * (time.perf_counter() - t0))
        live.append(int(trk.valid.sum()))
        return out

    trk.read_image = timed_read_image
    linsolve.gj_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, traj = runner.run_images(
        runner.sim_image_frames(data, n_frames=N_IMAGE_FRAMES),
        data.imu_t, data.acc, data.gyr, cfg, tracker=trk, device=device,
        dtype=torch.float64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = linsolve.gj_solve.launches

    if not est.initialized:
        raise AssertionError("image path: estimator did not initialize")
    if est.failure_count != 0:
        raise AssertionError(f"image path: failure_count {est.failure_count}")
    if not np.all(np.isfinite(traj["p"])) or traj["p"].shape != (len(traj["t"]), 3):
        raise AssertionError("image path: trajectory not finite or misshapen")
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape = metrics.ape_rmse(traj["p"], gt_p)["rmse"]
    solve_ms = [t["solve_ms"] for t in est.telemetry]
    print(f"image path: {N_IMAGE_FRAMES} frames of 640x640, {len(tracker_ms)} tracked, "
          f"{len(traj['initialized'])} published, {len(traj['t'])} poses, "
          f"{len(est.telemetry)} window solves {tag}")
    print(f"image path APE rmse {ape:.6f} m {tag}")
    print(f"image path wall {N_IMAGE_FRAMES / wall:.3f} frames/s ({wall:.2f} s, "
          f"rendering included) {tag}")
    print(f"image path median tracker ms per read_image "
          f"{statistics.median(tracker_ms[2:]):.3f} (synchronised) {tag}")
    print(f"image path median solve_ms {statistics.median(solve_ms):.3f} {tag}")
    print(f"image path mean live tracks {statistics.mean(live):.1f} of {cfg.max_cnt} {tag}")
    print(f"image path gj_solve launches {launches} {tag}")
    if not ape < 0.05:
        raise AssertionError(f"image path: APE {ape} m >= 0.05 m")
    if not launches > 0:
        raise AssertionError("image path: the Gauss-Jordan kernel was never launched")
    for part, dtype in ((est, torch.float64), (trk, torch.float32)):
        if part.device.type != "cuda" or part.dtype != dtype:
            raise AssertionError(f"image path ran on {part.device} in {part.dtype}")
    return launches


def clahe_and_distortion_on_card(device, tag: str) -> None:
    """Phase 8."""
    from vio_tpu_torch import runner, sim
    from vio_tpu_torch.config import sim_images_config

    data = sim.generate(noise=False, **DISTORT)
    cfg = sim_images_config(equalize=True, **DISTORT)
    trk = runner.make_tracker(cfg, device=device)
    worst = 0.0
    for k in range(N_CLAHE_FRAMES):
        out = trk.read_image(sim.render_image(data, k), float(data.cam_t[k]))
        xy_gt = data.obs_xy[k][data.obs_valid[k]]
        for bearing, _, _ in out.values():
            worst = max(worst, float(np.linalg.norm(xy_gt - bearing[:2], axis=1).min()))
    live = int(trk.valid.sum())
    print(f"clahe + radtan tracker: {N_CLAHE_FRAMES} frames, {live} live tracks at the end, "
          f"{len(out)} published, worst bearing {worst * 460.0:.3f} px from a landmark {tag}")
    if live < 40 or len(out) < 40:
        raise AssertionError(f"clahe + radtan tracker: {live} live tracks, {len(out)} published")
    if not worst < 5.0 / 460.0:
        raise AssertionError("clahe + radtan tracker: a published bearing is no landmark's")


def main() -> int:
    t_start = time.perf_counter()
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

    # ---- 6-8. the image frontend and the image main path ----
    frontend_on_card_against_cpu(est.device, tag)
    image_launches = image_main_path(None, tag)
    clahe_and_distortion_on_card(None, tag)

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.0f} s {tag}")

    # One kernel, two callers: the simulation path solves P = 171 in
    # float32 (the keys the record requires), the image path in float64
    # (the same numbers under "float64").
    main, main64 = rec[(torch.float32, MAIN_P)], rec[(torch.float64, MAIN_P)]
    print(json.dumps({"kernels": [{
        "name": "gj_solve", "route": "cuda",
        "source": "vio_tpu_torch/csrc/gj_solve.cu",
        "replaces": "vio_tpu/ops/linsolve.py:34",
        "launches": launches + image_launches, "max_abs_err": main["err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "launches_by_path": {"run_sim float32": launches,
                             "run_images float64": image_launches},
        "float64": {"max_abs_err": main64["err"], "ms": main64["ms"],
                    "plain_ms": main64["plain_ms"], "bound_ms": main64["bound_ms"],
                    "bound_by": main64["bound_by"],
                    "library_ms": main64["library_ms"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
