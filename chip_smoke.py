"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``.  It needs a
CUDA device, nvcc and g++, and exits non-zero, printing no result, without
them.  Phases, each of which raises on failure:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles vio_tpu_torch/csrc/*.cu (the Gauss-Jordan and the
   RANSAC kernels) for sm_90a (nvcc) and the measurement pairer,
   csrc/pairer.cpp (g++), side by side, at first use;
3. kernel against plain: the Gauss-Jordan kernel against its plain torch
   version on the card, on seeded random SPD systems in float32 (the main
   path's type) and float64, at P ∈ {17, 171, 300, 1024}, at both sides of
   the size where the kernel leaves the registers for the blocked regime,
   and at P ∈ {1, 2, 33, 1023}; times the kernel, the plain version and
   the faster of two library routes (``torch.linalg.solve``,
   ``torch.linalg.cholesky`` + ``torch.cholesky_solve``) with CUDA events,
   and computes the roofline bound from the shapes.  The library call is
   a yardstick here: the package calls the Cholesky route only for the
   pose graph's damped solve (phase 25);
4. ill-conditioned case: a seeded SPD system at P = 171 with eigenvalues
   spread over 1e5 and the estimator's damping λ = 1e-5·max|diag|, kernel
   against plain by backward error and by |Δx|;
5. simulation main path: vio_tpu_torch.runner.run_sim over 150 noise-free
   frames of the simulator at sim_config() (W=10, F=256, P=171) in float32
   on the card (the default device), held to tests/test_e2e_sim.py's
   bounds, counting the kernel's launches.  The estimator runs each frame
   as captured CUDA graphs (solver/graph.py): the launches are those the
   replays made, and the graphs captured, the seconds capturing, the
   replays and the host reads per frame are printed;
22. graphs against eager, right after phase 5: the inputs phase 5 gave
   its first 8 post-init frames, each through the eager
   ``frame_step.frame_step`` on the card, held to the graphed frame's
   output: the same LM iterations, every state within float32 round-off
   (GRAPH_RTOL of each leaf's largest entry + GRAPH_ATOL); the largest
   difference is printed;
26. the preintegration kernel, right after phase 22: every frame key's
   head graph holds one launch of ``imu.preintegrate_kernel`` (its chunk
   and tail none), and N_PREINT_REPLAYS of phase 5's frames run again
   through their graphs add one launch each; then the kernel against its
   plain version (``imu.preintegrate_reference``) on the card at the
   benchmark cell's shapes, PREINT_W intervals of M ∈ PREINT_M slots, in
   float32 and float64 and with either noise model, on full and scattered
   masks, to tests/test_torch_imu.py's bounds (PREINT_TOL); with every
   slot live (the longest interval sets the kernel's time) the kernel's
   device ms as a graph node and back to back from Python, the plain
   loop's as a captured graph, and the least time by operations;
27. the IMU factor kernel, right after phase 26: every frame key's
   graphs hold one launch of ``window.imu_factor_kernel`` an assembly
   (the head 1 + CHUNK, the chunk CHUNK, the tail one where it
   marginalizes the oldest frame), and N_IMU_FACTOR_REPLAYS of phase 5's
   frames run again add one launch an assembly; then the kernel against
   the plain block (``window.imu_factor_reference``) on the card at the
   benchmark cell's window, IMU_FACTOR_W intervals, in float32 and
   float64, every interval valid, the first alone and scattered, to
   tests/test_torch_imu_factor.py's bounds (IMU_FACTOR_RTOL); the
   kernel's device ms as a graph node and back to back from Python, the
   plain block's as a captured graph, and the least time by bytes and by
   operations;
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
   the bound (scripts/torch_image_path_precision.py measures both).  The
   tracker runs its device work as CUDA graphs (a ``ProgramGraph`` per
   program, solver/graph.py) and the RANSAC kernel: held to at least one
   and at most MAX_TRACKER_PROGRAMS replays and reads a read_image, and
   the RANSAC kernel launched; the replays and reads per read_image and
   per solve are printed (so are phases 9, 10, 18 and 20's);
8. CLAHE and distortion, tracker only: 30 frames rendered through a radtan
   camera of EuRoC magnitude, ``equalize=True``, through
   ``FeatureTracker.read_image``; enough live tracks at the end, and every
   published bearing the undistorted projection of some landmark.  Each
   frame is also run by a twin whose programs run eagerly on the card
   (``_run_eager``), held to the graphed tracker to the bit, as phase 23;
23. the tracker's graphs and the RANSAC kernel, right after phase 8:
   30 frames of phase 7's stream through a graphed tracker and an eager
   twin, held equal to the bit (positions, ids, track counts, templates,
   lifts, published features, the frame kept on the device); then the
   RANSAC kernel against its plain version on the card, in float32 and
   float64, on the tracker's inputs of the frame with the most valid rows
   (N = 150 slots, 256 hypotheses, the lifts in each type), against the
   plain version run in float64 on the same inputs: every hypothesis's
   null vector and projection within BACKWARD_C·eps in backward error
   (``ops/ransac.py``), E up to sign within E_TOL_C·eps·κ where the type determines it, the
   counts equal to the plain scoring of the kernel's E on COUNT_AGREE of
   the hypotheses and within 1 on the rest, and in float64 to the
   reference's likewise; in float32 no less accurate than the plain
   float32 version (ACCURACY_RATIO, COUNT_MARGIN); the refit on the best
   consensus set likewise, and ``refit_best`` (the choice of the best
   hypothesis and its consensus set folded into the refit's launch) on the
   kernel's own sweep against ``refit_best_reference`` run in float64 by
   the same gates.  Times the sweep, the refit and ``refit_best`` (device
   ms a call in a CUDA graph's replays, as the tracker runs them, and back
   to back from Python), the plain versions, the library's SVDs (batched ``torch.linalg.svd`` of the
   gathered (256, 8, 9) systems and the 3 × 3 projection) and the bound,
   from the least operations the functions need at this run's shapes; then
   the device ms of one replay of each tracker key's reject program (phase
   7's and phase 8's), 20 replays between CUDA events;
9. async image path: vio_tpu_torch.runner.run_images_async over phase 7's
   frames with phase 7's dtypes: the tracker in a producer thread, the
   native pairer, the estimator in this thread.  Held against phase 7's
   own result: the same published frames and timestamps, max |Δp| ≤ 1e-6 m
   (tests/test_image_pipeline.py::test_async_pipeline_matches_sync's
   bound), APE < 0.05 m, no failure, as many kernel launches, and a pairer
   that saw no disorder.  Prints frames/s beside phase 7's and the share of
   the producer's busy time during which the consumer was busy too;
10. loop closing: run_sim over the simulator's 600-frame closed circuit at
   tests/test_loop_integration.py's configuration (noisy IMU, priors
   underestimated by 3) on the default device, loop closing on through
   the estimator's flag (``loop_closure: 1``, ``loop_min_gap`` 80), the
   stream carrying one fixed random descriptor per landmark: BoW retrieval
   → mutual-Hamming matching → PnP → SE3 pose graph, inside
   ``process_image``; the published poses are the drift-corrected ones.
   Estimator and closer run in float64: in float32 the raw APE misses that
   test's 0.1583 m bound, on the card (0.66 m) as in the JAX package with
   64-bit mode off (0.27 m on the CPU); scripts/torch_loop_path_precision.py
   measures both.  Held to that test's bounds (raw APE of the window's
   odometry, at least one loop, edge errors against ground truth,
   corrected APE, bounded drift, the last published pose the
   drift-corrected one); then
   Estimator.apply_live_correction with the closer's drift,
   LoopCloser.rebase, and the circuit's last frame solved with no
   failure.  The closer's pose-graph solves run on the card from captured
   CUDA graphs (``posegraph.optimize`` on ``graph.loop``, the library's
   Cholesky, ``linsolve.cholesky_solve``, inside).
   Prints milliseconds per add_keyframe and per pose-graph solve (median
   and max), the pose graph's keys, graphs captured and seconds
   capturing, its attempts and host reads a solve and its
   ``cholesky_solve`` launches.  Also ``orb.describe`` on one rendered frame and
   ``orb.hamming_matrix``, card against CPU.
11. global BA on one card: ``global_ba.solve`` at bench.py's scale-out
   configuration (100 keyframes, 400 landmarks, 8 observations each: P =
   600, the kernel's blocked regime), float32 at the bench's settings
   (max_iter=10) and float64 at tests/test_global_ba.py's (max_iter=25).
   float64 is held to test_global_ba_larger_window's bounds (chi² < 1e-8
   chi²₀, max pose error < 1e-4 m).  The float32 run's own chi² carries no
   information here: at loss_delta=50 the Cauchy cost δ²·log(e²/δ² + 1)
   rounds to 0 in float32 once e² < ~1.5e-4, so it reads 0 while the poses
   are still mm off.  (float64's own chi² rounds to 0 too, but only once
   every e² < ~2.8e-13, which implies its bound.)  float32 is held instead to max pose error < 0.01 m
   and to the chi² of its result recomputed in float64 (``assemble``)
   ≤ 1e-6 of the start's, set from the JAX package's own float32 run of
   the same problem on the CPU (0.00381 m, recomputed chi² 8.669e-08 of
   the start's; the port's float32 runs on the CPU end between 2.5e-5 and
   3.8e-3 m, by the order of their sums; scripts/torch_scale_out_cpu.py
   jax).
   ``solve`` runs on the card from captured CUDA graphs
   (``graph.loop``'s ``LoopGraph``): the first call captures the key's graphs
   and solves (its launches are the record's, all graph replays, one
   ``gj_solve`` an attempt), a second call is timed alone (one host read
   per ``graph.CHUNK`` attempts is held).  Its eager twin (the same
   program on ``graph.EagerLoop``) runs on the same inputs: both runs are held
   to the bounds above; in float64 they must also take the same
   iterations and end within GLOBAL_TWIN_DP64; in float32 the iterations
   and the largest |Δp| are printed.  Prints P, the regime, iterations,
   chi², pose error, the launches, the first call's seconds with the
   keys, graphs, capture seconds (the kernels' build not among them) and
   pool MiB, the wall ms of a graphed
   solve against the eager twin's, replays and reads a solve, and from a
   third, instrumented eager run the milliseconds per λ-attempt of
   assembly, the Schur product, the solve and the rest (synchronised
   around each);
12. global BA at SCALING.md's largest size on one card: 64 keyframes,
   131,072 landmarks, 1,048,576 observation slots, P = 384, 8 LM
   iterations, float32, graphed and eager as phase 11.  Held to: chi²
   below chi²₀ and the poses closer to the truth than the perturbed start,
   both runs.  Prints phase 11's lines and the peak device memory of each;
   then ``graph.clear()`` drops every captured key, so that later phases
   get the pools' memory back;
24. PCG on the card, right after phase 12: ``pcg.pcg_solve`` (its own
   captured graphs) against its eager twin (the same program on
   ``graph.EagerLoop``) on seeded SPD systems (``spd_system``) at P ∈
   PCG_SIZES in float32 and float64, held to the same iterations and the
   true relative residual ≤ PCG_RTOL of the type for both, float64 x to a
   float64 direct solve within κ·rtol; the largest |Δx| and each side's
   ms a solve are printed.  Then ``global_ba.solve(use_pcg=True)`` on
   phase 11's float64 problem (the eager attempt loop, PCG graphed inside
   it), held to tests/test_global_ba.py's larger-window bounds (chi² <
   1e-8 chi²₀, pose error < 1e-4 m), its |Δp| against phase 11's direct
   graphed solve printed; and ``global_ba.solve`` at 200 keyframes
   (GLOBAL_PCG, P = 1200: ``spd_solve``'s PCG route) in float64, held to
   descent (chi² < chi²₀, pose error below the start's), with its wall
   time, CG iterations and reads an attempt printed;
13. distributed global BA: ``global_ba.solve_sharded`` at 64 keyframes,
   8,192 landmarks (65,536 observations), 8 iterations, in float64 and
   float32, on 1 rank under NCCL and on 2 ranks under gloo sharing the
   card (and on 2 ranks under NCCL, one card each, where there are two
   cards); each rank a spawned process.  In float64 the 2-rank poses are
   held to the 1-rank ones (≤ 1e-8 m) and chi² to the float64 reduction's
   parity (≤ 1e-9 relative, SCALING.md's); float32 is held to descent and
   its difference printed (``distributed_paths`` says why).  Every rank
   ends with the same poses to the bit.  Prints the bytes per all_reduce;
14. factor-sharded window solve: ``sharded.solve_window_sharded`` on 2
   ranks under gloo sharing the card (the same processes as phase 13's)
   against ``lm.solve_window`` at make_window_problem(10, 256, 8)
   (P = 171), float32, max_iter=10; poses ≤ 1e-3 (tests/
   test_sharding.py's bound);
15. BAL: ``bal.solve`` on seeded problems built as tests/test_bal.py's
   noise-free case is (observations exact, the first two cameras the
   gauge, intrinsics fixed, max_iter=40), at its size (6 cameras, 60
   points, P = 54) and at the published size of BAL's Ladybug
   problem-49-7776 (49 cameras, 7,776 points, 4 observations a point:
   P = 441, the blocked regime), in float32 and float64.  float64 is held
   to tests/test_bal.py's bounds (chi² < 1e-12 chi²₀, points < 1e-5);
   float32 to chi² < 1e-6 chi²₀ and points < 1e-3, the float32 floor of
   the same solve on the CPU (tests/test_torch_blockba.py);
16. direct method: ``direct.direct_ba`` on tests/test_direct_ba.py's
   textured-plane scene and ``direct.direct_pose_estimation`` on two
   rendered simulator frames (tests/test_components.py's case), on the
   card in float32 against the CPU in float64, each side held to those
   tests' bounds;
17. online td: tests/test_td.py::_run_online_td's stream (the camera clock
   lags the IMU clock by 6 ms, finite-difference feature velocities) for
   200 frames, the estimator refining td from 0 in float32 on the card,
   held to that test's bounds (2 < td < 7.2 ms, APE < 0.15 m);
18. EuRoC layout: ``io.write_euroc`` writes the first 60 of phase 7's
   frames (.npy), ``io.load_euroc`` must return phase 7's IMU samples and
   its stamps to the nanosecond, and ``runner.run_euroc`` runs them with
   phase 7's precisions, held to APE < 0.05 m against the written ground
   truth (paired by stamp as the CLI pairs them) and to a run_images of
   its first 40 frames, rendered, at the layout's stamps (max |dp| ≤
   1e-6 m).
   Against phase 7 itself the poses are printed, not held: rounding the
   stamps to nanoseconds moves the estimator's 0.1 s init-retry gate by a
   frame (scripts/torch_euroc_stamps.py measures it);
19. device functions, card against CPU: ``stereo.disparity_from_flow``
   (tests/test_stereo.py's 40-feature pair), ``icp.umeyama`` and
   ``icp.icp_gn`` (tests/test_components.py's case),
   ``intrinsics.refine_corners_subpix`` (tests/test_intrinsics.py's
   rendered board), ``marginalize_old`` / ``marginalize_new`` on
   make_window_problem(10, 256, 8) (P = 171) in float64 against the host
   float64 chain by H_prior, b_prior, H·JtᵀJt·H, H·Jtᵀerr and errᵀerr over
   the directions both sides keep (see ``_prior_invariants``; the kept
   spectrum below MARG_GAP, errᵀerr over all kept and the float32 chain's
   distance are printed), and ``calibrate_chessboard`` on the card, each
   at its reference test's bounds;
20. the CLI: ``python -m vio_tpu_torch.cli run --dataset sim``, ``run
   --dataset hybrid`` on IMU and camera-stamp files written from the
   simulator with a 2 s static prefix (80 frames: 40 would all fall in the
   prefix at the hybrid's 20 Hz), and ``sim --out``, three processes at
   once, each JSON line parsed and held: both runs on the card in their
   precision, with poses, kernel launches, no failure and APE < 0.01 m;
21. the bench: ``python -m vio_tpu_torch.cli bench`` in a process of its
   own at the default budget (185 s after the build), its details written
   to a temporary file; started beside phase 10 to stay inside the time
   limit, so its times are not the bench's record.  Held: exit 0, the headline ``window_ba_solve_fps``
   as the first line, no stage recorded as an error or skipped, the window
   solve's 10 LM iterations, its device time summed over the profiler's
   CUDA events and over ``key_averages()`` within 1 %, the end-to-end run
   initialized, and ``gj_solve`` launched in the F=256 and F=1024 window
   stages and the global BA.  The headline and the details are printed.
25. the pose graph, last, alone on the card (phase 21's process has
   ended): phase 10's circuit's last problem (rebuilt from the closer's
   stored keyframes and loops) and the drifting circuits of
   ``testing.posegraph_circuit`` at N ∈ POSEGRAPH_N, in float64: the
   graphed route (a first call that
   captures, a second timed alone) against its eager twin
   (``optimize_eager`` on the card: the same iterations, max |ΔP| ≤
   PG_TWIN_DP, chi² within PG_TWIN_CHI2 relative) and against the CPU
   route (the same iterations, P and q within PG_CPU_TOL); on the CPU,
   padded against unpadded (the buckets set to 1: the same iterations,
   P and q within PG_PAD_TOL); each graphed solve launches one
   ``linsolve.cholesky_solve`` an attempt and no ``gj_solve``.  Then
   ``gj_solve``
   at the pose graph's sizes P ∈ POSEGRAPH_P in float32 and float64
   against its plain version on the card, by backward error (≤ P·eps and
   ≤ 10× the plain version's), with the kernel's, the plain version's and
   the library call's ms and the bound, and the library route
   (``linsolve.cholesky_solve``) at the same sizes by backward error
   (≤ P·eps).

Times are printed and recorded, never asserted.  The script's own time is
printed after the last phase.  The line before the last
is the kernels' JSON record: ``gj_solve``, whose ``launches`` sums the
launches of phases 5, 7, 9, 10 (the pose graph's among them, also given
alone), 11-16, 17, 18, 20 and 21,
``essential_ransac`` (sweep, refit and refit_best), whose ``launches`` sums those of
phases 5, 7, 9, 10, 17, 18, 20 and 21 (the tracker's on the image paths,
the init's bootstrap on every estimator path), and ``preintegrate``,
whose ``launches`` sums those of phases 5, 7, 9, 10, 17, 18 and 20 (one a
solved frame from the head graphs, the initialiser's eager calls), and
``imu_factor``, whose ``launches`` sums those of phases 5, 7, 9, 10, 17,
18, 20 and 21 (one an assembly).  Each count is set to 0
just before each path and read just after; in phases 13-14 each rank
counts its own and the ranks' counts are summed; in phases 20 and 21 each
process reports its own, in its JSON line or its details.  The last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import json
import multiprocessing
import socket
import statistics
import subprocess
import sys
import threading
import time
import traceback
from queue import Empty

import numpy as np
import torch

# P = 384, 441 and 600: the scale-out paths' systems (phases 11-15)
SIZES = (1, 2, 17, 33, 171, 300, 384, 441, 600, 1023, 1024)
MAIN_P = 171
N_FRAMES = 150
N_GRAPH_FRAMES = 8             # phase 22: post-init frames replayed eagerly
# phase 22: eager and graphed frames run the same kernels in the same
# order (a difference is expected to be 0); the bound is float32 round-off
# of an LM solve relative to each leaf's largest entry
GRAPH_RTOL, GRAPH_ATOL = 1e-5, 1e-6
# phase 26: the benchmark cell's window (W = 10 intervals) at its IMU
# buckets, 48 slots about the mean frame's and 72 the tail frames'; the
# kernel against the plain loop to tests/test_torch_imu.py's bounds
# (rtol of each leaf's largest entry, atol); phase 5's frames run again
PREINT_W, PREINT_M = 10, (48, 72)
PREINT_TOL = {torch.float32: (2e-5, 0.0), torch.float64: (1e-10, 1e-12)}
N_PREINT_REPLAYS = 8
# phase 27: the IMU factor kernel against the plain block at the benchmark
# cell's window (W = 10 intervals), every interval valid, the first alone
# (the marginalization's) and scattered, to tests/test_torch_imu_factor.py's
# bounds (a share of each output's largest entry); phase 5's frames again
IMU_FACTOR_W = 10
IMU_FACTOR_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
N_IMU_FACTOR_REPLAYS = 8
N_IMAGE_FRAMES = 155
N_CLAHE_FRAMES = 30
N_TWIN_TRACKER_FRAMES = 30     # phases 8 and 23: graphed against eager read_image
MAX_TRACKER_PROGRAMS = 6       # replays and reads a read_image (the tracker has 5 a frame)
# phase 23.  The reference is the plain version in float64 on the same
# inputs.  Every hypothesis's null vector e and its projection E are held
# by their backward errors, none of the sample's condition: ‖A ê‖ − σ_min
# over ‖A‖_F, and E's distance from the projection of ê, each ≤
# BACKWARD_C · eps (``ops/ransac.py``: ``null_backward``,
# ``projection_backward``).  E up to sign is held to E_TOL_C · eps · κ, κ its
# condition in float64: σ1/σ8 of its 8 × 9 system (a null vector's
# first-order sensitivity) times 1 + 1/σ2 of its unit-norm E (the rank-2
# projection's), on the hypotheses with eps · κ ≤ WELL_POSED; the others
# have no E determined in the type.  Frame-to-frame motion is small, so
# x1 ≈ x0 nearly satisfies every skew-symmetric E and the tracker's
# minimal samples have κ ~ 1e4-1e5: float32 determines their E to
# ~1e-3-1e-2, so their counts under the Sampson threshold follow the
# round-off, the plain version's as much as the kernel's.  The kernel's
# counts are held to the plain Sampson scoring of the kernel's own E's
# (equal on COUNT_AGREE of the hypotheses, the others within 1: a row
# within round-off of the threshold flips) and, in float64, to the
# reference's counts likewise.  In float32 the kernel must be no less
# accurate than the plain float32 version: its median |ΔE| to the
# reference at most ACCURACY_RATIO times the plain version's, and its
# counts equal to the reference's on at least the plain version's share
# less COUNT_MARGIN.  The refit likewise, with σ1/(σ8 − σ9) of its
# weighted system, its inlier flags and count within 1 of the reference's.
COUNT_AGREE = 0.99
ACCURACY_RATIO = 2.0
COUNT_MARGIN = 0.02
E_TOL_C = 64
WELL_POSED = 1e-2
N_LOOP_FRAMES = 600
LOOP_DTYPE = torch.float64     # phase 10's estimator and closer; see above
# phase 25: the drifting circuits' sizes (189: the loop circuit's last), and
# gj_solve's blocked sizes up to its ceiling, each also solved by the pose
# graph's route (the library's Cholesky).  The graphs and the eager twin run the same kernels in
# the same order (index_add_'s atomics may order a sum otherwise); the CPU
# route sums H on the host and solves it by LU.
POSEGRAPH_N = (40, 189, 400)
POSEGRAPH_P = (1152, 2048, 4096)
PG_TWIN_DP = 1e-9              # m
PG_TWIN_CHI2 = 1e-9            # relative
PG_CPU_TOL = 1e-8              # m and quaternion units
PG_PAD_TOL = 1e-10
# EuRoC-magnitude radial-tangential distortion (the reference's MH-05
# camera, config/euroc_config.yaml), as tests/test_image_pipeline.py has it
DISTORT = dict(k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
# float32: tests/test_ops.py's bound for float32 elimination; float64:
# round-off of a well-conditioned system (condition number ~10).
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4, residual=1e-4),
       torch.float64: dict(rtol=1e-9, atol=1e-9, residual=1e-12)}
GLOBAL_BENCH = dict(N=100, M=400, obs_per_lm=8)          # bench.py:185-198
GLOBAL_SCALING = dict(N=64, M=131072, obs_per_lm=8)      # SCALING.md's largest row
GLOBAL_DIST = dict(N=64, M=8192, obs_per_lm=8)           # SCALING.md's second row
GLOBAL_PERTURB = dict(pose_sigma=0.02, rot_sigma=0.005)
GLOBAL_F32_POSE_TOL = 0.01     # m; the JAX package's float32 run: 0.00381 m (phase 11)
GLOBAL_F32_CHI2_64 = 1e-6      # of chi²₀, in float64; the JAX package's float32 run: 8.669e-08
# phase 11: the graphs and the eager twin run the same kernels in the same
# order; float64 poses are held to agree within float64 round-off of an LM
# solve (the index_add_ atomics may order a sum otherwise)
GLOBAL_TWIN_DP64 = 1e-9        # m
GLOBAL_PCG = dict(N=200, M=800, obs_per_lm=8)            # P = 1200 > gj_solve's 1024
PCG_SIZES = (600, 1200)        # phase 24: global BA's P at 100 and 200 keyframes
PCG_COND = 1e3                 # eigenvalue spread of phase 24's systems (κ ~1.6e4 with the diagonal)
# phase 24's rtol by type: float64 global BA's (use_pcg), float32 well above
# eps·κ, where the recursive residual still tracks the true one
PCG_RTOL = {torch.float32: 1e-3, torch.float64: 1e-8}
BAL_LADYBUG = dict(C=49, M=7776, per_point=4)   # problem-49-7776-pnts
DIST_TIMEOUT_S = 600
TD_TRUE = 0.006                # s; tests/test_td.py's online-td stream (phase 17)
N_TD_FRAMES = 200
N_EUROC_FRAMES = 60            # phase 18: the first frames of phase 7's stream
N_TWIN_FRAMES = 40             # phase 18's run_images at the layout's stamps
EUROC_APE = 0.05               # m; tests/test_image_pipeline.py's bound
EUROC_TWIN_DP = 1e-6           # m; phase 9's bound for one stream run twice
STEREO_FX, STEREO_BASELINE = 460.0, 0.11       # tests/test_stereo.py's rig
STEREO_FLIPS, STEREO_TOL = 2, 1e-2             # of 40 features; px (float32 positions)
ICP_TOL = 1e-4                 # float32 R and t against float64
MARG_RTOL = 1e-7               # tests/test_torch_marginalize.py's
MARG_EE_RTOL = 1e-5            # the same file's bound on errᵀerr
MARG_GAP = 1.0                 # between the priors' round-off floor (< 0.05) and their weakest direction (> 9)
CHESS_TRUE = dict(fx=460.0, fy=458.0, cx=325.0, cy=238.0,
                  k1=-0.28, k2=0.07, p1=1e-4, p2=-2e-4)   # tests/test_intrinsics.py's
CHESS_EXACT = (("fx", 0.01), ("fy", 0.01), ("cx", 0.01), ("cy", 0.01),
               ("k1", 1e-4), ("k2", 1e-4), ("p1", 1e-5), ("p2", 1e-5))
HYBRID_STATIC_S = 2.0          # s at rest before the simulator's motion (phase 20)
CLI_SIM_FRAMES, CLI_HYBRID_FRAMES = 40, 80
CLI_APE = 0.01                 # m; tests/test_torch_cli_viz.py's bound on the sim run
CLI_TIMEOUT_S = 400
BENCH_TIMEOUT_S = 900          # from its start beside phase 10; its budget is 185 s
BENCH_KERNEL_STAGES = ("window_ba", "window_ba_F1024_euroc_shape", "global_ba_100kf")
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


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Mean device ms a call of ``fn``: ``calls`` calls captured into one
    CUDA graph, as the tracker's programs run the RANSAC kernels, replayed
    ``reps`` times between CUDA events, so the host's enqueueing of each
    call (which back-to-back calls from Python measure for kernels of a few
    tens of microseconds) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


@contextlib.contextmanager
def ransac_counted(by_path: dict, label: str):
    """Zero the RANSAC kernel's counts just before a path, record its
    launches under ``label`` just after."""
    from vio_tpu_torch.ops import ransac
    ransac.sweep.launches = ransac.refit.launches = ransac.refit_best.launches = 0
    yield
    by_path[label] = ransac.launches()


@contextlib.contextmanager
def imu_kernels_counted(preint: dict, factor: dict, label: str):
    """Zero the preintegration kernel's and the IMU factor kernel's counts
    just before a path, record their launches under ``label`` just after."""
    from vio_tpu_torch import imu
    from vio_tpu_torch.solver import window as W
    imu.preintegrate_kernel.launches = W.imu_factor_kernel.launches = 0
    yield
    preint[label] = imu.preintegrate_kernel.launches
    factor[label] = W.imu_factor_kernel.launches


def graph_rates(before: dict, frames: int, solves: int) -> tuple[str, dict]:
    """``graph.STATS`` since ``before``: the tracker's replays and host
    reads per ``read_image`` (``frames``) and the estimator's per solve."""
    from vio_tpu_torch.solver import graph
    d = {k: graph.STATS[k] - before.get(k, 0)
         for k in ("program_replays", "program_reads", "replays", "reads")}
    parts = []
    if frames:
        parts.append(f"tracker {d['program_replays'] / frames:.2f} replays, "
                     f"{d['program_reads'] / frames:.2f} reads a read_image")
    if solves:
        parts.append(f"estimator {d['replays'] / solves:.2f} replays, "
                     f"{d['reads'] / solves:.2f} reads a solve")
    return "; ".join(parts), d


def hold_tracker_graphs(label: str, d: dict, frames: int) -> None:
    """The tracker's device work ran as replays: at least one a frame and
    at most MAX_TRACKER_PROGRAMS, as many host reads at most."""
    if not (frames <= d["program_replays"] <= MAX_TRACKER_PROGRAMS * frames
            and d["program_reads"] <= MAX_TRACKER_PROGRAMS * frames):
        raise AssertionError(f"{label}: {d} over {frames} read_image calls")


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


def image_main_path(device, tag: str) -> dict:
    """Phase 7.  The tracker keeps the device's dtype rule (float32); the
    estimator is asked for float64 (see the module's docstring).  Returns
    the Gauss-Jordan kernel's launches, the trajectory and the wall time,
    for phase 9 to hold its own against."""
    from vio_tpu_torch import metrics, runner, sim
    from vio_tpu_torch.config import sim_images_config
    from vio_tpu_torch.ops import linsolve, ransac
    from vio_tpu_torch.solver import graph

    cfg = sim_images_config()
    data = sim.generate(noise=False)
    trk = runner.make_tracker(cfg, device=device)
    read_image = trk.read_image
    tracker_ms, live = [], []
    before = dict(graph.STATS)

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
    print(f"image path gj_solve launches {launches}, essential_ransac launches "
          f"{ransac.launches()} {tag}")
    rates, d = graph_rates(before, len(tracker_ms), len(est.telemetry))
    print(f"image path graphs: {rates} {tag}")
    hold_tracker_graphs("image path", d, len(tracker_ms))
    if not ransac.launches() > 0:
        raise AssertionError("image path: the RANSAC kernel was never launched")
    if not ape < 0.05:
        raise AssertionError(f"image path: APE {ape} m >= 0.05 m")
    if not launches > 0:
        raise AssertionError("image path: the Gauss-Jordan kernel was never launched")
    for part, dtype in ((est, torch.float64), (trk, torch.float32)):
        if part.device.type != "cuda" or part.dtype != dtype:
            raise AssertionError(f"image path ran on {part.device} in {part.dtype}")
    return dict(launches=launches, traj=traj, wall=wall)


class BusyLog:
    """Host-clock intervals during which a wrapped call was running."""

    def __init__(self):
        self.spans = []

    def wrap(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((t0, time.perf_counter()))
        return timed

    def total(self) -> float:
        return sum(b - a for a, b in self.spans)

    def overlap(self, other: "BusyLog") -> float:
        """Seconds during which a span of self and a span of other both
        ran (each log's spans are disjoint: one thread made them)."""
        return sum(max(0.0, min(b, d) - max(a, c))
                   for a, b in self.spans for c, d in other.spans)


def async_image_path(device, tag: str, sync: dict) -> int:
    """Phase 9.  ``sync`` is phase 7's result.  Returns the launches."""
    from vio_tpu_torch import metrics, runner, sim
    from vio_tpu_torch.config import sim_images_config
    from vio_tpu_torch.estimator import Estimator
    from vio_tpu_torch.ops import linsolve
    from vio_tpu_torch.solver import graph

    cfg = sim_images_config()
    data = sim.generate(noise=False)
    trk = runner.make_tracker(cfg, device=device)
    before = dict(graph.STATS)
    producer, consumer, threads = BusyLog(), BusyLog(), set()
    read_image = producer.wrap(trk.read_image)

    def read_image_noting_its_thread(img, t):
        threads.add(threading.current_thread().name)
        return read_image(img, t)

    trk.read_image = read_image_noting_its_thread
    process_image = Estimator.process_image
    Estimator.process_image = consumer.wrap(process_image)
    linsolve.gj_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        est, traj = runner.run_images_async(
            runner.sim_image_frames(data, n_frames=N_IMAGE_FRAMES),
            data.imu_t, data.acc, data.gyr, cfg, tracker=trk, device=device,
            dtype=torch.float64)
    finally:
        Estimator.process_image = process_image
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = linsolve.gj_solve.launches

    if threads != {"vio-frontend"}:
        raise AssertionError(f"async image path: the tracker ran in {threads}")
    if not est.initialized or est.failure_count != 0:
        raise AssertionError(f"async image path: initialized {est.initialized}, "
                             f"failure_count {est.failure_count}")
    want = sync["traj"]
    if not (np.array_equal(traj["initialized"], want["initialized"])
            and traj["t"].shape == want["t"].shape
            and np.abs(traj["t"] - want["t"]).max() <= 1e-12):
        raise AssertionError("async image path: not the synchronous path's frames")
    dp = float(np.abs(traj["p"] - want["p"]).max())
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape = metrics.ape_rmse(traj["p"], gt_p)["rmse"]
    stats = traj["pairer"]
    share = producer.overlap(consumer) / producer.total()
    print(f"async image path: {len(traj['initialized'])} published, {len(traj['t'])} poses, "
          f"max |dp| against the synchronous path {dp:.3e} m, APE rmse {ape:.6f} m {tag}")
    print(f"async image path wall {N_IMAGE_FRAMES / wall:.3f} frames/s ({wall:.2f} s) against "
          f"{N_IMAGE_FRAMES / sync['wall']:.3f} frames/s synchronous ({sync['wall']:.2f} s; "
          f"there read_image was synchronised around, here it is not) {tag}")
    print(f"async image path: producer busy {producer.total():.2f} s in read_image, consumer "
          f"busy {consumer.total():.2f} s in process_image, both at once "
          f"{producer.overlap(consumer):.2f} s = {100 * share:.1f} % of the producer's time {tag}")
    print(f"async image path gj_solve launches {launches}, pairer {stats} {tag}")
    rates, d = graph_rates(before, len(producer.spans), len(est.telemetry))
    print(f"async image path graphs: {rates} {tag}")
    hold_tracker_graphs("async image path", d, len(producer.spans))
    if not dp <= 1e-6:
        raise AssertionError(f"async image path: max |dp| {dp} m > 1e-6 m")
    if not ape < 0.05:
        raise AssertionError(f"async image path: APE {ape} m >= 0.05 m")
    if launches != sync["launches"]:
        raise AssertionError(f"async image path: {launches} launches, synchronous "
                             f"{sync['launches']}")
    if stats["imu_disorder"] or stats["frame_disorder"] or stats["frames_queued"]:
        raise AssertionError(f"async image path: pairer {stats}")
    if est.device.type != "cuda" or est.dtype != torch.float64:
        raise AssertionError(f"async image path ran on {est.device} in {est.dtype}")
    return launches


def orb_on_card_against_cpu(device, tag: str) -> None:
    """Phase 10's functions: descriptors of one rendered frame at the blob
    centres, and Hamming distances of seeded descriptors, on the card
    against the CPU.  A descriptor bit compares two float32 bilinear
    samples, so a bit whose samples nearly tie may differ: at most 1 %."""
    from vio_tpu_torch import sim
    from vio_tpu_torch.features import orb

    data = sim.generate(noise=False)
    img = sim.render_image(data, 0)
    uv = data.obs_uv[0][data.obs_valid[0]].astype(np.float32)
    valid = np.ones(len(uv), bool)
    lanes = [orb.describe(torch.as_tensor(img, device=d), torch.as_tensor(uv, device=d),
                          torch.as_tensor(valid, device=d)) for d in (device, "cpu")]
    got, ref = (orb.from_lanes(x) for x in lanes)
    differing = int(np.unpackbits((got ^ ref).view(np.uint8)).sum())
    print(f"orb describe: {len(uv)} keypoints, {differing} of {256 * len(uv)} bits differ "
          f"between card and CPU {tag}")
    if differing > 0.01 * 256 * len(uv):
        raise AssertionError("orb describe: the card disagrees with the CPU")
    rng = np.random.default_rng(0)
    d1 = rng.integers(0, 2 ** 32, size=(150, 8), dtype=np.uint32)
    d2 = np.concatenate([rng.integers(0, 2 ** 32, size=(256, 8), dtype=np.uint32), got])
    D = [orb.hamming_matrix(orb.to_lanes(d1, d), orb.to_lanes(d2, d)).cpu().numpy()
         for d in (device, "cpu")]
    want = np.unpackbits((d1[:, None, :] ^ d2[None, :, :]).view(np.uint8), axis=-1).sum(-1)
    if not (np.array_equal(D[0], D[1]) and np.array_equal(D[0], want)):
        raise AssertionError("orb hamming_matrix: not exact on the card")
    print(f"orb hamming_matrix: {D[0].shape} exact on the card {tag}")


def loop_closing_path(device, tag: str, dtype=None) -> dict:
    """Phase 10.  ``dtype`` is the estimator's and the closer's (None: the
    device's, float32 on the card).  Returns the Gauss-Jordan kernel's
    launches, those of the pose graph among them, and the closer."""
    from vio_tpu_torch import metrics, runner, sim
    from vio_tpu_torch.config import sim_config
    from vio_tpu_torch.loop import closer as closer_mod
    from vio_tpu_torch.ops import linsolve
    from vio_tpu_torch.solver import graph
    from vio_tpu_torch.utils import lie_np

    # one fixed random 256-bit descriptor per landmark: what a distinctive
    # texture patch would give (tests/test_loop_integration.py)
    data = sim.generate(noise=True, pixel_noise=0.0, descriptor_seed=12345)
    cfg = sim_config(acc_n=0.2687 / 3.0, gyr_n=0.2121 / 3.0, loop_closure=1,
                     loop_min_gap=80, loop_train_after=25)
    kf_ms, pg_ms, raw = [], [], []

    def synchronised(fn, log):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            log.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    add_keyframe = closer_mod.LoopCloser.add_keyframe
    optimize = closer_mod.posegraph.optimize
    pg = dict(stats=[], launches=0, captures=0, capture_s=0.0)

    def counted_optimize(*args, **kwargs):
        """The pose graph's solves: their stats, their cholesky_solve
        launches, the graphs they captured and the seconds capturing."""
        n0, c0, s0 = (linsolve.cholesky_solve.launches, graph.STATS["captures"],
                      graph.STATS["capture_s"])
        out = optimize(*args, **kwargs)
        pg["stats"].append(out[2])
        pg["launches"] += linsolve.cholesky_solve.launches - n0
        pg["captures"] += graph.STATS["captures"] - c0
        pg["capture_s"] += graph.STATS["capture_s"] - s0
        return out

    def on_frame(est, t, feats):
        """The window's own (odometry) pose, beside the published one."""
        if est.initialized:
            raw.append((est.Ps[est.frame_count].copy(), est.Rs[est.frame_count].copy()))

    n = N_LOOP_FRAMES - 1          # the last frame is solved after the rebase
    closer_mod.posegraph.optimize = synchronised(counted_optimize, pg_ms)
    closer_mod.LoopCloser.add_keyframe = synchronised(add_keyframe, kf_ms)
    linsolve.gj_solve.launches = 0
    before = dict(graph.STATS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        est, traj = runner.run_sim(data, cfg, n_frames=n, on_frame=on_frame, device=device,
                                   dtype=dtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        closer = est.closer
        published = traj["p"]
        # the window's odometry, which the closer corrects
        traj["p"], traj["R"] = (np.stack(x) for x in zip(*raw))
        Ps_c, _ = closer.correct(traj["t"], traj["p"], traj["R"])
    finally:
        closer_mod.posegraph.optimize = optimize
        closer_mod.LoopCloser.add_keyframe = add_keyframe

    if not est.initialized or est.failure_count != 0:
        raise AssertionError(f"loop path: initialized {est.initialized}, "
                             f"failure_count {est.failure_count}")
    for part in (est, closer):
        if part.device.type != "cuda" or part.dtype != (dtype or torch.float32):
            raise AssertionError(f"loop path ran on {part.device} in {part.dtype}")
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape_raw = metrics.ape_rmse(traj["p"], gt_p)["rmse"]
    ape_corr = metrics.ape_rmse(Ps_c, gt_p)["rmse"]

    def gt_at(tt):
        i = int(np.searchsorted(data.cam_t, tt))
        return data.imu_p[i], data.imu_R[i]

    perr, aerr = [], []
    for (j, k, dP, dq) in closer.loops:
        (pj, Rj), (pk, Rk) = gt_at(closer.kfs[j].t), gt_at(closer.kfs[k].t)
        cos = (np.trace((Rj.T @ Rk).T @ lie_np.quat_to_mat_np(dq)) - 1) / 2
        perr.append(np.linalg.norm(dP - Rj.T @ (pk - pj)))
        aerr.append(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    p_c, R_c = closer.live_correct(traj["p"][-1], traj["R"][-1])
    drift = float(np.linalg.norm(closer.drift_t))
    if not np.array_equal(published[-1], p_c):
        raise AssertionError("loop path: the published pose is not the drift-corrected one")
    print(f"loop path in {str(est.dtype)[6:]}: {n} frames, {len(traj['t'])} poses, "
          f"{len(closer.kfs)} keyframes, {len(closer.loops)} loops accepted {tag}")
    print(f"loop path APE rmse raw {ape_raw:.6f} m, pose-graph corrected {ape_corr:.6f} m, "
          f"|drift_t| {drift:.4f} m {tag}")
    print(f"loop path wall {n / wall:.3f} frames/s ({wall:.2f} s, loop closing included) {tag}")
    print(f"loop path gj_solve launches {linsolve.gj_solve.launches} {tag}")
    print(f"loop path graphs: {graph_rates(before, 0, len(est.telemetry))[0]} {tag}")
    if not ape_raw < 0.1583:
        raise AssertionError(f"loop path: raw APE {ape_raw} m >= 0.1583 m")
    if not closer.loops:
        raise AssertionError("loop path: no loop accepted over a closed circuit")
    print(f"loop path edges against ground truth: median {np.median(perr):.4f} m "
          f"{np.median(aerr):.4f} deg, 90th percentile {np.percentile(perr, 90):.4f} m "
          f"{np.percentile(aerr, 90):.4f} deg {tag}")
    print(f"loop path add_keyframe: median {statistics.median(kf_ms):.3f} ms, mean "
          f"{statistics.mean(kf_ms):.3f} ms, max {max(kf_ms):.3f} ms over {len(kf_ms)} "
          f"(synchronised; an accepted loop's pose-graph solve included) {tag}")
    print(f"loop path pose-graph solve: median {statistics.median(pg_ms):.3f} ms, max "
          f"{max(pg_ms):.3f} ms over {len(pg_ms)}, the last over {len(closer.kfs)} "
          f"keyframes {tag}")
    keys = {st["key"] for st in pg["stats"]}
    n_pg = len(pg["stats"])
    print(f"loop path pose graph as graphs: {len(keys)} keys (padded poses, edges: "
          f"{sorted((k[1], k[2]) for k in keys)}), {pg['captures']} graphs captured in "
          f"{pg['capture_s']:.2f} s; a solve {sum(st['attempts'] for st in pg['stats']) / n_pg:.2f} "
          f"attempts, {sum(st['reads'] for st in pg['stats']) / n_pg:.2f} reads, "
          f"{sum(st['iterations'] for st in pg['stats']) / n_pg:.2f} iterations; "
          f"cholesky_solve launches {pg['launches']} {tag}")
    if None in keys or pg["launches"] < sum(st["iterations"] for st in pg["stats"]):
        raise AssertionError(f"loop path: the pose graph did not run from its graphs "
                             f"through cholesky_solve: {len(keys)} keys, "
                             f"{pg['launches']} launches")
    if not (np.median(perr) < 0.3 and np.percentile(perr, 90) < 1.0
            and np.median(aerr) < 1.0 and np.percentile(aerr, 90) < 2.0):
        raise AssertionError("loop path: loop edges are not the ground truth's")
    if not ape_corr < max(2.0 * ape_raw, 0.30):
        raise AssertionError(f"loop path: corrected APE {ape_corr} m, raw {ape_raw} m")
    if not (np.all(np.isfinite(p_c)) and np.all(np.isfinite(R_c)) and drift < 2.0):
        raise AssertionError(f"loop path: live correction {p_c}, |drift_t| {drift} m")

    # the loop's feedback into the live window, then the circuit's last frame
    Ry, ty = est.apply_live_correction(closer.drift_R, closer.drift_t)
    closer.rebase(Ry, ty)
    p_c1, _ = closer.live_correct(Ry @ traj["p"][-1] + ty, Ry @ traj["R"][-1])
    if not np.abs(p_c1 - p_c).max() < 1e-9:
        raise AssertionError("loop path: rebase moved the corrected output")
    solved = est.frame_solved
    t_prev, t = data.cam_t[n - 1], data.cam_t[n]
    runner.feed_interval(est, data.imu_t, data.acc, data.gyr, t_prev, t,
                         int(np.searchsorted(data.imu_t, t_prev, side="right")))
    lids = [int(lid) for lid in np.where(data.obs_valid[n])[0]]
    est.process_image({lid: (np.array([*data.obs_xy[n, lid], 1.0]), data.obs_uv[n, lid],
                             np.zeros(2)) for lid in lids}, t,
                      {lid: data.descriptors[lid] for lid in lids})
    torch.cuda.synchronize()
    launches = linsolve.gj_solve.launches
    yaw = float(lie_np.mat_to_ypr_np(Ry)[0])
    print(f"loop path: live correction of {yaw:.4f} deg yaw and {np.linalg.norm(ty):.4f} m "
          f"applied to window and closer; frame {n} solved after it, failure_count "
          f"{est.failure_count} {tag}")
    if est.frame_solved != solved + 1 or est.failure_count != 0:
        raise AssertionError("loop path: the frame after the live correction did not solve")
    return dict(launches=launches, closer=closer)


def posegraph_problems(closer) -> list:
    """Phase 25's problems: (label, optimize's positional arguments, edge
    weights).  The circuit's last, rebuilt from the closer as
    ``LoopCloser.correct`` builds it, then the drifting circuits."""
    from vio_tpu_torch import testing
    from vio_tpu_torch.utils import lie_np

    K = len(closer.kfs)
    ei, ej, dPs, dqs, w = closer._edges(K)
    last = (np.stack([f.p for f in closer.kfs]),
            lie_np.mat_to_quat_np(np.stack([f.R for f in closer.kfs])), ei, ej, dPs, dqs)
    out = [(f"loop circuit's last, {K} poses, {len(ei)} edges", last, w)]
    for n in POSEGRAPH_N:
        _, _, args, w = testing.posegraph_circuit(n)
        out.append((f"drifting circuit, {n} poses, {len(args[2])} edges", args, w))
    return out


def posegraph_on_card(closer, tag: str) -> dict:
    """Phase 25.  Returns gj_solve's record at POSEGRAPH_P, keyed like
    phase 3's."""
    from vio_tpu_torch.loop import posegraph
    from vio_tpu_torch.ops import linsolve
    from vio_tpu_torch.solver import graph

    for label, args, w in posegraph_problems(closer):
        kw = dict(edge_weights=w, max_iter=40, dtype=torch.float64)   # LoopCloser's

        def timed(fn, device):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, device=device, **kw)
            torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t0)

        c0, s0 = graph.STATS["captures"], graph.STATS["capture_s"]
        _, first_ms = timed(posegraph.optimize, "cuda")
        captures, capture_s = graph.STATS["captures"] - c0, graph.STATS["capture_s"] - s0
        g0, h0 = linsolve.gj_solve.launches, linsolve.cholesky_solve.launches
        (Pg, qg, sg), graphed_ms = timed(posegraph.optimize, "cuda")
        launched = dict(gj_solve=linsolve.gj_solve.launches - g0,
                        cholesky=linsolve.cholesky_solve.launches - h0)
        (Pe, qe, se), eager_ms = timed(posegraph.optimize_eager, "cuda")
        (Pc, qc, sc), cpu_ms = timed(posegraph.optimize, "cpu")
        buckets = posegraph.POSE_BUCKET, posegraph.EDGE_BUCKET, posegraph.EDGES_PER_POSE
        posegraph.POSE_BUCKET = posegraph.EDGE_BUCKET = 1
        posegraph.EDGES_PER_POSE = 0
        try:
            Pu, qu, su = posegraph.optimize(*args, device="cpu", **kw)
        finally:
            posegraph.POSE_BUCKET, posegraph.EDGE_BUCKET, posegraph.EDGES_PER_POSE = buckets
        d_eager = float(np.abs(Pg - Pe).max())
        d_chi = abs(sg["chi2"] - se["chi2"]) / abs(se["chi2"])
        d_cpu = max(float(np.abs(Pg - Pc).max()), float(np.abs(qg - qc).max()))
        d_pad = max(float(np.abs(Pc - Pu).max()), float(np.abs(qc - qu).max()))
        key = sg["key"]
        print(f"pose graph, {label} (padded {key[1]} poses, {key[2]} edges): "
              f"{sg['iterations']} iterations, {sg['attempts']} attempts, {sg['reads']} reads; "
              f"graphed {graphed_ms:.3f} ms (first call {first_ms:.3f} ms, {captures} graphs "
              f"captured in {capture_s:.3f} s), eager twin {eager_ms:.3f} ms, CPU route "
              f"{cpu_ms:.3f} ms; |dP| against eager {d_eager:.3e} m, chi2 {d_chi:.3e} "
              f"relative; against the CPU {d_cpu:.3e}; CPU padded against unpadded "
              f"{d_pad:.3e}; damped solves launched {launched} {tag}")
        if launched != dict(gj_solve=0, cholesky=sg["attempts"]):
            raise AssertionError(f"pose graph {label}: {sg['attempts']} attempts launched "
                                 f"{launched}")
        if not (sg["iterations"] == se["iterations"] and d_eager <= PG_TWIN_DP
                and d_chi <= PG_TWIN_CHI2):
            raise AssertionError(f"pose graph {label}: graphed against eager: iterations "
                                 f"{sg['iterations']} / {se['iterations']}, |dP| {d_eager:.3e}, "
                                 f"chi2 {d_chi:.3e}")
        if not (sg["iterations"] == sc["iterations"] and d_cpu <= PG_CPU_TOL):
            raise AssertionError(f"pose graph {label}: graphed against the CPU: iterations "
                                 f"{sg['iterations']} / {sc['iterations']}, {d_cpu:.3e}")
        if not (sc["iterations"] == su["iterations"] and d_pad <= PG_PAD_TOL):
            raise AssertionError(f"pose graph {label}: padded against unpadded: iterations "
                                 f"{sc['iterations']} / {su['iterations']}, {d_pad:.3e}")
        if not (sg["reads"] == -(-sg["attempts"] // graph.CHUNK) and Pg.shape == Pc.shape
                and np.all(np.isfinite(Pg)) and np.all(np.isfinite(qg))):
            raise AssertionError(f"pose graph {label}: {sg['reads']} reads for "
                                 f"{sg['attempts']} attempts, or a misshapen result")

    rec = {}
    for dtype in (torch.float32, torch.float64):
        eps = torch.finfo(dtype).eps
        for P in POSEGRAPH_P:
            A, b = spd(P, dtype, seed=P)
            x = linsolve.gj_solve(A, b)
            torch.cuda.synchronize()
            x_ref = linsolve.gj_solve_reference(A, b)
            torch.cuda.synchronize()
            eta, eta_ref = backward_error(A, b, x), backward_error(A, b, x_ref)
            if not (eta <= P * eps and eta <= 10 * eta_ref):
                raise AssertionError(f"gj_solve P={P} {dtype}: backward error {eta:.3e} "
                                     f"(plain {eta_ref:.3e}, bound {P * eps:.3e})")
            ms = cuda_ms(lambda: linsolve.gj_solve(A, b), reps=10, warmup=2)
            plain_ms = cuda_ms(lambda: linsolve.gj_solve_reference(A, b), reps=1, warmup=0)
            library_ms = library_solve_ms(A, b)
            least_ms, bound_by = bound_ms(P, dtype)
            err = float((x - x_ref).abs().max())
            print(f"gj_solve {str(dtype)[6:]} P={P} (blocked): backward error kernel "
                  f"{eta:.3e} plain {eta_ref:.3e} (bound {P * eps:.3e}), max|x-x_ref| "
                  f"{err:.3e}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
                  f"{library_ms:.4f} ms bound {least_ms:.3e} ms ({bound_by}) {tag}")
            x_chol = linsolve.cholesky_solve(A, b)
            eta_chol = backward_error(A, b, x_chol)
            print(f"cholesky_solve {str(dtype)[6:]} P={P}: backward error {eta_chol:.3e} "
                  f"{tag}")
            if not eta_chol <= P * eps:
                raise AssertionError(f"cholesky_solve P={P} {dtype}: backward error "
                                     f"{eta_chol:.3e} (bound {P * eps:.3e})")
            rec[(dtype, P)] = dict(err=err, backward_err=eta, ms=ms, plain_ms=plain_ms,
                                   library_ms=library_ms, bound_ms=least_ms, bound_by=bound_by)
    return rec


def tracker_graphs_against_eager(cfg, data, n_frames: int, label: str, tag: str,
                                 on_frame=None, device=None) -> tuple[list, object]:
    """Phases 8 and 23: ``FeatureTracker.read_image`` on the card with its
    programs replayed from captured graphs, against a twin whose programs
    run the same functions eagerly (``_run_eager``), frame by frame: the
    positions, ids, track counts, templates and velocities' lifts, the
    published features and the frame kept on the device, to the bit.
    ``on_frame(k, out)`` sees the graphed tracker's output.  Returns the
    host inputs of every graphed RANSAC call (pos, p1, ok, idx) and the
    graphed tracker."""
    from vio_tpu_torch import runner, sim
    from vio_tpu_torch.solver import graph

    trk = runner.make_tracker(cfg, device=device)
    twin = runner.make_tracker(cfg, device=device)
    twin._run = twin._run_eager
    recorded, run = [], trk._run

    def recording(name, key, host, *args, **kwargs):
        if name == "reject":
            recorded.append([np.array(a) for a in host])
        return run(name, key, host, *args, **kwargs)

    trk._run = recording
    before = dict(graph.STATS)
    for k in range(n_frames):
        img, t = sim.render_image(data, k), float(data.cam_t[k])
        out, ref = trk.read_image(img, t), twin.read_image(img, t)
        for name in ("pos", "ids", "track_cnt", "tmpl_T", "tmpl_Gx", "tmpl_Gy", "prev_un"):
            if not np.array_equal(getattr(trk, name), getattr(twin, name)):
                raise AssertionError(f"{label}: frame {k}: the graphed tracker's {name} "
                                     f"is not the eager one's")
        if not (sorted(out) == sorted(ref) and all(
                np.array_equal(a, b) for f in out for a, b in zip(out[f], ref[f]))):
            raise AssertionError(f"{label}: frame {k}: published features differ")
        if not torch.equal(trk.prev_img, twin.prev_img):
            raise AssertionError(f"{label}: frame {k}: the frames kept on the device differ")
        if on_frame is not None:
            on_frame(k, out)
    rates, d = graph_rates(before, n_frames, 0)
    print(f"{label}: {n_frames} frames, graphed and eager on the card equal to the bit "
          f"(positions, ids, track counts, templates, lifts, published features, the "
          f"frame on the device); {len(recorded)} RANSAC calls; graphed: {rates} {tag}")
    hold_tracker_graphs(label, d, n_frames)
    return recorded, trk


def clahe_and_distortion_on_card(tag: str) -> None:
    """Phase 8."""
    from vio_tpu_torch import sim
    from vio_tpu_torch.config import sim_images_config

    data = sim.generate(noise=False, **DISTORT)
    cfg = sim_images_config(equalize=True, **DISTORT)
    worst, last = [0.0], {}

    def bearings(k, out):
        xy_gt = data.obs_xy[k][data.obs_valid[k]]
        for bearing, _, _ in out.values():
            worst[0] = max(worst[0], float(np.linalg.norm(xy_gt - bearing[:2], axis=1).min()))
        last["out"] = out

    _, trk = tracker_graphs_against_eager(cfg, data, N_CLAHE_FRAMES, "clahe + radtan tracker",
                                          tag, on_frame=bearings)
    out, worst = last["out"], worst[0]
    live = int(trk.valid.sum())
    print(f"clahe + radtan tracker: {N_CLAHE_FRAMES} frames, {live} live tracks at the end, "
          f"{len(out)} published, worst bearing {worst * 460.0:.3f} px from a landmark {tag}")
    if live < 40 or len(out) < 40:
        raise AssertionError(f"clahe + radtan tracker: {live} live tracks, {len(out)} published")
    if not worst < 5.0 / 460.0:
        raise AssertionError("clahe + radtan tracker: a published bearing is no landmark's")


def _up_to_sign(a, b):
    """max |a − b| and max |a + b| per leading index, the smaller of the two."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return np.minimum(np.abs(a - b).max(axis=1), np.abs(a + b).max(axis=1))


def _library_sweep(A):
    """The library's version of the sweep's SVDs: the null vectors of the
    gathered (n_hyp, 8, 9) systems by ``torch.linalg.svd``, then the 3 × 3
    projection."""
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    E = Vh[:, -1, :].reshape(-1, 3, 3)
    U, _, Vt = torch.linalg.svd(E)
    return U[..., :2] @ Vt[..., :2, :]


def _library_refit(A):
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    U, _, Vt = torch.linalg.svd(Vh[-1].reshape(3, 3))
    return U[:, :2] @ Vt[:2, :]


# The least arithmetic the RANSAC functions need, by the cheapest direct
# algorithms, whatever the kernels do (the refit's Jacobi sweeps make several
# times more).  A sample: its design rows (4 products a row), the null
# vector of its 8 × 9 system by Householder QR of the 9 × 8 transpose
# (2n²(m − n/3)) and the 8 reflectors applied to e₉ (4(m − k + 1) each),
# the 3 × 3 projection's bidiagonalisation (4mn² − 4n³/3) and its rank-2
# product (2 · 2 · 9).  The refit: its weighted rows (4 products and 9
# weights a row) over the rows that weigh, their Householder QR, the 9 × 9
# triangle's bidiagonalisation and the projection.  A valid row under an
# E: its Sampson error (33).  The SVDs' iterations are not counted.
def _qr_flops(m: int, n: int) -> float:
    return 2.0 * n * n * (m - n / 3.0)


PROJECT_FLOPS = 4 * 3 * 9 - 4 * 27 / 3 + 2 * 2 * 9
SAMPLE_FLOPS = 8 * 4 + _qr_flops(9, 8) + sum(4 * (9 - k + 1) for k in range(1, 9)) \
    + PROJECT_FLOPS
SAMPSON_FLOPS = 33


def sweep_flops(n_hyp: int, n_valid: int) -> float:
    return n_hyp * (SAMPLE_FLOPS + SAMPSON_FLOPS * n_valid)


def refit_flops(n_weighed: int, n_valid: int) -> float:
    m = max(n_weighed, 9)
    return (13 * m + _qr_flops(m, 9) + 4 * 9 * 81 - 4 * 729 / 3 + PROJECT_FLOPS
            + SAMPSON_FLOPS * n_valid)


def least_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The larger of the operations over the type's peak rate and the
    bytes over the memory rate, in ms, and which it is."""
    t_ops, t_bytes = flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def preint_step_flops(exact: bool) -> int:
    """Operations (a multiply or an add each) of one live step of
    csrc/preintegrate.cu's block-structured recurrence (its note)."""
    return 12112 if exact else 9187


def preint_inputs(W: int, M: int, dtype, seed: int, scattered: bool) -> list:
    """W intervals of M slots of a 200 Hz stream, every slot live or a
    scattered mask, in the estimator's leaves' types on the card."""
    rng = np.random.default_rng(seed)
    dts = np.full((W, M), 1.0 / 200.0) * (1.0 + 0.01 * rng.standard_normal((W, M)))
    accs = np.array([0.0, 0.0, 9.81]) + 0.5 * rng.standard_normal((W, M, 3))
    gyrs = 0.3 * rng.standard_normal((W, M, 3))
    mask = rng.random((W, M)) < 0.6 if scattered else np.ones((W, M), bool)
    acc0 = np.array([0.0, 0.0, 9.81]) + 0.5 * rng.standard_normal((W, 3))
    gyr0 = 0.3 * rng.standard_normal((W, 3))
    ba = 0.01 * rng.standard_normal((W, 3))
    bg = 0.001 * rng.standard_normal((W, 3))
    nd = np.array([0.2687 ** 2] * 3 + [0.2121 ** 2] * 3 + [0.2687 ** 2] * 3
                  + [0.2121 ** 2] * 3 + [7.07e-6 ** 2] * 3 + [7.07e-7 ** 2] * 3)
    return [torch.as_tensor(a, device="cuda") if a.dtype == np.bool_
            else torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (dts, accs, gyrs, mask, acc0, gyr0, ba, bg, nd)]


def preintegrate_on_card(frames: list, tag: str) -> dict:
    """Phase 26: the preintegration kernel in the frame's graphs, then
    against its plain version at the benchmark cell's shapes.  Returns
    {(M, dtype, exact): numbers}."""
    from vio_tpu_torch import imu
    from vio_tpu_torch.solver import frame_step, graph

    with graph._LOCK:
        loops = [(key, g) for key, g in graph._CACHE.items()
                 if isinstance(key[0], frame_step.FrameKey)]
    for key, lg in loops:
        held = {name: n.get(imu.preintegrate_kernel, 0) for name, n in lg.launches.items()}
        if held != {"head": 1, "chunk": 0, "tail": 0}:
            raise AssertionError(f"preintegrate in the graphs of {key}: {held}")
    n0 = imu.preintegrate_kernel.launches
    replayed = frames[-N_PREINT_REPLAYS:]
    for args, kw, _ in replayed:
        frame_step.frame_step_graphed(*args, **kw)
    torch.cuda.synchronize()
    grew = imu.preintegrate_kernel.launches - n0
    if not (len(loops) > 0 and grew == len(replayed)):
        raise AssertionError(f"preintegrate: {grew} launches over {len(replayed)} frames "
                             f"({len(loops)} frame keys)")
    print(f"preintegrate: one launch in the head graph of each of {len(loops)} frame keys, "
          f"none in their chunks and tails; {grew} launches over {len(replayed)} frames "
          f"replayed {tag}")

    rec = {}
    for M in PREINT_M:
        for dtype in (torch.float32, torch.float64):
            rtol, atol = PREINT_TOL[dtype]
            for exact in (True, False):
                errs = []
                for scattered in (False, True):
                    args = preint_inputs(PREINT_W, M, dtype, seed=M + scattered,
                                         scattered=scattered)
                    out = imu.preintegrate_kernel(*args, exact)
                    torch.cuda.synchronize()
                    ref = imu.preintegrate_reference(*args, exact)
                    for name, a, b in zip(imu.PreintState._fields, out, ref):
                        d = float((a - b).abs().max())
                        scale = float(b.abs().max())
                        if not d <= atol + rtol * scale:
                            raise AssertionError(
                                f"preintegrate M={M} {dtype} exact={exact} scattered="
                                f"{scattered}: {name} differs by {d:.3e} (largest {scale:.3e})")
                        errs.append(d / max(scale, 1e-300))
                args = preint_inputs(PREINT_W, M, dtype, seed=M, scattered=False)
                ms = graph_ms(lambda: imu.preintegrate_kernel(*args, exact))
                enqueued_ms = cuda_ms(lambda: imu.preintegrate_kernel(*args, exact),
                                      reps=50, warmup=5)
                plain_ms = graph_ms(lambda: imu.preintegrate_reference(*args, exact),
                                    calls=1, reps=5)
                elem = torch.finfo(dtype).bits // 8
                nbytes = (PREINT_W * M * 7 * elem + PREINT_W * M + PREINT_W * 12 * elem
                          + 18 * elem + PREINT_W * 473 * elem)
                bound, bound_by = least_ms(PREINT_W * M * preint_step_flops(exact), nbytes,
                                           dtype)
                rec[(M, dtype, exact)] = dict(err=max(errs), ms=ms, enqueued_ms=enqueued_ms,
                                              plain_ms=plain_ms, bound_ms=bound,
                                              bound_by=bound_by)
                print(f"preintegrate {str(dtype)[6:]} W={PREINT_W} M={M} "
                      f"{'exact' if exact else 'independent'}: largest |d| of a leaf "
                      f"{max(errs):.3e} of its largest entry; kernel {ms:.4f} ms as a graph "
                      f"node, {enqueued_ms:.4f} ms back to back; plain {plain_ms:.3f} ms "
                      f"as a graph; bound {bound:.3e} ms ({bound_by}) {tag}")
    return rec


def imu_factor_flops(W: int) -> int:
    """Operations (a multiply or an add each) the IMU factors' block needs
    once per interval (csrc/imu_factor.cu's note): Omega J 13,050, J^T
    (Omega J) 26,100, Omega r 435, J^T Omega r 870, r^T Omega r 29, the
    sums into Hpp, bp and chi 931, the residual and J's coefficients ~500."""
    return W * (13050 + 26100 + 435 + 870 + 29 + 931 + 500)


def imu_factor_bytes(W: int, dtype) -> int:
    """Bytes the kernel must move: each interval's preintegrated terms
    (242 numbers) and Omega (225), the frames' states (16 a frame), g, the
    mask, and Hpp's band (15 rows a frame, 45 columns, less the two corner
    blocks), bp and chi read and written."""
    elem = torch.finfo(dtype).bits // 8
    W1 = W + 1
    return elem * (W * 467 + 16 * W1 + 3 + 2 * (15 * 45 * W1 - 450 + 15 * W1 + 1)) + W


def imu_factor_problem(W: int, dtype, valid: str, seed: int):
    """tests/test_torch_imu_factor.py's problem on the card: the
    simulator's window with biases off their linearisation points, Omega
    as the solve inverts it, Hpp, bp, chi as the reprojection factors
    could leave them."""
    from vio_tpu_torch import testing
    from vio_tpu_torch.solver import window as Wn

    st, f, _ = testing.make_window_problem(window_size=W, max_features=16, device="cuda",
                                           dtype=dtype, seed=seed, perturb=0.05)
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, dtype=torch.float64)).to(
            device="cuda", dtype=dtype)

    st = st._replace(Bas=randn(W + 1, 3, scale=0.02), Bgs=randn(W + 1, 3, scale=0.002))
    mask = {"all": torch.ones(W, dtype=torch.bool), "first": torch.arange(W) == 0,
            "scattered": torch.rand(W, generator=g) < 0.5}[valid]
    f = f._replace(imu_valid=mask.cuda())
    A = randn(Wn.num_pose_params(W), Wn.num_pose_params(W))
    return st, f, Wn._imu_infos(f), A @ A.T, randn(A.shape[0]), randn(scale=3.0).abs()


def imu_factor_on_card(frames: list, tag: str) -> dict:
    """Phase 27: the IMU factor kernel in the frame's graphs, then against
    its plain version at the benchmark cell's window.  Returns
    {dtype: numbers}."""
    from vio_tpu_torch.solver import frame_step, graph
    from vio_tpu_torch.solver import window as Wn

    with graph._LOCK:
        loops = [(key, g) for key, g in graph._CACHE.items()
                 if isinstance(key[0], frame_step.FrameKey)]
    for key, lg in loops:
        held = {name: n.get(Wn.imu_factor_kernel, 0) for name, n in lg.launches.items()}
        want = {"head": 1 + lg.chunk, "chunk": lg.chunk, "tail": int(key[0].marg_old)}
        if held != want:
            raise AssertionError(f"imu_factor in the graphs of {key}: {held}, not {want}")
    n0 = Wn.imu_factor_kernel.launches
    replayed = frames[-N_IMU_FACTOR_REPLAYS:]
    assemblies = 0
    for args, kw, _ in replayed:
        out = frame_step.frame_step_graphed(*args, **kw)
        # lm.start's, one an attempt (graph.CHUNK a read), the marginalization's
        assemblies += 1 + graph.CHUNK * out.reads + int(kw.get("marg_old", True))
    torch.cuda.synchronize()
    grew = Wn.imu_factor_kernel.launches - n0
    if not (len(loops) > 0 and grew == assemblies):
        raise AssertionError(f"imu_factor: {grew} launches over {len(replayed)} frames of "
                             f"{assemblies} assemblies ({len(loops)} frame keys)")
    print(f"imu_factor: one launch an assembly in the graphs of each of {len(loops)} frame "
          f"keys (head 1 + CHUNK, chunk CHUNK, tail 1 where it marginalizes); {grew} "
          f"launches over {len(replayed)} frames replayed, {assemblies} assemblies {tag}")

    rec = {}
    for dtype in (torch.float32, torch.float64):
        errs = {}
        for valid in ("all", "first", "scattered"):
            st, f, infos, H, b, chi = imu_factor_problem(IMU_FACTOR_W, dtype, valid, seed=27)
            ref = Wn.imu_factor_reference(st, f, infos, H, b, chi)
            out = Wn.imu_factor(st, f, infos, H.clone(), b.clone(), chi.clone())
            torch.cuda.synchronize()
            for name, a, r in zip(("Hpp", "bp", "chi"), out, ref):
                d, scale = float((a - r).abs().max()), float(r.abs().max())
                if not d <= IMU_FACTOR_RTOL[dtype] * scale:
                    raise AssertionError(f"imu_factor {dtype} {valid}: {name} differs by "
                                         f"{d:.3e} (largest {scale:.3e})")
                errs[f"{valid} {name}"] = d / max(scale, 1e-300)
        st, f, infos, H, b, chi = imu_factor_problem(IMU_FACTOR_W, dtype, "all", seed=27)
        ms = graph_ms(lambda: Wn.imu_factor(st, f, infos, H, b, chi))
        enqueued_ms = cuda_ms(lambda: Wn.imu_factor(st, f, infos, H, b, chi), reps=50,
                              warmup=5)
        plain_ms = graph_ms(lambda: Wn.imu_factor_reference(st, f, infos, H, b, chi),
                            calls=1, reps=10)
        bound, bound_by = least_ms(imu_factor_flops(IMU_FACTOR_W),
                                   imu_factor_bytes(IMU_FACTOR_W, dtype), dtype)
        ops_ms = 1e3 * imu_factor_flops(IMU_FACTOR_W) / PEAK_FLOP_S[dtype]
        rec[dtype] = dict(err=max(errs.values()), errs=errs, ms=ms, enqueued_ms=enqueued_ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                          ops_bound_ms=ops_ms)
        print(f"imu_factor {str(dtype)[6:]} W={IMU_FACTOR_W}: largest |d| of an output "
              f"{max(errs.values()):.3e} of its largest entry; kernel {ms:.4f} ms as a graph "
              f"node, {enqueued_ms:.4f} ms back to back; plain block {plain_ms:.4f} ms as a "
              f"graph; bound {bound:.3e} ms ({bound_by}; by operations {ops_ms:.3e}) {tag}")
    return rec


def ransac_kernel_against_plain(recorded: list, cfg, tag: str, device="cuda") -> dict:
    """Phase 23, second part: the RANSAC kernel against its plain version
    on the card, in float32 and float64, on the tracker's inputs of the
    frame with the most valid rows (phase 7's stream, 150 slots, 256
    hypotheses): lifts of the positions in each type, its ok mask and its
    drawn samples.  The reference is the plain version run in float64 on
    the same inputs (for float32, the float32 lifts widened).  Every
    hypothesis's null vector and projection are held by their backward
    errors (BACKWARD_C·eps); E up to sign to E_TOL_C·eps·κ where the type
    determines it; the counts as COUNT_AGREE says.  The refit on the
    reference's best consensus set likewise.  Times the kernel, the plain
    version in the same type, the library's SVDs and the bound."""
    from vio_tpu_torch import runner
    from vio_tpu_torch.ops import ransac

    cam = runner.camera_from_config(cfg)
    thresh = cfg.f_threshold / cfg.focal_length      # the tracker's
    pos, p1, ok, idx = max(recorded, key=lambda r: int(r[2].sum()))
    n_hyp, N, n_valid = len(idx), len(ok), int(ok.sum())
    rec = {}
    for dtype in (torch.float32, torch.float64):
        eps = torch.finfo(dtype).eps
        elem = torch.finfo(dtype).bits // 8
        name = str(dtype)[6:]
        x0 = cam.lift(torch.as_tensor(pos, dtype=dtype, device=device))
        x1 = cam.lift(torch.as_tensor(p1, dtype=dtype, device=device))
        valid = torch.as_tensor(ok, device=device)
        idx_d = torch.as_tensor(idx, device=device)
        e = torch.empty((n_hyp, 9), dtype=dtype, device=device)
        E, n = ransac.sweep(x0, x1, valid, idx_d, thresh, null_out=e)
        torch.cuda.synchronize()
        E_pl, n_pl = ransac.sweep_reference(x0, x1, valid, idx_d, thresh)
        w0, w1 = x0.double(), x1.double()
        E64, n64 = ransac.sweep_reference(w0, w1, valid, idx_d, thresh)
        h0, h1 = (torch.where(valid[:, None], x, 0.0).cpu().numpy() for x in (w0, w1))
        rows = ransac.design_rows(h0, h1) * ok[:, None]
        A = rows[idx]
        kappa = ransac.e_condition(A)
        e_h, E_h = e.double().cpu().numpy(), E.double().cpu().numpy()
        back = ransac.null_backward(A, e_h)
        proj = ransac.projection_backward(e_h, E_h)
        E64_h = E64.cpu().numpy()
        dE, dE_pl = _up_to_sign(E_h, E64_h), _up_to_sign(E_pl.double().cpu().numpy(), E64_h)
        posed = eps * kappa <= WELL_POSED
        limit = ransac.BACKWARD_C * eps
        xm0, xm1 = ransac.masked(x0, x1, valid)
        n_own = ((ransac.epipolar_err(E, xm0, xm1) < thresh * thresh) & valid).sum(-1)
        n_h, n64_h = n.cpu().numpy(), n64.cpu().numpy()
        d_own = np.abs(n_h - n_own.cpu().numpy())
        d_ref = np.abs(n_h - n64_h)
        agree, agree_ref = float((d_own == 0).mean()), float((d_ref == 0).mean())
        agree_pl = float((n_pl.cpu().numpy() == n64_h).mean())
        print(f"essential_ransac sweep {name}: {n_hyp} hypotheses over N={N} ({n_valid} "
              f"valid), κ median {np.median(kappa):.3e}; backward error of the null "
              f"vectors max {back.max():.3e}, of the projections max {proj.max():.3e} "
              f"(limit {ransac.BACKWARD_C}·eps = {limit:.3e}, all {n_hyp}); against the "
              f"plain version in float64: max |dE| up to sign {dE[posed].max(initial=0):.3e} on "
              f"the {int(posed.sum())} with eps·κ ≤ {WELL_POSED} (worst / (C·eps·κ) "
              f"{(dE[posed] / (E_TOL_C * eps * kappa[posed])).max(initial=0):.3e}), median "
              f"over all {np.median(dE):.3e} (the plain version in {name}: "
              f"{np.median(dE_pl):.3e}); counts equal to the plain scoring of the kernel's "
              f"E on {100 * agree:.2f} % (max |dn| {int(d_own.max())}), to the float64 plain "
              f"sweep's on {100 * agree_ref:.2f} % (max |dn| {int(d_ref.max())}; the plain "
              f"version in {name}: {100 * agree_pl:.2f} %) {tag}")
        if not (np.all(back <= limit) and np.all(proj <= limit)):
            raise AssertionError(f"essential_ransac sweep {name}: a null vector or its "
                                 f"projection is not backward stable")
        if not (np.all(dE[posed] <= E_TOL_C * eps * kappa[posed])
                and agree >= COUNT_AGREE and d_own.max() <= 1):
            raise AssertionError(f"essential_ransac sweep {name}: the kernel disagrees with "
                                 f"its plain version")
        if dtype == torch.float64 and not (agree_ref >= COUNT_AGREE and d_ref.max() <= 1):
            raise AssertionError("essential_ransac sweep float64: the counts are not the "
                                 "plain sweep's")
        if dtype == torch.float32 and not (
                np.median(dE) <= ACCURACY_RATIO * np.median(dE_pl)
                and agree_ref >= agree_pl - COUNT_MARGIN):
            raise AssertionError("essential_ransac sweep float32: the kernel is less accurate "
                                 "than its plain version")
        # the refit on the reference's best consensus set
        best = int(torch.argmax(n64))
        w64 = ((ransac.epipolar_err(E64[best], *ransac.masked(w0, w1, valid))
                < thresh ** 2) & valid).double()
        w = w64.to(dtype)
        er = torch.empty(9, dtype=dtype, device=device)
        Er, inl, c = ransac.refit(x0, x1, valid, w, thresh, null_out=er)
        torch.cuda.synchronize()
        Er64, inl64, c64 = ransac.refit_reference(w0, w1, valid, w64, thresh)
        wh = w64.cpu().numpy()
        Aw = (rows * wh[:, None])[None]
        kr = float(ransac.e_condition(Aw)[0])
        r_back = float(ransac.null_backward(Aw, er.double().cpu().numpy()[None])[0])
        r_proj = float(ransac.projection_backward(er.double().cpu().numpy()[None],
                                            Er.double().cpu().numpy()[None])[0])
        dEr = float(_up_to_sign(Er.double().cpu().numpy()[None], Er64.cpu().numpy()[None])[0])
        flips = int((inl != inl64).sum())
        print(f"essential_ransac refit {name}: {int(wh.sum())} rows weighted, backward error "
              f"of the null vector {r_back:.3e}, of the projection {r_proj:.3e} (limit "
              f"{limit:.3e}); against the plain version in float64: |dE| up to sign "
              f"{dEr:.3e} (bound {E_TOL_C * eps * kr:.3e}), {flips} inlier flags differ, "
              f"count {int(c)} against {int(c64)} {tag}")
        if not (r_back <= limit and r_proj <= limit and dEr <= E_TOL_C * eps * kr
                and flips <= 1 and abs(int(c) - int(c64)) <= 1):
            raise AssertionError(f"essential_ransac refit {name}: the kernel disagrees")
        # refit_best on the kernel's own sweep, against its plain version in
        # float64 (the same choice of hypothesis: the same counts)
        eb = torch.empty(9, dtype=dtype, device=device)
        Eb, inl_b, c_b = ransac.refit_best(x0, x1, valid, E, n, thresh, null_out=eb)
        torch.cuda.synchronize()
        Eb64, inl_b64, c_b64 = ransac.refit_best_reference(w0, w1, valid, E.double(), n,
                                                           thresh)
        k_best = int(torch.argmax(n))     # its consensus set in the input type, as the kernel's
        wb = ((ransac.epipolar_err(E[k_best], *ransac.masked(x0, x1, valid))
               < thresh ** 2) & valid).double().cpu().numpy()
        Ab = (rows * wb[:, None])[None]
        kb = float(ransac.e_condition(Ab)[0])
        b_back = float(ransac.null_backward(Ab, eb.double().cpu().numpy()[None])[0])
        b_proj = float(ransac.projection_backward(eb.double().cpu().numpy()[None],
                                                  Eb.double().cpu().numpy()[None])[0])
        dEb = float(_up_to_sign(Eb.double().cpu().numpy()[None], Eb64.cpu().numpy()[None])[0])
        b_flips = int((inl_b != inl_b64).sum())
        print(f"essential_ransac refit_best {name}: hypothesis {k_best}, {int(wb.sum())} rows "
              f"weighted, backward error of the null vector {b_back:.3e}, of the projection "
              f"{b_proj:.3e} (limit {limit:.3e}); against refit_best_reference in float64: "
              f"|dE| up to sign {dEb:.3e} (bound {E_TOL_C * eps * kb:.3e}), {b_flips} inlier "
              f"flags differ, count {int(c_b)} against {int(c_b64)} {tag}")
        if not (b_back <= limit and b_proj <= limit and dEb <= E_TOL_C * eps * kb
                and b_flips <= 1 and abs(int(c_b) - int(c_b64)) <= 1):
            raise AssertionError(f"essential_ransac refit_best {name}: the kernel disagrees")

        At = torch.as_tensor(A, dtype=dtype, device=device)
        Awt = torch.as_tensor(Aw[0], dtype=dtype, device=device)
        sweep_call = lambda: ransac.sweep(x0, x1, valid, idx_d, thresh)    # noqa: E731
        refit_call = lambda: ransac.refit(x0, x1, valid, w, thresh)        # noqa: E731
        best_call = lambda: ransac.refit_best(x0, x1, valid, E, n, thresh)  # noqa: E731
        ms, r_ms, b_ms = (graph_ms(f) for f in (sweep_call, refit_call, best_call))
        enq, r_enq, b_enq = (cuda_ms(f, reps=50, warmup=5)
                             for f in (sweep_call, refit_call, best_call))
        plain_ms = cuda_ms(lambda: ransac.sweep_reference(x0, x1, valid, idx_d, thresh),
                           reps=3, warmup=1)
        library_ms = cuda_ms(lambda: _library_sweep(At), reps=10, warmup=2)
        r_plain = cuda_ms(lambda: ransac.refit_reference(x0, x1, valid, w, thresh),
                          reps=10, warmup=2)
        r_library = cuda_ms(lambda: _library_refit(Awt), reps=10, warmup=2)
        b_plain = cuda_ms(lambda: ransac.refit_best_reference(x0, x1, valid, E, n, thresh),
                          reps=10, warmup=2)
        Abt = torch.as_tensor(Ab[0], dtype=dtype, device=device)
        b_library = cuda_ms(lambda: _library_refit(Abt), reps=10, warmup=2)
        # bytes: x0, x1, valid and idx in, E and the counts out; the
        # refit's x0, x1, valid and w in, E, the mask and the count out
        flops = sweep_flops(n_hyp, n_valid)
        least, bound_by = least_ms(flops, 4 * N * elem + N + 64 * n_hyp + 9 * n_hyp * elem
                                   + 8 * n_hyp, dtype)
        r_flops = refit_flops(int((wh > 0).sum()), n_valid)
        r_least, r_by = least_ms(r_flops, 5 * N * elem + N + 9 * elem + N + 8, dtype)
        # refit_best: x0, x1, valid, Es and the counts in; E, the mask and
        # the count out; the choice (n_hyp compares), E0's Sampson errors,
        # then the refit
        b_flops = n_hyp + SAMPSON_FLOPS * n_valid + refit_flops(int((wb > 0).sum()), n_valid)
        b_least, b_by = least_ms(b_flops, 4 * N * elem + N + 9 * n_hyp * elem + 8 * n_hyp
                                 + 9 * elem + N + 8, dtype)
        print(f"essential_ransac kernels {name}, ms a call back to back from Python (the "
              f"host's enqueueing): sweep {enq:.4f}, refit {r_enq:.4f}, refit_best "
              f"{b_enq:.4f} {tag}")
        print(f"essential_ransac sweep {name} n_hyp={n_hyp} N={N}: kernel {ms:.4f} ms (a "
              f"graph's replays), plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (torch.linalg.svd of the "
              f"gathered systems + the 3x3 projection), bound {least:.3e} ms ({bound_by}; "
              f"{flops / 1e6:.3f} MFLOP) {tag}")
        print(f"essential_ransac refit {name} N={N}: kernel {r_ms:.4f} ms (replays), plain "
              f"{r_plain:.4f} ms, library {r_library:.4f} ms, bound {r_least:.3e} ms "
              f"({r_by}; {r_flops / 1e6:.3f} MFLOP) {tag}")
        print(f"essential_ransac refit_best {name} n_hyp={n_hyp} N={N}: kernel {b_ms:.4f} ms "
              f"(replays), "
              f"plain {b_plain:.4f} ms (argmax, the consensus set, the plain refit), library "
              f"{b_library:.4f} ms (the consensus system's SVD + the projection; the choice "
              f"has no library call), bound {b_least:.3e} ms ({b_by}; "
              f"{b_flops / 1e6:.3f} MFLOP) {tag}")
        rec[dtype] = dict(err=float(dE[posed].max(initial=0)), backward_err=float(back.max()),
                          projection_err=float(proj.max()), backward_limit=limit,
                          ms=ms, enqueued_ms=enq, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=least,
                          bound_by=bound_by, count_agree_own=agree,
                          count_agree_plain64=agree_ref, plain_count_agree_plain64=agree_pl,
                          well_posed=int(posed.sum()),
                          refit=dict(err=dEr, backward_err=r_back, projection_err=r_proj,
                                     ms=r_ms, enqueued_ms=r_enq, plain_ms=r_plain,
                                     library_ms=r_library,
                                     bound_ms=r_least, bound_by=r_by),
                          refit_best=dict(err=dEb, backward_err=b_back, projection_err=b_proj,
                                          ms=b_ms, enqueued_ms=b_enq, plain_ms=b_plain,
                                          library_ms=b_library,
                                          bound_ms=b_least, bound_by=b_by))
    return rec


def reject_replay_ms(tag: str) -> dict:
    """Device ms of one replay of the reject program (the RANSAC: two
    lifts, the sweep and refit_best) of every tracker key captured so far,
    20 replays between CUDA events; by the key's shape and CLAHE flag."""
    from vio_tpu_torch.solver import graph

    out = {}
    for k, g in list(graph._CACHE.items()):
        if isinstance(g, graph.ProgramGraph) and k[0] == "reject":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            g.graph.replay()
            ev[0].record()
            for _ in range(20):
                g.graph.replay()
            ev[1].record()
            torch.cuda.synchronize()
            key = k[1]
            out[f"{key.shape[0]}x{key.shape[1]}{' clahe' if key.equalize else ''}"] = \
                ev[0].elapsed_time(ev[1]) / 20
    print("reject program, device ms of one replay: "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()) + f" {tag}")
    return out


@contextlib.contextmanager
def stage_timers(*targets):
    """Replace each (module, name) by a wrapper that synchronises before
    and after every call and logs its milliseconds; yields {name: [ms]}."""
    logs = {name: [] for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(fn, log):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            log.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn, logs[name]))
    try:
        yield logs
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def global_ba_eager(p, device=None, dtype=None, **kw):
    """``global_ba.solve(p, **kw)``'s program on ``graph.EagerLoop``: on the
    card the captured graphs' twin, which a stage timer can time."""
    from vio_tpu_torch.device import move, resolve
    from vio_tpu_torch.parallel import global_ba
    from vio_tpu_torch.solver import graph
    device, dtype = resolve(device, dtype)
    return global_ba.solve_with(graph.EagerLoop, move(p, device, dtype), **kw)


def global_ba_run(label: str, gt, noisy, kw: dict, tag: str, ok, memory: bool = False) -> dict:
    """Phases 11-12: ``global_ba.solve`` on the card, which replays the
    key's captured graphs: a first, counted call (the capture and one
    replayed solve), a second call timed alone; then the eager twin
    (``global_ba_eager``) on the same inputs, and one more eager run with every
    stage synchronised for the per-attempt breakdown.  ``ok(out, stats)``
    holds a run to the phase's bounds (raises); both runs are held.
    Returns the counted run's result and launches, and its distance from
    the twin's."""
    from vio_tpu_torch.ops import _build, linsolve
    from vio_tpu_torch.parallel import global_ba
    from vio_tpu_torch.solver import graph

    P = 6 * noisy.Ps.shape[0]
    elem = noisy.Ps.element_size()
    regime = "registers" if _build.load().gj_solve_work_elems(P, elem) == 0 else "blocked"
    if memory:
        torch.cuda.reset_peak_memory_stats()
    stats0 = dict(graph.STATS)
    linsolve.gj_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, st = global_ba.solve(noisy, **kw)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = linsolve.gj_solve.launches
    g = {k: graph.STATS[k] - stats0.get(k, 0) for k in (
        "keys", "captures", "capture_s", "pool_bytes", "replays", "reads", "attempts",
        "global_ba_graphed")}
    peak = torch.cuda.max_memory_allocated() if memory else None
    stats1 = dict(graph.STATS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2, _ = global_ba.solve(noisy, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = graph.STATS["reads"] - stats1.get("reads", 0)
    replays = graph.STATS["replays"] - stats1.get("replays", 0)
    # index_add_'s atomics sum in the order the threads arrive: two solves
    # of one key may differ in their last bits, and an LM decision after
    # them may follow
    dp_replays = float((out2.Ps - out.Ps).abs().max())

    if memory:
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, st_ref = global_ba_eager(noisy, **kw)
    torch.cuda.synchronize()
    wall_eager = time.perf_counter() - t0
    peak_eager = torch.cuda.max_memory_allocated() if memory else None
    with stage_timers((global_ba, "_assemble_terms"), (global_ba, "reduce_camera_system"),
                      (linsolve, "spd_solve")) as logs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        global_ba_eager(noisy, **kw)
        torch.cuda.synchronize()
        wall_i = 1e3 * (time.perf_counter() - t0)
    n_att = len(logs["spd_solve"])
    timed = sum(sum(v) for v in logs.values())
    asm = statistics.mean(logs["_assemble_terms"][1:])
    schur = statistics.mean(logs["reduce_camera_system"])
    solve = statistics.mean(logs["spd_solve"])
    rest = (wall_i - timed) / n_att

    chi2, chi2_0 = float(st["chi2"]), float(st["chi2_init"])
    err = float(torch.linalg.norm(out.Ps - gt.Ps, dim=1).max())
    err0 = float(torch.linalg.norm(noisy.Ps - gt.Ps, dim=1).max())
    dp = float((out.Ps - ref.Ps).abs().max())
    O = int(noisy.valid.sum())
    print(f"{label}: P={P} ({regime}), {O} observations, {st['iterations']} iterations, "
          f"chi2 {chi2:.6e} of {chi2_0:.6e}, max pose error {err:.3e} m (start {err0:.3e} m), "
          f"gj_solve launches {launches} (graph replays) {tag}")
    print(f"{label} graphed: first call {first:.3f} s ({g['keys']} key, {g['captures']} graphs "
          f"captured in {g['capture_s']:.3f} s, pool {g['pool_bytes'] / 2**20:.1f} MiB), then "
          f"wall {1e3 * wall:.3f} ms a solve with {replays} replays and {reads} reads "
          f"(K={graph.CHUNK}); eager twin wall {1e3 * wall_eager:.3f} ms "
          f"({st_ref['iterations']} iterations, {st_ref['reads']} reads) {tag}")
    print(f"{label} graphed against eager: iterations {st['iterations']} / "
          f"{st_ref['iterations']}, max |dp| {dp:.3e} m (two graphed solves: {dp_replays:.3e} "
          f"m) {tag}")
    print(f"{label} per λ-attempt of the eager twin ({n_att} attempts, synchronised): "
          f"assembly {asm:.3f} ms, Schur product {schur:.3f} ms, gj_solve {solve:.3f} ms, "
          f"rest {rest:.3f} ms; wall {wall_i / 1e3:.3f} s {tag}")
    if peak is not None:
        print(f"{label} peak device memory {peak / 2**30:.3f} GiB graphed (first call), "
              f"{peak_eager / 2**30:.3f} GiB eager {tag}")
    if g["global_ba_graphed"] != 1 or not (g["replays"] > 0 and g["captures"] >= 3):
        raise AssertionError(f"{label}: the solve did not run from captured graphs: {g}")
    # one gj_solve an attempt: every launch is a replayed attempt's, and at
    # K = 1 every attempt replayed is one the loop counts
    if not (launches > 0 and launches == g["attempts"]
            and (graph.CHUNK > 1 or launches == st["iterations"])):
        raise AssertionError(f"{label}: {launches} launches for {g['attempts']} attempts "
                             f"replayed, {st['iterations']} iterations")
    if reads != -(-st["iterations"] // graph.CHUNK):
        raise AssertionError(f"{label}: {reads} reads for {st['iterations']} attempts")
    if st.keys() != st_ref.keys() or not isinstance(st["chi2"], torch.Tensor):
        raise AssertionError(f"{label}: graphed stats {sorted(st)}, eager {sorted(st_ref)}")
    for name, o, s in (("graphed", out, st), ("eager", ref, st_ref)):
        if not (np.isfinite(float(s["chi2"])) and bool(torch.isfinite(o.Ps).all())):
            raise AssertionError(f"{label} {name}: not finite")
        if o.Ps.device.type != "cuda":
            raise AssertionError(f"{label} {name} ran on {o.Ps.device}")
        ok(o, s, name)
    return dict(out=out, launches=launches, regime=regime, dp=dp,
                iterations=st["iterations"], iterations_eager=st_ref["iterations"])


def global_ba_one_card(tag: str) -> tuple[dict, dict]:
    """Phase 11.  Returns the launches by type and the float64 run."""
    from vio_tpu_torch import testing
    from vio_tpu_torch.device import move
    from vio_tpu_torch.parallel import global_ba

    launches, runs = {}, {}
    for dtype, kw, pose_tol in (
            (torch.float32, dict(max_iter=10, fix_frames=2, loss_delta=50.0), GLOBAL_F32_POSE_TOL),
            (torch.float64, dict(max_iter=25, fix_frames=2, loss_delta=50.0), 1e-4)):
        gt, _ = testing.make_global_problem(**GLOBAL_BENCH, dtype=dtype)
        noisy = testing.perturb_global(gt, **GLOBAL_PERTURB)
        label = f"global BA 100 kf {str(dtype)[6:]}"

        # the float32 chi² reads 0 near the solution (docstring, phase 11):
        # the result's chi² in float64 is the one that is held
        def chi2_64(p):
            return float(global_ba.assemble(move(p, p.Ps.device, torch.float64),
                                            GLOBAL_BENCH["N"], GLOBAL_BENCH["M"],
                                            kw["fix_frames"], kw["loss_delta"]).chi2)

        def ok(out, st, name):
            err = float(torch.linalg.norm(out.Ps - gt.Ps, dim=1).max())
            if dtype == torch.float32:
                c, c0 = chi2_64(out), chi2_64(noisy)
                print(f"{label} {name}: the result's chi2 in float64 {c:.6e} of {c0:.6e} "
                      f"(ratio {c / c0:.3e}, bound {GLOBAL_F32_CHI2_64:g}), max pose error "
                      f"{err:.3e} m {tag}")
                held = c <= GLOBAL_F32_CHI2_64 * c0
            else:
                held = float(st["chi2"]) < 1e-8 * float(st["chi2_init"])
            if not (held and err < pose_tol):
                raise AssertionError(f"{label} {name}: chi2 {float(st['chi2'])} of "
                                     f"{float(st['chi2_init'])}, pose error {err} m "
                                     f"(bound {pose_tol})")

        r = global_ba_run(label, gt, noisy, dict(kw, dtype=dtype), tag, ok)
        if dtype == torch.float64 and not (r["iterations"] == r["iterations_eager"]
                                           and r["dp"] <= GLOBAL_TWIN_DP64):
            raise AssertionError(f"{label}: graphed {r['iterations']} iterations against eager "
                                 f"{r['iterations_eager']}, max |dp| {r['dp']:.3e} m "
                                 f"(bound {GLOBAL_TWIN_DP64})")
        if r["regime"] != "blocked":
            raise AssertionError("global BA: P=600 did not take the blocked regime")
        launches[dtype] = r["launches"]
        runs[dtype] = dict(r, gt=gt, noisy=noisy, kw=kw)
    return launches, runs[torch.float64]


def global_ba_scaling_size(tag: str) -> int:
    """Phase 12.  Returns the launches."""
    from vio_tpu_torch import testing

    t0 = time.perf_counter()
    gt, _ = testing.make_global_problem(**GLOBAL_SCALING, dtype=torch.float32)
    noisy = testing.perturb_global(gt, **GLOBAL_PERTURB)
    torch.cuda.synchronize()
    print(f"global BA 64 kf 1M obs: problem built in {time.perf_counter() - t0:.2f} s (host numpy) {tag}")
    err0 = float(torch.linalg.norm(noisy.Ps - gt.Ps, dim=1).max())

    def ok(out, st, name):
        err = float(torch.linalg.norm(out.Ps - gt.Ps, dim=1).max())
        if not (float(st["chi2"]) < float(st["chi2_init"]) and err < err0):
            raise AssertionError(f"global BA at 1M observations {name}: chi2 "
                                 f"{float(st['chi2'])} of {float(st['chi2_init'])}, pose error "
                                 f"{err} from {err0} m")

    r = global_ba_run("global BA 64 kf 1M obs float32", gt, noisy,
                      dict(max_iter=8, fix_frames=2), tag, ok, memory=True)
    return r["launches"]


def spd_system(P: int, cond: float, seed: int):
    """Phase 24's SPD system in float64 on the host: eigenvalues log-spaced
    over ``cond`` in a seeded orthogonal basis, rows and columns scaled by
    a seeded diagonal in [0.5, 2] (so the Jacobi preconditioner has work),
    and a seeded right-hand side."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((P, P)))
    D = np.diag(rng.uniform(0.5, 2.0, P))
    H = D @ (Q * np.logspace(0, np.log10(cond), P)) @ Q.T @ D
    return 0.5 * (H + H.T), rng.standard_normal(P)


def pcg_on_card(tag: str, direct64: dict) -> None:
    """Phase 24: Jacobi-PCG on the card, graphed (``pcg.pcg_solve``)
    against its eager twin (``pcg.solve_with(graph.EagerLoop, ...)``) at P = 600 and 1200 in
    both types; ``global_ba.solve(use_pcg=True)`` at phase 11's float64
    problem; ``global_ba.solve`` at 200 keyframes (P = 1200, PCG through
    ``spd_solve``)."""
    from vio_tpu_torch import testing
    from vio_tpu_torch.parallel import global_ba
    from vio_tpu_torch.solver import graph, pcg

    for P in PCG_SIZES:
        Hn, bn = spd_system(P, PCG_COND, seed=P)
        kappa = float(np.linalg.cond(Hn))
        for dtype in (torch.float32, torch.float64):
            rtol = PCG_RTOL[dtype]
            H = torch.as_tensor(Hn, dtype=dtype, device="cuda")
            b = torch.as_tensor(bn, dtype=dtype, device="cuda")
            s0 = dict(graph.STATS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, k = pcg.pcg_solve(H, b, rtol=rtol)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            ms = cuda_ms(lambda: pcg.pcg_solve(H, b, rtol=rtol), reps=5, warmup=0)
            reads = (graph.STATS["reads"] - s0.get("reads", 0)) / 6
            ms_eager = cuda_ms(lambda: pcg.solve_with(graph.EagerLoop, H, b, rtol=rtol),
                               reps=3, warmup=1)
            x_ref, k_ref = pcg.solve_with(graph.EagerLoop, H, b, rtol=rtol)
            nb = float(np.linalg.norm(bn))
            res = [float(np.linalg.norm(Hn @ v.double().cpu().numpy() - bn)) / nb
                   for v in (x, x_ref)]
            dx = float((x - x_ref).abs().max())
            name = f"pcg {str(dtype)[6:]} P={P}"
            line = (f"{name}: {k} iterations graphed, {k_ref} eager; relative residual "
                    f"{res[0]:.3e} / {res[1]:.3e} (rtol {rtol:g}); max |x - x_eager| {dx:.3e}; "
                    f"graphed {ms:.3f} ms a solve ({reads:.1f} reads, K={pcg.CHUNK}; first "
                    f"call {first:.3f} s with its capture), eager {ms_eager:.3f} ms")
            if dtype == torch.float64:
                x_dir = np.linalg.solve(Hn, bn)
                fwd = float(np.linalg.norm(x.cpu().numpy() - x_dir) / np.linalg.norm(x_dir))
                line += f"; against the direct solve {fwd:.3e} (bound κ·rtol {kappa * rtol:.3e})"
                if not fwd <= kappa * rtol:
                    raise AssertionError(f"{name}: {fwd:.3e} from the direct solve")
            print(f"{line} {tag}")
            if not (k == k_ref and max(res) <= rtol and 0 < k < 2 * P and x.is_cuda):
                raise AssertionError(f"{name}: iterations {k} / {k_ref}, residuals {res}")

    # global BA with use_pcg=True at phase 11's float64 problem
    gt, noisy, kw = direct64["gt"], direct64["noisy"], direct64["kw"]
    s0 = dict(graph.STATS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, st = global_ba.solve(noisy, use_pcg=True, dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {k: graph.STATS[k] - s0.get(k, 0) for k in ("pcg_solves", "pcg_iterations", "reads",
                                                     "global_ba_eager")}
    err = float(torch.linalg.norm(out.Ps - gt.Ps, dim=1).max())
    dp = float((out.Ps - direct64["out"].Ps).abs().max())
    chi2, chi2_0 = float(st["chi2"]), float(st["chi2_init"])
    print(f"global BA 100 kf float64 use_pcg=True: {st['iterations']} iterations, chi2 "
          f"{chi2:.6e} of {chi2_0:.6e}, max pose error {err:.3e} m, max |dp| against phase "
          f"11's direct graphed solve {dp:.3e} m; wall {wall:.3f} s, {d['pcg_solves']} PCG "
          f"solves, {d['pcg_iterations'] / max(d['pcg_solves'], 1):.1f} CG iterations and "
          f"{d['reads'] / max(d['pcg_solves'], 1):.1f} reads an attempt {tag}")
    if not (d["global_ba_eager"] == 1 and d["pcg_solves"] == st["iterations"]
            and chi2 < 1e-8 * chi2_0 and err < 1e-4):
        raise AssertionError(f"global BA use_pcg=True: {d}, chi2 {chi2} of {chi2_0}, "
                             f"pose error {err} m")

    # 200 keyframes: P = 1200 > gj_solve's 1024, so spd_solve takes PCG
    gt, _ = testing.make_global_problem(**GLOBAL_PCG, dtype=torch.float64)
    noisy = testing.perturb_global(gt, **GLOBAL_PERTURB)
    err0 = float(torch.linalg.norm(noisy.Ps - gt.Ps, dim=1).max())
    s0 = dict(graph.STATS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, st = global_ba.solve(noisy, dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {k: graph.STATS[k] - s0.get(k, 0) for k in ("pcg_solves", "pcg_iterations", "reads",
                                                     "global_ba_eager", "capture_s")}
    err = float(torch.linalg.norm(out.Ps - gt.Ps, dim=1).max())
    chi2, chi2_0 = float(st["chi2"]), float(st["chi2_init"])
    print(f"global BA 200 kf float64 (P=1200, PCG through spd_solve): {st['iterations']} "
          f"iterations, chi2 {chi2:.6e} of {chi2_0:.6e}, max pose error {err:.3e} m (start "
          f"{err0:.3e} m); wall {wall:.3f} s ({d['capture_s']:.3f} s capturing), "
          f"{d['pcg_iterations'] / max(d['pcg_solves'], 1):.1f} CG iterations and "
          f"{d['reads'] / max(d['pcg_solves'], 1):.1f} reads an attempt {tag}")
    if not (d["global_ba_eager"] == 1 and d["pcg_solves"] == st["iterations"] > 0
            and chi2 < chi2_0 and err < err0):
        raise AssertionError(f"global BA 200 kf: {d}, chi2 {chi2} of {chi2_0}, pose error "
                             f"{err} from {err0} m")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_worker(rank: int, world: int, backend: str, port: int, devices, jobs, queue):
    """One rank of phases 13-14, in a spawned process: puts (rank, results)
    on the queue, or (rank, the traceback) when it fails."""
    try:
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        from vio_tpu_torch import testing
        from vio_tpu_torch.ops import linsolve
        from vio_tpu_torch.parallel import global_ba, sharded

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def counted(fn):
            linsolve.gj_solve.launches = 0
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            return out, time.perf_counter() - t0, linsolve.gj_solve.launches

        res = {}
        if "global" in jobs:
            gt, _ = testing.make_global_problem(**GLOBAL_DIST, device="cpu", dtype=torch.float64)
            part = global_ba.prepare_sharded(testing.perturb_global(gt, **GLOBAL_PERTURB),
                                             rank, world)
            for dtype in (torch.float64, torch.float32):
                (out, st), wall, launches = counted(lambda: global_ba.solve_sharded(
                    part, max_iter=8, fix_frames=2, device=dev, dtype=dtype))
                res[dtype] = dict(Ps=out.Ps.double().cpu().numpy(), chi2=float(st["chi2"]),
                                  chi2_0=float(st["chi2_init"]), iterations=st["iterations"],
                                  allreduces=st["allreduces"], bytes=st["allreduce_bytes"],
                                  wall=wall, launches=launches)
        if "window" in jobs:
            states, f, _ = testing.make_window_problem(window_size=10, max_features=256,
                                                       imu_per_interval=8, device=dev)
            ls, lf = sharded.shard_problem(states, f, rank, world)
            (out, _, _, st), wall, launches = counted(lambda: sharded.solve_window_sharded(
                ls, lf, max_iter=10, device=dev))
            res["window"] = dict(Ps=out.Ps.double().cpu().numpy(), chi2=float(st["chi2"]),
                                 iterations=int(st["iterations"]), bytes=st["allreduce_bytes"],
                                 wall=wall, launches=launches)
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


def run_ranks(world: int, backend: str, devices, jobs) -> list:
    """Spawn ``world`` ranks of ``dist_worker``; returns their results in
    rank order and leaves no process running."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=dist_worker, args=(r, world, backend, port, devices, jobs, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while len(results) < world:
            try:
                rank, res = queue.get(timeout=5)
            except Empty:
                codes = [p.exitcode for p in procs]
                if any(codes) or time.monotonic() > deadline:
                    raise RuntimeError(f"{backend} ranks: exit codes {codes}, "
                                       f"{len(results)} of {world} results")
                continue
            if isinstance(res, str):
                raise RuntimeError(f"{backend} rank {rank} of {world} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"{backend} ranks exited with {codes}")
    return [results[r] for r in range(world)]


def distributed_paths(tag: str) -> dict:
    """Phases 13-14.  Returns the launches of each run, summed over its
    ranks.  The 2-rank solve is held to the 1-rank one in float64, where
    the float64 reduction makes the two agree as SCALING.md shows (poses
    ≤ 1e-8 m, chi² ≤ 1e-9 relative); in float32, 8 iterations at 65,536
    observations end far from convergence and the accept path follows the
    float32 partial sums' order (on the CPU 1.4e-3 m and 7 % of chi²
    between 1 and 2 ranks, scripts/torch_scale_out_cpu.py ranks), so there
    each run is held to descent only and the difference is printed."""
    from vio_tpu_torch import testing
    from vio_tpu_torch.ops import linsolve
    from vio_tpu_torch.solver import lm

    gt, _ = testing.make_global_problem(**GLOBAL_DIST, device="cpu", dtype=torch.float64)
    runs = {"1 rank nccl": run_ranks(1, "nccl", ["cuda:0"], ("global",)),
            "2 ranks gloo": run_ranks(2, "gloo", ["cuda:0", "cuda:0"], ("global", "window"))}
    if torch.cuda.device_count() >= 2:
        runs["2 ranks nccl"] = run_ranks(2, "nccl", ["cuda:0", "cuda:1"], ("global",))
    else:
        print(f"solve_sharded 2 ranks nccl on two cards: not run, "
              f"{torch.cuda.device_count()} card {tag}")
    launches = {}
    for dtype in (torch.float64, torch.float32):
        one = runs["1 rank nccl"][0][dtype]
        for name, ranks in runs.items():
            g = [r[dtype] for r in ranks]
            for r in g[1:]:
                if not np.array_equal(r["Ps"], g[0]["Ps"]) or r["iterations"] != g[0]["iterations"]:
                    raise AssertionError(f"solve_sharded {name}: the ranks' poses differ")
            dP = float(np.abs(g[0]["Ps"] - one["Ps"]).max())
            dchi = abs(g[0]["chi2"] - one["chi2"]) / one["chi2"]
            err = float(np.linalg.norm(g[0]["Ps"] - gt.Ps.numpy(), axis=1).max())
            label = f"solve_sharded {name} {str(dtype)[6:]}"
            launches[label] = sum(r["launches"] for r in g)
            print(f"{label}: {g[0]['iterations']} iterations, chi2 {g[0]['chi2']:.9e} of "
                  f"{g[0]['chi2_0']:.6e}, against 1 rank: |dchi2|/chi2 {dchi:.3e}, max |dP| "
                  f"{dP:.3e} m; max pose error {err:.3e} m, wall {max(r['wall'] for r in g):.3f} s, "
                  f"{g[0]['allreduces']} all_reduces of {g[0]['bytes']} bytes, gj_solve launches "
                  f"{[r['launches'] for r in g]} {tag}")
            if dtype == torch.float64 and not (dP <= 1e-8 and dchi <= 1e-9):
                raise AssertionError(f"{label}: not the 1-rank solution")
            if not (g[0]["chi2"] < g[0]["chi2_0"] and all(r["launches"] > 0 for r in g)):
                raise AssertionError(f"{label}: no descent or no launch")

    # phase 14: the window solve split over the features of 2 ranks
    states, f, _ = testing.make_window_problem(window_size=10, max_features=256,
                                               imu_per_interval=8)
    linsolve.gj_solve.launches = 0
    ref, _, _, st = lm.solve_window(states, f, max_iter=10)
    torch.cuda.synchronize()
    w = [r["window"] for r in runs["2 ranks gloo"]]
    if not np.array_equal(w[0]["Ps"], w[1]["Ps"]):
        raise AssertionError("solve_window_sharded: the ranks' poses differ")
    dP = float(np.abs(w[0]["Ps"] - ref.Ps.double().cpu().numpy()).max())
    launches["solve_window_sharded 2 ranks gloo float32"] = sum(r["launches"] for r in w)
    print(f"solve_window_sharded 2 ranks gloo: P=171, {w[0]['iterations']} iterations "
          f"(solve_window {int(st['iterations'])}), chi2 {w[0]['chi2']:.6e} (solve_window "
          f"{float(st['chi2']):.6e}), max |dP| against solve_window {dP:.3e} m, wall "
          f"{max(r['wall'] for r in w):.3f} s, all_reduce of {w[0]['bytes']} bytes, gj_solve "
          f"launches {[r['launches'] for r in w]} (solve_window {linsolve.gj_solve.launches}) {tag}")
    if not (dP <= 1e-3 and all(r["launches"] > 0 for r in w)):
        raise AssertionError(f"solve_window_sharded: max |dP| {dP} m against solve_window")
    return launches


def bal_problem(C: int, M: int, per_point, seed: int, device, dtype):
    """A noise-free BAL problem on ``device`` and its perturbed start, built
    as tests/test_bal.py's noise-free case (points uniform in [-2, 2]³, f
    = 500, k1 = 1e-4, k2 = 1e-7; the first two cameras unperturbed, the
    others' rotations by 0.02 rad and centres by 0.05, points by 0.05),
    with numpy draws.  The cameras sit on a cap of radius 8 around the
    cloud, each looking at its centre, so every point is in front of every
    camera; ``per_point`` cameras, drawn at random, see each point (None:
    all of them).  Returns (gt, noisy) BalProblems."""
    from vio_tpu_torch.device import move
    from vio_tpu_torch.solver import bal
    from vio_tpu_torch.utils import lie

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2.0, 2.0, (M, 3))
    polar = 0.6 * np.sqrt(rng.uniform(0.0, 1.0, C))
    azim = rng.uniform(0.0, 2.0 * np.pi, C)
    z = np.stack([np.sin(polar) * np.cos(azim), np.sin(polar) * np.sin(azim),
                  np.cos(polar)], axis=1)                     # centre direction
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=1)              # rows: camera axes
    t = -np.einsum("cij,cj->ci", R, 8.0 * z)                  # P = R X + t, P_z < 0
    if per_point is None:
        cam_idx, pt_idx = np.repeat(np.arange(C), M), np.tile(np.arange(M), C)
    else:
        cam_idx = np.stack([rng.choice(C, per_point, replace=False) for _ in range(M)]).reshape(-1)
        pt_idx = np.repeat(np.arange(M), per_point)
    host = dict(dtype=torch.float64)
    q = lie.mat_to_quat(torch.as_tensor(R, **host))
    fkk = torch.tensor([[500.0, 1e-4, 1e-7]], **host).repeat(C, 1)
    ci, pi = torch.as_tensor(cam_idx), torch.as_tensor(pt_idx)
    P = torch.as_tensor(pts, **host)
    tt = torch.as_tensor(t, **host)
    uv = bal.bal_residual(q[ci], tt[ci], fkk[ci], P[pi], torch.zeros((len(ci), 2), **host))
    gt = bal.BalProblem(cam_q=q, cam_t=tt, cam_fkk=fkk, points=P, cam_idx=ci, pt_idx=pi,
                        uv=uv, valid=torch.ones(len(ci), dtype=torch.bool))
    mask = torch.as_tensor((np.arange(C) >= 2)[:, None], **host)
    dth = torch.as_tensor(0.02 * rng.standard_normal((C, 3)), **host) * mask
    noisy = gt._replace(
        cam_q=lie.quat_normalize(lie.quat_mul(q, lie.so3_exp_quat(dth))),
        cam_t=tt + 0.05 * mask * torch.as_tensor(rng.standard_normal((C, 3)), **host),
        points=P + 0.05 * torch.as_tensor(rng.standard_normal((M, 3)), **host))
    return move(gt, device, dtype), move(noisy, device, dtype)


def bal_paths(device, tag: str) -> dict:
    """Phase 15.  Returns the launches by run."""
    from vio_tpu_torch.ops import _build, linsolve
    from vio_tpu_torch.solver import bal

    launches = {}
    for label, C, M, per_point in (("BAL 6 cameras 60 points", 6, 60, None),
                                   ("BAL Ladybug-49 size", BAL_LADYBUG["C"], BAL_LADYBUG["M"],
                                    BAL_LADYBUG["per_point"])):
        for dtype, chi_tol, pt_tol in ((torch.float32, 1e-6, 1e-3),
                                       (torch.float64, 1e-12, 1e-5)):
            gt, noisy = bal_problem(C, M, per_point, seed=C, device=device, dtype=dtype)
            P = 9 * C
            regime = ("registers" if _build.load().gj_solve_work_elems(P, gt.points.element_size())
                      == 0 else "blocked")
            linsolve.gj_solve.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, hist = bal.solve(noisy, max_iter=40, optimize_intrinsics=False, gauge_fix=2,
                                  dtype=dtype)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = linsolve.gj_solve.launches
            err = float(torch.linalg.norm(out.points - gt.points, dim=1).max())
            err0 = float(torch.linalg.norm(noisy.points - gt.points, dim=1).max())
            name = f"{label} {str(dtype)[6:]}"
            print(f"{name}: P={P} ({regime}), {len(gt.cam_idx)} observations, "
                  f"{len(hist) - 1} accepted steps, chi2 {hist[-1]:.6e} of {hist[0]:.6e}, "
                  f"max point error {err:.3e} (start {err0:.3e}), wall {wall:.3f} s, "
                  f"gj_solve launches {n} {tag}")
            if not (hist[-1] < chi_tol * hist[0] and err < pt_tol and n >= len(hist) - 1 > 0):
                raise AssertionError(f"{name}: chi2 {hist[-1]} of {hist[0]}, point error {err}, "
                                     f"{n} launches")
            launches[f"bal.solve {name}"] = n
    return launches


def _tex(x, y):
    """tests/test_direct_ba.py's plane texture."""
    return (128.0 + 45.0 * np.sin(5.5 * x + 3.0 * y) + 35.0 * np.cos(4.0 * x - 5.0 * y)
            + 30.0 * np.sin(9.5 * x + 0.3) + 25.0 * np.cos(8.5 * y + 0.9))


def direct_scene():
    """tests/test_direct_ba.py's scene (4 cameras over the plane z = 6,
    40 points, 240 x 320 images) and its perturbation, on the CPU in
    float64: (gt, noisy) DirectBAProblems."""
    from vio_tpu_torch.features import direct
    from vio_tpu_torch.utils import lie

    FX = FY = 200.0
    CX, CY, H, W, Z0, C, M = 160.0, 120.0, 240, 320, 6.0, 4, 40
    rng = np.random.default_rng(0)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    dirs_c = np.stack([(u - CX) / FX, (v - CY) / FY, np.ones_like(u)], -1)
    cam_q, cam_t, imgs = [], [], []
    for ci in range(C):
        phi = 0.02 * ci * np.array([0.5, -1.0, 0.7])
        Rcw = lie.so3_exp_mat(torch.as_tensor(phi)).numpy()
        center = np.array([0.4 * ci, -0.25 * ci, 0.08 * ci])
        dirs_w = dirs_c @ Rcw
        s = (Z0 - center[2]) / dirs_w[..., 2]
        Xw = center[None, None, :] + s[..., None] * dirs_w
        imgs.append(_tex(Xw[..., 0], Xw[..., 1]))
        cam_q.append(lie.mat_to_quat(torch.as_tensor(Rcw)).numpy())
        cam_t.append(-Rcw @ center)
    pts = np.stack([rng.uniform(-2.5, 2.5, M), rng.uniform(-1.8, 1.8, M), np.full(M, Z0)], 1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    gt = direct.DirectBAProblem(
        images=t(np.stack(imgs)), K=(FX, FY, CX, CY), cam_q=t(np.stack(cam_q)),
        cam_t=t(np.stack(cam_t)), points=t(pts), ref_patch=torch.zeros((M, 16), dtype=torch.float64),
        cam_idx=torch.arange(C).repeat_interleave(M), pt_idx=torch.arange(M).repeat(C),
        valid=torch.ones(C * M, dtype=torch.bool))
    zero = torch.zeros(M, dtype=torch.int64)
    ref, inb = direct._photo_residual(gt.images, zero, gt.K, gt.cam_q[zero], gt.cam_t[zero],
                                      gt.points, gt.ref_patch)
    if not bool(inb.all()):
        raise AssertionError("direct scene: a point is out of frame 0")
    gt = gt._replace(ref_patch=ref)
    rng = np.random.default_rng(1)
    mask = (np.arange(C) >= 2).astype(np.float64)[:, None]
    dth = t(0.008 * rng.standard_normal((C, 3)) * mask)
    noisy = gt._replace(
        cam_q=lie.quat_normalize(lie.quat_mul(gt.cam_q, lie.so3_exp_quat(dth))),
        cam_t=gt.cam_t + t(0.03 * rng.standard_normal((C, 3)) * mask),
        points=gt.points + t(0.03 * rng.standard_normal((M, 3))))
    return gt, noisy


def direct_paths(device, tag: str) -> int:
    """Phase 16.  Returns the launches of the card's direct BA."""
    from vio_tpu_torch import sim
    from vio_tpu_torch.features import direct
    from vio_tpu_torch.ops import linsolve

    gt, noisy = direct_scene()
    C, M = gt.cam_q.shape[0], gt.points.shape[0]
    chi_gt = float(direct._direct_assemble(gt, C, M, 2, 40.0).chi2)
    out = {}
    for side, kw in (("card float32", dict(device=device)), ("CPU float64", dict(device="cpu"))):
        linsolve.gj_solve.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, hist = direct.direct_ba(noisy, max_iter=30, gauge_fix=2, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cam0 = np.linalg.norm((noisy.cam_t - gt.cam_t).numpy(), axis=1)[2:].max()
        cam1 = np.linalg.norm(o.cam_t.double().cpu().numpy() - gt.cam_t.numpy(), axis=1)[2:].max()
        pt0 = np.median(np.linalg.norm((noisy.points - gt.points).numpy(), axis=1))
        pt1 = np.median(np.linalg.norm(o.points.double().cpu().numpy() - gt.points.numpy(), axis=1))
        out[side] = dict(o=o, launches=linsolve.gj_solve.launches)
        print(f"direct BA {side}: P={6 * C}, {len(hist) - 1} accepted steps, chi2 {hist[-1]:.6e} "
              f"of {hist[0]:.6e} (floor {chi_gt:.6e}), camera error {cam1:.3e} m from {cam0:.3e}, "
              f"median point error {pt1:.3e} from {pt0:.3e}, wall {wall:.3f} s, gj_solve "
              f"launches {linsolve.gj_solve.launches} {tag}")
        if not (hist[-1] < max(1.5 * chi_gt, 1e-3 * hist[0]) and cam1 < 0.3 * cam0
                and pt1 < 0.3 * pt0):
            raise AssertionError(f"direct BA {side}: tests/test_direct_ba.py's bounds missed")
    card, cpu = out["card float32"]["o"], out["CPU float64"]["o"]
    d = float((card.points.double().cpu() - cpu.points).abs().max())
    print(f"direct BA card against CPU: max |dX| {d:.3e} m {tag}")
    if card.points.device.type != "cuda" or not out["card float32"]["launches"] > 0:
        raise AssertionError("direct BA did not run on the card through the kernel")

    data = sim.generate(noise=False)
    img0, img1 = (sim.render_image(data, k) for k in (0, 1))
    lids = np.where(data.obs_valid[0] & data.obs_valid[1])[0]
    uv0 = data.obs_uv[0][lids]
    depth0 = np.einsum("ji,lj->li", data.cam_R[0], data.landmarks[lids] - data.cam_p[0])[:, 2]
    R_gt = data.cam_R[1].T @ data.cam_R[0]
    t_gt = data.cam_R[1].T @ (data.cam_p[0] - data.cam_p[1])
    est = {}
    for side, kw in (("card float32", dict(device=device)), ("CPU float64", dict(device="cpu"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R, t = direct.direct_pose_estimation(img0, img1, uv0, depth0,
                                             (460.0, 460.0, 255.0, 255.0), **kw)
        R, t = R.double().cpu().numpy(), t.double().cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
        ang = np.degrees(np.arccos(np.clip((np.trace(R_gt.T @ R) - 1) / 2, -1, 1)))
        est[side] = t
        print(f"direct_pose_estimation {side}: {len(lids)} points, rotation error {ang:.4f} deg, "
              f"|t - t_gt| {np.linalg.norm(t - t_gt):.3e}, {ms:.1f} ms {tag}")
        if not (ang < 0.5 and np.linalg.norm(t - t_gt) < 0.05):
            raise AssertionError(f"direct_pose_estimation {side}: bounds missed")
    print(f"direct_pose_estimation card against CPU: max |dt| "
          f"{np.abs(est['card float32'] - est['CPU float64']).max():.3e} {tag}")
    return out["card float32"]["launches"]


def online_td_path(tag: str) -> int:
    """Phase 17.  tests/test_td.py::_run_online_td's stream: the camera
    clock lags the IMU clock by TD_TRUE, the features carry their
    finite-difference velocities, and the estimator refines td from 0 on
    the default device in its type (the card, float32).  Returns the
    launches."""
    from vio_tpu_torch import metrics, runner, sim
    from vio_tpu_torch.config import sim_config
    from vio_tpu_torch.estimator import Estimator
    from vio_tpu_torch.ops import linsolve

    data = sim.generate(noise=False)
    lagged_t = data.cam_t - TD_TRUE
    est = Estimator(sim_config(td=0.0, estimate_td=True))
    ts, ps, imu_i = [], [], 0
    t_prev = lagged_t[0] + est.td
    linsolve.gj_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(N_TD_FRAMES):
        t = lagged_t[k] + est.td          # the live offset, as the drivers read it
        if k:
            imu_i = runner.feed_interval(est, data.imu_t, data.acc, data.gyr, t_prev, t, imu_i)
        t_prev = t
        dt = data.cam_t[k] - data.cam_t[k - 1] if k else 1.0
        feats = {}
        for lid in np.where(data.obs_valid[k])[0]:
            xy = data.obs_xy[k, lid]
            vel = ((xy - data.obs_xy[k - 1, lid]) / dt
                   if k and data.obs_valid[k - 1, lid] else np.zeros(2))
            feats[int(lid)] = (np.array([xy[0], xy[1], 1.0]), data.obs_uv[k, lid], vel)
        est.process_image(feats, t)
        if est.initialized:
            tt, p, _ = est.latest_pose()
            ts.append(tt)
            ps.append(p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = linsolve.gj_solve.launches
    if not (est.initialized and est.failure_count == 0):
        raise AssertionError(f"online td: initialized {est.initialized}, "
                             f"failure_count {est.failure_count}")
    ps = np.asarray(ps)
    gt_p, _ = runner.sim_ground_truth_at(data, np.asarray(ts) + (TD_TRUE - est.td))
    ape = metrics.ape_rmse(ps, gt_p)["rmse"]
    print(f"online td: {N_TD_FRAMES} frames, {len(ts)} poses, td {est.td * 1e3:.4f} ms "
          f"(true {TD_TRUE * 1e3:.1f} ms, bounds 2 < td < {1.2 * TD_TRUE * 1e3:.1f} ms), "
          f"APE rmse {ape:.6f} m (bound 0.15 m), {str(est.dtype)[6:]} {tag}")
    print(f"online td wall {N_TD_FRAMES / wall:.3f} frames/s ({wall:.2f} s), "
          f"gj_solve launches {launches} {tag}")
    if not (2e-3 < est.td < 1.2 * TD_TRUE and np.all(np.isfinite(ps)) and ape < 0.15):
        raise AssertionError(f"online td: td {est.td}, APE {ape}: tests/test_td.py's bounds missed")
    if not (est.device.type == "cuda" and est.dtype == torch.float32 and launches > 0):
        raise AssertionError(f"online td: {est.device}, {est.dtype}, {launches} launches")
    return launches


def euroc_layout_path(tag: str, sync: dict) -> tuple[int, dict]:
    """Phase 18.  ``sync`` is phase 7's result.  Returns the Gauss-Jordan
    kernel's launches of ``run_euroc`` and the RANSAC kernel's by path."""
    import dataclasses
    import tempfile

    from vio_tpu_torch import io as vio_io
    from vio_tpu_torch import metrics, runner, sim
    from vio_tpu_torch.cli import nearest_stamp
    from vio_tpu_torch.config import sim_images_config
    from vio_tpu_torch.ops import linsolve
    from vio_tpu_torch.solver import graph

    cfg = sim_images_config()
    data = sim.generate(noise=False)
    with tempfile.TemporaryDirectory(prefix="vio_euroc_") as seq:
        t0 = time.perf_counter()
        vio_io.write_euroc(data, seq, n_frames=N_EUROC_FRAMES)
        write_s = time.perf_counter() - t0
        back = vio_io.load_euroc(seq)
        if not (np.array_equal(back.acc, data.acc) and np.array_equal(back.gyr, data.gyr)
                and len(back.cam_t) == N_EUROC_FRAMES
                and np.abs(back.imu_t - data.imu_t).max() <= 1e-9
                and np.abs(back.cam_t - data.cam_t[:N_EUROC_FRAMES]).max() <= 1e-9):
            raise AssertionError("EuRoC layout: load_euroc does not return phase 7's IMU "
                                 "and stamps")
        trk = runner.make_tracker(cfg)
        reads = BusyLog()
        trk.read_image = reads.wrap(trk.read_image)
        linsolve.gj_solve.launches = 0
        by_path = {}
        before = dict(graph.STATS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ransac_counted(by_path, "run_euroc float64"):
            est, traj, _ = runner.run_euroc(seq, cfg, tracker=trk, dtype=torch.float64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = linsolve.gj_solve.launches
        rates, d = graph_rates(before, len(reads.spans), len(est.telemetry))
    # the same rendered frames at the layout's nanosecond stamps, over the
    # first N_TWIN_FRAMES (the estimator is causal)
    rounded = dataclasses.replace(data, imu_t=back.imu_t, cam_t=np.concatenate(
        [back.cam_t, data.cam_t[N_EUROC_FRAMES:]]))
    _, twin = runner.run_images(runner.sim_image_frames(rounded, n_frames=N_TWIN_FRAMES),
                                rounded.imu_t, rounded.acc, rounded.gyr, cfg,
                                tracker=runner.make_tracker(cfg), dtype=torch.float64)
    if not (est.initialized and est.failure_count == 0 and len(traj["t"]) > 0):
        raise AssertionError(f"run_euroc: initialized {est.initialized}, "
                             f"failure_count {est.failure_count}")
    n_twin = len(twin["t"])
    dp_twin = (np.abs(traj["p"][:n_twin] - twin["p"]).max(initial=0.0)
               if np.array_equal(traj["t"][:n_twin], twin["t"])
               and np.array_equal(traj["initialized"][:len(twin["initialized"])],
                                  twin["initialized"]) and n_twin > 0 else np.inf)
    ape = metrics.ape_rmse(traj["p"], back.gt_p[nearest_stamp(back.gt_t, traj["t"])])["rmse"]
    want = sync["traj"]
    n_pub = len(traj["initialized"])
    i, j = np.nonzero(np.abs(traj["t"][:, None] - want["t"][None, :]) < 1e-6)
    dp7 = np.abs(traj["p"][i] - want["p"][j]).max(initial=0.0)
    first = (int(np.argmax(traj["initialized"])), int(np.argmax(want["initialized"])))
    print(f"EuRoC layout: wrote {N_EUROC_FRAMES} frames in {write_s:.2f} s; run_euroc "
          f"{n_pub} published, {len(traj['t'])} poses, APE rmse {ape:.6f} m against the "
          f"written ground truth (bound {EUROC_APE} m) {tag}")
    print(f"EuRoC layout: against run_images over the first {N_TWIN_FRAMES} frames at the "
          f"layout's stamps ({n_twin} poses) max |dp| {dp_twin:.3e} m (bound "
          f"{EUROC_TWIN_DP} m); against phase 7 "
          f"(stamps not rounded): first pose at published frame {first[0]} and {first[1]}, "
          f"{len(i)} poses at equal stamps, max |dp| {dp7:.3e} m {tag}")
    print(f"EuRoC layout wall {N_EUROC_FRAMES / wall:.3f} frames/s ({wall:.2f} s, loading "
          f"included), gj_solve launches {launches}, essential_ransac launches "
          f"{by_path['run_euroc float64']} {tag}")
    print(f"EuRoC layout graphs: {rates} {tag}")
    hold_tracker_graphs("run_euroc", d, len(reads.spans))
    if not dp_twin <= EUROC_TWIN_DP:
        raise AssertionError(f"run_euroc: max |dp| {dp_twin} m from run_images at its stamps")
    if not ape < EUROC_APE:
        raise AssertionError(f"run_euroc: APE {ape} m >= {EUROC_APE} m")
    if not (est.device.type == "cuda" and est.dtype == torch.float64 and launches > 0):
        raise AssertionError(f"run_euroc: {est.device}, {est.dtype}, {launches} launches")
    return launches, by_path


def _stereo_pair(seed=0, n=40):
    """tests/test_stereo.py::_make_stereo_pair: blobs spread over distinct
    rows, shifted left by fx·b/Z in the right image."""
    from vio_tpu_torch import sim
    rng = np.random.default_rng(seed)
    uv_l = np.stack([rng.uniform(80, 580, n),
                     np.linspace(40, 600, n) + rng.uniform(-3, 3, n)], axis=1)
    Z = rng.uniform(2.0, 12.0, n)
    disp_gt = STEREO_FX * STEREO_BASELINE / Z
    uv_r = uv_l.copy()
    uv_r[:, 0] -= disp_gt
    return sim.render_blobs(uv_l), sim.render_blobs(uv_r), uv_l, disp_gt


def _chessboard_views(V=10, seed=3):
    """tests/test_intrinsics.py::synth_views: V views of a 9×6 board of
    3 cm squares through CHESS_TRUE's radtan camera."""
    from vio_tpu_torch.utils import lie
    T = CHESS_TRUE
    rng = np.random.default_rng(seed)
    bx, by = np.meshgrid(np.arange(9) * 0.03, np.arange(6) * 0.03)
    board = np.stack([bx.ravel(), by.ravel()], axis=1)
    p3 = np.concatenate([board, np.zeros((len(board), 1))], axis=1)
    views = []
    for _ in range(V):
        w = rng.normal(0, 0.25, 3)
        R = lie.so3_exp_mat(torch.as_tensor(w)).numpy()
        t = np.array([-0.12 + 0.02 * rng.normal(), -0.08 + 0.02 * rng.normal(),
                      0.55 + 0.1 * rng.random()])
        pc = p3 @ R.T + t
        xn, yn = pc[:, 0] / pc[:, 2], pc[:, 1] / pc[:, 2]
        r2 = xn * xn + yn * yn
        rad = 1 + T["k1"] * r2 + T["k2"] * r2 * r2
        xd = xn * rad + 2 * T["p1"] * xn * yn + T["p2"] * (r2 + 2 * xn * xn)
        yd = yn * rad + T["p1"] * (r2 + 2 * yn * yn) + 2 * T["p2"] * xn * yn
        views.append(np.stack([T["fx"] * xd + T["cx"], T["fy"] * yd + T["cy"]], axis=1))
    return board, np.stack(views)


def _checker_board_image():
    """tests/test_intrinsics.py's rendered, perspective-warped chessboard
    (320×240) with its inner corners, and seeded starts within 0.7 px."""
    sq = 24.0
    Hm = np.array([[1.05, 0.08, 40.0], [-0.05, 0.98, 30.0], [1e-4, -8e-5, 1.0]])
    Hi = np.linalg.inv(Hm)
    u, v = np.meshgrid(np.arange(320, dtype=np.float64), np.arange(240, dtype=np.float64))
    den = Hi[2, 0] * u + Hi[2, 1] * v + Hi[2, 2]
    X = (Hi[0, 0] * u + Hi[0, 1] * v + Hi[0, 2]) / den
    Y = (Hi[1, 0] * u + Hi[1, 1] * v + Hi[1, 2]) / den
    img = 128 + 100 * np.tanh(6.0 * np.sin(np.pi * X / sq)) * np.tanh(6.0 * np.sin(np.pi * Y / sq))
    pts = []
    for i in range(1, 10):
        for j in range(1, 7):
            p = Hm @ np.array([i * sq, j * sq, 1.0])
            p = p[:2] / p[2]
            if 15 < p[0] < 320 - 15 and 15 < p[1] < 240 - 15:
                pts.append(p)
    pts = np.asarray(pts)
    start = pts + np.random.default_rng(0).uniform(-0.7, 0.7, pts.shape)
    return img.astype(np.float32), pts, start


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _prior_invariants(o) -> dict:
    """What two eigensolvers agree on in a prior (H, b, err, Jt_inv):
    H·JtᵀJt·H, H·Jtᵀerr, and errᵀerr = bᵀ·pinv(H)·b over the directions
    whose eigenvalue lies above MARG_GAP.  Row i of Jt_inv is v_i/√λ_i
    for each eigenvalue λ_i kept above the 1e-8 cut (zero otherwise) and
    err_i = -v_i·b/√λ_i, so the rows give the kept spectrum and each
    direction's share of errᵀerr.  The Schur step leaves round-off of
    machine epsilon times the eliminated block's largest eigenvalue in the
    prior (7.2e13 · 2.2e-16 ≈ 1.6e-2 in make_window_problem(10, 256, 8)),
    far above the cut, so which round-off eigenvalues are kept, and
    their values, are the eigensolver's own."""
    H, b, e, J = o
    n2 = (J * J).sum(axis=1)
    lam = np.where(n2 > 0, 1.0 / np.where(n2 > 0, n2, 1.0), 0.0)
    common = lam > MARG_GAP
    return dict(H=H, b=b, HJJH=H @ J.T @ J @ H, HJe=H @ (J.T @ e), ee=e @ e,
                ee_common=e[common] @ e[common], kept=int((n2 > 0).sum()),
                common=int(common.sum()), near=np.sort(lam[(n2 > 0) & ~common]))


def device_functions_on_card(tag: str) -> None:
    """Phase 19.  Each function on the card (float32 unless stated)
    against the same function on the CPU in float64, at a stated
    tolerance, and at its reference test's bounds."""
    from vio_tpu_torch import testing
    from vio_tpu_torch.calib import intrinsics
    from vio_tpu_torch.features import stereo
    from vio_tpu_torch.init import icp
    from vio_tpu_torch.solver import marginalize as marg
    from vio_tpu_torch.utils import lie

    dev = torch.device("cuda")
    f32 = dict(dtype=torch.float32, device=dev)
    f64 = dict(dtype=torch.float64)

    # stereo: images float32 on both sides, positions float32 / float64
    left, right, uv_l, disp_gt = _stereo_pair()
    valid = torch.ones(len(uv_l), dtype=torch.bool)
    out = {}
    for side, kw in (("card", f32), ("CPU", f64)):
        t0 = time.perf_counter()
        d, ok = stereo.disparity_from_flow(
            torch.as_tensor(left, dtype=torch.float32, device=kw.get("device")),
            torch.as_tensor(right, dtype=torch.float32, device=kw.get("device")),
            torch.as_tensor(uv_l, **kw), valid.to(kw.get("device", "cpu")))
        d, ok = d.double().cpu().numpy(), ok.cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
        err = np.abs(d[ok] - disp_gt[ok])
        r = float(stereo.pearson(torch.as_tensor(d[ok]), torch.as_tensor(disp_gt[ok])))
        out[side] = (d, ok)
        print(f"stereo.disparity_from_flow {side}: {int(ok.sum())} of {len(ok)} ok, median "
              f"error {np.median(err):.4f} px, Pearson {r:.6f}, {ms:.1f} ms {tag}")
        if not (ok.sum() >= 0.8 * len(ok) and np.median(err) < 0.1 and r > 0.99):
            raise AssertionError(f"stereo {side}: tests/test_stereo.py's bounds missed")
    (dc, okc), (dh, okh) = out["card"], out["CPU"]
    both = okc & okh
    dd = float(np.abs(dc[both] - dh[both]).max())
    print(f"stereo card against CPU: {int((okc != okh).sum())} ok on one side only, max "
          f"|d disp| {dd:.3e} px (bounds {STEREO_FLIPS}, {STEREO_TOL} px) {tag}")
    if int((okc != okh).sum()) > STEREO_FLIPS or not dd <= STEREO_TOL:
        raise AssertionError("stereo: the card disagrees with the CPU")

    # Umeyama and Gauss-Newton ICP: tests/test_components.py's cases
    rng = np.random.default_rng(1)
    src = rng.standard_normal((100, 3)) * 2.0
    R_gt = lie.so3_exp_mat(torch.tensor([0.1, 0.3, -0.2], **f64)).numpy()
    t_gt = np.array([0.5, 0.2, -0.7])
    dst = src @ R_gt.T + t_gt + 0.01 * rng.standard_normal((100, 3))
    R0 = lie.so3_exp_mat(torch.tensor([0.05, 0.0, 0.0], **f64)).numpy() @ R_gt
    res = {}
    for side, kw in (("card", f32), ("CPU", f64)):
        a = [torch.as_tensor(x, **kw) for x in (src, dst, R0, t_gt + 0.1)]
        Ru, tu = icp.umeyama(a[0], a[1])
        Rg, tg, rms = icp.icp_gn(*a)
        res[side] = [x.double().cpu().numpy() for x in (Ru, tu, Rg, tg)] + [float(rms)]
    du = max(np.abs(c - h).max() for c, h in zip(res["card"][:2], res["CPU"][:2]))
    dg = max(np.abs(c - h).max() for c, h in zip(res["card"][2:4], res["CPU"][2:4]))
    Rg, tg, rms = res["card"][2:]
    ang = np.degrees(np.arccos(np.clip((np.trace(R_gt.T @ Rg) - 1) / 2, -1, 1)))
    print(f"icp card against CPU: umeyama max |d(R, t)| {du:.3e}, icp_gn {dg:.3e} (bound "
          f"{ICP_TOL}); icp_gn on the card: {ang:.4f} deg, |t - t_gt| "
          f"{np.linalg.norm(tg - t_gt):.4f} m, RMS {rms:.4f} m {tag}")
    if not (du <= ICP_TOL and dg <= ICP_TOL and ang < 0.5
            and np.linalg.norm(tg - t_gt) < 0.02 and rms < 0.03):
        raise AssertionError("icp: the card disagrees with the CPU or misses the bounds")

    # sub-pixel saddle refinement: float32 on both sides
    img, pts, start = _checker_board_image()
    ref_c = intrinsics.refine_corners_subpix(img, start, half=4, n_iter=4, device=dev)
    ref_h = intrinsics.refine_corners_subpix(img, start, half=4, n_iter=4, device="cpu")
    ref_c = ref_c.cpu().double().numpy()
    d = float(np.abs(ref_c - ref_h.double().numpy()).max())
    err = np.linalg.norm(ref_c - pts, axis=1)
    print(f"refine_corners_subpix card against CPU: {len(pts)} corners, max |dp| {d:.3e} px "
          f"(bound 1e-3); on the card mean error {err.mean():.4f} px, 90th pct "
          f"{np.percentile(err, 90):.4f} px {tag}")
    if not (d <= 1e-3 and err.mean() < 0.05 and np.percentile(err, 90) < 0.08):
        raise AssertionError("refine_corners_subpix: the card disagrees or misses the bounds")

    # marginalization: the device chain in float64 on the card against the
    # host float64 chain on the CPU (P = 171)
    shape = dict(window_size=10, max_features=256, imu_per_interval=8, perturb=0.0)
    s64, f64w, _ = testing.make_window_problem(**shape, device=dev, dtype=torch.float64)
    host = marg.marginalize_old_host(s64, f64w)
    card = [x.cpu().numpy() for x in marg.marginalize_old(s64, f64w)]
    fnew = f64w._replace(H_prior=torch.as_tensor(host[0], device=dev),
                         b_prior=torch.as_tensor(host[1], device=dev))
    card_new = [x.cpu().numpy() for x in marg.marginalize_new(fnew)]
    host_new = marg.marginalize_new_host(host[0], host[1])

    for name, c, h in (("marginalize_old", card, host), ("marginalize_new", card_new, host_new)):
        ci, hi = _prior_invariants(c), _prior_invariants(h)
        rel = {k: _rel(ci[k], hi[k]) for k in ("H", "b", "HJJH", "HJe", "ee", "ee_common")}
        print(f"{name} float64 card against the host chain: " +
              ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) +
              f" (bounds {MARG_RTOL}, errᵀerr over the directions both keep {MARG_EE_RTOL}, "
              f"errᵀerr over all kept printed) {tag}")
        for side, i in (("card", ci), ("host", hi)):
            print(f"{name} {side}: keeps {i['kept']} eigenvalues above the {marg.EPS} cut, "
                  f"{i['common']} above {MARG_GAP}; kept below {MARG_GAP}: "
                  f"{np.array2string(i['near'], precision=4)}, their errᵀerr "
                  f"{i['ee'] - i['ee_common']:.4e} of {i['ee']:.4e} {tag}")
        if not (max(rel[k] for k in ("H", "b", "HJJH", "HJe")) <= MARG_RTOL
                and ci["common"] == hi["common"] and rel["ee_common"] <= MARG_EE_RTOL):
            raise AssertionError(f"{name}: the card's float64 chain disagrees with the host's")
    s32, f32w, _ = testing.make_window_problem(**shape, device=dev, dtype=torch.float32)
    c32 = [x.double().cpu().numpy() for x in marg.marginalize_old(s32, f32w)]
    if not all(np.all(np.isfinite(x)) for x in c32):
        raise AssertionError("marginalize_old float32: not finite")
    print(f"marginalize_old float32 on the card against the host float64 chain: H_prior "
          f"{_rel(c32[0], host[0]):.3e}, b_prior {_rel(c32[1], host[1]):.3e} relative "
          f"(not a prior: the float32 chain inverts round-off eigenvalues, as vio_tpu's "
          f"float32 chain does; the estimator runs the host chain) {tag}")

    # chessboard calibration on the card (float32 residuals, host LM)
    board, views = _chessboard_views()
    for name, pts2 in (("exact", views),
                       ("noisy 0.2 px", views + np.random.default_rng(11).normal(
                           0, 0.2, views.shape))):
        t0 = time.perf_counter()
        o = intrinsics.calibrate_chessboard(board, pts2)
        ms = 1e3 * (time.perf_counter() - t0)
        errs = {k: o[k] - CHESS_TRUE[k] for k in CHESS_TRUE}
        print(f"calibrate_chessboard {name} on the card: " +
              ", ".join(f"{k} {v:+.3e}" for k, v in errs.items()) +
              f", RMS {o['reproj_rms_px']:.3e} px, {ms:.0f} ms {tag}")
        if name == "exact":
            ok = all(abs(errs[k]) < tol for k, tol in CHESS_EXACT) and o["reproj_rms_px"] < 1e-4
        else:
            ok = (abs(errs["fx"]) / CHESS_TRUE["fx"] < 0.01 and abs(errs["fy"]) / CHESS_TRUE["fy"] < 0.01
                  and abs(errs["cx"]) < 3.0 and abs(errs["cy"]) < 3.0 and abs(errs["k1"]) < 0.02
                  and 0.1 < o["reproj_rms_px"] < 0.35)
        if not ok:
            raise AssertionError(f"calibrate_chessboard {name}: tests/test_intrinsics.py's "
                                 "bounds missed")


def cli_on_card(tag: str, preint: dict, factor: dict) -> tuple[dict, dict]:
    """Phase 20.  ``python -m vio_tpu_torch.cli`` as three processes at
    once: ``run --dataset sim``, ``run --dataset hybrid`` on streams
    written here, and ``sim --out``.  Returns the launches of each run,
    read from its JSON line: the Gauss-Jordan kernel's and the RANSAC
    kernel's; the preintegration kernel's go into ``preint`` and the IMU
    factor kernel's into ``factor``."""
    import os
    import tempfile

    from vio_tpu_torch import io as vio_io
    from vio_tpu_torch import sim, testing

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory(prefix="vio_cli_") as tmp:
        testing.write_hybrid_streams(sim.generate(noise=False), tmp, static_s=HYBRID_STATIC_S)
        cmds = {
            "run sim": ["run", "--dataset", "sim", "--frames", str(CLI_SIM_FRAMES)],
            "run hybrid": ["run", "--dataset", "hybrid", "--path", tmp,
                           "--frames", str(CLI_HYBRID_FRAMES)],
            "sim --out": ["sim", "--out", os.path.join(tmp, "csv")],
        }
        logs = {k: (open(os.path.join(tmp, f"{i}.out"), "w+"),
                    open(os.path.join(tmp, f"{i}.err"), "w+")) for i, k in enumerate(cmds)}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen([sys.executable, "-m", "vio_tpu_torch.cli"] + v,
                                     cwd=root, env=env, stdout=logs[k][0], stderr=logs[k][1],
                                     text=True)
                 for k, v in cmds.items()}
        outs, walls = {}, {}
        try:
            while len(walls) < len(procs):          # each one's own end
                for k, p in procs.items():
                    if k not in walls and p.poll() is not None:
                        walls[k] = time.perf_counter() - t0
                if time.perf_counter() - t0 > CLI_TIMEOUT_S:
                    raise AssertionError(f"cli: still running after {CLI_TIMEOUT_S} s")
                time.sleep(0.05)
            for k, p in procs.items():
                out, err = (f.seek(0) or f.read() for f in logs[k])
                if p.returncode != 0:
                    raise AssertionError(f"cli {k}: exit {p.returncode}\n{err[-2000:]}")
                outs[k] = out.strip().splitlines()
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in (f for pair in logs.values() for f in pair):
                f.close()
        ids, frames = vio_io.read_sim_keyframes(os.path.join(tmp, "csv"))
    launches, ransac = {}, {}
    for k in ("run sim", "run hybrid"):
        r = json.loads(outs[k][-1])
        start = walls[k] - r["wall_s"]
        print(f"cli {k}: {json.dumps(r)} {tag}")
        print(f"cli {k}: process {walls[k]:.1f} s, of which outside the run (start, "
              f"data, exit; three processes at once) {start:.1f} s {tag}")
        want = "float32" if k == "run sim" else "float64"
        if not (r["failures"] == 0 and r["device"].startswith("cuda") and r["dtype"] == want
                and r["frames"] > 0 and r["gj_solve_launches"] > 0
                and r["ape"]["rmse"] < CLI_APE):
            raise AssertionError(f"cli {k}: {r} (bounds: poses, launches, APE < {CLI_APE} m)")
        launches[f"cli {k} {want}"] = r["gj_solve_launches"]
        ransac[f"cli {k} {want}"] = r["essential_ransac_launches"]
        preint[f"cli {k} {want}"] = r["preintegrate_launches"]
        factor[f"cli {k} {want}"] = r["imu_factor_launches"]
        g, n = r["graphs"], max(r["frames"], 1)
        print(f"cli {k} graphs per pose: tracker {g['program_replays'] / n:.2f} replays, "
              f"{g['program_reads'] / n:.2f} reads; estimator {g['replays'] / n:.2f} "
              f"replays, {g['reads'] / n:.2f} reads ({g['keys']} keys) {tag}")
    print(f"cli sim --out: {len(frames)} keyframe files, {len(ids)} landmarks, process "
          f"{walls['sim --out']:.1f} s {tag}")
    if len(frames) != 600 or not ids:
        raise AssertionError("cli sim --out: not the simulator's 600 keyframes")
    return launches, ransac


class BenchProcess:
    """Phase 21: ``python -m vio_tpu_torch.cli bench`` as a process of its
    own at the default budget.  It is started beside phase 10, the longest
    phase, so that the script stays inside its time limit, and checked
    after phase 20; its times therefore share the host and the card with
    phase 10 and are not the bench's record (a run of its own is).  A
    process still running when the script exits is killed."""

    def __init__(self):
        import os
        import tempfile

        root = os.path.dirname(os.path.abspath(__file__))
        env = {k: v for k, v in os.environ.items()
               if k not in ("VIO_BENCH_FULL", "VIO_BENCH_BUDGET_S")}
        env["PYTHONPATH"] = root
        self.tmp = tempfile.mkdtemp(prefix="vio_bench_")
        self.details = os.path.join(self.tmp, "details.json")
        self.out = open(os.path.join(self.tmp, "out"), "w+")
        self.err = open(os.path.join(self.tmp, "err"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "vio_tpu_torch.cli", "bench",
                                      "--details", self.details], cwd=root, env=env,
                                     stdout=self.out, stderr=self.err, text=True)
        atexit.register(self.close)

    def close(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.err.close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self, tag: str, factor: dict) -> dict:
        """Wait for the process and hold its output.  Returns the launches
        of the stages that solve, read from its details; the IMU factor
        kernel's go into ``factor``."""
        left = BENCH_TIMEOUT_S - (time.perf_counter() - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"bench: still running after {BENCH_TIMEOUT_S} s") from None
        out, err = (f.seek(0) or f.read() for f in (self.out, self.err))
        if rc != 0:
            raise AssertionError(f"bench: exit {rc}\n{out[-2000:]}\n{err[-3000:]}")
        with open(self.details) as fh:
            d = json.load(fh)
        head = json.loads(out.splitlines()[0])
        print(f"bench headline: {json.dumps(head)} {tag}")
        print(f"bench details: {json.dumps(d)} {tag}")
        print(f"bench: ran beside phase 10, stages {d['total_wall_s']:.1f} s after a build "
              f"of {d['build_s']} s {tag}")
        if set(head) != {"metric", "value", "unit", "vs_baseline"} or \
                head["metric"] != "window_ba_solve_fps" or not head["value"] > 0:
            raise AssertionError(f"bench: the first line is not the headline: {head}")
        bad = {k: v for k, v in d.items()
               if isinstance(v, str) and v.startswith(("error", "skipped"))}
        if bad:
            raise AssertionError(f"bench: stages failed or skipped: {bad}")
        e2e = d.get("e2e_sim_120frames") or d.get("e2e_sim_60frames")   # the budget's choice
        if not (d["window_ba_lm_iterations"] == 10 and isinstance(e2e, dict)
                and e2e["initialized"] and d["device"].startswith("cuda")
                and d["dtype"] == "float32"):
            raise AssertionError("bench: not 10 LM iterations in float32 on the card, or the "
                                 "end-to-end run did not initialize")
        sums = (d["window_ba_device_ms_per_solve"], d["window_ba_device_ms_per_solve_key_averages"])
        if not abs(sums[0] - sums[1]) <= 0.01 * sums[0]:
            raise AssertionError(f"bench: the profiler's two device-time sums disagree: {sums}")
        by_stage = d["gj_solve_launches_by_stage"]
        if not all(by_stage.get(k, 0) > 0 for k in BENCH_KERNEL_STAGES):
            raise AssertionError(f"bench: gj_solve did not launch in {BENCH_KERNEL_STAGES}: "
                                 f"{by_stage}")
        ransac_by_stage = d["essential_ransac_launches_by_stage"]
        e2e_key = "e2e_sim_120frames" if "e2e_sim_120frames" in d else "e2e_sim_60frames"
        if not ransac_by_stage.get(e2e_key, 0) > 0:
            raise AssertionError(f"bench: the RANSAC kernel did not launch in the init of "
                                 f"{e2e_key}: {ransac_by_stage}")
        factor.update({f"bench {k} float32": n
                       for k, n in d["imu_factor_launches_by_stage"].items() if n})
        return ({f"bench {k} float32": n for k, n in by_stage.items() if n},
                {f"bench {k} float32": n for k, n in ransac_by_stage.items() if n})


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. environment ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    from vio_tpu_torch import metrics, runner, sim
    from vio_tpu_torch.config import sim_config, sim_images_config
    from vio_tpu_torch.ops import _build, linsolve
    from vio_tpu_torch.solver import frame_step, graph

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
    pairer_info = {}
    pairer_build = threading.Thread(
        target=lambda: pairer_info.update(_build.build_pairer()))
    pairer_build.start()           # g++ beside nvcc
    info = _build.build()
    pairer_build.join()
    if not pairer_info:
        raise RuntimeError("the measurement pairer did not build")
    lib = _build.load()
    _build.load_pairer()
    print(f"build: {'compiled' if info['built'] else 'up to date'} "
          f"{_build.LIB.name}, nvcc {info['seconds']:.2f} s; "
          f"{'compiled' if pairer_info['built'] else 'up to date'} "
          f"{_build.PAIRER_LIB.name}, g++ {pairer_info['seconds']:.2f} s")
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
    frames = []                    # phase 22's inputs, and the graphed outputs
    graphed = frame_step.frame_step_graphed

    def recording(*args, **kw):
        out = graphed(*args, **kw)
        frames.append((args, kw, out))
        return out

    frame_step.frame_step_graphed = recording
    graph.reset_stats()
    linsolve.gj_solve.launches = 0
    ransac_by_path = {}            # the RANSAC kernel's launches by path
    preint_by_path = {}            # the preintegration kernel's launches by path
    factor_by_path = {}            # the IMU factor kernel's launches by path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with ransac_counted(ransac_by_path, "run_sim float32"), \
                imu_kernels_counted(preint_by_path, factor_by_path, "run_sim float32"):
            est, traj = runner.run_sim(data, cfg, n_frames=N_FRAMES)
    finally:
        frame_step.frame_step_graphed = graphed
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = linsolve.gj_solve.launches
    gst = dict(graph.STATS)

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
    if not ransac_by_path["run_sim float32"] > 0:
        raise AssertionError("the init's RANSAC did not launch its kernel")
    print(f"main path: {N_FRAMES} frames, {len(traj['t'])} poses, "
          f"{len(est.telemetry)} window solves, {iters} LM iterations {tag}")
    print(f"main path APE rmse {ape:.6f} m {tag}")
    print(f"main path wall {N_FRAMES / wall:.3f} frames/s ({wall:.2f} s) {tag}")
    print(f"main path median solve_ms {statistics.median(solve_ms):.3f} {tag}")
    print(f"main path gj_solve launches {launches}, essential_ransac launches "
          f"{ransac_by_path['run_sim float32']} (the init's bootstrap) {tag}")
    n_solves = max(len(est.telemetry), 1)
    if not (len(frames) == len(est.telemetry) and gst.get("replays", 0) > 0):
        raise AssertionError(f"the estimator did not replay graphs: {gst}")
    # one solve an attempt (P=171 float32, the register regime): every
    # launch is a replayed attempt's
    if launches != gst["attempts"]:
        raise AssertionError(f"gj_solve launches {launches} are not the replayed "
                             f"attempts: {gst}")
    print(f"main path graphs: {gst.get('keys', 0)} keys, {gst.get('captures', 0)} graphs "
          f"captured in {gst.get('capture_s', 0.0):.2f} s (pools "
          f"{gst.get('pool_bytes', 0) / 2**20:.1f} MiB); per frame "
          f"{gst['replays'] / n_solves:.2f} replays, {gst['reads'] / n_solves:.2f} reads, "
          f"{gst['attempts'] / n_solves:.2f} attempts (K={graph.CHUNK}) {tag}")

    # ---- 22. graphs against eager: phase 5's frames through frame_step ----
    t_phase = time.perf_counter()
    worst, n_cmp = 0.0, 0
    for args, kw, out in frames[:N_GRAPH_FRAMES]:
        ref = frame_step.fetch(frame_step.frame_step(*args, **kw))
        if int(ref.iterations) != int(out.iterations):
            raise AssertionError(f"graph against eager: {out.iterations} iterations, "
                                 f"eager {int(ref.iterations)}")
        for name, a, b in zip(ref.states._fields, out.states, ref.states):
            a, b = np.asarray(a), np.asarray(b)
            d = float(np.abs(a - b).max())
            worst = max(worst, d)
            if not d <= GRAPH_ATOL + GRAPH_RTOL * float(np.abs(b).max()):
                raise AssertionError(f"graph against eager: {name} differs by {d:.3e}")
        n_cmp += 1
    if n_cmp < 5:
        raise AssertionError(f"graph against eager: only {n_cmp} post-init frames")
    print(f"graph against eager: {n_cmp} post-init frames, the same iterations, largest "
          f"|d state| {worst:.3e} (bound rtol {GRAPH_RTOL} of the leaf + atol {GRAPH_ATOL}) "
          f"{tag}")
    print(f"chip_smoke: phase 22 (graphs against eager) took "
          f"{time.perf_counter() - t_phase:.1f} s {tag}")

    # ---- 26. the preintegration kernel: in the graphs, against plain ----
    t_phase = time.perf_counter()
    preint_rec = preintegrate_on_card(frames, tag)
    print(f"chip_smoke: phase 26 (preintegration kernel) took "
          f"{time.perf_counter() - t_phase:.1f} s {tag}")

    # ---- 27. the IMU factor kernel: in the graphs, against plain ----
    t_phase = time.perf_counter()
    factor_rec = imu_factor_on_card(frames, tag)
    print(f"chip_smoke: phase 27 (IMU factor kernel) took "
          f"{time.perf_counter() - t_phase:.1f} s {tag}")

    # ---- 6-8. the image frontend and the image main path ----
    frontend_on_card_against_cpu(est.device, tag)
    with ransac_counted(ransac_by_path, "run_images float64"), \
            imu_kernels_counted(preint_by_path, factor_by_path, "run_images float64"):
        sync = image_main_path(None, tag)
    clahe_and_distortion_on_card(tag)

    # ---- 23. the tracker's graphs against eager, the RANSAC kernel against plain ----
    t_phase = time.perf_counter()
    recorded, _ = tracker_graphs_against_eager(
        sim_images_config(), sim.generate(noise=False), N_TWIN_TRACKER_FRAMES,
        "tracker graphs against eager", tag)
    ransac_rec = ransac_kernel_against_plain(recorded, sim_images_config(), tag)
    reject_ms = reject_replay_ms(tag)
    print(f"chip_smoke: phase 23 (tracker graphs, RANSAC kernel) took "
          f"{time.perf_counter() - t_phase:.1f} s {tag}")

    # ---- 9-10. the async image path and loop closing ----
    with ransac_counted(ransac_by_path, "run_images_async float64"), \
            imu_kernels_counted(preint_by_path, factor_by_path, "run_images_async float64"):
        async_launches = async_image_path(None, tag, sync)
    orb_on_card_against_cpu(est.device, tag)
    bench = BenchProcess()         # phase 21, beside phase 10
    with ransac_counted(ransac_by_path, "run_sim + LoopCloser float64"), \
            imu_kernels_counted(preint_by_path, factor_by_path, "run_sim + LoopCloser float64"):
        loop = loop_closing_path(None, tag, LOOP_DTYPE)


    # ---- 11-16. scale-out: global BA, distributed, window split, BAL, direct ----
    t_scale = time.perf_counter()
    by_path = {"run_sim float32": launches, "run_images float64": sync["launches"],
               "run_images_async float64": async_launches,
               "run_sim + LoopCloser float64": loop["launches"]}
    gba_launches, gba64 = global_ba_one_card(tag)
    for dtype, n in gba_launches.items():
        by_path[f"global_ba.solve 100 kf P=600 {str(dtype)[6:]}, graph replays"] = n
    by_path["global_ba.solve 64 kf 1M obs P=384 float32, graph replays"] = \
        global_ba_scaling_size(tag)
    graph.clear()                  # the keys' pools (phase 12's most of all)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    pcg_on_card(tag, gba64)
    print(f"chip_smoke: phase 24 (PCG on the card) took {time.perf_counter() - t_phase:.1f} s "
          f"{tag}")
    by_path.update(distributed_paths(tag))
    by_path.update(bal_paths(est.device, tag))
    by_path["direct_ba float32"] = direct_paths(est.device, tag)
    print(f"chip_smoke: phases 11-16 took {time.perf_counter() - t_scale:.0f} s {tag}")

    # ---- 17-21. online td, the EuRoC layout, device functions, the CLI, the bench ----
    def online_td():
        with ransac_counted(ransac_by_path, "online td float32"), \
                imu_kernels_counted(preint_by_path, factor_by_path, "online td float32"):
            by_path["online td float32"] = online_td_path(tag)

    def both(counts):
        gj, rs = counts
        by_path.update(gj)
        ransac_by_path.update(rs)

    def euroc():
        with imu_kernels_counted(preint_by_path, factor_by_path, "run_euroc float64"):
            n, rs = euroc_layout_path(tag, sync)
        both(({"run_euroc float64": n}, rs))

    for phase, label, run in (
            (17, "online td", online_td),
            (18, "EuRoC layout", euroc),
            (19, "device functions", lambda: device_functions_on_card(tag)),
            (20, "the CLI",
             lambda: both(cli_on_card(tag, preint_by_path, factor_by_path))),
            (21, "the bench", lambda: both(bench.check(tag, factor_by_path))),
            (25, "the pose graph", lambda: rec.update(posegraph_on_card(loop["closer"], tag)))):
        t_phase = time.perf_counter()
        run()
        print(f"chip_smoke: phase {phase} ({label}) took "
              f"{time.perf_counter() - t_phase:.1f} s {tag}")

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.0f} s {tag}")

    # One kernel, many paths: the simulation path solves P = 171 in
    # float32 (the keys the record requires), the two image paths and the
    # loop path in float64 (the same numbers under "float64"); the
    # scale-out paths' and the pose graph's sizes under "sizes".
    main, main64 = rec[(torch.float32, MAIN_P)], rec[(torch.float64, MAIN_P)]
    r32, r64 = ransac_rec[torch.float32], ransac_rec[torch.float64]
    if not all(n > 0 for n in (ransac_by_path["run_images float64"],
                               ransac_by_path["run_images_async float64"])):
        raise AssertionError(f"the RANSAC kernel did not launch on an image path: "
                             f"{ransac_by_path}")
    if not all(n > 0 for n in preint_by_path.values()):
        raise AssertionError(f"the preintegration kernel did not launch on every "
                             f"estimator path: {preint_by_path}")
    print(f"preintegrate launches by path: {json.dumps(preint_by_path)} {tag}")
    if not all(n > 0 for n in factor_by_path.values()):
        raise AssertionError(f"the IMU factor kernel did not launch on every estimator "
                             f"path: {factor_by_path}")
    print(f"imu_factor launches by path: {json.dumps(factor_by_path)} {tag}")
    f64 = factor_rec[torch.float64]
    p64 = preint_rec[(PREINT_M[0], torch.float64, True)]
    print(json.dumps({"kernels": [{
        "name": "gj_solve", "route": "cuda",
        "source": "vio_tpu_torch/csrc/gj_solve.cu",
        "replaces": "vio_tpu/ops/linsolve.py:34",
        "launches": sum(by_path.values()),
        "max_abs_err": main["err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "launches_by_path": by_path,
        "float64": {"max_abs_err": main64["err"], "ms": main64["ms"],
                    "plain_ms": main64["plain_ms"], "bound_ms": main64["bound_ms"],
                    "bound_by": main64["bound_by"],
                    "library_ms": main64["library_ms"]},
        "sizes": {f"{str(dt)[6:]} P={P}": {k: rec[(dt, P)][k] for k in (
            "err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                  for dt in (torch.float32, torch.float64)
                  for P in (384, 441, 600) + POSEGRAPH_P}}, {
        # the tracker's sweep runs in float32 (the keys the record
        # requires), the image paths' bootstrap in float64; the refit's
        # numbers under "refit"
        "name": "essential_ransac", "route": "cuda",
        "source": "vio_tpu_torch/csrc/essential_ransac.cu",
        "replaces": "vio_tpu/init/sfm.py:172",
        "launches": sum(ransac_by_path.values()),
        "max_abs_err": r32["err"],
        "ms": r32["ms"], "plain_ms": r32["plain_ms"],
        "bound_ms": r32["bound_ms"], "bound_by": r32["bound_by"],
        "library_ms": r32["library_ms"],
        "launches_by_path": ransac_by_path,
        "enqueued_ms": r32["enqueued_ms"],
        "float64": {k: r64[k] for k in ("err", "ms", "enqueued_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        "refit": {"float32": r32["refit"], "float64": r64["refit"]},
        "refit_best": {"float32": r32["refit_best"], "float64": r64["refit_best"]},
        "reject_program_replay_ms": reject_ms,
        "backward_err": {"float32": r32["backward_err"], "float64": r64["backward_err"]},
        "projection_err": {"float32": r32["projection_err"],
                           "float64": r64["projection_err"]},
        "backward_limit": {"float32": r32["backward_limit"],
                           "float64": r64["backward_limit"]},
        "count_agree_own_E": {"float32": r32["count_agree_own"],
                              "float64": r64["count_agree_own"]},
        "count_agree_plain_float64": {"float32": r32["count_agree_plain64"],
                                      "float64": r64["count_agree_plain64"]},
        "plain_float32_count_agree_plain_float64": r32["plain_count_agree_plain64"]}, {
        # the benchmark cell's shape and type (float64, exact noise) under
        # the keys the record requires; every shape, type and noise model
        # under "shapes"
        "name": "preintegrate", "route": "cuda",
        "source": "vio_tpu_torch/csrc/preintegrate.cu",
        "replaces": "none: vio_tpu/imu.py:180's lax.scan, left to XLA",
        "launches": sum(preint_by_path.values()),
        "max_abs_err": p64["err"],
        "ms": p64["ms"], "plain_ms": p64["plain_ms"],
        "bound_ms": p64["bound_ms"], "bound_by": p64["bound_by"],
        "enqueued_ms": p64["enqueued_ms"],
        "launches_by_path": preint_by_path,
        "shapes": {f"{str(dt)[6:]} W={PREINT_W} M={M} {'exact' if ex else 'independent'}":
                   preint_rec[(M, dt, ex)] for M, dt, ex in preint_rec}}, {
        # the benchmark cell's window and type (float64) under the keys the
        # record requires; float32 under "float32"
        "name": "imu_factor", "route": "cuda",
        "source": "vio_tpu_torch/csrc/imu_factor.cu",
        "replaces": "none: vio_tpu/solver/window.py's IMU block, left to XLA",
        "launches": sum(factor_by_path.values()),
        "max_abs_err": f64["err"],
        "ms": f64["ms"], "plain_ms": f64["plain_ms"],
        "bound_ms": f64["bound_ms"], "bound_by": f64["bound_by"],
        "enqueued_ms": f64["enqueued_ms"],
        "launches_by_path": factor_by_path,
        "float32": factor_rec[torch.float32]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
