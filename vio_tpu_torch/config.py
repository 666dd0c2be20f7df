"""Frozen dataclass configuration mirroring the reference YAML schema.

Replaces the mutable-global config system (reference:
vins-mono/src/parameters.cpp:52-211, include/parameters.h:10-49) with one
immutable config object.  Window size and feature capacity are static so
every jitted function has fixed shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class VioConfig:
    # --- static shape parameters (compile-time) ---
    window_size: int = 10            # reference: parameters.h:35 WINDOW_SIZE
    max_features: int = 256          # capacity of the SoA feature table (ref NUM_OF_F=1000)
    max_imu_per_interval: int = 64   # IMU sample capacity per keyframe interval

    # --- camera / projection ---
    focal_length: float = 460.0      # reference: parameters.cpp:70 FOCAL_LENGTH
    image_width: int = 640
    image_height: int = 640
    fx: float = 460.0
    fy: float = 460.0
    cx: float = 255.0
    cy: float = 255.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    # --- IMU noise priors (continuous-time, discretized inside preint) ---
    acc_n: float = 0.2687            # reference: config/vio_simulation.yaml
    gyr_n: float = 0.2121
    acc_w: float = 7.07e-6
    gyr_w: float = 7.07e-7
    # IMU preintegration noise model (imu.py midpoint_step):
    #   "exact"       — round-5 correlated-noise recursion accounting for
    #                   the boundary IMU sample shared by consecutive
    #                   midpoint steps (Monte-Carlo-validated; fixes the
    #                   ~2x white-noise underestimate of the reference's
    #                   model and the resulting IMU overconfidence)
    #   "independent" — the reference's independent-per-step model
    #                   (integration_base.h:54-128), kept for configs
    #                   whose empirical tuning predates the exact model
    imu_noise_model: str = "exact"
    g_norm: float = 9.81

    # --- extrinsics: camera→IMU (R_bc as row-major 9-tuple, t_bc) ---
    estimate_extrinsic: int = 0
    ric: Tuple[float, ...] = (0.0, 0.0, -1.0,
                              -1.0, 0.0, 0.0,
                              0.0, 1.0, 0.0)
    tic: Tuple[float, float, float] = (0.05, 0.04, 0.03)

    # --- estimator policy ---
    min_parallax_px: float = 10.0    # keyframe_parallax (pixels); divided by focal
    max_num_iterations: int = 10     # reference hardcodes Solve(10) (estimator.cpp:1037)
    init_depth: float = 5.0          # reference: parameters.cpp INIT_DEPTH
    td: float = 0.0                  # camera-IMU time offset: t_imu =
                                     # t_cam + td (parameters.cpp TD).
                                     # Applied by every playback driver
                                     # before IMU pairing (runner.py).
    estimate_td: bool = False        # online td refinement (parameters.cpp
                                     # ESTIMATE_TD): after each window
                                     # solve, a 1-D LS of reprojection
                                     # residual against feature velocity
                                     # updates Estimator.td, which the
                                     # drivers apply to subsequent pairing
    rolling_shutter: bool = False    # parameters.cpp ROLLING_SHUTTER
    rolling_shutter_tr: float = 0.0  # read-out time of one full frame [s]
                                     # (parameters.cpp TR): each feature's
                                     # normalized coords are shifted by
                                     # -vel * tr * (row / image_height) to
                                     # the frame-start instant
    outlier_reproj_px: float = 3.0   # post-solve feature rejection gate
                                     # (full VINS-Mono removeOutlier); 0 = off
    min_excitation: float = 0.0      # init IMU-observability gate: std of
                                     # per-frame delta_v/dt must exceed this
                                     # (estimator.cpp:243-270 computes the
                                     # same statistic against 0.25 but has
                                     # its early-return commented out; 0.0
                                     # reproduces that warn-only behavior)
    prior_forgetting: float = 1.0    # per-frame information decay on the
                                     # marginalization prior (covariance
                                     # inflation); 1.0 = reference behavior.
                                     # <1 lets slow systematics (e.g. init
                                     # scale residue) wash out instead of
                                     # being locked in by the prior

    # --- loop closing (VINS-Mono's loop_closure flag, euroc_config.yaml;
    #     the course code reads it and wires no pose graph) ---
    loop_closure: int = 0            # 1: the estimator owns a LoopCloser
                                     # (loop/closer.py), hands it each
                                     # keyframe and publishes the
                                     # drift-corrected pose; the window is
                                     # not rebased (fast_relocalization 0)
    loop_min_gap: int = 60           # the closer's settings that deployments
    loop_train_after: int = 25       # vary (LoopCloser's min_gap, keyframes
                                     # between a loop's ends, and train_after,
                                     # the keyframes the vocabulary trains on)

    # --- frontend ---
    max_cnt: int = 150
    min_dist: int = 30
    freq: int = 30
    f_threshold: float = 1.0
    equalize: bool = True

    # --- numerics ---
    solver_dtype: str = "float64"    # float64 on CPU tests, float32 on TPU

    @property
    def min_parallax(self) -> float:
        return self.min_parallax_px / self.focal_length

    @property
    def R_ic(self) -> np.ndarray:
        return np.asarray(self.ric, dtype=np.float64).reshape(3, 3)

    @property
    def t_ic(self) -> np.ndarray:
        return np.asarray(self.tic, dtype=np.float64)

    @property
    def gravity(self) -> np.ndarray:
        return np.array([0.0, 0.0, self.g_norm])

    @property
    def num_pose_params(self) -> int:
        """Total local pose-block dimension: ext(6) + (W+1) x [pose6 + sb9]."""
        return 6 + (self.window_size + 1) * 15


def sim_config(**overrides) -> VioConfig:
    """Config matching the reference VIO simulation
    (reference: config/vio_simulation.yaml + simulator/include/param.h)."""
    return VioConfig(**overrides)


def sim_images_config(**overrides) -> VioConfig:
    """Config for the RENDERED-image sim pipeline (images → CLAHE/KLT →
    estimator), tuned for the synthetic blob scenes:

    - equalize off (CLAHE manufactures gradients on near-flat renders),
    - min_dist 15 px (blob spacing; 30 px suppresses half the scene),
    - strong IMU priors for the noise-free IMU stream (the reference's
      vio_simulation.yaml priors are its NOISY-run values — with
      sub-pixel visual systematics and such weak IMU weights the solver
      lets velocity/bias wander and the scale collapses ~30 %), with the
      reference-compatible "independent" noise model whose effective
      information this regime's tuning was built on (the round-5 exact
      model is the VioConfig default; see imu_noise_model),
    - 1 px post-solve reprojection outlier gate,
    - prior forgetting 0.95 so the marginalization prior cannot lock in
      the small init-scale residue.
    """
    base = dict(equalize=False, min_dist=15,
                acc_n=0.05, gyr_n=0.01,
                imu_noise_model="independent",
                outlier_reproj_px=1.0, prior_forgetting=0.95)
    base.update(overrides)
    return VioConfig(**base)


def euroc_config(**overrides) -> VioConfig:
    """Config matching the reference EuRoC setup
    (reference: config/euroc_config.yaml)."""
    base = dict(
        image_width=752, image_height=480,
        fx=4.616e+02, fy=4.603e+02, cx=3.630e+02, cy=2.481e+02,
        k1=-2.917e-01, k2=8.228e-02, p1=5.333e-05, p2=-1.578e-04,
        acc_n=0.08, gyr_n=0.004, acc_w=4e-5, gyr_w=2e-6,
        g_norm=9.81007,
        ric=(0.0148655429818, -0.999880929698, 0.00414029679422,
             0.999557249008, 0.0149672133247, 0.025715529948,
             -0.0257744366974, 0.00375618835797, 0.999660727178),
        tic=(-0.0216401454975, -0.064676986768, 0.00981073058949),
        max_num_iterations=8,
        max_features=1024,
        freq=10,
    )
    base.update(overrides)
    return VioConfig(**base)
