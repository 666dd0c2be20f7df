"""Sliding-window VIO estimator: the framework's core state machine.

Port of ``vio_tpu/estimator.py`` (reference: vins-mono/src/estimator.cpp:
105-1264 — processIMU / processImage / initialStructure /
visualInitialAlign / solveOdometry / backendOptimization / slideWindow /
failureDetection; :622-642 for the loop closer's feedback,
``apply_live_correction``).

Architecture: a thin host-side state machine (keyframe policy, window
bookkeeping, init orchestration) in float64 numpy, driving device work on
an explicit ``device`` in an explicit ``dtype``: batched preintegration,
SfM, and one ``solver/frame_step.py`` call per frame (assembly + LM solve
through the Gauss-Jordan kernel; on the card, the frame's captured CUDA
graphs replayed).  The marginalization prior chain and
the visual-IMU alignment stay on the host in float64 on every device.

With ``cfg.loop_closure`` (VINS-Mono's flag) the estimator owns a
``LoopCloser`` on its own device and in its own dtype, hands it each
keyframe inside ``process_image`` (on the frame's thread) and publishes
the pose corrected by the closer's drift (``latest_pose``): VINS-Mono's
drift-corrected path with ``fast_relocalization: 0``, so the window is
never rebased.
"""
from __future__ import annotations

import numpy as np
import torch

from . import imu, trace
from .config import VioConfig
from .device import resolve
from .feature_manager import FeatureManager
from .init import alignment, sfm
from .init.ex_rotation import ExtrinsicRotationCalibrator
from .loop.closer import LoopCloser
from .solver import frame_step, marginalize, window as W
from .utils import lie
from .utils import lie_np

# IMU samples per window interval are packed to the longest buffer rounded
# up to a multiple of this, a static shape of the frame's captured graphs.
# vio_tpu rounds to 32 with the configured capacity (max_imu_per_interval,
# 64) as a floor; on the card this finer bucket took a post-init frame from
# 37.1 to 24.4 ms of device time and run_sim from 17.1 to 19.5 frames/s,
# for 10 graph keys instead of 2 over 150 frames (PERF.md §6).
IMU_BUCKET = 8

# solved landmarks a keyframe needs to enter the loop closer (the count
# the test hooks kept before the flag)
LOOP_MIN_LANDMARKS = 10

SOLVER_INITIAL = 0
SOLVER_NON_LINEAR = 1
MARGIN_OLD = 0
MARGIN_NEW = 1


class IntervalBuffer:
    """Raw IMU samples spanning one interval, with the preintegration
    anchor (the sample just before the interval) and linearization bias
    captured at creation (reference dt_buf/acc_buf/gyr_buf,
    estimator.h:76-78)."""

    __slots__ = ("dts", "accs", "gyrs", "acc0", "gyr0")

    def __init__(self, acc0, gyr0):
        self.dts = []
        self.accs = []
        self.gyrs = []
        self.acc0 = np.asarray(acc0, dtype=np.float64)
        self.gyr0 = np.asarray(gyr0, dtype=np.float64)

    def push(self, dt, acc, gyr):
        self.dts.append(float(dt))
        self.accs.append(np.asarray(acc, dtype=np.float64))
        self.gyrs.append(np.asarray(gyr, dtype=np.float64))

    def merge_from(self, other: "IntervalBuffer"):
        self.dts += other.dts
        self.accs += other.accs
        self.gyrs += other.gyrs

    def delta_R(self, bg) -> np.ndarray:
        """Host-side midpoint gyro integration → relative rotation matrix
        (the pre_integrations[k]->delta_q the extrinsic calibrator consumes,
        estimator.cpp:168).  Tiny (~7 samples), so plain numpy."""
        q = np.array([0.0, 0.0, 0.0, 1.0])
        gyr_prev = self.gyr0
        for dt, gyr in zip(self.dts, self.gyrs):
            w = 0.5 * (gyr_prev + gyr) - bg
            half = 0.5 * w * dt
            dq = np.concatenate([half, [1.0]])
            x1, y1, z1, w1 = q
            x2, y2, z2, w2 = dq
            q = np.array([
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            ])
            q /= np.linalg.norm(q)
            gyr_prev = gyr
        x, y, z, w_ = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z), 2 * (x * z + w_ * y)],
            [2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w_ * x)],
            [2 * (x * z - w_ * y), 2 * (y * z + w_ * x), 1 - 2 * (x * x + y * y)],
        ])

    def delta_v(self, ba=None, bg=None):
        """Host-side midpoint preintegrated velocity delta (body frame of
        the interval start) and total dt — the pre_integration->delta_v /
        sum_dt pair the reference's init excitation check consumes
        (estimator.cpp:249-251).  Tiny buffers, plain numpy."""
        ba = np.zeros(3) if ba is None else np.asarray(ba, np.float64)
        bg = np.zeros(3) if bg is None else np.asarray(bg, np.float64)
        q = np.array([0.0, 0.0, 0.0, 1.0])
        v = np.zeros(3)
        acc_prev, gyr_prev = self.acc0, self.gyr0
        sum_dt = 0.0
        for dt, acc, gyr in zip(self.dts, self.accs, self.gyrs):
            R0 = _quat_to_mat_np(q)
            un_acc_0 = R0 @ (acc_prev - ba)
            w = 0.5 * (gyr_prev + gyr) - bg
            half = 0.5 * w * dt
            q = _quat_mul_np(q, np.concatenate([half, [1.0]]))
            q /= np.linalg.norm(q)
            un_acc_1 = _quat_to_mat_np(q) @ (acc - ba)
            v = v + 0.5 * (un_acc_0 + un_acc_1) * dt
            sum_dt += dt
            acc_prev, gyr_prev = acc, gyr
        return v, sum_dt

    def __len__(self):
        return len(self.dts)


def _quat_mul_np(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _so3_exp_np(w):
    """Rodrigues in plain numpy — process_imu runs once per IMU sample on
    the host, where a device call per sample would cost a launch and a
    sync each."""
    th2 = float(w @ w)
    K = np.array([[0.0, -w[2], w[1]],
                  [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    if th2 < 1e-16:
        return np.eye(3) + K
    th = np.sqrt(th2)
    return (np.eye(3) + np.sin(th) / th * K +
            (1.0 - np.cos(th)) / th2 * (K @ K))


def _quat_to_mat_np(q):
    x, y, z, w_ = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z), 2 * (x * z + w_ * y)],
        [2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w_ * x)],
        [2 * (x * z - w_ * y), 2 * (y * z + w_ * x), 1 - 2 * (x * x + y * y)],
    ])


class FrameRec:
    """all_image_frame entry (reference initial/initial_alignment.h
    ImageFrame): raw feature map + IMU buffer since the previous frame."""

    __slots__ = ("t", "feats", "buf", "R", "T", "is_key_frame")

    def __init__(self, t, feats, buf):
        self.t = t
        self.feats = feats
        self.buf = buf
        self.R = np.eye(3)
        self.T = np.zeros(3)
        self.is_key_frame = False


def _pad_buffer(buf: IntervalBuffer | None, M: int):
    """(dts, accs, gyrs, mask, acc0, gyr0) padded to capacity M."""
    dts = np.zeros(M)
    accs = np.zeros((M, 3))
    gyrs = np.zeros((M, 3))
    mask = np.zeros(M, dtype=bool)
    if buf is not None and len(buf) > 0:
        n = min(len(buf), M)
        dts[:n] = buf.dts[:n]
        accs[:n] = np.stack(buf.accs[:n])
        gyrs[:n] = np.stack(buf.gyrs[:n])
        mask[:n] = True
        acc0, gyr0 = buf.acc0, buf.gyr0
    else:
        acc0 = np.zeros(3)
        gyr0 = np.zeros(3)
    return dts, accs, gyrs, mask, acc0, gyr0


def _ms_key(span: str, in_loop: bool = False) -> str:
    """A span's key in a frame's telemetry: ``est.pack`` → ``pack_ms``,
    ``graph.wait`` → ``wait_ms``; inside the closer's call every key is
    the loop's: ``est.loop`` → ``loop_ms``, ``loop.solve`` →
    ``loop_solve_ms``, the pose graph's ``graph.wait`` → ``loop_wait_ms``."""
    part = span.partition(".")[2]
    if in_loop and span != "est.loop":
        return f"loop_{part}_ms"
    return f"{part}_ms"


class Estimator:
    """The sliding-window VIO core (reference estimator.{h,cpp})."""

    def __init__(self, cfg: VioConfig, device=None, dtype=None):
        """device/dtype: where and in what precision the device work runs.
        device defaults to the CUDA device and raises without one; pass
        ``device="cpu"`` to run on the CPU.  dtype defaults to float32 on
        CUDA (the TPU's regime) and float64 on the CPU (the JAX tests' x64
        regime)."""
        self.cfg = cfg
        self.device, self.dtype = resolve(device, dtype)
        self.W = cfg.window_size
        self.W1 = cfg.window_size + 1
        self.P = cfg.num_pose_params
        self.noise_diag = imu.noise_diag(
            cfg.acc_n, cfg.gyr_n, cfg.acc_w, cfg.gyr_w).numpy()
        self.ric = cfg.R_ic
        self.tic = cfg.t_ic
        # live camera-IMU time offset: starts at the configured prior and
        # is refined online when cfg.estimate_td (like the reference's TD
        # global, parameters.cpp:130-131).  Survives failure resets — a
        # hardware property, not a trajectory state.
        self.td = float(cfg.td)
        self._record = None      # the solved frame's telemetry, until it ends
        self.closer = (LoopCloser(R_ic=cfg.R_ic, t_ic=cfg.t_ic, min_gap=cfg.loop_min_gap,
                                  train_after=cfg.loop_train_after, focal=cfg.focal_length,
                                  device=self.device, dtype=self.dtype)
                       if cfg.loop_closure else None)
        self.clear_state()

    # ------------------------------------------------------------------
    # state management (clearState, estimator.cpp:60-103)
    # ------------------------------------------------------------------

    def clear_state(self):
        W1 = self.W1
        self.Ps = np.zeros((W1, 3))
        self.Rs = np.tile(np.eye(3), (W1, 1, 1))
        self.Vs = np.zeros((W1, 3))
        self.Bas = np.zeros((W1, 3))
        self.Bgs = np.zeros((W1, 3))
        self.headers = np.zeros(W1)
        self.bufs: list[IntervalBuffer | None] = [None] * W1
        self.frame_count = 0
        self.first_imu = False
        self.acc_0 = np.zeros(3)
        self.gyr_0 = np.zeros(3)
        self.solver_flag = SOLVER_INITIAL
        self.marg_flag = MARGIN_OLD
        self.g = np.array([0.0, 0.0, self.cfg.g_norm])
        self.fm = FeatureManager(self.W, self.cfg.min_parallax)
        self.all_frames: list[FrameRec] = []
        self.tmp_buf: IntervalBuffer | None = None
        # marginalization prior (static size P)
        self.H_prior = np.zeros((self.P, self.P))
        self.b_prior = np.zeros(self.P)
        self.err_prior = np.zeros(self.P)
        self.Jt_prior_inv = np.zeros((self.P, self.P))
        self.last_P = np.zeros(3)
        self.last_R = np.eye(3)
        self.failure_count = 0
        self.frame_solved = 0
        self.last_failure_diag: list[str] = []
        # online extrinsic calibration state (estimator.cpp:161-184):
        # 2 = calibrate rotation online, 1 = optimize in BA, 0 = fixed
        self.estimate_extrinsic = self.cfg.estimate_extrinsic
        self.ex_calibrator = ExtrinsicRotationCalibrator(self.W)
        self.initial_timestamp = 0.0
        self._init_align_rejects = 0
        self.last_excitation = 0.0
        # telemetry survives failure resets (it documents them)
        self.telemetry: list[dict] = getattr(self, "telemetry", [])
        # a reset starts a new world frame: the closer's keyframes and
        # drift belong to the old one
        if self.closer is not None:
            self.closer.reset()

    def pop_telemetry(self) -> list[dict]:
        """Drain the per-solve telemetry records collected so far."""
        out = self.telemetry
        self.telemetry = []
        return out

    # ------------------------------------------------------------------
    # IMU path (processIMU, estimator.cpp:105-139)
    # ------------------------------------------------------------------

    def process_imu(self, dt: float, acc, gyr):
        acc = np.asarray(acc, dtype=np.float64)
        gyr = np.asarray(gyr, dtype=np.float64)
        if not self.first_imu:
            self.first_imu = True
            self.acc_0 = acc
            self.gyr_0 = gyr

        j = self.frame_count
        if self.bufs[j] is None:
            self.bufs[j] = IntervalBuffer(self.acc_0, self.gyr_0)
        if self.tmp_buf is None:
            self.tmp_buf = IntervalBuffer(self.acc_0, self.gyr_0)

        if j != 0:
            self.bufs[j].push(dt, acc, gyr)
            self.tmp_buf.push(dt, acc, gyr)
            # midpoint state propagation (estimator.cpp:128-135)
            un_acc_0 = self.Rs[j] @ (self.acc_0 - self.Bas[j]) - self.g
            un_gyr = 0.5 * (self.gyr_0 + gyr) - self.Bgs[j]
            R_new = self.Rs[j] @ _so3_exp_np(un_gyr * dt)
            un_acc_1 = R_new @ (acc - self.Bas[j]) - self.g
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            self.Ps[j] = self.Ps[j] + self.Vs[j] * dt + 0.5 * un_acc * dt * dt
            self.Vs[j] = self.Vs[j] + un_acc * dt
            self.Rs[j] = R_new
        self.acc_0 = acc
        self.gyr_0 = gyr

    # ------------------------------------------------------------------
    # image path (processImage, estimator.cpp:141-238)
    # ------------------------------------------------------------------

    def process_image(self, feats: dict, t: float, descriptors: dict | None = None):
        """feats: {feature_id: (bearing (3,) with z=1, uv (2,), vel (2,))};
        descriptors: {feature_id: packed (8,) uint32 descriptor}, the
        frame's for the loop closer (``LoopCloser.add_keyframe``'s
        layout), required with ``cfg.loop_closure`` and unused without.
        A frame that solves appends its telemetry record once it is done:
        the solve's numbers, each span opened in the frame as
        ``<name>_ms`` (``trace.py``; the part after the dot: ``frame_ms``,
        ``pack_ms``, ``step_ms``, the frame step's ``wait_ms``, ...; the
        closer's call under the loop's own keys: ``loop_ms``,
        ``loop_query_ms``, ``loop_verify_ms``, ``loop_solve_ms`` and its
        pose graph's ``loop_wait_ms``, ``loop_replay_ms``, ...), ``reads``
        (the LM loop's host reads of its condition, 0 on the CPU),
        ``solve_ms`` (pack + step) and ``marg_ms`` (the prior chain)."""
        if self.closer is not None and descriptors is None:
            raise ValueError("loop_closure is on: process_image needs the frame's "
                             "descriptors")
        m = trace.mark()
        self._record = None      # nothing left from a call that raised
        in_loop = {}
        with trace.span("est.frame"):
            self._process_image(feats, t)
            own = trace.since(m)
            if self.closer is not None:
                m_loop = trace.mark()
                self._add_keyframe(descriptors)
                in_loop = trace.since(m_loop)
        rec, self._record = self._record, None
        if rec is not None:
            own["est.frame"] = trace.since(m)["est.frame"]
            ms = {_ms_key(name): round(s * 1e3, 3) for name, s in own.items()}
            ms.update({_ms_key(name, True): round(s * 1e3, 3) for name, s in in_loop.items()})
            rec.update(ms, solve_ms=round((own["est.pack"] + own["est.step"]) * 1e3, 3),
                       marg_ms=ms["prior_ms"])
            self.telemetry.append(rec)

    def _add_keyframe(self, descriptors: dict):
        """The loop closer's keyframe (VINS-Mono's keyframe to the pose
        graph): after a frame that marginalized the oldest, with at least
        ``LOOP_MIN_LANDMARKS`` solved landmarks in view, the newest
        frame's odometry pose, landmarks and descriptors."""
        if not self.initialized or self.marg_flag != MARGIN_OLD:
            return
        with trace.span("est.loop"):
            ids, xy, pts_cam = self.current_landmarks()
            if len(ids) < LOOP_MIN_LANDMARKS:
                return
            k = self.frame_count
            self.closer.add_keyframe(self.headers[k], self.Ps[k].copy(), self.Rs[k].copy(),
                                     np.stack([descriptors[int(i)] for i in ids]), xy,
                                     pts_cam=pts_cam, pts_xy=xy)

    def _process_image(self, feats: dict, t: float):
        with trace.span("est.features"):
            self._add_features(feats, t)

        if self.solver_flag == SOLVER_INITIAL:
            if self.frame_count == self.W:
                # wait for extrinsic calibration; retry init at most every
                # 0.1 s (estimator.cpp:185-192)
                attempt = (self.estimate_extrinsic != 2
                           and (t - self.initial_timestamp) > 0.1)
                if attempt:
                    self.initial_timestamp = t
                if attempt and self._initial_structure():
                    self.solver_flag = SOLVER_NON_LINEAR
                    self._solve_odometry()
                    with trace.span("est.slide"):
                        self._slide_window()
                        self.fm.remove_failures()
                        self.last_P = self.Ps[self.W].copy()
                        self.last_R = self.Rs[self.W].copy()
                else:
                    self._slide_window()
            else:
                self.frame_count += 1
                prev = self.frame_count - 1
                self.Ps[self.frame_count] = self.Ps[prev]
                self.Rs[self.frame_count] = self.Rs[prev]
                self.Vs[self.frame_count] = self.Vs[prev]
                self.Bas[self.frame_count] = self.Bas[prev]
                self.Bgs[self.frame_count] = self.Bgs[prev]
        else:
            self._solve_odometry()
            with trace.span("est.slide"):
                if self._failure_detection():
                    self.failure_count += 1
                    self.clear_state()
                    return
                if self.cfg.estimate_td:
                    self._estimate_td()
                self._slide_window()
                self.fm.remove_failures()
                self.last_P = self.Ps[self.W].copy()
                self.last_R = self.Rs[self.W].copy()

    def _add_features(self, feats: dict, t: float):
        """The frame's features into the feature manager and the window
        (processImage's front half, estimator.cpp:141-184)."""
        if self.cfg.rolling_shutter and self.cfg.rolling_shutter_tr > 0:
            # rolling-shutter row-time compensation (the full VINS-Mono's
            # TD_FACTOR row term, parameters.cpp TR): shift each feature
            # to the frame-start instant using its image-plane velocity
            # and the read-out fraction of its row
            tr = self.cfg.rolling_shutter_tr
            h = float(self.cfg.image_height)
            comp = {}
            for fid, (xyz, uv, vel) in feats.items():
                dtrow = tr * (float(uv[1]) / h)
                xyz = np.asarray(xyz, np.float64).copy()
                xyz[:2] = xyz[:2] - np.asarray(vel, np.float64) * dtrow
                comp[fid] = (xyz, uv, vel)
            feats = comp
        if self.fm.add_feature_check_parallax(self.frame_count, feats):
            self.marg_flag = MARGIN_OLD
        else:
            self.marg_flag = MARGIN_NEW

        self.headers[self.frame_count] = t
        rec = FrameRec(t, feats, self.tmp_buf)
        self.all_frames.append(rec)
        self.tmp_buf = IntervalBuffer(self.acc_0, self.gyr_0)

        # online extrinsic rotation calibration (estimator.cpp:161-184):
        # hand-eye pairs (camera relative R from 2-view geometry, body
        # relative R from gyro preintegration) until the calibrator accepts,
        # then downgrade to "optimize in BA" mode.
        if self.estimate_extrinsic == 2 and self.frame_count != 0:
            pa, pb = self.fm.get_corresponding(self.frame_count - 1,
                                               self.frame_count)
            buf = self.bufs[self.frame_count]
            if len(pa) >= 9 and buf is not None and len(buf) > 0:
                R_cam = sfm.relative_rotation(pa, pb, device=self.device,
                                              dtype=self.dtype)
                if R_cam is not None:
                    R_imu = buf.delta_R(self.Bgs[self.frame_count])
                    self.ex_calibrator.add_pair(R_cam, R_imu)
                    ok, ric = self.ex_calibrator.solve()
                    if ok:
                        self.ric = np.asarray(ric)
                        self.estimate_extrinsic = 1

    def _estimate_td(self):
        """Online camera-IMU time-offset refinement (the capability behind
        parameters.cpp ESTIMATE_TD; the reference build reads the flag
        but ships no td factor — here a first-order update equivalent to
        the full VINS ProjectionTdFactor's td linearization): reprojection
        residual r of every solved landmark observation is modelled as
        r = v * dtd (feature image velocity times the pairing-time error),
        giving the 1-D LS update dtd = sum(v.r)/sum(v.v).  Drivers read
        ``self.td`` each frame, so the refined offset shifts subsequent
        IMU pairing."""
        num = 0.0
        den = 0.0
        for ft in self.fm.features.values():
            if ft.depth <= 0 or ft.solve_flag == 2:
                continue
            i = ft.start_frame
            pw = self.Rs[i] @ (self.ric @ (ft.pts[0] * ft.depth) +
                               self.tic) + self.Ps[i]
            for k in range(1, len(ft.pts)):
                j = i + k
                if j > self.W:
                    break
                v = ft.vels[k]
                if abs(v[0]) + abs(v[1]) < 1e-9:
                    continue
                pc = self.ric.T @ (self.Rs[j].T @ (pw - self.Ps[j]) -
                                   self.tic)
                if pc[2] < 0.1:
                    continue
                r = ft.pts[k][:2] - pc[:2] / pc[2]
                num += float(v @ r)
                den += float(v @ v)
        if den > 1e-8:
            # damped, clamped update: td errors express as a few ms; the
            # clamp keeps a bad frame from destabilizing pairing
            self.td += 0.5 * float(np.clip(num / den, -2e-3, 2e-3))

    # ------------------------------------------------------------------
    # initialization (initialStructure, estimator.cpp:240-382)
    # ------------------------------------------------------------------

    def _initial_structure(self) -> bool:
        # IMU observability check (estimator.cpp:243-270): RMS spread of
        # per-interval mean specific force delta_v/dt across collected
        # frames.  The reference computes this against 0.25 m/s^2 but its
        # early-return is commented out; cfg.min_excitation > 0 turns the
        # statistic into a real gate (0.0 = reference warn-only parity).
        dvs, sdts = [], []
        for rec in self.all_frames[1:]:
            if rec.buf is not None and len(rec.buf) > 0:
                dv, sdt = rec.buf.delta_v()
                if sdt > 0:
                    dvs.append(dv)
                    sdts.append(sdt)
        if len(dvs) >= 2:
            self.last_excitation = alignment.excitation_std(
                np.stack(dvs), np.asarray(sdts))
            if self.last_excitation < self.cfg.min_excitation:
                return False

        # build the SfM observation grid over window frames
        feats = list(self.fm.features.values())
        if len(feats) < 10:
            return False
        Fa = len(feats)
        obs = np.zeros((self.W1, Fa, 2))
        valid = np.zeros((self.W1, Fa), dtype=bool)
        for fi, ft in enumerate(feats):
            for k, p in enumerate(ft.pts):
                j = ft.start_frame + k
                if j <= self.W:
                    obs[j, fi] = p[:2] / p[2]
                    valid[j, fi] = True

        ok_l = self._relative_pose()
        if ok_l is None:
            return False
        l, R_rel, t_rel = ok_l

        ok, Rs_c, ts_c, X, tri = sfm.construct(obs, valid, l, R_rel, t_rel,
                                               device=self.device,
                                               dtype=self.dtype)
        if not ok:
            self.marg_flag = MARGIN_OLD
            return False

        # camera world→cam poses → body poses in c0 for the window keyframes
        fid_index = {ft.feature_id: i for i, ft in enumerate(feats)}
        key_ts = set(self.headers[:self.W1])
        prev_R = np.eye(3)
        prev_t = np.zeros(3)
        ki = 0
        for rec in self.all_frames:
            if ki <= self.W and rec.t == self.headers[ki]:
                rec.is_key_frame = True
                rec.R = Rs_c[ki].T @ self.ric.T   # body→c0
                rec.T = -Rs_c[ki].T @ ts_c[ki]    # camera position in c0
                prev_R, prev_t = Rs_c[ki], ts_c[ki]
                ki += 1
                continue
            # PnP for non-keyframes against the SfM landmarks
            pts3, pts2 = [], []
            for fid, (xyz, _uv, _vel) in rec.feats.items():
                i = fid_index.get(fid)
                if i is not None and tri[i]:
                    pts3.append(X[i])
                    pts2.append(np.asarray(xyz[:2]) / xyz[2])
            if len(pts3) < 6:
                return False
            R_pnp, t_pnp, msq = sfm.pnp_gn(
                self._dev(np.stack(pts3)), self._dev(np.stack(pts2)),
                torch.ones(len(pts3), dtype=torch.bool, device=self.device),
                self._dev(prev_R), self._dev(prev_t))
            R_pnp = self._host(R_pnp)
            t_pnp = self._host(t_pnp)
            rec.R = R_pnp.T @ self.ric.T
            rec.T = -R_pnp.T @ t_pnp
            prev_R, prev_t = R_pnp, t_pnp

        return self._visual_initial_align()

    def _relative_pose(self):
        """Find bootstrap frame l (relativePose, estimator.cpp:462-490)."""
        for i in range(self.W):
            pa, pb = self.fm.get_corresponding(i, self.W)
            if len(pa) < 20:
                continue
            parallax = np.mean(np.linalg.norm(pa - pb, axis=1))
            # 30 px of mean parallax at the configured focal
            # (estimator.cpp:473-477 uses the FOCAL_LENGTH global)
            if parallax * self.cfg.focal_length <= 30.0:
                continue
            ok, R, t = sfm.solve_relative_rt(pa, pb, np.ones(len(pa), bool),
                                             device=self.device,
                                             dtype=self.dtype)
            if ok:
                return i, R, t
        return None

    def _frame_preints(self, bg, stride: int = 1):
        """Batched preintegration of all_frames interval pairs at gyro bias
        bg (zero acc bias).  With stride > 1, consecutive raw intervals are
        MERGED into longer spans between frames [0, stride, 2·stride, …,
        last] — longer Δt makes the gravity/scale alignment observable
        (the g column scales with ½Δt² while visual noise does not; see
        _visual_initial_align).  The frame axis is padded to a static
        capacity (multiples of 32) so compile count stays bounded while
        all_frames grows pre-init).  The port has no recompiles to bound:
        it packs exactly the n intervals at the longest buffer's length
        (masked steps are exact no-ops).  Returns (host float64 numpy
        PreintState, idx) where idx are the all_frames indices the pairs
        connect."""
        if stride <= 1:
            idx = list(range(len(self.all_frames)))
            bufs = [r.buf for r in self.all_frames[1:]]
        else:
            idx = list(range(0, len(self.all_frames), stride))
            if idx[-1] != len(self.all_frames) - 1:
                idx.append(len(self.all_frames) - 1)
            bufs = []
            for a, b in zip(idx[:-1], idx[1:]):
                first = self.all_frames[a + 1].buf
                mb = IntervalBuffer(
                    first.acc0 if first is not None else np.zeros(3),
                    first.gyr0 if first is not None else np.zeros(3))
                for j in range(a + 1, b + 1):
                    if self.all_frames[j].buf is not None:
                        mb.merge_from(self.all_frames[j].buf)
                bufs.append(mb)
        n = len(bufs)
        M = max((len(b) for b in bufs if b is not None), default=0)
        packs = [_pad_buffer(b, max(M, 1)) for b in bufs]
        dts, accs, gyrs, mask, acc0, gyr0 = (
            np.stack([p[i] for p in packs]) for i in range(6))
        up = self._dev
        st = imu.preintegrate_batch(
            up(dts), up(accs), up(gyrs),
            torch.as_tensor(mask, device=self.device), up(acc0), up(gyr0),
            up(np.zeros((n, 3))), up(np.tile(bg, (n, 1))),
            up(self.noise_diag), self.cfg.imu_noise_model == "exact")
        return imu.PreintState(*map(self._host, st)), idx

    def _dev(self, a) -> torch.Tensor:
        """Host array → device tensor in the solve dtype."""
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """Device tensor → host float64 numpy."""
        return t.detach().cpu().numpy().astype(np.float64)

    def _visual_initial_align(self) -> bool:
        """(visualInitialAlign, estimator.cpp:384-455 +
        VisualIMUAlignment, initial_aligment.cpp:199)."""
        R_all = np.stack([r.R for r in self.all_frames])
        T_all = np.stack([r.T for r in self.all_frames])

        # 1) gyro bias from rotation-only constraints
        st, _ = self._frame_preints(np.zeros(3))
        delta_q = np.asarray(st.delta_q)
        dq_dbg = np.asarray(st.jacobian)[:, 3:6, 12:15]
        dbg = np.asarray(alignment.solve_gyroscope_bias(R_all, delta_q, dq_dbg))
        for i in range(self.W1):
            self.Bgs[i] = dbg
        # repropagate at the solved bias
        st, _ = self._frame_preints(dbg)
        delta_p = np.asarray(st.delta_p)
        delta_v = np.asarray(st.delta_v)
        dts = np.asarray(st.sum_dt)

        # 2) gravity + scale on STRIDE-MERGED pairs.  Over consecutive
        # 30 Hz pairs the (g, s, v) system is near-degenerate: the gravity
        # column enters as ½Δt² (~5e-4 at Δt=1/30) so sub-pixel visual
        # noise swings the solution 30 %+ along the weak direction while
        # ‖g‖ still lands inside the reference's ±1.0 acceptance band.
        # Merging intervals to Δt≈0.15 s boosts the gravity signal ~25×
        # against the same visual noise.  Velocities are recovered in
        # closed form afterwards (alignment.recover_velocities).
        n_pairs = len(self.all_frames) - 1
        # stride by TARGET merged Δt, not a fixed cap: gravity enters the
        # position rows as ½Δt², so observability is set by the merged
        # interval length — ~0.25 s makes |g| solvable as soon as the
        # window exists, instead of waiting many seconds for the r3-era
        # stride≤4 (Δt 0.13 s at 30 Hz) to become conditioned.  Capped so
        # at least ~6 merged pairs remain for the LS.
        ts_f = [r.t for r in self.all_frames]
        med_dt = float(np.median(np.diff(ts_f))) if n_pairs >= 2 else 0.033
        stride = int(np.clip(round(0.25 / max(med_dt, 1e-3)),
                             1, max(1, n_pairs // 6)))
        st_m, idx = self._frame_preints(dbg, stride=stride)
        dp_m = np.asarray(st_m.delta_p)
        dv_m = np.asarray(st_m.delta_v)
        dt_m = np.asarray(st_m.sum_dt)
        ok, _x, g_c0, s = alignment.linear_alignment(
            R_all[idx], T_all[idx], dp_m, dv_m, dt_m,
            self.tic, self.cfg.g_norm)
        if not ok:
            return False

        # Scale self-consistency gate: a noisy-but-plausible alignment can
        # pass the ‖g‖ band with 10 %+ scale error, which the prior then
        # locks into the whole run (the reference has no defense — its sim
        # init sees exact features).  Solve the SAME system on each half
        # of the pairs; accept only if both halves stand on their own and
        # agree on scale.  Deferring costs 0.1 s per retry
        # (estimator.cpp:185-192 retry cadence); a fail-safe accepts after
        # 12 deferrals so degenerate-motion streams still initialize.
        if len(idx) >= 8 and self._init_align_rejects < 12:
            m = (len(idx) + 1) // 2

            def _half(sf, sp):
                # the halves only provide INDEPENDENT scale estimates to
                # compare — with ~5 pairs each they cannot meet the full
                # system's tight scale-confidence gate (rel_std 0.02), so
                # run them with it relaxed.  Requiring full confidence of
                # each half rejected perfectly good frame-11 inits and
                # deferred to later, worse ones (round-4 regression hunt:
                # clean image-path APE 0.047 → 0.41 at the r3 gate commit).
                okh, _, _, sh = alignment.linear_alignment(
                    R_all[idx][sf], T_all[idx][sf], dp_m[sp], dv_m[sp],
                    dt_m[sp], self.tic, self.cfg.g_norm,
                    max_scale_rel_std=0.15, g_band=2.5)
                return sh if okh else None

            s1 = _half(slice(0, m), slice(0, m - 1))
            s2 = _half(slice(m - 1, None), slice(m - 1, None))
            # Agreement threshold 0.15: measured round-5 trade study —
            # the clean first-window init (good, final APE < 0.05) and a
            # noisy 7%-off init (final APE 0.84) produce near-IDENTICAL
            # half-disagreement (~0.09·s, dominated by the short halves'
            # own LS noise on this geometry), so no threshold separates
            # them; tightening to 0.08 fixed noisy (0.32) but broke clean
            # (0.42 — later windows on this trajectory are worse
            # conditioned, so deferral hurts).  0.15 keeps clean inits
            # first-try; drift from occasionally-accepted scale error in
            # noisy regimes is the loop closer's job to repair.
            if s1 is None or s2 is None or abs(s1 - s2) > 0.15 * s:
                self._init_align_rejects += 1
                return False
        x = alignment.recover_velocities(R_all, T_all, delta_p, delta_v,
                                         dts, self.tic, g_c0, s).reshape(-1)

        # 3) window states from the SfM keyframe poses (visual scale)
        kf_idx = [i for i, r in enumerate(self.all_frames) if r.is_key_frame]
        for k, i in enumerate(kf_idx[:self.W1]):
            self.Ps[k] = self.all_frames[i].T
            self.Rs[k] = self.all_frames[i].R
            self.all_frames[i].is_key_frame = True

        # 4) triangulate at visual scale with zero extrinsic translation
        self.fm.clear_depth()
        self.fm.triangulate(self.Ps, self.Rs, np.zeros(3), self.ric)

        # 5) metric rescale + move origin to body frame 0
        for i in range(self.W, -1, -1):
            self.Ps[i] = (s * self.Ps[i] - self.Rs[i] @ self.tic
                          - (s * self.Ps[0] - self.Rs[0] @ self.tic))
        for k, i in enumerate(kf_idx[:self.W1]):
            self.Vs[k] = self.all_frames[i].R @ x[3 * i:3 * i + 3]
        for ft in self.fm.features.values():
            if ft.depth > 0:
                ft.depth *= s

        # 6) gravity-align the c0 frame, keeping frame-0 yaw at zero (host
        #    float64, like the rest of the alignment)
        R0 = lie.g_to_R(torch.as_tensor(g_c0, dtype=torch.float64)).numpy()
        yaw = float(lie.mat_to_ypr(torch.as_tensor(R0 @ self.Rs[0]))[0])
        R0 = lie.ypr_to_mat(torch.tensor([-yaw, 0.0, 0.0],
                                         dtype=torch.float64)).numpy() @ R0
        self.g = R0 @ g_c0
        for i in range(self.W1):
            self.Ps[i] = R0 @ self.Ps[i]
            self.Rs[i] = R0 @ self.Rs[i]
            self.Vs[i] = R0 @ self.Vs[i]
        return True

    # ------------------------------------------------------------------
    # solve path (solveOdometry → backendOptimization,
    # estimator.cpp:492-503, 1075-1143)
    # ------------------------------------------------------------------

    def _solve_odometry(self):
        with trace.span("est.triangulate"):
            self.fm.triangulate(self.Ps, self.Rs, self.tic, self.ric)
        self._backend_optimization()

    def _pack_states(self) -> W.WindowStates:
        """Host-side pack: numpy leaves (uploaded once, by frame_step)."""
        Qs = lie_np.mat_to_quat_np(self.Rs)
        cands = self.fm.candidates()
        F = self.cfg.max_features
        inv_dep = np.ones(F)   # padded slots: 1.0, never 0 (1/0 → NaN Hessian)
        for i, ft in enumerate(cands[:F]):
            inv_dep[i] = 1.0 / ft.depth
        return W.WindowStates(
            ext_t=np.asarray(self.tic),
            ext_q=lie_np.mat_to_quat_np(self.ric),
            Ps=self.Ps.copy(), Qs=Qs,
            Vs=self.Vs.copy(), Bas=self.Bas.copy(),
            Bgs=self.Bgs.copy(), inv_dep=inv_dep)

    def _pack_imu_raw(self):
        """Raw padded IMU buffers for the window intervals 1..W, host
        numpy.  Non-keyframe slides MERGE intervals, so a window interval
        can exceed the nominal capacity (e.g. ~0.4 s of 200 Hz IMU);
        truncating would silently shorten delta_p and bias the solved
        scale.  The capacity is a bucket, the longest buffer rounded up to
        a multiple of ``IMU_BUCKET``: a static shape of the frame's captured
        graphs (in the JAX package it bounds XLA's recompiles), so a run
        captures a few keys.  The masked steps the preintegration runs
        past a buffer's end are exact no-ops."""
        longest = max((len(b) for b in self.bufs[1:self.W1] if b is not None),
                      default=0)
        M = max(IMU_BUCKET, -(-longest // IMU_BUCKET) * IMU_BUCKET)
        packs = [_pad_buffer(self.bufs[k], M) for k in range(1, self.W1)]
        imu_valid = np.array([self.bufs[k] is not None and len(self.bufs[k]) > 0
                              for k in range(1, self.W1)])
        return (np.stack([p[0] for p in packs]),
                np.stack([p[1] for p in packs]),
                np.stack([p[2] for p in packs]),
                np.stack([p[3] for p in packs]),
                np.stack([p[4] for p in packs]),
                np.stack([p[5] for p in packs]),
                imu_valid)

    def _pack_reproj_raw(self):
        """Raw reprojection grid arrays, host numpy."""
        F = self.cfg.max_features
        W1 = self.W1
        cands = self.fm.candidates()[:F]
        pts_i = np.zeros((F, 3))
        pts_i[:, 2] = 1.0
        pts_j = np.zeros((F, W1, 3))
        pts_j[:, :, 2] = 1.0
        start = np.zeros(F, dtype=np.int32)
        obs_mask = np.zeros((F, W1), dtype=bool)
        feat_valid = np.zeros(F, dtype=bool)
        for i, ft in enumerate(cands):
            start[i] = ft.start_frame
            pts_i[i] = ft.pts[0]
            feat_valid[i] = True
            for k, p in enumerate(ft.pts[1:], start=1):
                j = ft.start_frame + k
                if j <= self.W:
                    pts_j[i, j] = p
                    obs_mask[i, j] = True
        return pts_i, pts_j, start, obs_mask, feat_valid

    def _obs_cap(self, obs_mask) -> int:
        """Live-observation cap for the compacted assembly (window.assemble
        n_obs): the live count rounded up to a multiple of 512, capped at
        the grid size — the JAX package's bucket (there it bounds XLA
        recompiles), kept so both packages assemble the same rows."""
        live = int(np.asarray(obs_mask).sum())
        cap = max(512, ((live + 511) // 512) * 512)
        return min(cap, self.cfg.max_features * self.W1)

    def _backend_optimization(self):
        with trace.span("est.pack"):
            states = self._pack_states()
            imu_pack = self._pack_imu_raw()
            pts_i, pts_j, start, obs_mask, feat_valid = self._pack_reproj_raw()
            marg_old = self.marg_flag == MARGIN_OLD
            args = (states, *imu_pack, pts_i, pts_j, start, obs_mask, feat_valid,
                    self.H_prior, self.b_prior, self.err_prior, self.Jt_prior_inv,
                    self.g, self.noise_diag, np.float64(self.cfg.focal_length / 1.5))
            kw = dict(max_iter=self.cfg.max_num_iterations,
                      fix_ext=self.estimate_extrinsic == 0,
                      n_obs=self._obs_cap(obs_mask), marg_old=marg_old,
                      exact_noise=self.cfg.imu_noise_model == "exact",
                      device=self.device, dtype=self.dtype)

        # ONE device call for the whole frame (solver/frame_step.py):
        # preintegrate → LM solve → yaw-gauge re-fix → outlier errors →
        # marg subproblem; then ONE fetch of the result to the host.  On
        # the card it is the frame's captured graphs, replayed (a capture
        # or replay that fails raises); on the CPU the same functions run
        # eagerly.
        with trace.span("est.step"):
            if self.device.type == "cuda":
                out = frame_step.frame_step_graphed(*args, **kw)
            else:
                out = frame_step.fetch(frame_step.frame_step(*args, **kw))
        with trace.span("est.unpack"):
            self.b_prior = np.asarray(out.b_prior, np.float64)
            self.err_prior = np.asarray(out.err_prior, np.float64)
            self._unpack_states(out.states)

        # post-solve reprojection outlier rejection (the full VINS-Mono's
        # removeOutlier): features whose mean residual at the solution
        # exceeds the pixel gate are flagged and dropped by
        # remove_failures() after the slide — their constant measurement
        # offsets are inconsistent with any rigid point and bias the scale.
        if self.cfg.outlier_reproj_px > 0:
            with trace.span("est.outliers"):
                errs = np.asarray(out.feat_errs)
                gate = self.cfg.outlier_reproj_px / self.cfg.focal_length
                cands = self.fm.candidates()[:self.cfg.max_features]
                for i, ft in enumerate(cands):
                    if errs[i] > gate:
                        ft.solve_flag = 2

        # marginalization (estimator.cpp:1131-1142).  The prior CHAIN
        # (Schur of the evicted block + eigh pseudo-inverse + sqrt form)
        # runs in HOST float64: the prior is the window's long-memory
        # state and f32 rounding there compounds over a full run
        # (round-5 on-chip accuracy fix; the reference needed the same
        # care, problem.cc:747-779).  The factor linearization itself
        # came back from the fused device call (marg_Hpp/marg_bp).
        # The solve's record is built inside the prior's span too: that is
        # ``marg_ms``'s interval (the chain, the forgetting, the record).
        with trace.span("est.prior"):
            self._marginalize(out, marg_old)
            self.frame_solved += 1

            # per-solve structured telemetry (the reference prints these at
            # problem.cc:177,246-248; here they are machine-readable —
            # SURVEY §5.1/5.5); process_image adds the frame's spans and
            # appends it once the frame is done
            self._record = dict(
                t=float(self.headers[self.frame_count]),
                chi2_init=float(np.asarray(out.chi2_init)),
                chi2=float(np.asarray(out.chi2)),
                iterations=int(np.asarray(out.iterations)),
                lam=float(np.asarray(out.lam)),
                n_features=int(feat_valid.sum()),
                n_reproj_factors=int(obs_mask.sum()),
                n_imu_factors=int(imu_pack[6].sum()),
                marg="old" if self.marg_flag == MARGIN_OLD else "new",
                reads=int(out.reads),
            )

    def _marginalize(self, out, marg_old: bool):
        """The host float64 prior chain from the frame step's outputs, then
        the prior's forgetting."""
        if marg_old:
            Hp, bp, errp, Jtp = marginalize.finalize_old_from_blocks(
                out.marg_Hpp, out.marg_bp)
        else:
            Hp, bp, errp, Jtp = marginalize.marginalize_new_host(
                self.H_prior, self.b_prior)
        self.H_prior = np.asarray(Hp)
        self.b_prior = np.asarray(bp)
        self.err_prior = np.asarray(errp)
        self.Jt_prior_inv = np.asarray(Jtp)
        lam = self.cfg.prior_forgetting
        if 0.0 < lam < 1.0:
            # exponential information decay (covariance inflation): scale
            # the prior's sqrt-Jacobian by √λ so H → λH, b → λb, err → √λ·err
            rl = np.sqrt(lam)
            self.H_prior = self.H_prior * lam
            self.b_prior = self.b_prior * lam
            self.err_prior = self.err_prior * rl
            self.Jt_prior_inv = self.Jt_prior_inv / rl
        elif lam == 0.0:
            # prior dropped entirely (lam=0 would otherwise divide by zero)
            self.H_prior = np.zeros_like(self.H_prior)
            self.b_prior = np.zeros_like(self.b_prior)
            self.err_prior = np.zeros_like(self.err_prior)
            self.Jt_prior_inv = np.zeros_like(self.Jt_prior_inv)

    def _unpack_states(self, s: W.WindowStates):
        """double2vector unpack of the fetched gauge-fixed solution (the
        yaw-gauge re-fix itself runs inside frame_step,
        estimator.cpp:549-600)."""
        self.Rs = lie_np.quat_to_mat_np(np.asarray(s.Qs))
        self.Ps = np.asarray(s.Ps, np.float64).copy()
        self.Vs = np.asarray(s.Vs, np.float64).copy()
        self.Bas = np.asarray(s.Bas, np.float64).copy()
        self.Bgs = np.asarray(s.Bgs, np.float64).copy()
        if self.estimate_extrinsic != 0:
            # write back the optimized camera-IMU extrinsic
            # (double2vector, estimator.cpp:602-608)
            self.ric = lie_np.quat_to_mat_np(np.asarray(s.ext_q))
            self.tic = np.asarray(s.ext_t)

        inv_dep = np.asarray(s.inv_dep)
        cands = self.fm.candidates()[:self.cfg.max_features]
        self.fm.set_inv_depths(inv_dep[:len(cands)])

    # ------------------------------------------------------------------
    # relocalization feedback (estimator.cpp:622-642 setReloFrame lineage)
    # ------------------------------------------------------------------

    def apply_live_correction(self, dR, dt):
        """Rebase the LIVE window by an accepted loop's world correction
        (LoopCloser.drift_R/drift_t), so subsequent window solves
        linearize at the drift-corrected states — the reference's
        relocalization plumbing makes the loop constrain the live
        estimate, not only the exported trajectory (estimator.cpp:622-642
        relo_Pose drift-correct).

        Only the YAW component of dR is applied (plus the matching
        translation): gravity direction is observable in VIO, so pose
        drift lives in 4 DoF and a pitch/roll correction would fight the
        window's gravity alignment (the reason VINS's pose graph is
        4-DoF).  The marginalization prior is kept consistent to first
        order with the same b -= H·dx update rule the LM accept path uses
        (problem.cc:466-478).  Returns the (Ry, ty) actually applied."""
        dR = np.asarray(dR)
        dt = np.asarray(dt)
        ypr = lie_np.mat_to_ypr_np(dR)
        Ry = lie_np.ypr_to_mat_np(np.array([ypr[0], 0.0, 0.0]))
        # translation matched at the newest window frame: the full and the
        # yaw-only correction agree exactly where the loop was observed
        p_anchor = self.Ps[self.frame_count]
        ty = (dR @ p_anchor + dt) - Ry @ p_anchor

        dx = np.zeros(self.P)
        for i in range(self.W1):
            P_new = Ry @ self.Ps[i] + ty
            R_new = Ry @ self.Rs[i]
            V_new = Ry @ self.Vs[i]
            base = 6 + 15 * i
            dx[base:base + 3] = P_new - self.Ps[i]
            dx[base + 3:base + 6] = lie_np.so3_log_np(self.Rs[i].T @ R_new)
            dx[base + 6:base + 9] = V_new - self.Vs[i]
            self.Ps[i] = P_new
            self.Rs[i] = R_new
            self.Vs[i] = V_new
        self.b_prior = self.b_prior - self.H_prior @ dx
        self.err_prior = -(self.Jt_prior_inv @ self.b_prior)
        self.last_P = Ry @ self.last_P + ty
        self.last_R = Ry @ self.last_R
        return Ry, ty

    # ------------------------------------------------------------------
    # failure detection (estimator.cpp:645-691)
    # ------------------------------------------------------------------

    def _failure_detection(self) -> bool:
        # diagnostics the reference computes but leaves non-fatal
        # (estimator.cpp:647-651 little-feature, :679-688 big delta_angle —
        # both `return true` lines are commented out there)
        self.last_failure_diag = []
        if self.fm.last_track_num < 2:
            self.last_failure_diag.append("little_feature")
        if np.linalg.norm(self.Bas[self.W]) > 2.5:
            return True
        if np.linalg.norm(self.Bgs[self.W]) > 1.0:
            return True
        dp = self.Ps[self.W] - self.last_P
        if np.linalg.norm(dp) > 5.0:
            return True
        if abs(dp[2]) > 1.0:
            return True
        delta_R = self.Rs[self.W].T @ self.last_R
        cos_half = np.clip(0.5 * np.sqrt(max(1.0 + np.trace(delta_R), 0.0)),
                           -1.0, 1.0)
        if np.degrees(2.0 * np.arccos(cos_half)) > 50.0:
            self.last_failure_diag.append("big_delta_angle")
        return False

    # ------------------------------------------------------------------
    # window slide (slideWindow, estimator.cpp:1144-1264)
    # ------------------------------------------------------------------

    def _slide_window(self):
        if self.marg_flag == MARGIN_OLD:
            t0 = self.headers[0]
            back_R0 = self.Rs[0].copy()
            back_P0 = self.Ps[0].copy()
            if self.frame_count == self.W:
                for i in range(self.W):
                    self.Ps[i] = self.Ps[i + 1]
                    self.Rs[i] = self.Rs[i + 1]
                    self.Vs[i] = self.Vs[i + 1]
                    self.Bas[i] = self.Bas[i + 1]
                    self.Bgs[i] = self.Bgs[i + 1]
                    self.headers[i] = self.headers[i + 1]
                    self.bufs[i] = self.bufs[i + 1]
                self.Ps[self.W] = self.Ps[self.W - 1]
                self.Rs[self.W] = self.Rs[self.W - 1]
                self.Vs[self.W] = self.Vs[self.W - 1]
                self.Bas[self.W] = self.Bas[self.W - 1]
                self.Bgs[self.W] = self.Bgs[self.W - 1]
                self.headers[self.W] = self.headers[self.W - 1]
                self.bufs[self.W] = IntervalBuffer(self.acc_0, self.gyr_0)
                # drop pre-window frames from the init archive
                self.all_frames = [r for r in self.all_frames if r.t > t0]
                self._slide_window_old(back_R0, back_P0)
        else:
            if self.frame_count == self.W:
                # merge the newest interval into the previous one
                if self.bufs[self.W] is not None:
                    if self.bufs[self.W - 1] is None:
                        self.bufs[self.W - 1] = IntervalBuffer(
                            self.bufs[self.W].acc0, self.bufs[self.W].gyr0)
                    self.bufs[self.W - 1].merge_from(self.bufs[self.W])
                self.Ps[self.W - 1] = self.Ps[self.W]
                self.Rs[self.W - 1] = self.Rs[self.W]
                self.Vs[self.W - 1] = self.Vs[self.W]
                self.Bas[self.W - 1] = self.Bas[self.W]
                self.Bgs[self.W - 1] = self.Bgs[self.W]
                self.headers[self.W - 1] = self.headers[self.W]
                self.bufs[self.W] = IntervalBuffer(self.acc_0, self.gyr_0)
                self.fm.remove_front(self.frame_count)

    def _slide_window_old(self, back_R0, back_P0):
        if self.solver_flag == SOLVER_NON_LINEAR:
            R0 = back_R0 @ self.ric
            P0 = back_P0 + back_R0 @ self.tic
            R1 = self.Rs[0] @ self.ric
            P1 = self.Ps[0] + self.Rs[0] @ self.tic
            self.fm.remove_back_shift_depth(R0, P0, R1, P1)
        else:
            self.fm.remove_back()

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self.solver_flag == SOLVER_NON_LINEAR

    def latest_pose(self):
        """(t, p_wb, R_wb) of the newest window frame; with loop closing,
        corrected by the closer's drift (``LoopCloser.live_correct``)."""
        p, R = self.Ps[self.frame_count].copy(), self.Rs[self.frame_count].copy()
        if self.closer is not None:
            p, R = self.closer.live_correct(p, R)
        return self.headers[self.frame_count], p, R

    def current_landmarks(self):
        """Local reconstruction at the newest frame for loop closing:
        (ids, xy (N, 2) normalized coords in the newest frame, pts_cam
        (N, 3) 3D points in the newest CAMERA frame) for features observed
        now with a solved depth (the relocalization side data of
        estimator.cpp:622-642 / setReloFrame).

        Callers (``_add_keyframe``, runner on_frame hooks) see the
        estimator AFTER the window slide, where the just-processed frame's
        observations sit at index frame_count-1 (the slide copied its
        states up to frame_count, so both indices hold the same pose)."""
        fts = self.fm.features.values()
        j = max((ft.end_frame for ft in fts), default=self.frame_count)
        R_wc_j = self.Rs[j] @ self.ric
        t_wc_j = self.Ps[j] + self.Rs[j] @ self.tic
        ids, xys, pts = [], [], []
        for ft in self.fm.features.values():
            if ft.end_frame == j and ft.depth > 0:
                i = ft.start_frame
                R_wc_i = self.Rs[i] @ self.ric
                t_wc_i = self.Ps[i] + self.Rs[i] @ self.tic
                X_w = R_wc_i @ (ft.pts[0] * ft.depth) + t_wc_i
                X_cj = R_wc_j.T @ (X_w - t_wc_j)
                p = ft.pts[-1]
                ids.append(ft.feature_id)
                xys.append(p[:2] / p[2])
                pts.append(X_cj)
        if not ids:
            return (np.zeros(0, np.int64), np.zeros((0, 2)),
                    np.zeros((0, 3)))
        return (np.asarray(ids), np.stack(xys), np.stack(pts))
