"""Visual frontend: the KLT feature tracker over camera streams.

Port of ``vio_tpu/features/tracker.py`` (reference:
vins-mono/src/feature_tracker.cpp:81-305 readImage — KLT tracking,
RANSAC-F outlier rejection, min-distance replenishment, undistortion +
per-feature normalized-plane velocity).

Split of labor: the per-frame device work (pyramids, batched KLT,
Shi-Tomasi + NMS detection, the RANSAC hypothesis sweep) runs with STATIC
capacity N (id bookkeeping masks); the tiny id/track-count bookkeeping
lives on the host in numpy.  The device work is a handful of pure
programs of static-shaped inputs, one per jitted call of ``vio_tpu``'s
tracker (merged where ``vio_tpu`` does no host work between them; see
``_programs``).  On the card each is a CUDA graph captured once per
``TrackerKey`` (``solver/graph.py``'s ``ProgramGraph``): one upload, one
replay and one read a call.  On the CPU the same functions run eagerly.
The frame's image stays on the device, in the tracker's own buffer
(``prev_img``), from one frame to the next.  When ``equalize`` is on,
frames pass through device-side CLAHE first (features/clahe.py),
matching the reference's cv::CLAHE(3.0, 8×8) at feature_tracker.cpp:89-91.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import clahe as clahe_mod
from . import detect, klt
from ..device import resolve
from ..init import sfm
from ..solver import graph

KLT_ITERS = 10     # klt.track_fb's iterations a level, as vio_tpu's tracker runs it
N_HYP = 256        # RANSAC hypotheses a frame (sfm.essential_ransac's default)


class TrackerKey(NamedTuple):
    """What the tracker's captured programs are specialised on: what
    ``jax.jit`` holds static in ``vio_tpu``'s tracker (the shapes, the
    tracker's options), the camera (a capture bakes its parameters in),
    the dtype of the positions and the device."""
    shape: tuple
    max_cnt: int
    levels: int
    n_iters: int
    fb_thresh: float
    equalize: bool
    clahe_clip: float
    min_dist: int
    n_hyp: int
    f_thresh: float
    camera: tuple
    dtype: torch.dtype
    device: torch.device


def _programs(key: TrackerKey, camera) -> dict:
    """name → (input specs, fn) of the tracker's device programs; each fn
    takes its inputs (host arrays' tensors first, then device tensors) and
    returns (outputs for the host, tensors kept on the device):

    - image: [clahe] of the frame → kept: the frame (no tracking this frame);
    - track: [clahe] + ``klt.track_fb`` + ``klt.refine_on_templates`` →
      p_ref, ok; kept: the frame;
    - reject: ``lift(pos)``, ``lift(p1)`` + ``sfm.essential_ransac_from_samples``
      → inl, n_inl;
    - detect: ``detect.occupancy_from_points`` + ``detect.detect`` → xy, dvalid;
    - templates: ``klt.sample_templates`` → T, Gx, Gy;
    - lift: ``lift(pos)``."""
    H, W = key.shape
    N = key.max_cnt
    P2 = (2 * klt.REFINE_HALF + 1) ** 2
    f32, b, pos = torch.float32, torch.bool, key.dtype
    img_s, pos_s, flag_s, tmpl_s = ((H, W), f32), ((N, 2), pos), ((N,), b), ((N, P2), f32)

    def frame(img):
        if key.equalize:
            return clahe_mod.clahe(img, clip_limit=key.clahe_clip)
        return img.clone()

    def image(img):
        return [], [frame(img)]

    def track(img, p0, valid, T, Gx, Gy, prev):
        cur = frame(img)
        p1, ok, _ = klt.track_fb(prev, cur, p0, valid, levels=key.levels,
                                 n_iters=key.n_iters, fb_thresh=key.fb_thresh)
        # drift-free refinement against the birth templates: the
        # frame-to-frame estimate only seeds the search
        p_ref, ok_ref, _ = klt.refine_on_templates(cur, T, Gx, Gy, p1, ok)
        return [p_ref, ok & ok_ref], [cur]

    def reject(p0, p1, ok, idx):
        _, inl, n_inl = sfm.essential_ransac_from_samples(
            camera.lift(p0), camera.lift(p1), ok, idx, thresh=key.f_thresh)
        return [inl, n_inl], []

    def replenish(p0, valid, img):
        occ = detect.occupancy_from_points((H, W), p0, valid, key.min_dist)
        xy, _, dvalid = detect.detect(img, occ, max_corners=key.max_cnt,
                                      min_dist=key.min_dist)
        return [xy, dvalid], []

    def templates(p0, img):
        return list(klt.sample_templates(img, p0)), []

    def lift(p0):
        return [camera.lift(p0)], []

    return dict(
        image=([img_s], image),
        track=([img_s, pos_s, flag_s, tmpl_s, tmpl_s, tmpl_s, img_s], track),
        reject=([pos_s, pos_s, flag_s, ((key.n_hyp, 8), torch.int64)], reject),
        detect=([pos_s, flag_s, img_s], replenish),
        templates=([pos_s, img_s], templates),
        lift=([pos_s], lift))


class FeatureTracker:
    """Stateful host wrapper over the device tracking programs.

    ``device=None`` is the CUDA device and raises without one
    (``device.resolve``).  Images are float32 on every device; positions
    are ``dtype`` (float32 on CUDA, float64 on the CPU, unless given)."""

    def __init__(self, camera, max_cnt: int = 150, min_dist: int = 30,
                 f_thresh_px: float = 1.0, focal: float = 460.0,
                 fb_thresh: float = 0.5, seed: int = 0,
                 equalize: bool = False, clahe_clip: float = 3.0,
                 levels: int = 3, reanchor_every: int = 25,
                 device=None, dtype=None):
        self.device, self.dtype = resolve(device, dtype)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cam = camera
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.f_thresh = f_thresh_px / focal
        self.fb_thresh = fb_thresh
        self.equalize = equalize
        self.clahe_clip = clahe_clip
        self.levels = levels
        self.n_iters = KLT_ITERS
        self.n_hyp = N_HYP
        # drift-free anchoring: per-feature birth templates (see
        # klt.sample_templates); re-anchored every `reanchor_every` frames
        # so real-scene appearance change stays within the basin
        # (0 = never re-anchor)
        self.reanchor_every = reanchor_every
        npatch = (2 * klt.REFINE_HALF + 1) ** 2
        self.tmpl_T = np.zeros((max_cnt, npatch), np.float32)
        self.tmpl_Gx = np.zeros((max_cnt, npatch), np.float32)
        self.tmpl_Gy = np.zeros((max_cnt, npatch), np.float32)
        # deterministic, frame-counted RANSAC stream: frame k draws from a
        # generator seeded by (seed, k) alone, so reruns on the same data
        # are reproducible regardless of timestamp values
        self.seed = seed
        self.frame_idx = 0
        self.prev_img = None      # the last frame's (equalized) image, on the device
        self.prev_t = None
        self.pos = np.zeros((max_cnt, 2))         # pixel positions
        self.ids = -np.ones(max_cnt, dtype=np.int64)
        self.track_cnt = np.zeros(max_cnt, dtype=np.int64)
        self.prev_un = np.zeros((max_cnt, 2))     # normalized coords
        self.next_id = 0
        self._progs = {}

    @property
    def valid(self):
        return self.ids >= 0

    def key(self, shape) -> TrackerKey:
        """The key of this tracker's programs for images of ``shape``."""
        cam = (type(self.cam).__name__, dataclasses.astuple(self.cam))
        return TrackerKey(tuple(int(n) for n in shape), int(self.max_cnt), int(self.levels),
                          int(self.n_iters), float(self.fb_thresh), bool(self.equalize),
                          float(self.clahe_clip), int(self.min_dist), int(self.n_hyp),
                          float(self.f_thresh), cam, self.dtype, self.device)

    def _program(self, name, key):
        if key not in self._progs:
            self._progs[key] = _programs(key, self.cam)
        return self._progs[key][name]

    def _run(self, name, key, host, device=(), keep=()):
        """Program ``name``: replayed from its captured graph on the card,
        run eagerly on the CPU.  Returns its outputs as host arrays."""
        if self.device.type != "cuda":
            return self._run_eager(name, key, host, device, keep)
        specs, fn = self._program(name, key)
        return graph.program_graph((name, key), specs, fn, self.device).run(
            host, device, keep)

    def _run_eager(self, name, key, host, device=(), keep=()):
        specs, fn = self._program(name, key)
        return graph.run_eagerly(specs, fn, host, device, keep, on=self.device)

    def _ransac_generator(self) -> torch.Generator:
        return torch.Generator().manual_seed(
            (self.seed % (1 << 31)) * (1 << 32) + self.frame_idx)

    def _enforce_min_dist(self):
        """Mutual min-distance exclusion between live tracks: when two come
        within min_dist, the longer track survives (the reference's setMask
        walk in descending track_cnt order, feature_tracker.cpp:36-79 —
        tracks landing inside an earlier track's masked disk are dropped).
        Prevents two merging image features from feeding duplicate /
        captured measurements into the BA."""
        live = np.where(self.valid)[0]
        if len(live) < 2:
            return
        order = live[np.argsort(-self.track_cnt[live], kind="stable")]
        kept_pos = []
        md2 = float(self.min_dist) ** 2
        for slot in order:
            p = self.pos[slot]
            if kept_pos and np.min(np.sum((np.asarray(kept_pos) - p) ** 2,
                                          axis=1)) < md2:
                self.ids[slot] = -1
                self.track_cnt[slot] = 0
            else:
                kept_pos.append(p)

    def read_image(self, img: np.ndarray, t: float):
        """Process one frame.  Returns {feature_id: (bearing(3,), uv(2,),
        vel(2,))} for features with track_cnt > 1 (the reference only
        publishes re-observed features, System.cpp:228-266)."""
        img = np.asarray(img, dtype=np.float32)
        key = self.key(img.shape)
        have_prev = self.prev_img is not None
        if have_prev and tuple(self.prev_img.shape) != img.shape:
            raise ValueError(f"FeatureTracker.read_image: a {img.shape} image after "
                             f"{tuple(self.prev_img.shape)} ones; a stream keeps its size")
        if not have_prev:
            self.prev_img = torch.empty(img.shape, dtype=torch.float32, device=self.device)

        if have_prev and bool(np.any(self.valid)):
            # frame-to-frame KLT, then drift-free refinement against the
            # birth templates: a track whose refinement fails is KILLED,
            # not left to drift on the frame-to-frame estimate (SVO-style
            # alignment gate).  The frame replaces the previous one in
            # prev_img.
            p1, ok = self._run("track", key, [img, self.pos, self.valid, self.tmpl_T,
                                               self.tmpl_Gx, self.tmpl_Gy],
                               [self.prev_img], keep=[self.prev_img])
            p1 = p1.astype(np.float64)
            ok = ok & self.valid
            # RANSAC-F outlier rejection on normalized coords
            # (rejectWithF, feature_tracker.cpp:169-202)
            if ok.sum() >= 15:
                idx = sfm.ransac_samples(ok, key.n_hyp, self._ransac_generator())
                inl, n_inl = self._run("reject", key, [self.pos, p1, ok, idx.numpy()])
                if int(n_inl) >= 8:
                    ok &= inl
            self.pos = np.where(ok[:, None], p1, self.pos)
            self.ids = np.where(ok, self.ids, -1)
            self.track_cnt = np.where(ok, self.track_cnt + 1, 0)
            self._enforce_min_dist()
        else:
            self._run("image", key, [img], keep=[self.prev_img])

        # replenish with new detections away from current tracks
        n_live = int(self.valid.sum())
        n_new = self.max_cnt - n_live
        new_slots = []
        if n_new > 0:
            xy, dvalid = self._run("detect", key, [self.pos, self.valid], [self.prev_img])
            free = np.where(~self.valid)[0]
            picked = np.where(dvalid)[0][:len(free)]
            for slot, k in zip(free, picked):
                self.pos[slot] = xy[k]
                self.ids[slot] = self.next_id
                self.track_cnt[slot] = 1
                self.next_id += 1
                new_slots.append(slot)

        # capture / refresh birth templates (new features always;
        # established ones on the re-anchor cadence)
        upd = np.zeros(self.max_cnt, bool)
        upd[new_slots] = True
        if self.reanchor_every > 0:
            upd |= self.valid & (self.track_cnt > 1) & \
                   (self.track_cnt % self.reanchor_every == 0)
        if upd.any():
            T, Gx, Gy = self._run("templates", key, [self.pos], [self.prev_img])
            self.tmpl_T[upd] = T[upd]
            self.tmpl_Gx[upd] = Gx[upd]
            self.tmpl_Gy[upd] = Gy[upd]

        # undistort + velocities (undistortedPoints,
        # feature_tracker.cpp:258-305)
        un = self._run("lift", key, [self.pos])[0].astype(np.float64)
        dt = (t - self.prev_t) if self.prev_t is not None else None
        out = {}
        for slot in np.where(self.valid & (self.track_cnt > 1))[0]:
            vel = ((un[slot] - self.prev_un[slot]) / dt
                   if dt else np.zeros(2))
            out[int(self.ids[slot])] = (
                np.array([un[slot, 0], un[slot, 1], 1.0]),
                self.pos[slot].copy(), vel)

        self.prev_t = t
        self.prev_un = un
        self.frame_idx += 1
        return out
