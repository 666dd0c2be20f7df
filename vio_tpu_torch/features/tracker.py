"""Visual frontend: the KLT feature tracker over camera streams.

Port of ``vio_tpu/features/tracker.py`` (reference:
vins-mono/src/feature_tracker.cpp:81-305 readImage — KLT tracking,
RANSAC-F outlier rejection, min-distance replenishment, undistortion +
per-feature normalized-plane velocity).

Split of labor: the per-frame device work (pyramids, batched KLT,
Shi-Tomasi + NMS detection, the RANSAC hypothesis sweep) runs with STATIC
capacity N (id bookkeeping masks); the tiny id/track-count bookkeeping
lives on the host in numpy, so every result the bookkeeping reads is a
device-to-host copy.  When ``equalize`` is on, frames pass through
device-side CLAHE first (features/clahe.py), matching the reference's
cv::CLAHE(3.0, 8×8) at feature_tracker.cpp:89-91.
"""
from __future__ import annotations

import numpy as np
import torch

from . import clahe as clahe_mod
from . import detect, klt
from ..device import resolve
from ..init import sfm


class FeatureTracker:
    """Stateful host wrapper over the device tracking functions.

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
        self.cam = camera
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.f_thresh = f_thresh_px / focal
        self.fb_thresh = fb_thresh
        self.equalize = equalize
        self.clahe_clip = clahe_clip
        self.levels = levels
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
        self.prev_img = None
        self.prev_t = None
        self.pos = np.zeros((max_cnt, 2))         # pixel positions
        self.ids = -np.ones(max_cnt, dtype=np.int64)
        self.track_cnt = np.zeros(max_cnt, dtype=np.int64)
        self.prev_un = np.zeros((max_cnt, 2))     # normalized coords
        self.next_id = 0

    @property
    def valid(self):
        return self.ids >= 0

    def _positions(self, a):
        """Host positions → device tensor in the tracker's dtype."""
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _flags(self, a):
        return torch.as_tensor(a, dtype=torch.bool, device=self.device)

    def _lift(self, a):
        """Undistort host pixel positions on the device; float64 on the
        host."""
        return self.cam.lift(self._positions(a)).cpu().numpy().astype(np.float64)

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
        img_d = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        if self.equalize:
            img_d = clahe_mod.clahe(img_d, clip_limit=self.clahe_clip)

        if self.prev_img is not None and bool(np.any(self.valid)):
            p1, ok, _ = klt.track_fb(self.prev_img, img_d,
                                     self._positions(self.pos),
                                     self._flags(self.valid),
                                     levels=self.levels,
                                     fb_thresh=self.fb_thresh)
            # drift-free refinement against the birth templates: the
            # frame-to-frame estimate only seeds the search.  A track whose
            # refinement fails is KILLED, not left to drift on the
            # frame-to-frame estimate (SVO-style alignment gate).
            p_ref, ok_ref, _ = klt.refine_on_templates(
                img_d, torch.as_tensor(self.tmpl_T, device=self.device),
                torch.as_tensor(self.tmpl_Gx, device=self.device),
                torch.as_tensor(self.tmpl_Gy, device=self.device), p1, ok)
            p1 = p_ref.cpu().numpy().astype(np.float64)
            ok = ok.cpu().numpy() & ok_ref.cpu().numpy() & self.valid
            # RANSAC-F outlier rejection on normalized coords
            # (rejectWithF, feature_tracker.cpp:169-202)
            if ok.sum() >= 15:
                un0 = self._lift(self.pos)
                un1 = self._lift(p1)
                _, inl, n_inl = sfm.essential_ransac(
                    self._positions(un0), self._positions(un1),
                    self._flags(ok), self._ransac_generator(),
                    thresh=self.f_thresh)
                if int(n_inl) >= 8:
                    ok &= inl.cpu().numpy()
            self.pos = np.where(ok[:, None], p1, self.pos)
            self.ids = np.where(ok, self.ids, -1)
            self.track_cnt = np.where(ok, self.track_cnt + 1, 0)
            self._enforce_min_dist()

        # replenish with new detections away from current tracks
        n_live = int(self.valid.sum())
        n_new = self.max_cnt - n_live
        new_slots = []
        if n_new > 0:
            occ = detect.occupancy_from_points(
                img.shape, self._positions(self.pos), self._flags(self.valid),
                self.min_dist)
            xy, _, dvalid = detect.detect(
                img_d, occ, max_corners=self.max_cnt,
                min_dist=self.min_dist)
            xy = xy.cpu().numpy()
            dvalid = dvalid.cpu().numpy()
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
            T, Gx, Gy = klt.sample_templates(img_d, self._positions(self.pos))
            self.tmpl_T[upd] = T.cpu().numpy()[upd]
            self.tmpl_Gx[upd] = Gx.cpu().numpy()[upd]
            self.tmpl_Gy[upd] = Gy.cpu().numpy()[upd]

        # undistort + velocities (undistortedPoints,
        # feature_tracker.cpp:258-305)
        un = self._lift(self.pos)
        dt = (t - self.prev_t) if self.prev_t is not None else None
        out = {}
        for slot in np.where(self.valid & (self.track_cnt > 1))[0]:
            vel = ((un[slot] - self.prev_un[slot]) / dt
                   if dt else np.zeros(2))
            out[int(self.ids[slot])] = (
                np.array([un[slot, 0], un[slot, 1], 1.0]),
                self.pos[slot].copy(), vel)

        self.prev_img = img_d
        self.prev_t = t
        self.prev_un = un
        self.frame_idx += 1
        return out
