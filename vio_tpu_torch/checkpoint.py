"""Estimator checkpoint / resume.

Port of ``vio_tpu/checkpoint.py``.  The reference has no state
checkpointing (append-only pose logs plus pose-graph save flags that are
read but unused, config/euroc_config.yaml:66-70).  A production service needs to survive
restarts mid-sequence, so this serializes the FULL estimator state — window
arrays, marginalization prior (H/b/err/Jt), IMU interval buffers, the
feature table, and the pre-init frame archive — as one compressed npz of
plain arrays (orbax-style: pure data, no pickled code objects), and
restores an Estimator that continues bit-for-bit.  The file holds host
numpy arrays only, in the JAX package's layout: a checkpoint written by
either package loads in the other.
"""
from __future__ import annotations

import json

import numpy as np

from .config import VioConfig
from .estimator import Estimator, FrameRec, IntervalBuffer


def _pack_buf(buf: IntervalBuffer | None):
    if buf is None or len(buf) == 0:
        anchor = (buf.acc0, buf.gyr0) if buf is not None else (np.zeros(3),
                                                               np.zeros(3))
        return dict(n=0 if buf is None else -1,
                    dts=np.zeros(0), accs=np.zeros((0, 3)),
                    gyrs=np.zeros((0, 3)), acc0=anchor[0], gyr0=anchor[1])
    return dict(n=len(buf), dts=np.asarray(buf.dts),
                accs=np.stack(buf.accs), gyrs=np.stack(buf.gyrs),
                acc0=buf.acc0, gyr0=buf.gyr0)


def _unpack_buf(d):
    n = int(d["n"])
    if n == 0:
        return None
    buf = IntervalBuffer(d["acc0"], d["gyr0"])
    for k in range(max(n, 0)):
        buf.push(float(d["dts"][k]), d["accs"][k], d["gyrs"][k])
    return buf


def _cfg_fields(cfg: VioConfig) -> dict:
    """The configuration as the file holds it: the loop-closing fields,
    which the JAX package's configuration lacks, only where one differs
    from its default, so that a file without loop closing loads in both
    packages.  The closer's state is not saved (``LoopCloser.save``)."""
    default = VioConfig()
    return {k: v for k, v in cfg.__dict__.items()
            if not k.startswith("loop_") or v != getattr(default, k)}


def save(est: Estimator, path: str):
    """Write the full estimator state to one .npz file."""
    arrays = {}
    meta = dict(
        frame_count=est.frame_count, first_imu=est.first_imu,
        solver_flag=est.solver_flag, marg_flag=est.marg_flag,
        estimate_extrinsic=est.estimate_extrinsic,
        failure_count=est.failure_count, frame_solved=est.frame_solved,
        initial_timestamp=est.initial_timestamp,
        last_track_num=est.fm.last_track_num,
        cfg=_cfg_fields(est.cfg),
    )
    for name in ("Ps", "Rs", "Vs", "Bas", "Bgs", "headers", "acc_0",
                 "gyr_0", "g", "H_prior", "b_prior", "err_prior",
                 "Jt_prior_inv", "last_P", "last_R"):
        arrays[name] = np.asarray(getattr(est, name))
    arrays["ric"] = np.asarray(est.ric)
    arrays["tic"] = np.asarray(est.tic)

    def put_buf(prefix, buf):
        for k, v in _pack_buf(buf).items():
            arrays[f"{prefix}_{k}"] = np.asarray(v)

    for i, buf in enumerate(est.bufs):
        put_buf(f"buf{i}", buf)
    put_buf("tmpbuf", est.tmp_buf)

    # feature table (SoA arrays + ragged offsets)
    feats = list(est.fm.features.values())
    meta["n_features"] = len(feats)
    if feats:
        arrays["ft_id"] = np.asarray([f.feature_id for f in feats])
        arrays["ft_start"] = np.asarray([f.start_frame for f in feats])
        arrays["ft_depth"] = np.asarray([f.depth for f in feats])
        arrays["ft_flag"] = np.asarray([f.solve_flag for f in feats])
        arrays["ft_len"] = np.asarray([len(f.pts) for f in feats])
        arrays["ft_pts"] = np.concatenate([np.stack(f.pts) for f in feats])
        arrays["ft_vels"] = np.concatenate([np.stack(f.vels) for f in feats])

    # pre-init frame archive (all_frames): needed to re-initialize after a
    # failure reset; feats maps stored as flat arrays per frame
    meta["n_frames_arch"] = len(est.all_frames)
    for i, rec in enumerate(est.all_frames):
        arrays[f"af{i}_t"] = np.asarray(rec.t)
        arrays[f"af{i}_R"] = rec.R
        arrays[f"af{i}_T"] = rec.T
        arrays[f"af{i}_kf"] = np.asarray(rec.is_key_frame)
        ids = np.asarray(sorted(rec.feats.keys()), dtype=np.int64)
        arrays[f"af{i}_ids"] = ids
        arrays[f"af{i}_xyz"] = np.stack(
            [np.asarray(rec.feats[j][0]) for j in ids]) if len(ids) else \
            np.zeros((0, 3))
        arrays[f"af{i}_uv"] = np.stack(
            [np.asarray(rec.feats[j][1]) for j in ids]) if len(ids) else \
            np.zeros((0, 2))
        arrays[f"af{i}_vel"] = np.stack(
            [np.asarray(rec.feats[j][2]) for j in ids]) if len(ids) else \
            np.zeros((0, 2))
        put_buf(f"af{i}_buf", rec.buf)

    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load(path: str, device=None, dtype=None) -> Estimator:
    """Restore an Estimator that continues exactly where save() left off.
    ``device``/``dtype`` place its device work as in ``Estimator``: the
    CUDA device unless the caller passes ``device="cpu"``."""
    z = np.load(path if path.endswith(".npz") else path + ".npz",
                allow_pickle=False)
    meta = json.loads(bytes(z["__meta__"]).decode())
    cfg = VioConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in meta["cfg"].items()})
    est = Estimator(cfg, device=device, dtype=dtype)
    for name in ("Ps", "Rs", "Vs", "Bas", "Bgs", "headers", "acc_0",
                 "gyr_0", "g", "H_prior", "b_prior", "err_prior",
                 "Jt_prior_inv", "last_P", "last_R"):
        setattr(est, name, np.array(z[name]))
    est.ric = np.array(z["ric"])
    est.tic = np.array(z["tic"])
    est.frame_count = int(meta["frame_count"])
    est.first_imu = bool(meta["first_imu"])
    est.solver_flag = int(meta["solver_flag"])
    est.marg_flag = int(meta["marg_flag"])
    est.estimate_extrinsic = int(meta["estimate_extrinsic"])
    est.failure_count = int(meta["failure_count"])
    est.frame_solved = int(meta["frame_solved"])
    est.initial_timestamp = float(meta["initial_timestamp"])
    est.fm.last_track_num = int(meta["last_track_num"])

    def get_buf(prefix):
        return _unpack_buf({k: z[f"{prefix}_{k}"] for k in
                            ("n", "dts", "accs", "gyrs", "acc0", "gyr0")})

    est.bufs = [get_buf(f"buf{i}") for i in range(est.W1)]
    est.tmp_buf = get_buf("tmpbuf")

    from .feature_manager import Feature
    est.fm.features = {}
    if meta["n_features"]:
        off = 0
        for n in range(meta["n_features"]):
            ft = Feature(int(z["ft_id"][n]), int(z["ft_start"][n]))
            L = int(z["ft_len"][n])
            ft.pts = [z["ft_pts"][off + k].copy() for k in range(L)]
            ft.vels = [z["ft_vels"][off + k].copy() for k in range(L)]
            off += L
            ft.depth = float(z["ft_depth"][n])
            ft.solve_flag = int(z["ft_flag"][n])
            est.fm.features[ft.feature_id] = ft

    est.all_frames = []
    for i in range(meta["n_frames_arch"]):
        ids = z[f"af{i}_ids"]
        feats = {int(j): (z[f"af{i}_xyz"][k], z[f"af{i}_uv"][k],
                          z[f"af{i}_vel"][k])
                 for k, j in enumerate(ids)}
        rec = FrameRec(float(z[f"af{i}_t"]), feats, get_buf(f"af{i}_buf"))
        rec.R = np.array(z[f"af{i}_R"])
        rec.T = np.array(z[f"af{i}_T"])
        rec.is_key_frame = bool(z[f"af{i}_kf"])
        est.all_frames.append(rec)
    return est
