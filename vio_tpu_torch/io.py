"""Dataset IO: EuRoC ASL loading, reference-format simulator CSVs.

Numpy copy of ``vio_tpu/io.py``; quaternions come from
``utils/lie_np`` and the simulator's motion from the port's ``sim``.

Re-derivation of the reference entry-point IO
(reference: vins-mono/test/run_euroc.cpp:26-91 — imu0/cam0 txt index
playback; test/run_vio_simulation.cpp:35-242 — simulator CSV parsing;
System.cpp:437-443 TUM-ish pose output).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class EurocData:
    """One EuRoC ASL sequence (timestamps in seconds)."""
    imu_t: np.ndarray      # (N,)
    acc: np.ndarray        # (N, 3)
    gyr: np.ndarray        # (N, 3)
    cam_t: np.ndarray      # (M,)
    cam_files: list        # (M,) absolute image paths
    gt_t: np.ndarray | None = None
    gt_p: np.ndarray | None = None
    gt_q: np.ndarray | None = None   # (x, y, z, w)


def load_euroc(seq_dir: str) -> EurocData:
    """Load a EuRoC sequence from its `mav0/` layout."""
    mav = os.path.join(seq_dir, "mav0") if \
        os.path.isdir(os.path.join(seq_dir, "mav0")) else seq_dir

    imu = np.loadtxt(os.path.join(mav, "imu0", "data.csv"),
                     delimiter=",", skiprows=1)
    imu_t = imu[:, 0] * 1e-9
    gyr = imu[:, 1:4]
    acc = imu[:, 4:7]

    cam_csv = os.path.join(mav, "cam0", "data.csv")
    cam_rows = []
    with open(cam_csv) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            ts, fn = line.strip().split(",")[:2]
            cam_rows.append((float(ts) * 1e-9,
                             os.path.join(mav, "cam0", "data", fn)))
    cam_t = np.array([r[0] for r in cam_rows])
    cam_files = [r[1] for r in cam_rows]

    gt_t = gt_p = gt_q = None
    gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        gt = np.loadtxt(gt_csv, delimiter=",", skiprows=1)
        gt_t = gt[:, 0] * 1e-9
        gt_p = gt[:, 1:4]
        # EuRoC stores (w, x, y, z) → ours is (x, y, z, w)
        gt_q = np.concatenate([gt[:, 5:8], gt[:, 4:5]], axis=1)
    return EurocData(imu_t=imu_t, acc=acc, gyr=gyr, cam_t=cam_t,
                     cam_files=cam_files, gt_t=gt_t, gt_p=gt_p, gt_q=gt_q)


def load_imu_txt(path: str):
    """Load a whitespace-separated raw IMU stream
    ``timestamp_ns gx gy gz ax ay az`` — the file format the reference's
    EuRoC driver replays (run_euroc.cpp:26-60, PubImuData over
    MH_05_imu0.txt).  Returns (t_s (N,), acc (N,3), gyr (N,3))."""
    raw = np.loadtxt(path)
    t = raw[:, 0] * 1e-9
    gyr = raw[:, 1:4]
    acc = raw[:, 4:7]
    return t, acc, gyr


def load_cam_stamps_txt(path: str):
    """Load a ``timestamp_ns filename`` camera index (run_euroc.cpp:63-91,
    MH_05_cam0.txt).  Returns (t_s (M,), filenames list)."""
    ts, names = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            ts.append(float(parts[0]) * 1e-9)
            names.append(parts[1] if len(parts) > 1 else "")
    return np.asarray(ts), names


def load_image(path: str) -> np.ndarray:
    """Load one grayscale frame as float32 (H, W) in [0, 255].  EuRoC ships
    8-bit PNGs (decoded via PIL); `.npy` arrays are accepted for synthetic
    sequences."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float32)


def write_euroc(data, out_dir: str, n_frames: int | None = None,
                image_format: str = "npy", render_kw: dict | None = None):
    """Write a SimData sequence in the EuRoC ASL layout (mav0/imu0/data.csv,
    mav0/cam0/{data.csv,data/*}, state_groundtruth_estimate0) with frames
    rendered by sim.render_image — a self-contained end-to-end harness for
    the run_euroc path without the (absent) real dataset."""
    from . import sim as sim_mod
    from .utils.lie_np import mat_to_quat_np

    mav = os.path.join(out_dir, "mav0")
    cam_data = os.path.join(mav, "cam0", "data")
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    os.makedirs(cam_data, exist_ok=True)
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"), exist_ok=True)

    with open(os.path.join(mav, "imu0", "data.csv"), "w") as fh:
        fh.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t, g, a in zip(data.imu_t, data.gyr, data.acc):
            fh.write(f"{int(round(t * 1e9))},{g[0]},{g[1]},{g[2]},"
                     f"{a[0]},{a[1]},{a[2]}\n")

    n = len(data.cam_t) if n_frames is None else min(n_frames, len(data.cam_t))
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as fh:
        fh.write("#timestamp [ns],filename\n")
        for k in range(n):
            ns = int(round(data.cam_t[k] * 1e9))
            img = sim_mod.render_image(data, k, **(render_kw or {}))
            if image_format == "npy":
                fn = f"{ns}.npy"
                np.save(os.path.join(cam_data, fn), img.astype(np.float32))
            else:
                from PIL import Image
                fn = f"{ns}.png"
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(cam_data, fn))
            fh.write(f"{ns},{fn}\n")

    qs = mat_to_quat_np(data.imu_R)  # x,y,z,w
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
              "w") as fh:
        fh.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for k in range(n):
            p, q = data.imu_p[k], qs[k]
            fh.write(f"{int(round(data.cam_t[k] * 1e9))},"
                     f"{p[0]},{p[1]},{p[2]},{q[3]},{q[0]},{q[1]},{q[2]}\n")


# ---------------------------------------------------------------------------
# Reference-simulator CSV round trip (drop-in compatibility with the
# reference's evaluation tooling: imu_pose.txt "t qw qx qy qz px py pz ..."
# and keyframe/all_points_<k>.txt "x_w y_w z_w 1 u_n v_n" per landmark,
# run_vio_simulation.cpp:163-171)
# ---------------------------------------------------------------------------

def write_sim_csvs(data, out_dir: str):
    """Write a SimData dataset in the reference simulator's file formats."""
    from . import sim as sim_mod
    from .utils.lie_np import mat_to_quat_np
    os.makedirs(os.path.join(out_dir, "keyframe"), exist_ok=True)

    def pose_rows(ts, ps, Rs, acc=None, gyr=None):
        rows = []
        qs = mat_to_quat_np(np.asarray(Rs))  # x,y,z,w
        for i, (t, p, q) in enumerate(zip(ts, ps, qs)):
            row = [t, q[3], q[0], q[1], q[2], p[0], p[1], p[2]]
            if acc is not None:
                row += list(gyr[i]) + list(acc[i])
            rows.append(row)
        return np.asarray(rows)

    # imu_pose.txt: full-rate IMU poses + measurements
    m = sim_mod.motion_model(data.imu_t)
    np.savetxt(os.path.join(out_dir, "imu_pose.txt"),
               pose_rows(data.imu_t, m["p_wb"], m["R_wb"], data.acc, data.gyr))
    # cam_pose.txt + per-keyframe landmark files
    np.savetxt(os.path.join(out_dir, "cam_pose.txt"),
               pose_rows(data.cam_t, data.cam_p, data.cam_R))
    for k in range(len(data.cam_t)):
        sel = np.where(data.obs_valid[k])[0]
        rows = []
        for lid in sel:
            x, y, z = data.landmarks[lid]
            u, v = data.obs_xy[k, lid]
            rows.append([x, y, z, 1.0, u, v])
        np.savetxt(os.path.join(out_dir, "keyframe",
                                f"all_points_{k}.txt"), np.asarray(rows))


def read_sim_keyframes(out_dir: str):
    """Read back the reference-format keyframe landmark files into
    (landmark_xyz dict, per-frame {lid: (u_n, v_n)}).  Landmark identity is
    recovered by world-coordinate matching, exactly like the reference
    (run_vio_simulation.cpp matches feature ids by point coordinates)."""
    import glob
    import re
    frames = {}
    id_map = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "keyframe",
                                              "all_points_*.txt")),
                       key=lambda p: int(re.findall(r"(\d+)", p)[-1])):
        k = int(re.findall(r"(\d+)", path)[-1])
        arr = np.loadtxt(path, ndmin=2)
        obs = {}
        for row in arr:
            key = tuple(np.round(row[:3], 9))
            lid = id_map.setdefault(key, len(id_map))
            obs[lid] = (row[4], row[5])
        frames[k] = obs
    return id_map, frames
