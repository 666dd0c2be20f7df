"""The port's dataset IO (vio_tpu_torch/io.py) and ``runner.run_euroc``
against the JAX package's, on the CPU: each package reads what the other
wrote (EuRoC ASL layout, the reference simulator's CSVs, the raw IMU and
camera-stamp text files), then ``run_euroc`` over
tests/test_image_pipeline.py::test_euroc_layout_roundtrip's 12
half-resolution frames in both packages.

Tolerances: what is written as text is read back bit for bit by both
readers; quaternions from ``utils/lie_np`` against ``lie.mat_to_quat``
agree to 1e-12; images round-trip exactly (``.npy``) or to the uint8 grey
level (PNG).  Before the estimator initializes its states come from IMU
propagation alone, so both packages' states agree to 1e-9."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from vio_tpu import io as jio
from vio_tpu import runner as jrunner
from vio_tpu.config import sim_images_config as jax_sim_images_config
from test_torch_features import RENDER, half_res_cfg, half_res_data
from vio_tpu_torch import io as tio
from vio_tpu_torch import runner, sim

torch.set_num_threads(1)
N_FRAMES = 12


@pytest.fixture(scope="module")
def data():
    return half_res_data()


def _short(data, n_cam: int):
    """The first n_cam camera frames and the IMU samples up to them."""
    n_imu = int(np.searchsorted(data.imu_t, data.cam_t[n_cam - 1])) + 1
    cam = dict(cam_t=data.cam_t[:n_cam], cam_p=data.cam_p[:n_cam],
               cam_R=data.cam_R[:n_cam], imu_p=data.imu_p[:n_cam],
               imu_R=data.imu_R[:n_cam], imu_v=data.imu_v[:n_cam],
               obs_xy=data.obs_xy[:n_cam], obs_uv=data.obs_uv[:n_cam],
               obs_valid=data.obs_valid[:n_cam])
    imu = {k: getattr(data, k)[:n_imu] for k in
           ("imu_t", "acc", "gyr", "acc_bias", "gyr_bias")}
    return dataclasses.replace(data, **cam, **imu)


def _same_euroc(a, b):
    for k in ("imu_t", "acc", "gyr", "cam_t", "gt_t", "gt_p"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    np.testing.assert_allclose(a.gt_q, b.gt_q, rtol=0, atol=1e-12)
    assert [os.path.basename(f) for f in a.cam_files] == \
        [os.path.basename(f) for f in b.cam_files]


@pytest.mark.parametrize("fmt", ["npy", "png"])
def test_euroc_layout_crosses_between_packages(data, tmp_path, fmt):
    """write_euroc of each package, load_euroc and load_image of both."""
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    tio.write_euroc(data, out_t, n_frames=4, image_format=fmt, render_kw=RENDER)
    jio.write_euroc(data, out_j, n_frames=4, image_format=fmt, render_kw=RENDER)
    seqs = [tio.load_euroc(out_t), jio.load_euroc(out_j),
            jio.load_euroc(out_t), tio.load_euroc(out_j)]
    for s in seqs[1:]:
        _same_euroc(seqs[0], s)
    back = seqs[0]
    np.testing.assert_allclose(back.imu_t, data.imu_t, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(back.acc, data.acc)
    np.testing.assert_allclose(back.cam_t, data.cam_t[:4], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(back.gt_p, data.imu_p[:4])
    for k in range(4):
        img = tio.load_image(back.cam_files[k])
        np.testing.assert_array_equal(img, jio.load_image(seqs[1].cam_files[k]))
        np.testing.assert_array_equal(img, jio.load_image(back.cam_files[k]))
        assert img.dtype == np.float32 and img.shape == (320, 320)
        ref = sim.render_image(data, k, **RENDER)
        np.testing.assert_allclose(img, ref if fmt == "npy" else ref.astype(np.uint8),
                                   rtol=0, atol=1e-4)


def test_sim_csvs_cross_between_packages(data, tmp_path):
    """write_sim_csvs of each package, read_sim_keyframes of both."""
    short = _short(data, 5)
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    tio.write_sim_csvs(short, out_t)
    jio.write_sim_csvs(short, out_j)
    for name in ("imu_pose.txt", "cam_pose.txt"):
        np.testing.assert_allclose(np.loadtxt(os.path.join(out_t, name)),
                                   np.loadtxt(os.path.join(out_j, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    ids_t, frames_t = tio.read_sim_keyframes(out_t)
    for ids, frames in (jio.read_sim_keyframes(out_t), jio.read_sim_keyframes(out_j),
                        tio.read_sim_keyframes(out_j)):
        assert ids == ids_t and frames == frames_t
    assert sorted(frames_t) == list(range(5))
    assert len(frames_t[0]) == int(short.obs_valid[0].sum())


def test_raw_imu_and_stamp_files(data, tmp_path):
    """load_imu_txt / load_cam_stamps_txt on the raw MH_05-style files."""
    imu_path, cam_path = tmp_path / "imu0.txt", tmp_path / "cam0.txt"
    ns = np.round(data.imu_t[:400] * 1e9).astype(np.int64)
    with open(imu_path, "w") as fh:
        for t, g, a in zip(ns, data.gyr[:400], data.acc[:400]):
            fh.write(" ".join([str(t)] + [repr(float(v)) for v in (*g, *a)]) + "\n")
    with open(cam_path, "w") as fh:
        for t in np.round(data.cam_t[:40] * 1e9).astype(np.int64):
            fh.write(f"{t} {t}.png\n\n")
    for got, ref in zip(tio.load_imu_txt(str(imu_path)), jio.load_imu_txt(str(imu_path))):
        np.testing.assert_array_equal(got, ref)
    t, acc, gyr = tio.load_imu_txt(str(imu_path))
    np.testing.assert_array_equal(acc, data.acc[:400])
    np.testing.assert_array_equal(gyr, data.gyr[:400])
    np.testing.assert_allclose(t, data.imu_t[:400], rtol=0, atol=1e-9)
    ts, names = tio.load_cam_stamps_txt(str(cam_path))
    ts_j, names_j = jio.load_cam_stamps_txt(str(cam_path))
    np.testing.assert_array_equal(ts, ts_j)
    assert names == names_j and len(names) == 40 and names[0].endswith(".png")


def test_run_euroc_matches_jax(data, tmp_path):
    """run_euroc over the written 12 frames: 12 - 2 primers - 1 unpublished
    = 9 published frames in both packages, none initialized yet, and the
    same IMU-propagated states."""
    seq = str(tmp_path / "seq")
    tio.write_euroc(data, seq, n_frames=N_FRAMES, render_kw=RENDER)
    est, traj, back = runner.run_euroc(seq, half_res_cfg(), device="cpu")
    est_j, traj_j, _ = jrunner.run_euroc(seq, half_res_cfg(jax_sim_images_config))
    assert est.device.type == "cpu" and est.dtype == torch.float64
    assert len(traj["initialized"]) == len(traj_j["initialized"]) == 9
    assert not traj["initialized"].any() and not traj_j["initialized"].any()
    np.testing.assert_array_equal(back.cam_t, tio.load_euroc(seq).cam_t)
    assert est.frame_count == est_j.frame_count
    np.testing.assert_array_equal(est.headers, est_j.headers)
    for k in ("Ps", "Vs", "Rs", "Bas", "Bgs"):
        np.testing.assert_allclose(getattr(est, k), getattr(est_j, k),
                                   rtol=0, atol=1e-9, err_msg=k)
    assert sorted(est.fm.features) == sorted(est_j.fm.features)
    # n_frames cuts the stream as the reference's does
    _, traj5, _ = runner.run_euroc(seq, half_res_cfg(), n_frames=5, device="cpu")
    assert len(traj5["initialized"]) == 2
