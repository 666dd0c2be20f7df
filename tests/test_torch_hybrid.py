"""The port's hybrid dataset builder (vio_tpu_torch/hybrid.py) against
the JAX package's, on IMU and camera-stamp files this test writes from
sim.generate in load_imu_txt's format (the MH-05 streams the reference's
flagship reads are not in the repository; vio_tpu_torch.testing.
write_hybrid_streams): a static prefix with the body at rest, then the
simulator's motion.

Both modules are host numpy on the same numpy, so every array agrees to
1e-12 (the rotation interpolation's arccos/sin at round-off)."""
import numpy as np
import pytest
import torch

from vio_tpu import hybrid as jhybrid
from vio_tpu_torch import hybrid, sim, testing

torch.set_num_threads(1)
STATIC_S = 2.0
FIELDS = ("imu_t", "acc", "gyr", "acc_bias", "gyr_bias", "cam_t", "cam_p", "cam_R",
          "imu_p", "imu_R", "imu_v", "landmarks", "obs_xy", "obs_uv")


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    out = tmp_path_factory.mktemp("mh05")
    t, acc, gyr = testing.write_hybrid_streams(sim.generate(noise=False), str(out),
                                               static_s=STATIC_S)
    return str(out), t, acc, gyr


def test_static_init_and_dead_reckoning_match_jax(streams):
    _, t, acc, gyr = streams
    out = hybrid.static_init(t, acc, gyr)
    ref = jhybrid.static_init(t, acc, gyr)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    bg, ba, R0 = out
    np.testing.assert_allclose(bg, 0.0, atol=1e-15)        # at rest: zero rates
    np.testing.assert_allclose(R0 @ (acc[0] - ba), [0.0, 0.0, hybrid.GRAVITY], atol=1e-9)
    n = int(6.0 / (t[1] - t[0]))
    for a, b in zip(hybrid.dead_reckon(t[:n], acc[:n], gyr[:n], *out),
                    jhybrid.dead_reckon(t[:n], acc[:n], gyr[:n], *ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    Rs, ps, _ = hybrid.dead_reckon(t[:n], acc[:n], gyr[:n], *out)
    k0 = int(STATIC_S / (t[1] - t[0]))
    assert np.abs(ps[:k0]).max() < 1e-9                     # no drift at rest
    assert np.abs(ps[n - 1]).max() > 0.1                    # then it moves
    for w in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(hybrid._slerp_R(Rs[k0], Rs[n - 1], w),
                                   jhybrid._slerp_R(Rs[k0], Rs[n - 1], w),
                                   rtol=0, atol=1e-12)


def test_generate_hybrid_matches_jax(streams):
    path = streams[0]
    kw = dict(duration=5.0, kf_every=4, k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
    out = hybrid.generate_hybrid(f"{path}/MH_05_imu0.txt", f"{path}/MH_05_cam0.txt", **kw)
    ref = jhybrid.generate_hybrid(f"{path}/MH_05_imu0.txt", f"{path}/MH_05_cam0.txt", **kw)
    assert isinstance(out, sim.SimData)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(out, k), getattr(ref, k), rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(getattr(ref, k)).max()),
                                   err_msg=k)
    np.testing.assert_array_equal(out.obs_valid, ref.obs_valid)
    assert 90 <= len(out.cam_t) <= 100 and out.obs_valid.sum(axis=1).min() > 0
    # the camera stamps are the written ones from the stream start
    np.testing.assert_allclose(np.diff(out.cam_t), 0.05, atol=1e-9)
