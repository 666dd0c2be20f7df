"""The frozen traffic source is the program's simulator."""
import numpy as np
import pytest

from benchmark.harness import core, stream, traffic

FIELDS = ("imu_t", "acc", "gyr", "acc_bias", "gyr_bias", "cam_t", "cam_p", "cam_R",
          "imu_p", "imu_R", "imu_v", "landmarks", "obs_xy", "obs_uv", "obs_valid")


@pytest.mark.parametrize("kw", [dict(noise=False), dict(noise=True, seed=2 ** 33 + 7),
                                dict(noise=True, seed=5, pixel_noise=0.5),
                                dict(noise=True, seed=9, k1=-0.28, k2=0.07, p1=1e-4, p2=-2e-4)])
def test_generator_is_the_programs(kw):
    from vio_tpu_torch import sim
    a = stream.generate(t_end=3.0, **kw)
    b = sim.generate(t_end=3.0, **kw)
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_stream_sized_for_the_ceiling():
    cell = core.Cell("sim_features")
    data = traffic.generate(cell, 3, 4.0)
    w = cell.workload
    assert len(data.cam_t) >= w["warmup_frames"] + w["ceiling_frames_per_s"] * 4.0
