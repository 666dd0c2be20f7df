"""The tracker's device programs (vio_tpu_torch/features/tracker.py) on
the CPU: the key that its captured CUDA graphs are cached by holds every
static argument, like ``jax.jit``'s cache, and a CPU ``read_image`` runs
the same programs eagerly, capturing nothing, with the JAX tracker's
output (positions to 1e-3 px, as tests/test_torch_features.py holds the
two trackers, with RANSAC neutralised so that neither depends on its
random stream)."""
import dataclasses

import numpy as np
import pytest
import torch

from vio_tpu import runner as jrunner
from vio_tpu.config import sim_images_config as jax_sim_images_config
from vio_tpu_torch import runner, sim
from vio_tpu_torch.camera import PinholeCamera
from vio_tpu_torch.config import sim_images_config
from vio_tpu_torch.features import tracker as ttracker
from vio_tpu_torch.solver import graph

torch.set_num_threads(1)

POS_TOL = 1e-3    # pixels
CAM = dict(fx=230.0, fy=230.0, cx=159.5, cy=159.5)
N_FRAMES = 6


def _cfg(make=sim_images_config, **overrides):
    base = dict(focal_length=230.0, image_width=320, image_height=320, min_dist=8, **CAM)
    base.update(overrides)
    return make(**base)


def _tracker(**kw):
    return ttracker.FeatureTracker(PinholeCamera(**CAM), device="cpu", **kw)


STATIC = [("max_cnt", 120), ("min_dist", 12), ("f_thresh_px", 2.0), ("focal", 300.0),
          ("fb_thresh", 0.7), ("equalize", True), ("clahe_clip", 2.0), ("levels", 2)]


@pytest.mark.parametrize("name,value", STATIC, ids=[n for n, _ in STATIC])
def test_key_changes_with_each_static_argument(name, value):
    base = _tracker().key((320, 320))
    assert _tracker().key((320, 320)) == base                 # equal configurations
    assert hash(_tracker().key((320, 320))) == hash(base)
    assert _tracker(**{name: value}).key((320, 320)) != base


def test_key_holds_shape_camera_dtype_device_and_iterations():
    trk = _tracker()
    base = trk.key((320, 320))
    assert trk.key((240, 320)) != base
    assert _tracker(dtype=torch.float32).key((320, 320)) != base
    other = ttracker.FeatureTracker(dataclasses.replace(PinholeCamera(**CAM), k1=-0.1),
                                    device="cpu")
    assert other.key((320, 320)) != base
    assert base.device == torch.device("cpu") and base.dtype == torch.float64
    assert (base.n_iters, base.n_hyp) == (ttracker.KLT_ITERS, ttracker.N_HYP)
    trk.n_hyp = 128
    assert trk.key((320, 320)) != base


def test_programs_take_their_specs():
    """Every program runs eagerly on inputs of its specs and returns host
    arrays: the shapes the tracker's bookkeeping reads."""
    trk = _tracker(max_cnt=40)
    key = trk.key((64, 80))
    progs = ttracker._programs(key, trk.cam)
    assert set(progs) == {"image", "track", "reject", "detect", "templates", "lift"}
    rng = np.random.default_rng(0)
    img = torch.from_numpy((255 * rng.random((64, 80))).astype(np.float32))
    for name, (specs, fn) in progs.items():
        n_dev = {"track": 1, "detect": 1, "templates": 1}.get(name, 0)
        host = []
        for shape, dt in specs[:len(specs) - n_dev]:
            if dt == torch.bool:
                host.append(np.ones(shape, bool))
            elif dt == torch.int64:
                host.append(np.stack([rng.choice(shape[0] * 0 + 40, 8, replace=False)
                                      for _ in range(shape[0])]))
            elif shape == (64, 80):
                host.append(img.numpy())
            else:
                host.append(rng.uniform(10.0, 50.0, shape))
        keep = [torch.empty((64, 80))] if name in ("image", "track") else []
        out = graph.run_eagerly(specs, fn, host, [img] * n_dev, keep, on=torch.device("cpu"))
        assert all(isinstance(a, np.ndarray) for a in out)
    assert graph.cached_keys() == [] or all(k[0] == "solve_window" or isinstance(k, tuple)
                                             for k in graph.cached_keys())


def test_cpu_read_image_captures_nothing_and_matches_jax_tracker():
    data = sim.generate(noise=False, image_w=320.0, image_h=320.0, **CAM)
    frames = [sim.render_image(data, k, height=320, width=320) for k in range(N_FRAMES)]
    big = dict(f_threshold=1e6)
    trk_j = jrunner.make_tracker(_cfg(jax_sim_images_config, **big))
    trk_t = runner.make_tracker(_cfg(**big), device="cpu")
    graph.reset_stats()
    keys = graph.cached_keys()
    published = 0
    for k, img in enumerate(frames):
        out_j = trk_j.read_image(img, float(data.cam_t[k]))
        out_t = trk_t.read_image(img, float(data.cam_t[k]))
        np.testing.assert_array_equal(trk_t.ids, trk_j.ids)
        np.testing.assert_array_equal(trk_t.track_cnt, trk_j.track_cnt)
        live = trk_j.valid
        np.testing.assert_allclose(trk_t.pos[live], trk_j.pos[live], rtol=0, atol=POS_TOL)
        assert sorted(out_t) == sorted(out_j)
        for fid, (bear, uv, vel) in out_t.items():
            np.testing.assert_allclose(bear, out_j[fid][0], rtol=0, atol=POS_TOL / 230.0)
            np.testing.assert_allclose(uv, out_j[fid][1], rtol=0, atol=POS_TOL)
        published += len(out_t)
    assert published >= 30 * (N_FRAMES - 1)
    assert graph.STATS == graph.Counter() and graph.cached_keys() == keys
    assert trk_t.prev_img.dtype == torch.float32 and trk_t.prev_img.shape == (320, 320)
    np.testing.assert_array_equal(trk_t.prev_img.numpy(), frames[-1])


def test_read_image_refuses_a_new_image_size():
    """A stream keeps its image size: the frame kept on the device has the
    first frame's shape, and tracking against a frame of another would
    read memory the new size does not fill."""
    trk = _tracker(max_cnt=20)
    rng = np.random.default_rng(1)
    first = (255 * rng.random((64, 80))).astype(np.float32)
    trk.read_image(first, 0.0)
    with pytest.raises(ValueError, match="keeps its size"):
        trk.read_image(first[:48], 0.05)
    assert trk.frame_idx == 1 and trk.prev_img.shape == (64, 80)
    np.testing.assert_array_equal(trk.prev_img.numpy(), first)
