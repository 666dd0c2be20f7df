"""The port's image frontend against ``vio_tpu.features`` on the CPU: the
same rendered 320×320 frames (float32) and the same float64 positions go
through both packages.  Pyramid, gradients and sampling to 1e-5 grey
levels; KLT positions to 1e-3 px with equal ``ok`` masks; the same
detections; CLAHE to 1e-3 grey levels; then the two ``FeatureTracker``s
frame by frame with RANSAC neutralised, the port's own drift bound, and
its reproducibility."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import runner as jrunner
from vio_tpu.config import sim_images_config as jax_sim_images_config
from vio_tpu.features import clahe as jclahe
from vio_tpu.features import detect as jdetect
from vio_tpu.features import klt as jklt
from vio_tpu.features import pyramid as jpyr
from vio_tpu_torch import runner, sim
from vio_tpu_torch.config import sim_images_config
from vio_tpu_torch.features import clahe as tclahe
from vio_tpu_torch.features import detect as tdetect
from vio_tpu_torch.features import klt as tklt
from vio_tpu_torch.features import pyramid as tpyr

torch.set_num_threads(1)

IMG_TOL = 1e-5    # grey levels of [0, 255] images in float32
POS_TOL = 1e-3    # pixels
RENDER = dict(height=320, width=320)
CAM = dict(fx=230.0, fy=230.0, cx=159.5, cy=159.5)


def half_res_data():
    return sim.generate(noise=False, image_w=320.0, image_h=320.0, **CAM)


def half_res_cfg(make=sim_images_config, **overrides):
    base = dict(focal_length=230.0, image_width=320, image_height=320,
                min_dist=8, **CAM)
    base.update(overrides)
    return make(**base)


@pytest.fixture(scope="module")
def data():
    return half_res_data()


@pytest.fixture(scope="module")
def imgs(data):
    return [sim.render_image(data, k, **RENDER) for k in range(2)]


@pytest.fixture(scope="module")
def blobs(data):
    """Ground-truth centres of the blobs seen in frames 0 and 1, plus a
    few positions at and beyond the image edge (what the in-bounds gates
    and the sampling clamp see)."""
    sel = data.obs_valid[0] & data.obs_valid[1]
    p0 = data.obs_uv[0][sel]
    edge = np.array([[0.2, 0.3], [318.9, 5.0], [5.0, 319.4], [-3.0, 100.0],
                     [322.0, 330.0], [1.0, 1.0], [318.0, 318.0]])
    return np.concatenate([p0, edge])


def _j(a, dtype=None):
    return jnp.asarray(a, dtype)


def _t(a, dtype=None):
    return torch.as_tensor(a, dtype=dtype)


def _img32(img):
    return _j(img, jnp.float32), _t(img, torch.float32)


# ---------------------------------------------------------------------------
# pyramid.py
# ---------------------------------------------------------------------------

def test_build_pyramid_matches_jax(imgs):
    ij, it = _img32(imgs[0])
    want = jpyr.build_pyramid(ij, 3)
    got = tpyr.build_pyramid(it, 3)
    assert [tuple(g.shape) for g in got] == [(320, 320), (160, 160), (80, 80)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=IMG_TOL)


@pytest.mark.parametrize("name", ["scharr_gradients", "central_gradients"])
def test_gradients_match_jax(imgs, name):
    """Random texture added so that the borders, where the central
    difference wraps around and the Scharr stencil sees zeros, are not
    flat."""
    rng = np.random.default_rng(0)
    img = (imgs[0] + 20.0 * rng.random(imgs[0].shape)).astype(np.float32)
    ij, it = _img32(img)
    for g, w in zip(getattr(tpyr, name)(it), getattr(jpyr, name)(ij)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=IMG_TOL)
    gx, _ = tpyr.central_gradients(it)
    np.testing.assert_allclose(gx[:, 0].numpy(), 0.5 * (img[:, 1] - img[:, -1]),
                               rtol=0, atol=IMG_TOL)


def test_conv2_matches_jax(imgs):
    ij, it = _img32(imgs[0])
    k = np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], np.float32)
    np.testing.assert_allclose(tpyr._conv2(it, _t(k)).numpy(),
                               np.asarray(jpyr._conv2(ij, _j(k))),
                               rtol=0, atol=IMG_TOL)


@pytest.mark.parametrize("pos_dtype", [np.float64, np.float32])
def test_bilinear_sample_matches_jax(imgs, pos_dtype):
    """Positions inside, on the clamp (W − 1.001) and far outside."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(-5.0, 325.0, (500, 2))
    xy[:6] = [[0.0, 0.0], [319.0, 319.0], [318.999, 318.999],
              [318.5, 0.5], [-1.0, 400.0], [400.0, -1.0]]
    xy = xy.astype(pos_dtype)
    ij, it = _img32(imgs[0])
    want = np.asarray(jpyr.bilinear_sample(ij, _j(xy)))
    got = tpyr.bilinear_sample(it, _t(xy))
    assert got.numpy().dtype == want.dtype == pos_dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_TOL)


def test_patch_sample_matches_jax(imgs, blobs):
    ij, it = _img32(imgs[0])
    want = jpyr.patch_sample_multi(jnp.stack([ij, 2.0 * ij]), _j(blobs), 5,
                                   method="gather")
    got = tpyr.patch_sample_multi(torch.stack([it, 2.0 * it]), _t(blobs), 5)
    assert got.shape == (2, len(blobs), 121)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=IMG_TOL)
    np.testing.assert_array_equal(tpyr.patch_sample(it, _t(blobs), 5).numpy(),
                                  got[0].numpy())


# ---------------------------------------------------------------------------
# klt.py
# ---------------------------------------------------------------------------

def _same_track(got, want, min_ok):
    p_t, ok_t, res_t = (g.numpy() for g in got)
    p_j, ok_j, res_j = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.sum() >= min_ok and not ok_j.all()
    np.testing.assert_allclose(p_t[ok_j], p_j[ok_j], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(res_t[ok_j], res_j[ok_j], rtol=0, atol=POS_TOL)


@pytest.mark.parametrize("name", ["track", "track_fb"])
def test_track_matches_jax(imgs, blobs, name):
    (i0j, i0t), (i1j, i1t) = _img32(imgs[0]), _img32(imgs[1])
    valid = np.ones(len(blobs), bool)
    valid[::7] = False
    want = getattr(jklt, name)(i0j, i1j, _j(blobs), _j(valid))
    got = getattr(tklt, name)(i0t, i1t, _t(blobs), _t(valid))
    assert got[0].dtype == torch.float64
    _same_track(got, want, min_ok=30)


def test_templates_and_refine_match_jax(data, imgs, blobs):
    """Birth templates at frame 0, refined in frame 1 from the true
    positions displaced by up to 0.7 px; the templates go through float32
    storage as in the tracker."""
    (i0j, i0t), (i1j, i1t) = _img32(imgs[0]), _img32(imgs[1])
    want_T = jklt.sample_templates(i0j, _j(blobs))
    got_T = tklt.sample_templates(i0t, _t(blobs))
    for g, w in zip(got_T, want_T):
        assert g.shape == (len(blobs), 121)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=IMG_TOL)

    sel = data.obs_valid[0] & data.obs_valid[1]
    rng = np.random.default_rng(2)
    p_init = np.concatenate([data.obs_uv[1][sel], blobs[sel.sum():]])
    p_init = p_init + rng.uniform(-0.7, 0.7, p_init.shape)
    valid = np.ones(len(blobs), bool)
    valid[::5] = False
    T32 = [np.asarray(w).astype(np.float32) for w in want_T]
    want = jklt.refine_on_templates(i1j, *[_j(a) for a in T32], _j(p_init), _j(valid))
    got = tklt.refine_on_templates(i1t, *[_t(a) for a in T32], _t(p_init), _t(valid))
    _same_track(got, want, min_ok=30)
    # and it does refine: the ok tracks land on the true centres
    ok = got[1].numpy()[:sel.sum()]
    err = np.linalg.norm(got[0].numpy()[:sel.sum()] - data.obs_uv[1][sel], axis=1)
    assert np.median(err[ok]) < 0.1


def test_klt_in_float32_positions_keeps_the_tracks(imgs, blobs):
    """The card's regime (float32 positions) against float64 on the same
    functions: the same tracks survive but for a handful on a threshold,
    and the survivors agree to 1e-2 px."""
    i0, i1 = _t(imgs[0], torch.float32), _t(imgs[1], torch.float32)
    valid = torch.ones(len(blobs), dtype=torch.bool)
    p64, ok64, _ = tklt.track_fb(i0, i1, _t(blobs), valid)
    p32, ok32, _ = tklt.track_fb(i0, i1, _t(blobs, torch.float32), valid)
    assert p32.dtype == torch.float32
    assert int((ok64 != ok32).sum()) <= 2
    both = (ok64 & ok32).numpy()
    np.testing.assert_allclose(p32.numpy()[both], p64.numpy()[both], rtol=0, atol=1e-2)


# ---------------------------------------------------------------------------
# detect.py
# ---------------------------------------------------------------------------

def _valid_peaks(xy, score, valid):
    xy, score, valid = np.asarray(xy), np.asarray(score), np.asarray(valid)
    order = np.lexsort((xy[valid][:, 0], xy[valid][:, 1]))
    return xy[valid][order], score[valid][order]


@pytest.mark.parametrize("masked", [False, True])
def test_detect_matches_jax(data, imgs, masked):
    ij, it = _img32(imgs[0])
    occ_j = occ_t = None
    if masked:
        live = data.obs_uv[0][data.obs_valid[0]][::2]
        flags = np.ones(len(live), bool)
        occ_j = jdetect.occupancy_from_points((320, 320), _j(live), _j(flags), 8)
        occ_t = tdetect.occupancy_from_points((320, 320), _t(live), _t(flags), 8)
    want = jdetect.detect(ij, occ_j, max_corners=150, min_dist=8)
    got = tdetect.detect(it, occ_t, max_corners=150, min_dist=8)
    xy_j, s_j = _valid_peaks(*want)
    xy_t, s_t = _valid_peaks(*(g.numpy() for g in got))
    assert len(xy_j) >= 10 and len(xy_j) == len(xy_t)
    np.testing.assert_allclose(xy_t, xy_j, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5)
    # the top-k order is the order in which the tracker hands out ids
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy()[np.asarray(want[2])],
                               np.asarray(want[0])[np.asarray(want[2])],
                               rtol=0, atol=POS_TOL)


def test_shi_tomasi_response_matches_jax(imgs):
    ij, it = _img32(imgs[0])
    want = np.asarray(jdetect.shi_tomasi_response(ij))
    np.testing.assert_allclose(tdetect.shi_tomasi_response(it).numpy(), want,
                               rtol=1e-5, atol=1e-4 * want.max())


def test_occupancy_from_points_matches_jax():
    """Negative and out-of-range positions (truncation toward zero, then
    the clip), duplicates, and invalid slots, which must write nothing."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(-20.0, 340.0, (60, 2))
    xy[:4] = [[-0.7, 10.2], [10.9, -0.2], [319.9, 319.9], [10.9, 10.2]]
    xy[4] = xy[3]
    valid = rng.random(60) < 0.6
    valid[:5] = [True, True, True, False, True]
    want = np.asarray(jdetect.occupancy_from_points((320, 320), _j(xy), _j(valid), 8))
    got = tdetect.occupancy_from_points((320, 320), _t(xy), _t(valid), 8).numpy()
    assert got.dtype == bool and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)
    none = tdetect.occupancy_from_points((320, 320), _t(xy), _t(np.zeros(60, bool)), 8)
    assert not none.any()


# ---------------------------------------------------------------------------
# clahe.py
# ---------------------------------------------------------------------------

def _clahe_images():
    rng = np.random.default_rng(0)
    return {
        "random": (255.0 * rng.random((100, 150))).astype(np.float32),   # pads to 104 × 152
        "dark": 10.0 + 8.0 * rng.random((64, 96)).astype(np.float32),
        "constant": np.full((64, 64), 37.0, np.float32),
    }


@pytest.mark.parametrize("name,clip", [("random", 3.0), ("dark", 4.0), ("constant", 3.0)])
def test_clahe_matches_jax(name, clip):
    img = _clahe_images()[name]
    want = np.asarray(jclahe.clahe(img, clip_limit=clip))
    got = tclahe.clahe(_t(img), clip_limit=clip)
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    if name == "dark":      # test_clahe_equalizes_dark_image's property
        assert got.max() - got.min() > 3.0 * (img.max() - img.min())
    if name == "constant":  # test_clahe_constant_image_stays_flat's
        assert float(got.std()) < 1e-3


def test_clahe_on_a_rendered_frame_matches_jax(imgs):
    want = np.asarray(jclahe.clahe(imgs[0]))
    got = tclahe.clahe(_t(imgs[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# tracker.py
# ---------------------------------------------------------------------------

N_TRACK = 12


@pytest.fixture(scope="module")
def frames(data):
    return [sim.render_image(data, k, **RENDER) for k in range(N_TRACK)]


def test_tracker_matches_jax_tracker(data, frames):
    """With ``f_threshold`` so large that RANSAC rejects nothing, neither
    tracker depends on its random stream: same ids in the same slots,
    same published keys, positions to 1e-3 px, every frame."""
    big = dict(f_threshold=1e6)
    trk_j = jrunner.make_tracker(half_res_cfg(jax_sim_images_config, **big))
    trk_t = runner.make_tracker(half_res_cfg(**big), device="cpu")
    assert trk_t.device.type == "cpu" and trk_t.dtype == torch.float64
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
            np.testing.assert_allclose(vel, out_j[fid][2], rtol=0, atol=30 * POS_TOL / 230.0)
        published += len(out_t)
    assert published >= 30 * (N_TRACK - 1)
    assert trk_t.next_id == trk_j.next_id


def _drifts(trk, data, frames):
    """tests/test_image_pipeline.py's drift measure: displacement of each
    track at the last frame from the landmark it was born on."""
    assoc, drifts = {}, []
    for k, img in enumerate(frames):
        trk.read_image(img, float(data.cam_t[k]))
        vis = np.where(data.obs_valid[k])[0]
        uv = data.obs_uv[k][vis]
        for slot in np.where(trk.valid)[0]:
            fid = int(trk.ids[slot])
            p = trk.pos[slot]
            if fid not in assoc:
                d = np.linalg.norm(uv - p, axis=1)
                j = int(d.argmin())
                if d[j] < 3.0:
                    assoc[fid] = (vis[j], p - uv[j])
                continue
            if k == len(frames) - 1:
                lid, off0 = assoc[fid]
                if data.obs_valid[k][lid]:
                    drifts.append(np.linalg.norm(p - data.obs_uv[k][lid] - off0))
    return np.array(drifts)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_tracker_is_drift_free_on_rendered_frames(data, frames, dtype):
    """RANSAC at its normal threshold; float32 positions rehearse the
    card's regime."""
    trk = runner.make_tracker(half_res_cfg(), device="cpu", dtype=dtype)
    drifts = _drifts(trk, data, frames)
    assert len(drifts) >= 25
    assert np.percentile(drifts, 90) < 0.3, drifts


def test_tracker_reruns_are_reproducible(data, frames):
    """The RANSAC stream depends on (seed, frame index) alone: two runs
    with other timestamps give the same tracks, bit for bit."""
    runs = []
    for t0 in (0.0, 1000.0):
        trk = runner.make_tracker(half_res_cfg(), seed=3, device="cpu")
        for k, img in enumerate(frames[:8]):
            trk.read_image(img, t0 + float(data.cam_t[k]))
        runs.append((trk.ids.copy(), trk.pos.copy(), trk.track_cnt.copy()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    g0 = trk._ransac_generator().initial_seed()
    trk.frame_idx += 1
    assert trk._ransac_generator().initial_seed() != g0


def test_tracker_with_clahe_and_distortion_tracks_landmarks():
    """equalize=True and a radtan camera: the published bearings are the
    undistorted projections of some landmark, as
    tests/test_features.py::test_tracker_loop holds them."""
    distort = dict(k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
    data = sim.generate(noise=False, image_w=320.0, image_h=320.0, **CAM, **distort)
    trk = runner.make_tracker(half_res_cfg(equalize=True, **distort), device="cpu")
    for k in range(4):
        out = trk.read_image(sim.render_image(data, k, **RENDER), float(data.cam_t[k]))
    assert len(out) > 30
    xy_gt = data.obs_xy[3][data.obs_valid[3]]
    for bear, _, _ in out.values():
        assert np.linalg.norm(xy_gt - bear[:2], axis=1).min() < 5.0 / 230.0
