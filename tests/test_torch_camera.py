"""The port's camera models against ``vio_tpu.camera`` on the CPU in
float64: the same seeded numpy inputs through both packages, all four
models.  These are also the first tests of the three wide-angle models."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import camera as jcam
from vio_tpu_torch import camera as tcam

torch.set_num_threads(1)

TOL = 1e-12   # float64, the same arithmetic in the same order

MODELS = {
    "PINHOLE": dict(fx=460.0, fy=458.0, cx=320.0, cy=240.0,
                    k1=-0.28, k2=0.07, p1=1e-4, p2=-2e-4, width=640, height=480),
    "KANNALA_BRANDT": dict(fx=280.0, fy=281.0, cx=320.0, cy=240.0,
                           k2=-0.012, k3=0.004, k4=-0.002, k5=0.0005,
                           width=640, height=480),
    "MEI": dict(xi=1.2, gamma1=700.0, gamma2=702.0, u0=320.0, v0=240.0,
                k1=-0.1, k2=0.02, p1=1e-4, p2=-2e-4, width=640, height=480),
    "SCARAMUZZA": dict(poly=(-180.0, 0.0, 2.2e-3, -1.0e-6, 4.0e-9),
                       inv_poly=(260.0, 150.0, -10.0, 25.0, 8.0),
                       xc=320.0, yc=240.0, c=1.001, d=2e-4, e=-3e-4,
                       width=640, height=480),
}
# project(lift_to_ray(uv)) returns uv as far as the model's fixed-count
# inverse has converged: (half-width of the box around the centre,
# tolerance in px).  The pinhole's 8 fixed-point steps at EuRoC-magnitude
# k1 leave ~1e-3 px at 200 px from the centre.  Scaramuzza's two
# polynomials above are not each other's inverse, so its round trip is not
# a property to hold.
ROUND_TRIP = {"PINHOLE": (200.0, 2e-3), "KANNALA_BRANDT": (250.0, 1e-8),
              "MEI": (250.0, 1e-6)}


def _pixels(seed, n=200):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(20, 620, n), rng.uniform(20, 460, n)], -1)


def _points(seed, n=200):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(1.0, 6.0, n)], -1)


@pytest.fixture(params=sorted(MODELS))
def cams(request):
    p = MODELS[request.param]
    return request.param, jcam.make_camera(request.param, **p), \
        tcam.make_camera(request.param, **p)


def test_project_matches_jax(cams):
    _, cj, ct = cams
    pc = _points(1)
    want = np.asarray(cj.project(jnp.asarray(pc)))
    got = ct.project(torch.as_tensor(pc)).numpy()
    assert got.dtype == np.float64 and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * 1e3)  # pixels ~1e3


@pytest.mark.parametrize("method", ["lift", "lift_to_ray"])
def test_lift_matches_jax(cams, method):
    _, cj, ct = cams
    uv = _pixels(2)
    want = np.asarray(getattr(cj, method)(jnp.asarray(uv)))
    got = getattr(ct, method)(torch.as_tensor(uv)).numpy()
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_lift_keeps_leading_dimensions_and_dtype(cams):
    _, cj, ct = cams
    uv = _pixels(3, 24).reshape(4, 6, 2).astype(np.float32)
    got = ct.lift(torch.as_tensor(uv))
    assert got.shape == (4, 6, 2) and got.dtype == torch.float32
    want = np.asarray(cj.lift(jnp.asarray(uv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_project_inverts_lift_to_ray(name):
    half, tol = ROUND_TRIP[name]
    cam = tcam.make_camera(name, **MODELS[name])
    rng = np.random.default_rng(4)
    uv = np.array([320.0, 240.0]) + rng.uniform(-half, half, (200, 2))
    back = cam.project(cam.lift_to_ray(torch.as_tensor(uv))).numpy()
    np.testing.assert_allclose(back, uv, rtol=0, atol=tol)


def test_pinhole_without_distortion_returns_early():
    """Zero distortion takes the closed form: exactly (uv − c) / f."""
    cam = tcam.PinholeCamera(fx=460.0, fy=460.0, cx=255.0, cy=255.0)
    uv = _pixels(5)
    np.testing.assert_array_equal(cam.lift(torch.as_tensor(uv)).numpy(),
                                  (uv - 255.0) / 460.0)


_YAML = {
    "PINHOLE": """%YAML:1.0
model_type: PINHOLE
camera_name: camera
image_width: 752
image_height: 480
distortion_parameters:
   k1: -2.917e-01
   k2: 8.228e-02
   p1: 5.333e-05
   p2: -1.578e-04
projection_parameters:
   fx: 4.616e+02
   fy: 4.603e+02
   cx: 3.630e+02
   cy: 2.481e+02
""",
    "KANNALA_BRANDT": """%YAML:1.0
model_type: KANNALA_BRANDT
image_width: 640
image_height: 480
projection_parameters:
   k2: -0.012
   k3: 0.004
   k4: -0.002
   k5: 0.0005
   mu: 280.0
   mv: 281.0
   u0: 320.0
   v0: 240.0
""",
    "MEI": """%YAML:1.0
model_type: MEI
image_width: 640
image_height: 480
mirror_parameters:
   xi: 1.2
distortion_parameters:
   k1: -0.1
   k2: 0.02
   p1: 1.0e-4
   p2: -2.0e-4
projection_parameters:
   gamma1: 700.0
   gamma2: 702.0
   u0: 320.0
   v0: 240.0
""",
    "SCARAMUZZA": """%YAML:1.0
model_type: SCARAMUZZA
image_width: 640
image_height: 480
poly_parameters:
   p0: -180.0
   p1: 0.0
   p2: 2.2e-3
   p3: -1.0e-6
inv_poly_parameters:
   p0: 260.0
   p1: 150.0
   p2: -10.0
affine_parameters:
   ac: 1.001
   ad: 2.0e-4
   ae: -3.0e-4
   cx: 320.0
   cy: 240.0
""",
}


@pytest.mark.parametrize("name", sorted(_YAML))
def test_camera_from_yaml_matches_jax(name, tmp_path):
    path = tmp_path / f"{name}.yaml"
    path.write_text(_YAML[name])
    cj = jcam.camera_from_yaml(str(path))
    ct = tcam.camera_from_yaml(str(path))
    assert type(ct).__name__ == type(cj).__name__
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    uv = _pixels(6)
    np.testing.assert_allclose(ct.lift_to_ray(torch.as_tensor(uv)).numpy(),
                               np.asarray(cj.lift_to_ray(jnp.asarray(uv))),
                               rtol=0, atol=TOL)


def test_unknown_model_is_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown camera model"):
        tcam.make_camera("ORTHOGRAPHIC")
    path = tmp_path / "bad.yaml"
    path.write_text("%YAML:1.0\nmodel_type: ORTHOGRAPHIC\n")
    with pytest.raises(ValueError, match="unknown model_type"):
        tcam.camera_from_yaml(str(path))
