"""Camera models: pinhole (radtan), equidistant (fisheye), MEI
(catadioptric) and Scaramuzza (omnidirectional), batched torch.

Port of ``vio_tpu/camera.py`` (reference: src/camera_models/camera_models/
{PinholeCamera.cc,EquidistantCamera.cc,CataCamera.cc,ScaramuzzaCamera.cc},
factory at CameraFactory.cc:90).  Unprojection (``liftProjective``) uses a
fixed number of inverse-distortion iterations (reference:
PinholeCamera.cc:485-512 recursive inverse), so shapes and the amount of
work never depend on the data.  The methods take their device and dtype
from the tensor they are given.

Ray conventions: ``lift`` always returns z=1-plane coords (..., 2), valid
for rays within 90° of the optical axis (wide-FOV models clamp beyond
that).  ``lift_to_ray`` returns (..., 3): a z=1 homogeneous ray for the
narrow-FOV models (pinhole, equidistant — what the VIO factor stack
consumes) and a UNIT ray for the full-FOV models (MEI, Scaramuzza), whose
field of view can exceed the z>0 hemisphere.
"""
from __future__ import annotations

import dataclasses

import torch

UNDISTORT_ITERS = 8


def _radtan(p, k1, k2, p1, p2):
    """Apply radtan distortion to normalized coords p (..., 2)."""
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2
    dx = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return p + torch.stack([dx, dy], dim=-1)


def _undistort(distort, pd):
    """Fixed-point inverse of ``distort`` started at the distorted point."""
    pu = pd
    for _ in range(UNDISTORT_ITERS):
        pu = pd - (distort(pu) - pu)
    return pu


def _homogeneous(pn):
    return torch.cat([pn, torch.ones_like(pn[..., :1])], dim=-1)


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """fx, fy, cx, cy with radtan distortion (k1, k2, p1, p2)."""
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 0
    height: int = 0

    def distort(self, p):
        """Apply radtan distortion to normalized coords p (..., 2)."""
        return _radtan(p, self.k1, self.k2, self.p1, self.p2)

    def project(self, pc):
        """Camera-frame 3D points (..., 3) → pixel coords (..., 2)."""
        pn = pc[..., :2] / pc[..., 2:3]
        pd = self.distort(pn)
        return torch.stack([self.fx * pd[..., 0] + self.cx,
                            self.fy * pd[..., 1] + self.cy], dim=-1)

    def lift(self, uv):
        """Pixel coords (..., 2) → normalized image-plane coords (..., 2)
        (z=1).  Fixed-point inverse of the distortion, matching the
        reference's recursive undistortion."""
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        pd = torch.stack([mx, my], dim=-1)
        if self.k1 == 0.0 and self.k2 == 0.0 and self.p1 == 0.0 and self.p2 == 0.0:
            return pd
        return _undistort(self.distort, pd)

    def lift_to_ray(self, uv):
        return _homogeneous(self.lift(uv))


@dataclasses.dataclass(frozen=True)
class CataCamera:
    """MEI unified catadioptric model: unit-sphere projection with mirror
    parameter ``xi``, radtan distortion, then the generalized focal
    (gamma1, gamma2) — reference: CataCamera.cc (spaceToPlane /
    liftProjective)."""
    xi: float
    gamma1: float
    gamma2: float
    u0: float
    v0: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 0
    height: int = 0

    def _distort(self, p):
        return _radtan(p, self.k1, self.k2, self.p1, self.p2)

    def project(self, pc):
        """Camera-frame 3D points (..., 3) → pixel coords (..., 2)."""
        Ps = pc / torch.linalg.norm(pc, dim=-1, keepdim=True)
        denom = Ps[..., 2] + self.xi
        m = Ps[..., :2] / denom[..., None]
        md = self._distort(m)
        return torch.stack([self.gamma1 * md[..., 0] + self.u0,
                            self.gamma2 * md[..., 1] + self.v0], dim=-1)

    def _sphere(self, uv):
        """Undistorted mirror-plane point mu (..., 2) and the unit-sphere
        scale lam (...) of CataCamera.cc's liftProjective."""
        mx = (uv[..., 0] - self.u0) / self.gamma1
        my = (uv[..., 1] - self.v0) / self.gamma2
        mu = _undistort(self._distort, torch.stack([mx, my], dim=-1))
        rho2 = mu[..., 0] ** 2 + mu[..., 1] ** 2
        lam = (self.xi + torch.sqrt(1.0 + (1.0 - self.xi ** 2) * rho2)) / (1.0 + rho2)
        return mu, lam

    def lift(self, uv):
        """Pixels → normalized image-plane coords (z=1): fixed-point
        undistortion then the unit-sphere back-projection."""
        mu, lam = self._sphere(uv)
        # z = lam - xi hits 0 at exactly 90° viewing angle (routine for
        # xi >= 1 mirrors with >180° FOV); clamp so edge pixels map to a
        # far-but-finite z=1-plane point instead of inf / flipped sign.
        # Full-FOV consumers should use lift_to_ray.
        z = torch.clamp(lam - self.xi, min=1e-6)
        return mu * (lam / z)[..., None]

    def lift_to_ray(self, uv):
        """Full 3D unit-sphere back-projection (x, y, z) — valid across the
        whole mirror FOV, unlike lift() which forces the z=1 plane."""
        mu, lam = self._sphere(uv)
        ray = torch.cat([mu * lam[..., None], (lam - self.xi)[..., None]], dim=-1)
        return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class ScaramuzzaCamera:
    """Scaramuzza omnidirectional (OCamCalib) model: forward polynomial
    ``poly(theta)`` for projection (world→image radius), back polynomial
    ``inv ray z = poly(rho)`` for lifting, with the 2×2 affine
    [[c, d], [e, 1]] stretch — reference: ScaramuzzaCamera.cc
    (spaceToPlane / liftProjective)."""
    poly: tuple          # cam2world coefficients a0..aN (z = Σ ai ρ^i)
    inv_poly: tuple      # world2cam coefficients b0..bM (ρ = Σ bi θ^i)
    xc: float
    yc: float
    c: float = 1.0
    d: float = 0.0
    e: float = 0.0
    width: int = 0
    height: int = 0

    def project(self, pc):
        norm = torch.sqrt(pc[..., 0] ** 2 + pc[..., 1] ** 2)
        norm = torch.clamp(norm, min=1e-12)
        theta = torch.atan2(-pc[..., 2], norm)
        rho = torch.zeros_like(theta)
        for b in reversed(self.inv_poly):
            rho = rho * theta + b
        xn = pc[..., 0] / norm * rho
        yn = pc[..., 1] / norm * rho
        return torch.stack([xn * self.c + yn * self.d + self.xc,
                            xn * self.e + yn + self.yc], dim=-1)

    def lift_to_ray(self, uv):
        """Pixels → unit-norm ray (..., 3) via the forward polynomial.

        Unlike the pinhole/equidistant models (whose ``lift_to_ray``
        returns z=1 homogeneous rays), this returns a UNIT ray, because
        omnidirectional FOVs routinely exceed 90° where a z=1 plane does
        not exist.  Intentional deviation from the reference
        (OCAMCamera::liftProjective builds the ray x/y from the RAW
        centered coords, using the affine-inverted coords only for rho):
        the affine inverse is applied to the ray x/y as well, which is the
        consistent inversion of spaceToPlane — identical when the affine
        part is the identity (the common calibration)."""
        inv_scale = 1.0 / (self.c - self.d * self.e)
        dx = uv[..., 0] - self.xc
        dy = uv[..., 1] - self.yc
        xn = inv_scale * (dx - self.d * dy)
        yn = inv_scale * (-self.e * dx + self.c * dy)
        rho = torch.sqrt(xn * xn + yn * yn)
        z = torch.zeros_like(rho)
        for a in reversed(self.poly):
            z = z * rho + a
        ray = torch.stack([xn, yn, -z], dim=-1)
        return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)

    def lift(self, uv):
        """z=1-plane coords; only meaningful for pixels viewing < 90° off
        axis (ray z > 0).  Edge pixels beyond that are clamped to a far
        near-plane direction instead of flipping sign — use lift_to_ray for
        full-FOV geometry."""
        ray = self.lift_to_ray(uv)
        z = torch.clamp(ray[..., 2:3], min=1e-6)
        return ray[..., :2] / z


@dataclasses.dataclass(frozen=True)
class EquidistantCamera:
    """Kannala-Brandt equidistant fisheye: theta-polynomial k2..k5
    (reference: EquidistantCamera.cc)."""
    fx: float
    fy: float
    cx: float
    cy: float
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    width: int = 0
    height: int = 0

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (self.k2 + t2 * (self.k3 + t2 * (self.k4 + t2 * self.k5))))

    def project(self, pc):
        r = torch.linalg.norm(pc[..., :2], dim=-1)
        theta = torch.atan2(r, pc[..., 2])
        td = self._theta_d(theta)
        scale = td / torch.clamp(r, min=1e-12)
        return torch.stack([self.fx * scale * pc[..., 0] + self.cx,
                            self.fy * scale * pc[..., 1] + self.cy], dim=-1)

    def lift(self, uv):
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        td = torch.sqrt(mx * mx + my * my)

        # Newton on the scalar polynomial with analytic derivative.
        theta = td
        for _ in range(UNDISTORT_ITERS):
            t2 = theta * theta
            f = self._theta_d(theta) - td
            df = 1.0 + t2 * (3 * self.k2 + t2 * (5 * self.k3 + t2 * (7 * self.k4 + t2 * 9 * self.k5)))
            theta = theta - f / torch.clamp(df, min=1e-12)
        scale = torch.tan(theta) / torch.clamp(td, min=1e-12)
        return torch.stack([mx * scale, my * scale], dim=-1)

    def lift_to_ray(self, uv):
        return _homogeneous(self.lift(uv))


def make_camera(model_type: str, **params):
    """Factory by model name, mirroring CameraFactory::generateCamera
    (reference: CameraFactory.cc:90 — KANNALA_BRANDT/MEI/PINHOLE/
    SCARAMUZZA switch)."""
    mt = model_type.upper()
    if mt in ("PINHOLE",):
        return PinholeCamera(**params)
    if mt in ("KANNALA_BRANDT", "EQUIDISTANT", "FISHEYE"):
        return EquidistantCamera(**params)
    if mt in ("MEI", "CATA"):
        return CataCamera(**params)
    if mt in ("SCARAMUZZA", "OCAM"):
        return ScaramuzzaCamera(**params)
    raise ValueError(f"unknown camera model {model_type!r}")


def camera_from_yaml(path: str):
    """Build a camera from a camodocal-style OpenCV YAML file
    (reference: CameraFactory::generateCameraFromYamlFile,
    CameraFactory.cc:90; euroc_config.yaml schema).  Parses the cv
    FileStorage dialect (leading ``%YAML:1.0`` directive) without OpenCV."""
    import re
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r"^%YAML:[\d.]+\n", "", text)
    text = text.replace("!!opencv-matrix", "")
    import yaml
    doc = yaml.safe_load(text)

    mt = str(doc.get("model_type", "PINHOLE")).upper()
    w = int(doc.get("image_width", 0))
    h = int(doc.get("image_height", 0))
    if mt == "PINHOLE":
        d = doc.get("distortion_parameters", {})
        p = doc.get("projection_parameters", {})
        return PinholeCamera(fx=p["fx"], fy=p["fy"], cx=p["cx"], cy=p["cy"],
                             k1=d.get("k1", 0.0), k2=d.get("k2", 0.0),
                             p1=d.get("p1", 0.0), p2=d.get("p2", 0.0),
                             width=w, height=h)
    if mt == "KANNALA_BRANDT":
        p = doc.get("projection_parameters", {})
        return EquidistantCamera(fx=p["mu"], fy=p["mv"], cx=p["u0"], cy=p["v0"],
                                 k2=p.get("k2", 0.0), k3=p.get("k3", 0.0),
                                 k4=p.get("k4", 0.0), k5=p.get("k5", 0.0),
                                 width=w, height=h)
    if mt == "MEI":
        mp = doc.get("mirror_parameters", {})
        d = doc.get("distortion_parameters", {})
        p = doc.get("projection_parameters", {})
        return CataCamera(xi=mp["xi"], gamma1=p["gamma1"], gamma2=p["gamma2"],
                          u0=p["u0"], v0=p["v0"],
                          k1=d.get("k1", 0.0), k2=d.get("k2", 0.0),
                          p1=d.get("p1", 0.0), p2=d.get("p2", 0.0),
                          width=w, height=h)
    if mt == "SCARAMUZZA":
        pp = doc.get("poly_parameters", {})
        ip = doc.get("inv_poly_parameters", {})
        ap = doc.get("affine_parameters", {})
        poly = tuple(pp[f"p{i}"] for i in range(len(pp)))
        inv_poly = tuple(ip[f"p{i}"] for i in range(len(ip)))
        # camodocal key map (ScaramuzzaCamera.cc:98-103): ac→c, ad→d, ae→e,
        # cx→xc (image center), cy→yc
        return ScaramuzzaCamera(poly=poly, inv_poly=inv_poly,
                                xc=ap.get("cx", ap.get("xc", 0.0)),
                                yc=ap.get("cy", ap.get("yc", 0.0)),
                                c=ap.get("ac", ap.get("c", 1.0)),
                                d=ap.get("ad", ap.get("d", 0.0)),
                                e=ap.get("ae", ap.get("e", 0.0)),
                                width=w, height=h)
    raise ValueError(f"unknown model_type {mt!r} in {path}")
