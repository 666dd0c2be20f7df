"""Where the RANSAC kernels' time goes on the card: variants of
``vio_tpu_torch/csrc/essential_ransac.cu`` built side by side, each timed
as the tracker runs the kernels (20 calls captured into a CUDA graph,
replayed 10 times between CUDA events).

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_ransac_ablation.py

The variants are the source as built and the source with one piece cut
or swapped by a text substitution (the script stops if the piece is not
found):

- ``division rotation``: the Jacobi rotation from zeta = (beta - alpha) /
  2 gamma with two divisions and two hypots, the form before the
  division-free one;
- ``no refit Jacobi``: the refit takes the last row of its triangle in
  place of the Jacobi's null vector (its E is wrong: timing only);
- ``no projection``: both kernels take the null vector as E, without the
  3 x 3 Jacobi (timing only).

The inputs are seeded: 150 correspondences of a random scene under a
frame-to-frame motion, 60 of them valid, 256 samples of 8 valid rows.
Prints the device microseconds a call of the sweep and of refit_best for
each variant and type, and each variant's E and counts against the
source as built.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torch_ransac_profile import graph_ms  # noqa: E402
from vio_tpu_torch.ops import _build  # noqa: E402

SOURCE = _build.CSRC / "essential_ransac.cu"
THRESH = 1.0 / 460.0

DIVISION_ROTATION = '''  if (!(fabs(gamma) > tol * sqrt(alpha) * sqrt(beta))) return false;
  const Work zeta = (beta - alpha) / (2 * gamma);
  const Work t = copysign(Work(1), zeta) / (fabs(zeta) + hypot(Work(1), zeta));
  c = 1 / hypot(Work(1), t);
  s = c * t;
  return true;
}'''

VARIANTS = {
    "as built": [],
    "division rotation": [(
        '''  if (!(gamma * gamma > (tol * tol) * (alpha * beta))) return false;
  const Work d = beta - alpha, g2 = 2 * gamma;
  const Work den = fabs(d) + sqrt(fma(d, d, g2 * g2));
  const Work h = rsqrt(fma(den, den, g2 * g2));
  c = den * h;
  s = copysign(Work(1), d) * g2 * h;
  return true;
}''', DIVISION_ROTATION)],
    "no refit Jacobi": [(
        "    jacobi_null(Rs[0], lane, e);",
        "    for (int i = 0; i < kCols; ++i) e[i] = Rs[0][kCols - 1][i];")],
    "no projection": [(
        "__device__ __forceinline__ void project_essential(const Work (&e)[9], Work (&out)[9]) {",
        "__device__ __forceinline__ void project_essential(const Work (&e)[9], Work (&out)[9]) {\n"
        "  for (int i = 0; i < 9; ++i) out[i] = e[i];\n  return;")],
}


def build(tmp: Path) -> dict:
    """Each variant's library, built with one nvcc each, all at once."""
    text = SOURCE.read_text()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the piece to swap is not in {SOURCE.name}: {old!r}")
            src = src.replace(old, new)
        cu, so = tmp / f"v{i}.cu", tmp / f"v{i}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *flags, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for t, sc in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, f"essential_sweep_{t}")
            fn.argtypes, fn.restype = [vp, vp, vp, vp, ci, ci, sc, vp, vp, vp, vp], ci
            fn = getattr(lib, f"essential_refit_best_{t}")
            fn.argtypes, fn.restype = [vp, vp, vp, vp, vp, ci, ci, sc, vp, vp, vp, vp, vp], ci
        libs[name] = lib
    return libs


def inputs(dtype, N=150, n_valid=60, n_hyp=256, seed=4):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-3, 3, N), rng.uniform(5, 10, N)], 1)
    th = 1e-2 * np.array([0.05, -0.12, 0.04])
    R = np.eye(3) + np.array([[0, -th[2], th[1]], [th[2], 0, -th[0]], [-th[1], th[0], 0]])
    c1 = pts @ R.T + 1e-2 * np.array([0.6, -0.2, 0.1])
    x0 = pts[:, :2] / pts[:, 2:]
    x1 = c1[:, :2] / c1[:, 2:] + rng.normal(0.0, 3e-6, (N, 2))
    valid = np.zeros(N, bool)
    valid[rng.choice(N, n_valid, replace=False)] = True
    rows = np.where(valid)[0]
    idx = np.stack([rng.choice(rows, 8, replace=False) for _ in range(n_hyp)])
    dev = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device="cuda")  # noqa: E731
    return dev(x0, dtype), dev(x1, dtype), dev(valid), dev(idx)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ransac_ablation: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    tag = f"[{smi.splitlines()[0]}]"
    print(smi)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for dtype in (torch.float32, torch.float64):
            x0, x1, valid, idx = inputs(dtype)
            N, H = x0.shape[0], idx.shape[0]
            t = "f32" if dtype == torch.float32 else "f64"
            scalar = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
            ref = None
            for name, lib in libs.items():
                E = torch.empty((H, 3, 3), dtype=dtype, device="cuda")
                n = torch.empty((H,), dtype=torch.int64, device="cuda")
                Eb = torch.empty((3, 3), dtype=dtype, device="cuda")
                inl = torch.empty((N,), dtype=torch.bool, device="cuda")
                cb = torch.empty((), dtype=torch.int64, device="cuda")

                def sweep(lib=lib, E=E, n=n, name=name):
                    rc = getattr(lib, f"essential_sweep_{t}")(
                        x0.data_ptr(), x1.data_ptr(), valid.data_ptr(), idx.data_ptr(), N, H,
                        scalar(THRESH * THRESH), E.data_ptr(), n.data_ptr(), None,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: sweep launch failed: CUDA error {rc}")

                def best(lib=lib, E=E, n=n, Eb=Eb, inl=inl, cb=cb, name=name):
                    rc = getattr(lib, f"essential_refit_best_{t}")(
                        x0.data_ptr(), x1.data_ptr(), valid.data_ptr(), E.data_ptr(),
                        n.data_ptr(), H, N, scalar(THRESH ** 2), Eb.data_ptr(), inl.data_ptr(),
                        cb.data_ptr(), None, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: refit_best launch failed: CUDA error {rc}")

                sweep()
                best()
                torch.cuda.synchronize()
                if ref is None:
                    ref = E.clone(), n.clone(), Eb.clone()
                dE = float(torch.minimum((E - ref[0]).abs().amax((1, 2)),
                                         (E + ref[0]).abs().amax((1, 2))).max())
                dEb = float(min((Eb - ref[2]).abs().max(), (Eb + ref[2]).abs().max()))
                print(f"{str(dtype)[6:]} {name:18s} sweep {1e3 * graph_ms(sweep):7.2f} us, "
                      f"refit_best {1e3 * graph_ms(best):7.2f} us; against as built: sweep "
                      f"max |dE| {dE:.2e}, counts equal {float((n == ref[1]).float().mean()):.3f}, "
                      f"refit_best |dE| {dEb:.2e} {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
