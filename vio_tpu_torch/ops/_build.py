"""Build and load the port's CUDA kernels (plain C interface, ctypes).

``load()`` compiles every ``vio_tpu_torch/csrc/*.cu`` with nvcc for
``sm_90a`` into one shared library under ``vio_tpu_torch/_build/``, at
first use and again whenever a source is newer than the library, and
loads it.  A missing nvcc or a failed compile raises: there is no
fallback.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
LIB = BUILD_DIR / "libvio_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _stale() -> bool:
    """True when the library is missing or older than a source."""
    if not LIB.exists():
        return True
    built = LIB.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def build() -> dict:
    """Compile the library if it is stale.  Returns {"built": bool,
    "seconds": float, "log": nvcc's output (register/smem report)}."""
    if not _stale():
        return dict(built=False, seconds=0.0, log="")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB)   # atomic: a concurrent loader sees old or new
    return dict(built=True, seconds=seconds, log=proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its C entry points."""
    build()
    lib = ctypes.CDLL(str(LIB))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("gj_solve_f32", "gj_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, ci, vp]
        fn.restype = ci
    lib.gj_solve_work_elems.argtypes = [ci, ci]
    lib.gj_solve_work_elems.restype = ctypes.c_longlong
    lib.gj_solve_error_string.argtypes = [ci]
    lib.gj_solve_error_string.restype = ctypes.c_char_p
    return lib
