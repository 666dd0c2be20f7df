"""Build and load the port's native code (plain C interfaces, ctypes).

``load()`` compiles every ``vio_tpu_torch/csrc/*.cu`` with nvcc for
``sm_90a`` (one nvcc a source, all started together, then one link) into
one shared library under ``vio_tpu_torch/_build/``, at first use and
again whenever a source is newer than the library, and loads it.
``load_pairer()`` does the same for the host-only measurement pairer
(``csrc/pairer.cpp``) with g++, into a library of its own, so a machine
with g++ and no nvcc can build it.  A missing compiler or a
failed compile raises: there is no fallback.  Both are safe to call from
several threads.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
LIB = BUILD_DIR / "libvio_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
PAIRER_SRC = CSRC / "pairer.cpp"
PAIRER_LIB = BUILD_DIR / "libvio_tpu_torch_pairer.so"
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-pthread"]
_LOCK = threading.Lock()   # one build at a time within a process

# The kernel wrappers whose launches a CUDA graph holds (``solver/graph.py``),
# each registered by ``counted`` where it is defined.
COUNTED: list = []


def counted(fn):
    """Register a kernel wrapper with the graph cache: ``fn.launches``
    counts its launches on the card, a graph's replays included, and
    ``fn.captured`` the launches it records into CUDA graphs; the wrapper
    adds to one or the other at each launch, and each replay of a graph
    adds the launches the graph holds."""
    fn.launches = 0
    fn.captured = 0
    COUNTED.append(fn)
    return fn


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


def _stale(lib: Path, sources: list[Path]) -> bool:
    """True when the library is missing or older than a source."""
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources)


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise on the first that fails.  Returns
    their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed ({p.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    return "".join(out + err for out, err in outs)


def _compile(compiler: list[str], sources: list[Path], lib: Path) -> dict:
    """Compile each of ``sources`` into an object, all at once, and link
    them into ``lib``, if it is stale.  Returns {"built": bool, "seconds":
    float, "log": the compiler's output}."""
    with _LOCK:
        if not _stale(lib, sources):
            return dict(built=False, seconds=0.0, log="")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
            flags = [f for f in compiler[1:] if f != "-shared"]
            log = _run([[compiler[0], *flags, "-c", "-o", obj, str(src)]
                        for src, obj in zip(sources, objs)])
            out = str(Path(tmp) / lib.name)
            log += _run([[*compiler, "-o", out, *objs]])
            os.replace(out, lib)   # atomic: a concurrent loader sees old or new
        return dict(built=True, seconds=time.perf_counter() - t0, log=log)


def build() -> dict:
    """Compile the kernels' library if it is stale; "log" is nvcc's
    register/smem report."""
    return _compile([_nvcc(), *NVCC_FLAGS], _sources(), LIB)


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
    for name in ("preintegrate_f32", "preintegrate_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 19 + [ci, ci, ci, vp]
        fn.restype = ci
    for name in ("imu_factor_f32", "imu_factor_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 18 + [ci, vp]
        fn.restype = ci
    lib.gj_solve_error_string.argtypes = [ci]
    lib.gj_solve_error_string.restype = ctypes.c_char_p
    for name, scalar in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fn = getattr(lib, f"essential_sweep_{name}")
        fn.argtypes = [vp, vp, vp, vp, ci, ci, scalar, vp, vp, vp, vp]
        fn.restype = ci
        fn = getattr(lib, f"essential_refit_{name}")
        fn.argtypes = [vp, vp, vp, vp, ci, scalar, vp, vp, vp, vp, vp]
        fn.restype = ci
        fn = getattr(lib, f"essential_refit_best_{name}")
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, scalar, vp, vp, vp, vp, vp]
        fn.restype = ci
    return lib


def build_pairer() -> dict:
    """Compile the measurement pairer's library with g++ if it is stale."""
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    if gxx is None:
        raise RuntimeError("g++ not found (PATH, CXX): the measurement pairer "
                           "cannot be built")
    return _compile([gxx, *GXX_FLAGS], [PAIRER_SRC], PAIRER_LIB)


@functools.lru_cache(maxsize=None)
def load_pairer() -> ctypes.CDLL:
    """Build if needed, then load the pairer and declare its C entry points."""
    build_pairer()
    lib = ctypes.CDLL(str(PAIRER_LIB))
    vp, ci, i64, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
    lib.pairer_new.argtypes, lib.pairer_new.restype = [], vp
    lib.pairer_free.argtypes, lib.pairer_free.restype = [vp], None
    lib.pairer_push_imu.argtypes, lib.pairer_push_imu.restype = [vp] + [d] * 7, ci
    lib.pairer_push_frame.argtypes, lib.pairer_push_frame.restype = [vp, d, i64], ci
    lib.pairer_next.argtypes = [vp, ci, ctypes.POINTER(d), ctypes.POINTER(i64)]
    lib.pairer_next.restype = i64
    lib.pairer_rows.argtypes, lib.pairer_rows.restype = [vp, vp], None
    lib.pairer_stats.argtypes, lib.pairer_stats.restype = [vp, vp], None
    lib.pairer_close.argtypes, lib.pairer_close.restype = [vp], None
    return lib
