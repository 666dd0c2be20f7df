"""Where a pivot step of the register-resident Gauss-Jordan kernel spends
its clocks (vio_tpu_torch/csrc/gj_solve.cu, float32).

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_gj_step_cost.py

It compiles instrumented copies of the kernel's source into a temporary
directory -- the pivot loop bracketed by ``clock64()`` -- in variants that
each take one part of the step away, and prints clocks per step and the
time of back-to-back launches for each.  The variants other than ``full``
compute wrong answers on purpose; only their times mean anything:

- ``full``: the kernel as it is;
- ``no_rest``: without the FMAs that follow the next pivot's publication;
- ``no_col_shuffle``: the column taken from the thread's own registers
  instead of by shuffle from the owning lane;
- ``no_sync``: without the split barrier's wait and arrive;
- ``no_rcp``: the pivot row published unscaled, without the pivot's
  shuffle and reciprocal (the owner warp's dependent chain);
- ``approx_rcp``: ``rcp.approx.ftz.f32`` in place of the correctly rounded
  reciprocal (what giving up IEEE rounding there would buy);
- ``no_row_load``: the row made up in registers instead of read from the
  stash in shared memory;
- ``loop_only``: all five taken away: the loop, the next row's update
  and its stores.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_tpu_torch.ops import _build  # noqa: E402

VARIANTS = (("full", []), ("no_rest", ["-DNO_REST"]),
            ("no_col_shuffle", ["-DNO_CSHFL"]), ("no_sync", ["-DNO_SYNC"]),
            ("no_rcp", ["-DNO_RCP"]), ("approx_rcp", ["-DAPPROX_RCP"]),
            ("no_row_load", ["-DNO_RLDS"]),
            ("loop_only", ["-DNO_REST", "-DNO_CSHFL", "-DNO_SYNC", "-DNO_RCP", "-DNO_RLDS"]))
SIZES = (127, 171)          # the last P of the 8x4 tile and the estimator's P

SHFL_PIVOT = "__shfl_sync(0xffffffffu, m[II][JJ], (II % 2) * kTY + t)"
SHFL_COLUMN = "__shfl_sync(0xffffffffu, m[ii][JJ], (II % 2) * kTY + t)"


def _either(flag: str, without: str, with_: str) -> str:
    return f"#ifdef {flag}\n{without}\n#else\n{with_}\n#endif"


# (text in gj_solve.cu, its replacement, how often it occurs there)
EDITS = (
    # a device symbol for the loop's clocks, and a C function to read it
    ("namespace {\n", "namespace {\n__device__ long long g_clk;\n", 1),
    ('extern "C" {\n',
     'extern "C" {\nlong long gj_loop_clocks() { long long v; '
     'cudaMemcpyFromSymbol(&v, g_clk, sizeof(v)); return v; }\n', 1),
    ("  gj_reg_publish<T, RY, RX, 0>(m, rowst, 0, tx, ty);\n",
     "  const long long t0 = clock64();\n"
     "  gj_reg_publish<T, RY, RX, 0>(m, rowst, 0, tx, ty);\n", 1),
    ("  if (tx == P % kTX) {",
     "  if (threadIdx.x == 0) g_clk = clock64() - t0;\n  if (tx == P % kTX) {", 1),
    # float32 only
    ("  return launch<double>(A, b, x, work, P, static_cast<cudaStream_t>(stream));",
     "  return 1;", 1),
    # the variants
    ("      if ((ii == RW) == FIRST) m[ii][jj] -= c[ii] * r[jj];",
     _either("NO_REST", "      if (FIRST && ii == RW) m[ii][jj] -= c[ii] * r[jj];",
             "      if ((ii == RW) == FIRST) m[ii][jj] -= c[ii] * r[jj];"), 1),
    (f"      c[ii] = {SHFL_COLUMN};",
     _either("NO_CSHFL", "      c[ii] = m[ii][JJ] * T(1e-30);",
             f"      c[ii] = {SHFL_COLUMN};"), 1),
    ("    mbar_wait(bar, buf);", _either("NO_SYNC", "", "    mbar_wait(bar, buf);"), 1),
    ("      mbar_arrive_warp(bar);",
     _either("NO_SYNC", "", "      mbar_arrive_warp(bar);"), 2),
    (f"    const T inv = rcp({SHFL_PIVOT});",
     "#if defined(NO_RCP)\n"
     "    const T inv = T(1);\n"
     "#elif defined(APPROX_RCP)\n"
     "    T inv;\n"
     f'    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"({SHFL_PIVOT}));\n'
     "#else\n"
     f"    const T inv = rcp({SHFL_PIVOT});\n"
     "#endif", 1),
    ("    for (int jj = JJ; jj < RX; ++jj) r[jj] = rowst[buf * kRow + jj * kTX + tx];",
     _either("NO_RLDS",
             "    for (int jj = JJ; jj < RX; ++jj) r[jj] = T(1e-30) * (jj + tx);",
             "    for (int jj = JJ; jj < RX; ++jj) r[jj] = rowst[buf * kRow + jj * kTX + tx];"), 1),
)


def instrumented_source() -> str:
    src = (_build.CSRC / "gj_solve.cu").read_text()
    for old, new, count in EDITS:
        if src.count(old) != count:
            raise RuntimeError(f"gj_solve.cu no longer has {old!r} {count} time(s)")
        src = src.replace(old, new)
    return src


def spd(P: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    M = torch.randn((P, P), generator=gen, dtype=torch.float64)
    A = M @ M.T + P * torch.eye(P, dtype=torch.float64)
    b = torch.randn((P,), generator=gen, dtype=torch.float64)
    return A.to("cuda", torch.float32), b.to("cuda", torch.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gj_step_cost: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    vp = ctypes.c_void_p
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / "gj_solve_instrumented.cu"
        cu.write_text(instrumented_source())
        for name, flags in VARIANTS:
            so = Path(tmp) / f"{name}.so"
            flags_all = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
            subprocess.run([_build._nvcc(), *flags_all, *flags, "-o", str(so), str(cu)],
                           check=True, capture_output=True, text=True)
            lib = ctypes.CDLL(str(so))
            lib.gj_solve_f32.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp]
            lib.gj_solve_f32.restype = ctypes.c_int
            lib.gj_loop_clocks.restype = ctypes.c_longlong
            for P in SIZES:
                A, b = spd(P, seed=P)
                x = torch.empty_like(b)
                stream = vp(torch.cuda.current_stream().cuda_stream)

                def solve():
                    rc = lib.gj_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                                          None, P, stream)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: CUDA error {rc}")

                for _ in range(5):
                    solve()
                torch.cuda.synchronize()
                clocks = lib.gj_loop_clocks()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(200):
                    solve()
                end.record()
                torch.cuda.synchronize()
                print(f"{name} float32 P={P}: pivot loop {clocks} clocks = "
                      f"{clocks / P:.1f} per step; "
                      f"{start.elapsed_time(end) / 200 * 1e3:.2f} us per launch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
