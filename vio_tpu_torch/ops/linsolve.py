"""Small dense SPD solve: a hand-written CUDA Gauss-Jordan kernel.

Port of ``vio_tpu/ops/linsolve.py``.  The TPU kernel ``_gj_solve_pallas``
becomes ``csrc/gj_solve.cu`` (see the note there), called through
``gj_solve``; ``gj_solve_reference`` is the same elimination in plain
torch.  ``spd_solve`` sends a CUDA tensor to the kernel and a CPU tensor
to the plain version; it never falls back from one to the other.

The kernel has two regimes, chosen by size: the system in one block's
registers (float32 P ≤ 176, float64 P ≤ 127), else a blocked elimination
in panels of 32 pivots over many blocks.  ``gj_solve_reference`` follows
the same rule, so that where kernel and plain version are compared they
do the same arithmetic in the same order.

Gauss-Jordan without pivoting is safe because every system solved here is
SPD by construction (JᵀWJ + λI with λ ≥ 1e-5·max|diag|, problem.cc:434-436).
The TPU kernel's padding of A to a multiple of 128 and of b to 128 lanes
follows the TPU's tile shape and is not carried over.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# Largest P the kernel keeps in registers, by element size (gj_solve.cu's
# kRegMaxP), and its panel width above that (kNB).
REGISTER_MAX_P = {torch.float32: 176, torch.float64: 127}
PANEL = 32
# The kernel's largest system (gj_solve.cu's kMaxP), a float64 working
# copy of 136 MB.  Nothing in the blocked regime's indexing or grid
# depends on it.
KERNEL_MAX_P = 4096
# spd_solve's largest direct solve; larger systems go to Jacobi-PCG, as in
# vio_tpu (vio_tpu/ops/linsolve.py:95).
DIRECT_MAX_P = 1024


def _eliminate(S: torch.Tensor) -> None:
    """Gauss-Jordan without pivoting, in place, on the rows of S (r, w)
    whose pivots are its first r diagonal entries, in the order of the TPU
    kernel (linsolve.py:47-61): scale row k by the pivot's reciprocal,
    then subtract column k × row k from every other row.  Columns left of
    k never feed the columns right of it again, so each step updates
    columns k.. only, as the CUDA kernel does."""
    for k in range(S.shape[0]):
        rowk = S[k, k:] * (1.0 / S[k, k])
        c = S[:, k].clone()
        S[:, k:].addr_(c, rowk, alpha=-1)   # row k too; overwritten next
        S[k, k:] = rowk


def gj_solve_unblocked_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's register regime: one elimination
    over the whole of [A | b] → x (P,)."""
    M = torch.cat([A, b[:, None]], dim=1)
    _eliminate(M)
    return M[:, -1]


def gj_solve_blocked_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's blocked regime: for each panel of
    PANEL pivots, eliminate inside the panel's rows, then subtract
    (the other rows' panel columns) × (the normalised panel rows) from
    the columns right of the panel."""
    P = A.shape[0]
    M = torch.cat([A, b[:, None]], dim=1)
    for kb in range(0, P, PANEL):
        ke = min(kb + PANEL, P)
        _eliminate(M[kb:ke, kb:])
        R = M[kb:ke, ke:]
        M[:kb, ke:] -= M[:kb, kb:ke] @ R
        M[ke:, ke:] -= M[ke:, kb:ke] @ R
    return M[:, -1]


def gj_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain torch version: the unblocked elimination where
    the kernel runs in registers, the blocked one above that."""
    if A.shape[0] <= REGISTER_MAX_P[A.dtype]:
        return gj_solve_unblocked_reference(A, b)
    return gj_solve_blocked_reference(A, b)


@_build.counted
def gj_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b (A (P, P) SPD, b (P,)) with the CUDA kernel, on the
    current stream, without synchronising.  Takes float32 or float64
    CUDA tensors; raises on anything else, on a build failure and on a
    refused launch."""
    if not (A.is_cuda and b.is_cuda and A.device == b.device):
        raise ValueError("gj_solve takes CUDA tensors on one device")
    if A.dtype != b.dtype or A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"gj_solve takes float32 or float64, got {A.dtype}/{b.dtype}")
    P = A.shape[0]
    if A.shape != (P, P) or b.shape != (P,) or not 1 <= P <= KERNEL_MAX_P:
        raise ValueError(f"gj_solve shapes: A {tuple(A.shape)}, b {tuple(b.shape)}")
    A = A.contiguous()
    b = b.contiguous()
    lib = _build.load()
    x = torch.empty_like(b)
    n_work = lib.gj_solve_work_elems(P, A.element_size())
    work = (torch.empty(n_work, dtype=A.dtype, device=A.device)
            if n_work else None)      # the blocked regime's working copy
    fn = lib.gj_solve_f32 if A.dtype == torch.float32 else lib.gj_solve_f64
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                work.data_ptr() if n_work else None, P, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"gj_solve launch failed: CUDA error {rc} "
                           f"({lib.gj_solve_error_string(rc).decode()})")
    if torch.cuda.is_current_stream_capturing():
        gj_solve.captured += 1    # recorded, not run: each replay launches it
    else:
        gj_solve.launches += 1
    return x


@_build.counted
def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b (A (P, P) SPD, b (P,)) with the library's Cholesky
    factorisation and its two triangular solves (``torch.linalg.cholesky_ex``
    without its error check, ``torch.cholesky_solve``): nothing is read
    back to the host, so a CUDA graph captures it.  A is SPD by the
    caller's contract, as for ``gj_solve``.  On the card it counts its
    launches as ``gj_solve`` does; the first call of a thread on a device
    should come before any capture (``warm_cholesky``), which makes the
    library's handle."""
    L, _ = torch.linalg.cholesky_ex(A, check_errors=False)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    if A.is_cuda:
        if torch.cuda.is_current_stream_capturing():
            cholesky_solve.captured += 1
        else:
            cholesky_solve.launches += 1
    return x


_CHOLESKY_WARM: set = set()


def warm_cholesky(device, dtype) -> None:
    """One eager library solve on ``device`` in ``dtype`` from this thread,
    once: the solver library's handle and workspace come into being here,
    never inside a capture."""
    key = (threading.get_ident(), torch.device(device), dtype)
    if key in _CHOLESKY_WARM:
        return
    eye = torch.eye(2, dtype=dtype, device=device)
    L, _ = torch.linalg.cholesky_ex(eye, check_errors=False)
    torch.cholesky_solve(eye[:, :1], L)
    _CHOLESKY_WARM.add(key)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system ``A x = b`` (A: (P, P), b: (P,)).

    P ≤ DIRECT_MAX_P (1024): the Gauss-Jordan kernel on a CUDA tensor,
    its plain torch version on a CPU tensor — the unblocked one at every
    size and type, so that a CPU result does not depend on where the
    card's kernel changes regime.  Larger systems go to Jacobi-PCG (solver/pcg.py), as in the
    JAX package (on a CUDA tensor from its captured graphs)."""
    P = A.shape[0]
    if P > DIRECT_MAX_P:
        from ..solver.pcg import pcg_solve
        x, _ = pcg_solve(A, b)
        return x
    if A.is_cuda:
        return gj_solve(A, b)
    return gj_solve_unblocked_reference(A, b)
