"""The library route of the pose graph's damped solve against its
roofline in the traced slice: the least time of the slice's damped
solves on that route (``roofline.counts.spd_solve_s`` at each padded P,
in the estimator's dtype, times the attempts the pose graph made at that
P: one damped solve an attempt, ``pg_attempts_P<P>``) over the device
time of the library's factorisation and triangular-solve kernels
(``KERNELS``: cuSOLVER's unpivoted factorisation, which its Cholesky
runs, and its triangular solves).  None where the slice made no such
solve or ran none of those kernels."""
from benchmark.harness.trace import kernel_seconds
from benchmark.roofline import counts

KERNELS = ("getrf_wo_pivot", "trsv_lt_exec", "trsv_ln_exec")


def read(run):
    s = run.trace_summary
    if s is None:
        return None
    tally = {int(k[len("pg_attempts_P"):]): v for k, v in s["counters"].items()
             if k.startswith("pg_attempts_P") and v}
    if not tally:
        return None
    dtype = run.cell.config["estimator_dtype"]
    least = sum(n * counts.spd_solve_s(P, dtype) for P, n in tally.items())
    t = kernel_seconds(s, *KERNELS)
    if least <= 0 or t <= 0:
        return None
    return 100.0 * least / t
