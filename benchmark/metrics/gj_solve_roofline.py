"""The SPD solve kernel's share of its roofline in the traced slice: the
least time of the slice's solves (``roofline.counts.spd_solve_s`` at the
window's pose dimension P and the estimator's dtype) over the device
time of the kernel's launches (``gj_reg_kernel``, ``gj_blk_*``)."""
from benchmark.harness.trace import kernel_seconds
from benchmark.roofline import counts


def read(run):
    s = run.trace_summary
    if s is None:
        return None
    n = s["counters"]["gj_solves"]
    t = kernel_seconds(s, "gj_reg_kernel", "gj_blk_")
    if not n or t <= 0:
        return None
    cfg = run.cell.config
    P = 6 + 15 * (cfg["settings"]["window_size"] + 1)
    return 100.0 * n * counts.spd_solve_s(P, cfg["estimator_dtype"]) / t
