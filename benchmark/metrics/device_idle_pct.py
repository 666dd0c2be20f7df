"""The share of the traced slice in which no kernel, copy or fill ran
on the device (1 − the union of its activity over the slice)."""


def read(run):
    s = run.trace_summary
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
