"""The 95th percentile of the window's frame latencies, handoff to pose
on the host, over every frame handed in during the window that gave one."""
import numpy as np


def read(run):
    lat = [f["t_out"] - f["t_in"] for f in run.frames if f["t_out"] is not None]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
