"""The one generator of the benchmark's traffic.

A traffic file (``traffic/<name>.json``) says what the stream carries:
``stream`` (``features``: the simulator's published landmarks), whether
the IMU carries its noise and bias walks (``imu_noise``) and a pixel
noise on the published features (``pixel_noise``).  The configuration's ``sensor`` gives the rates, the camera
and the noise densities; the workload's ``warmup_frames`` and
``ceiling_frames_per_s`` how long the stream is: the warm-up plus
the window at the ceiling rate.  Everything is drawn from the run's seed.
"""
from __future__ import annotations

import math

from benchmark.harness import stream


def vio_config(config: dict):
    """The program's configuration object from a configuration file."""
    from vio_tpu_torch.config import VioConfig
    s = {k: tuple(v) if isinstance(v, list) else v for k, v in config["settings"].items()}
    return VioConfig(**s)


def n_frames(cell, seconds: float) -> int:
    w = cell.workload
    return int(w["warmup_frames"] + math.ceil(w["ceiling_frames_per_s"] * seconds) + 2)


def generate(cell, seed: int, seconds: float) -> stream.SimData:
    """The camera-IMU stream of a run."""
    tr, sensor = cell.traffic, cell.config["sensor"]
    if tr["stream"] != "features":
        raise SystemExit(f"traffic/{cell.entry['traffic']}.json: no generator for a "
                         f"{tr['stream']!r} stream")
    n = n_frames(cell, seconds)
    return stream.generate(noise=bool(tr["imu_noise"]), seed=seed,
                           t_end=n / sensor["cam_hz"], pixel_noise=tr["pixel_noise"],
                           **sensor)

