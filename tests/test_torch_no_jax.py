"""The port never imports JAX, directly or through vio_tpu, and importing
it builds nothing: checked in a fresh interpreter, since this test
process has JAX loaded already."""
import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "vio_tpu_torch", "vio_tpu_torch.camera", "vio_tpu_torch.checkpoint",
    "vio_tpu_torch.config", "vio_tpu_torch.convert", "vio_tpu_torch.device",
    "vio_tpu_torch.estimator", "vio_tpu_torch.factors",
    "vio_tpu_torch.feature_manager", "vio_tpu_torch.features",
    "vio_tpu_torch.features.clahe", "vio_tpu_torch.features.detect",
    "vio_tpu_torch.features.klt", "vio_tpu_torch.features.orb",
    "vio_tpu_torch.features.pyramid",
    "vio_tpu_torch.features.tracker", "vio_tpu_torch.imu",
    "vio_tpu_torch.loop", "vio_tpu_torch.loop.closer",
    "vio_tpu_torch.loop.posegraph", "vio_tpu_torch.loop.vocab",
    "vio_tpu_torch.metrics", "vio_tpu_torch.runner", "vio_tpu_torch.runtime",
    "vio_tpu_torch.sim",
    "vio_tpu_torch.init.alignment", "vio_tpu_torch.init.ex_rotation",
    "vio_tpu_torch.init.sfm", "vio_tpu_torch.ops._build",
    "vio_tpu_torch.ops.linsolve", "vio_tpu_torch.ops.ransac",
    "vio_tpu_torch.solver.frame_step",
    "vio_tpu_torch.solver.generic", "vio_tpu_torch.solver.graph",
    "vio_tpu_torch.solver.lm",
    "vio_tpu_torch.solver.marginalize", "vio_tpu_torch.solver.pcg",
    "vio_tpu_torch.solver.window", "vio_tpu_torch.utils.lie",
    "vio_tpu_torch.utils.lie_np", "vio_tpu_torch.testing",
    "vio_tpu_torch.solver.blockba", "vio_tpu_torch.solver.bal",
    "vio_tpu_torch.features.direct", "vio_tpu_torch.parallel",
    "vio_tpu_torch.parallel.global_ba", "vio_tpu_torch.parallel.sharded",
    "vio_tpu_torch.parallel.collective", "vio_tpu_torch.utils.tree",
    "vio_tpu_torch.io", "vio_tpu_torch.features.stereo", "vio_tpu_torch.init.icp",
    "vio_tpu_torch.calib", "vio_tpu_torch.calib.allan",
    "vio_tpu_torch.calib.intrinsics", "vio_tpu_torch.hybrid", "vio_tpu_torch.viz",
    "vio_tpu_torch.cli", "vio_tpu_torch.bench", "vio_tpu_torch.trace",
]

_PROBE = """
import importlib, json, sys
import torch
from vio_tpu_torch.ops import _build
compiles = []
_build.subprocess.run = lambda *a, **k: compiles.append(a)   # nvcc or g++
for m in {modules!r}:
    importlib.import_module(m)
print(json.dumps(dict(
    jax=sorted(k for k in sys.modules
               if k in ("jax", "vio_tpu", "vio_native") or k.startswith(("jax.", "vio_tpu."))),
    tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
    built=bool(compiles))))
"""


def test_module_list_is_complete():
    """Every module of the package is in MODULES, so a new one cannot
    escape the probe."""
    pkg = os.path.join(ROOT, "vio_tpu_torch")
    found = set()
    for base, _, files in os.walk(pkg):
        if os.path.basename(base) in ("__pycache__", "_build"):
            continue
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(base, f), ROOT)[:-3]
                found.add(rel.replace(os.sep, ".").removesuffix(".__init__"))
    empty_inits = {"vio_tpu_torch.init", "vio_tpu_torch.ops",
                   "vio_tpu_torch.solver", "vio_tpu_torch.utils"}
    assert found - empty_inits == set(MODULES)


def test_port_imports_no_jax_and_builds_nothing():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(modules=MODULES)],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == [], out["jax"]
    assert out["tf32"] == [False, False]
    assert out["built"] is False
