"""Nothing the benchmark loads imports JAX or the JAX package."""
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _modules() -> list[str]:
    out = []
    for p in sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or p.name in ("run.py", "readings.py"):
            continue
        out.append(".".join(rel.parts).removesuffix(".__init__"))
    return out


def test_no_module_imports_jax():
    mods = _modules()
    assert "benchmark.reference.window" in mods and "benchmark.drivers.features" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import vio_tpu_torch.runner, vio_tpu_torch.estimator\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "vio_tpu"}, top
    assert "vio_tpu_torch" in top


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys\n"
            "import benchmark.reference.window, benchmark.reference.prior\n"
            "import benchmark.reference.posegraph, benchmark.reference.check\n"
            "import benchmark.reference.judges.window, benchmark.reference.judges.prior\n"
            "import benchmark.reference.judges.posegraph\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "vio_tpu", "vio_tpu_torch"}, top


def test_without_the_program_the_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sim_features",
                          "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
