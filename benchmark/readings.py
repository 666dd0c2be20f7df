"""The readings that a cell's limits are set from: many seeds of the
cell, and of its precision control, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds <first> <n> \
        [--control-seeds <first> <n>] --seconds <s>

Each seed is one whole run of the cell (``core.execute``: set-up, the
warm-up, a window of ``--seconds`` at the cell's own load, the check);
only the process, the kernels' library and the graph cache are shared,
so a seed after the first captures nothing.  Prints one JSON line a
seed: the seed, whether it is the control, ``correct``, attempted and
failed frames, and every number compared with its limit.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_v] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import core  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 0))
    ap.add_argument("--control-seeds", type=int, nargs=2, default=(0, 0))
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    core.cache_env()
    from vio_tpu_torch.solver import graph
    graph.clear = lambda: None     # the keys stay captured from seed to seed
    plan = [(s, False) for s in range(a.seeds[0], a.seeds[0] + a.seeds[1])]
    plan += [(s, True) for s in range(a.control_seeds[0], a.control_seeds[0] + a.control_seeds[1])]
    for seed, control in plan:
        args = core.parse(["--workload", a.workload, "--seed", str(seed), "--seconds",
                           str(a.seconds), "--device", a.device])
        t0 = time.perf_counter()
        out = core.execute(args, t0, control=control)
        run = out.pop("_run")
        print(json.dumps(dict(seed=seed, control=control, correct=out["correct"],
                              attempted=out["attempted"], failed=out["failed"],
                              setup_s=run.setup_s, check=out["check"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
