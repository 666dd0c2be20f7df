"""The benchmark's command: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints the run's result as the last
line of standard output, and the numbers that decided ``correct``,
each with its limit, as the last lines of standard error.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one host thread for the libraries' own pools: the frame's host work is
# small matrices, and idle pool threads spinning beside it spread the times
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_v] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T0))
