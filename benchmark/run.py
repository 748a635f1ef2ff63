"""Run one cell of BENCHMARK.json once:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line (the result) as the last
line of standard output. The port's CUDA libraries are built into the
package's ``_build/`` on the first run of a checkout; every other cache
the run's libraries may keep is pinned under ``.bench_cache/`` in the
checkout (``harness.pin_caches``).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.pin_caches()
    sys.exit(harness.main(sys.argv[1:], T_START))
