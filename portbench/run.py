"""Runs one cell of the benchmark once and prints its result line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells)."""
import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench.bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
