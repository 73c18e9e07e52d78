"""Run one cell of the benchmark of the PyTorch and CUDA port once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last the numbers compared with
their limits under ``checks``); the same numbers and limits are the last
lines of standard error.  Without as many CUDA devices as the cell asks
for, it exits with 2 and prints no result.  See ``harness/bench.py``."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(t_start=T_START))
