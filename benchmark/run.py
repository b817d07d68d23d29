"""Entry point of the benchmark: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout (see
``harness.py``)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this script's folder, whose module names
# (trace, corpus) would shadow the standard library's
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
