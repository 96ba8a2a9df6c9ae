#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, one cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, their metrics and their bounds
are in ``BENCHMARK.json``; the harness is ``benchmark/harness/``.  The last
line of standard output is the run's result as one JSON object.
"""

import time

START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import launch  # noqa: E402

if __name__ == "__main__":
    sys.exit(launch.main(t0=START))
