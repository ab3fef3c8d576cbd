"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic, driver,
reference, per-layer metric readers and limits are found by name (see
README.md). Needs a CUDA card: without one it exits with 2 and prints no
result. The last line of standard output is the result as one JSON object;
the last lines of standard error are the numbers compared, each beside its
limit.
"""

import time

T_START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T_START))
