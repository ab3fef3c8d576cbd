"""The benchmark's own tests, on the CPU: ``python -m pytest bench_torch/tests``
from the root of the checkout."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
