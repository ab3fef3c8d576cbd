#!/usr/bin/env python3
"""Where the port's insertion build spends device time, on one CUDA card.

    python3 scripts/profile_insert_build.py            # 1M x 128
    python3 scripts/profile_insert_build.py --n 100000 --table prof.txt

Builds HnswIndex(HnswConfig(M=30, ef_construction=128), strategy="insert")
over bench.py's clustered data under torch.profiler (CPU + CUDA activity).
Prints the card, the build's wall seconds, the summed time of the
device-side events (kernels, copies, sets: the device's busy share of the
wall), HnswBuilder's own split of the build (device spans of the
level-0-only and upper-level insert searches and of the applies), and the
device events by total time; ``--table`` writes the profiler's full table
to a file. The kernels are built first, outside the profiled window.

It is a script of its own, not a phase of chip_smoke.py, so that the
profiler's tracing never touches the build time chip_smoke reports.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def self_dev_us(evt) -> float:
    """Self device microseconds of a key_averages entry (the attribute name
    moved between torch releases)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--table", type=Path, default=None,
                    help="write the profiler's full table here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_insert_build: no CUDA device", file=sys.stderr)
        return 2
    from hnsw_slim_tpu_torch.config import HnswConfig
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.utils.data import clustered

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cuda.build()
    cuda.lib()
    base, _ = clustered(args.n, 128, n_queries=0,
                        n_clusters=max(64, args.n // 1000), seed=7,
                        scale=0.3)

    h = HnswIndex(HnswConfig(M=30, ef_construction=128), strategy="insert",
                  device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h.build(base)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device-side events only (kernels, copies, sets): a CPU op's self
    # device time repeats the time of the kernels it launched
    kern = [e for e in ka if self_dev_us(e) > 0
            and "CUDA" in str(getattr(e, "device_type", ""))]
    busy_us = sum(self_dev_us(e) for e in kern)
    print(f"insert build under the profiler: {wall:.3f} s wall, kernels "
          f"{busy_us / 1e6:.3f} s (device busy {busy_us / 1e6 / wall:.3f} "
          f"of the wall), HnswBuilder's own split (s) "
          f"{h.build_stats['phase_s']}",
          flush=True)
    kern.sort(key=self_dev_us, reverse=True)
    for e in kern[:20]:
        print(f"kernel {self_dev_us(e) / 1e3:10.1f} ms {e.count:7d} x  "
              f"{e.key[:100]}", flush=True)
    if args.table is not None:
        for key in ("self_device_time_total", "self_cuda_time_total"):
            try:
                table = ka.table(sort_by=key, row_limit=60)
                break
            except (AttributeError, KeyError, ValueError):
                table = ka.table(row_limit=60)
        args.table.write_text(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
