#!/usr/bin/env python3
"""Where the host time of a label-filtered batch call goes, beside the same
calls unfiltered on the same index and ef: the label cell's closed loop
(``drivers/closed_batch_label.py``) timed phase by phase, without a
profiler.

    python3 scripts/label_host_phases.py --seed 7 --calls 400 \
        --out chiprun_out/label_host_phases.json

Builds the configuration's system as the benchmark does, installs the
cell's labels, then for each of "tags" (each query under its own label)
and "plain" (no filter) runs ``--calls`` calls of ``--batch`` consecutive
pool queries as the cell's window does (results kept), after warm calls
that capture the replayed graph. It reports, a call, in ms on the host's
clock: the call (the cell's ``search_call``), the time in each of the
port's spans (``index.search``, ``index.words``, ``index.upload``,
``index.replay``, ``index.readback``; the span facility is swapped for a
stopwatch, so nothing records) and the loop's own time between calls; then
the device time of one replay of that call's graph (CUDA events around 50
replays back to back, so no host gap lies between them) and the host time
the card waits through, the loop's time a call less that. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench_torch"), str(ROOT)]


class Stopwatch:
    """A stand-in for ``trace.span``: seconds summed by span name."""

    def __init__(self):
        self.s: dict = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t


def graph_ms(g, reps: int = 50) -> float:
    """Device ms of one replay of the captured graph ``g``."""
    import torch

    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    g.graph.replay()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        g.graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default="sift1m-slim-label12.batch")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--calls", type=int, default=400)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("label_host_phases: no CUDA device", file=sys.stderr)
        return 2
    from drivers import closed_batch_label as drv
    from harness import data as datalib
    from harness import manifest, runner

    from hnsw_slim_tpu_torch.utils import trace

    runner.pin_caches()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    run = runner.Run(manifest.load(), args.cell, args.seed, 1.0, False, dev)
    cfg, k, b = run.cfg, run.cfg["k"], args.batch
    run.data = datalib.make(cfg, args.seed, dev)
    system = manifest.system(cfg["system"]).build(cfg, run.data, dev)
    run.system, run.info = system, dict(system.info)
    drv.setup(run)
    idx, pool_n = system.index, run.data.pool_n
    out = {"card": smi, "cell": args.cell, "seed": args.seed,
           "ef": idx.scfg.ef, "batch": b, "calls": args.calls}
    real_span = trace.span
    for mode in ("tags", "plain"):
        def call(start, mode=mode):
            need = drv._needs(run, start, b) if mode == "tags" else None
            return system.search(run.data.queries(start, b), k, need=need)

        for j in range(4):
            call(j * b)
        torch.cuda.synchronize()
        watch, kept, in_call = Stopwatch(), [], 0.0
        trace.span = watch.span
        try:
            start = 0
            t0 = time.perf_counter()
            for _ in range(args.calls):
                t = time.perf_counter()
                kept.append(call(start))
                in_call += time.perf_counter() - t
                start = (start + b) % pool_n
            loop = time.perf_counter() - t0
        finally:
            trace.span = real_span
        n = args.calls
        g = next(g for key, g in idx._replay._graphs.items()
                 if key[0][2] == (2 if mode == "tags" else 0))
        row = {"loop_ms": 1e3 * loop / n, "call_ms": 1e3 * in_call / n,
               "spans_ms": {s: 1e3 * v / n for s, v in watch.s.items()},
               "graph_device_ms": graph_ms(g)}
        row["between_calls_ms"] = row["loop_ms"] - row["call_ms"]
        row["outside_index_search_ms"] = (row["call_ms"]
                                          - row["spans_ms"]["index.search"])
        row["host_wait_ms"] = row["loop_ms"] - row["graph_device_ms"]
        out[mode] = row
        print(json.dumps({mode: row}), flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
