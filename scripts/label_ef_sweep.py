#!/usr/bin/env python3
"""Filtered recall@10, work counts and time per call of the label-filtered
Slim configuration at each of a list of ef values, on one index built from
one seed: how ``bench_torch/configs/sift1m-slim-label12.json`` chose its ef.

    python3 scripts/label_ef_sweep.py --seed 7 --efs 64,96,128,192,256 \
        --out chiprun_out/label_sweep.json

Builds the configuration's system as the benchmark does
(``bench_torch/systems``), draws and installs the cell's labels
(``drivers/closed_batch_label.py``), then for each ef answers the whole
query pool in calls of ``--batch``, each query under its own label, scored
as the cell scores them (recall@10 against the plain reference's filtered
top 10, ``filter_miss``, short rows); counts the beam's distances and the
admitted candidates a query over one call (the port's trace counters); and
times ``--calls`` calls after two warm ones (host clock, the card
synchronised), with the same calls unfiltered beside them. Last, the
device time by kernel of one profiled filtered call at the configuration's
ef. Prints one JSON line per ef and one object at the end, written to
``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench_torch"), str(ROOT)]


def counters(fn) -> dict:
    """The port's trace counters over ``fn()``, under a CPU-only profile."""
    from torch.profiler import ProfilerActivity, profile

    from hnsw_slim_tpu_torch.utils import trace

    trace.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return trace.drain()["counters"]


def timed(fn, calls: int) -> float:
    """ms a call of ``fn(j)``, j = 0..calls-1, after two warm calls."""
    import torch

    fn(0)
    fn(1)
    torch.cuda.synchronize()
    t = time.monotonic()
    for j in range(calls):
        fn(j)
    torch.cuda.synchronize()
    return 1e3 * (time.monotonic() - t) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default="sift1m-slim-label12.batch")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--efs", default="64,96,128,192,256")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("label_ef_sweep: no CUDA device", file=sys.stderr)
        return 2
    from drivers import closed_batch_label as drv
    from harness import data as datalib
    from harness import manifest, runner

    runner.pin_caches()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    run = runner.Run(manifest.load(), args.cell, args.seed, 1.0, False, dev)
    cfg, k, b = run.cfg, run.cfg["k"], args.batch
    t0 = time.monotonic()
    run.data = datalib.make(cfg, args.seed, dev)
    system = manifest.system(cfg["system"]).build(cfg, run.data, dev)
    build_s = time.monotonic() - t0
    run.system, run.info = system, dict(system.info)
    drv.setup(run)
    idx = system.index
    out = {"card": smi, "cell": args.cell, "seed": args.seed,
           "build_s": build_s, "info": run.info, "sweep": []}
    pool_n = run.data.pool_n
    starts = list(range(0, pool_n, b))

    def call(j, filtered=True):
        s = (j * b) % pool_n
        need = drv._needs(run, s, b) if filtered else None
        return system.search(run.data.queries(s, b), k, need=need)

    for ef in [int(e) for e in args.efs.split(",")]:
        idx.scfg = dataclasses.replace(idx.scfg, ef=ef)
        ids, dists, rows = [], [], []
        for s in starts:
            d, i = system.search(run.data.queries(s, b), k,
                                 need=drv._needs(run, s, b))
            dists.append(d)
            ids.append(i)
            rows.append((s + np.arange(b)) % pool_n)
        sc = drv.score(run, np.concatenate(rows), np.concatenate(ids),
                       np.concatenate(dists))
        c = counters(lambda: call(0))
        u = counters(lambda: call(0, False))
        row = {"ef": ef, "recall_at_10": sc["recall"],
               "dist_err": sc["dist_err"], "filter_miss": sc["filter_miss"],
               "short": sc["short"], "malformed": sc["malformed"],
               "dcomp_per_query": c["index.beam_dcomp"] / c["index.queries"],
               "admit_share": c["index.filter_admit"] / c["index.beam_dcomp"],
               "unfiltered_dcomp_per_query":
                   u["index.beam_dcomp"] / u["index.queries"],
               "ms_per_call": timed(call, args.calls),
               "unfiltered_ms_per_call": timed(
                   lambda j: call(j, False), args.calls)}
        row["qps"] = 1e3 * b / row["ms_per_call"]
        print(json.dumps(row), flush=True)
        out["sweep"].append(row)
    idx.scfg = dataclasses.replace(idx.scfg, **cfg["search"])

    call(0)
    call(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(2)
        torch.cuda.synchronize()
    ops = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA or \
                getattr(ev, "self_device_time_total", 0):
            ops[ev.key] = round(getattr(ev, "self_device_time_total",
                                        getattr(ev, "self_cuda_time_total",
                                                0)) / 1e3, 4)
    out["device_ms_of_one_call"] = ops
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
