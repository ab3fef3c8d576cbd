#!/usr/bin/env python3
"""Recall@10 and time per call of a benchmark configuration's SlimQ index at
each of a list of ef values, on one index built from one seed: how
``bench_torch/configs/sift1m-slimq.json`` chose its ef.

    python3 scripts/slimq_ef_sweep.py --config sift1m-slimq --seed 7 \
        --efs 64,128,256 --traversals 1bit,ex --out chiprun_out/sweep.json

Builds the configuration's system as the benchmark does
(``bench_torch/systems``), then for each traversal (1-bit estimates, or the
whole code: ``use_ex``) and ef answers the whole query pool in calls of
``--batch`` (recall@10 against the plain reference's exact top 10) and
times ``--calls`` calls after two warm ones (host clock, the card
synchronised). Then the check of the codes (``code_miss``, ``factor_err``)
as the benchmark makes it (float64) and, for comparison, in float32, and
the device operations of one profiled call by name. Prints one JSON object
and writes it to ``--out``. Needs a CUDA card.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="sift1m-slimq")
    ap.add_argument("--cell", default="sift1m-slimq.batch")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--efs", default="64,128,256")
    ap.add_argument("--traversals", default="1bit",
                    help="1bit, ex (use_ex: the whole code), or both")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("slimq_ef_sweep: no CUDA device", file=sys.stderr)
        return 2
    from drivers import closed_batch_slimq as drv
    from harness import data as datalib
    from harness import manifest, runner
    from harness.check import score_answers

    runner.pin_caches()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    man = manifest.load()
    run = runner.Run(man, args.cell, args.seed, 1.0, False, dev)
    cfg, ref, k = run.cfg, run.reference, run.cfg["k"]
    t0 = time.monotonic()
    run.data = datalib.make(cfg, args.seed, dev)
    system = manifest.system(cfg["system"]).build(cfg, run.data, dev)
    build_s = time.monotonic() - t0
    run.system, run.info = system, dict(system.info)
    idx = system.index
    out = {"card": smi, "config": args.config, "seed": args.seed,
           "build_s": build_s, "build_stats": idx.build_stats,
           "info": run.info, "sweep": []}

    pool_n = run.data.pool_n
    base = ref.to_device(run.data.base, dev)
    pool = ref.to_device(run.data.pool[:pool_n], dev)
    _, gt = ref.exact_topk(base, pool, k)
    starts = list(range(0, pool_n, args.batch))
    points = [(t, int(e)) for t in args.traversals.split(",")
              for e in args.efs.split(",")]
    for traversal, ef in points:
        idx.scfg = dataclasses.replace(idx.scfg, ef=ef,
                                       use_ex=traversal == "ex")
        ids, dists, rows = [], [], []
        for s in starts:
            d, i = system.search(run.data.queries(s, args.batch), k)
            dists.append(d)
            ids.append(i)
            rows.append((s + np.arange(args.batch)) % pool_n)
        sc = score_answers(base, pool, np.concatenate(rows),
                           np.concatenate(ids), np.concatenate(dists),
                           gt_ids=gt)
        q = run.data.queries(0, args.batch)
        for _ in range(2):
            system.search(q, k)
        torch.cuda.synchronize()
        t = time.monotonic()
        for j in range(args.calls):
            system.search(run.data.queries(j * args.batch, args.batch), k)
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t) / args.calls
        row = {"traversal": traversal, "ef": ef, "recall_at_10": sc["recall"],
               "dist_err": sc["dist_err"], "malformed": sc["malformed"],
               "ms_per_call": ms, "qps": 1e3 * args.batch / ms}
        print(json.dumps(row), flush=True)
        out["sweep"].append(row)
    idx.scfg = dataclasses.replace(idx.scfg, **cfg["search"])

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        system.search(run.data.queries(0, args.batch), k)
        torch.cuda.synchronize()
    ops = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ops[ev.name] = ops.get(ev.name, 0) + 1
    out["ops_of_one_call"] = ops

    drv.collect(run)
    saved = dict(run.rec["codes"])
    out["codes_f64"] = drv.code_numbers(run)  # the check's own
    run.rec["codes"] = saved
    plain = ref.rotate  # the same rotated rows, quantized in float32
    ref.rotate = lambda x, fb: plain(x, fb).float()
    try:
        out["codes_f32"] = drv.code_numbers(run)
    finally:
        ref.rotate = plain
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
