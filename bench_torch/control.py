"""Readings that set the limits of ``correct``; the benchmark's own runs do
not run this.

For each seed one system of the configuration is built, and each cell
named runs a short window on it at the cell's own load and is checked as a
benchmark run checks it:

- ``program``: the system as the configuration states it, on ``--seeds``:
  the lower readings;
- ``bf16``: the system with its own lower-precision path switched on, a
  bfloat16 vector store (``HnswConfig.store_dtype``), on ``--bf16-seeds``;
- ``tf32``: for every ``program`` seed, the reference put in the system's
  place, its top-k computed with TF32 products, checked against the fp32
  reference on the same queries;
- a planted fault (``FAULTS``), on ``--fault-seeds``: the search's ef cut in
  half (``ef32``), the beam stopped after one step (``stop1``), inserted
  vectors stored but never linked into the graph (``unlinked``).

    python3 bench_torch/control.py --config sift1m-slim \
        --cells sift1m-slim.batch --seeds 1,2,3 --bf16-seeds 4,5,6 \
        --faults ef32,stop1 --fault-seeds 7,8,9 --seconds 3 \
        --out chiprun_out/control.jsonl

Cells that change the system (updates) go last. One JSON line per seed,
cell and variant; a summary of the largest and smallest readings at the end.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from harness import check, manifest, runner  # noqa: E402
from harness import data as datalib  # noqa: E402

BF16 = {"hnsw": {"store_dtype": "bfloat16"}}


def unlinked():
    """Plant the fault: an insert batch's vectors are stored (and shipped)
    but the insert links none of them; the full build is untouched. Returns
    the function that removes it."""
    import numpy as np

    from hnsw_slim_tpu_torch.graph.build import HnswBuilder

    plain = HnswBuilder._insert_range

    def insert_range(self, start, n, levels, entry, cur_maxlevel, *a,
                     collect=None, **kw):
        if collect is None:
            return plain(self, start, n, levels, entry, cur_maxlevel, *a,
                         collect=collect, **kw)
        levels[start:n] = 0
        collect.setdefault(0, []).append(np.arange(start, n))
        return entry, cur_maxlevel

    HnswBuilder._insert_range = insert_range

    def undo():
        HnswBuilder._insert_range = plain
    return undo


FAULTS = {"ef32": {"search": {"ef": 32}},
          "stop1": {"search": {"max_iters": 1}},
          "unlinked": unlinked}


def tf32_numbers(run) -> dict:
    """The control's reading: the reference's TF32 top-k of the queries the
    run checked, scored as the system's answers are."""
    import numpy as np

    ref = run.reference
    store, queries = run.driver.checked(run)
    base = ref.to_device(store, run.device)
    q = ref.to_device(queries, run.device)
    d, i = ref.exact_topk(base, q, run.cfg["k"], tf32=True)
    sc = check.score_answers(base, q, np.arange(len(q)), i.cpu().numpy(),
                             d.cpu().numpy())
    return {"dist_err": sc["dist_err"]}


def one_seed(man, cells, seed: int, seconds: float, variant: str, device,
             traffic_override=None, cfg_override=None):
    """Readings of every cell on one system built from ``seed``."""
    import torch

    fault = FAULTS.get(variant)
    over = cfg_override
    if variant == "bf16":
        over = runner.merged(cfg_override or {}, BF16)
    elif isinstance(fault, dict):
        over = runner.merged(cfg_override or {}, fault)
    runs = [runner.Run(man, c, seed, seconds, False, device, cfg_override=over,
                       traffic_override=(traffic_override or {}).get(c))
            for c in cells]
    first = runs[0]
    n_extra = max((r.driver.extra_vectors(r.traffic, seconds)
                   for r in runs if hasattr(r.driver, "extra_vectors")),
                  default=0)
    data = datalib.make(first.cfg, seed, device, n_extra)
    system = manifest.system(first.cfg["system"]).build(first.cfg, data,
                                                        device)
    rows = []
    undo = fault() if callable(fault) else None
    try:
        for run in runs:
            run.data, run.system, run.info = data, system, dict(system.info)
            drv = run.driver
            try:
                drv.setup(run)
                drv.window(run)
                if hasattr(drv, "collect"):
                    drv.collect(run)
            finally:
                if hasattr(drv, "teardown"):
                    drv.teardown(run)
            e2e, numbers = drv.evaluate(run)
            row = {"cell": run.name, "seed": seed, "variant": variant,
                   "numbers": numbers, "e2e": e2e,
                   "attempted": run.rec["attempted"],
                   "failed": run.rec["failed"]}
            rows.append(row)
            if variant == "program":
                rows.append({"cell": run.name, "seed": seed,
                             "variant": "tf32", "numbers": tf32_numbers(run)})
    finally:
        if undo:
            undo()
        system.close()
        del system
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def summary(rows) -> dict:
    """{cell: {variant: {number: [min, max]}}}."""
    out: dict = {}
    for r in rows:
        for name, v in r["numbers"].items():
            lo_hi = out.setdefault(r["cell"], {}).setdefault(
                r["variant"], {}).setdefault(name, [math.inf, -math.inf])
            lo_hi[0] = min(lo_hi[0], v)
            lo_hi[1] = max(lo_hi[1], v)
    return out


def _jsonable(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_jsonable(v) for v in x]
    return x


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--bf16-seeds", default="")
    ap.add_argument("--faults", default="", help="of " + ",".join(FAULTS))
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    runner.pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    man = manifest.load()
    cells = args.cells.split(",")
    for c in cells:
        if manifest.cell(man, c)["config"] != args.config:
            raise SystemExit(f"{c} is not a cell of {args.config}")
    unknown = [f for f in args.faults.split(",") if f and f not in FAULTS]
    if unknown:
        raise SystemExit(f"no fault named {unknown}: {list(FAULTS)}")
    dev = torch.device("cuda")
    rows = []
    jobs = [(int(s), "program") for s in args.seeds.split(",") if s] + \
        [(int(s), "bf16") for s in args.bf16_seeds.split(",") if s] + \
        [(int(s), f) for f in args.faults.split(",") if f
         for s in args.fault_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, variant in jobs:
            t0 = time.monotonic()
            for row in one_seed(man, cells, seed, args.seconds, variant, dev):
                row["s"] = round(time.monotonic() - t0, 1)
                rows.append(row)
                line = json.dumps(_jsonable(row))
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    print(json.dumps(_jsonable({"summary": summary(rows)})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
