"""One run of one cell: data from the seed, the system built and warmed up
(set-up), the measured window, the read-back of what the window produced,
then the plain reference and the result line.

A driver module (``drivers/<name>.py``) gives the traffic:

- ``SYSTEM``: the kind of system it drives (``systems/<SYSTEM>.py``);
- ``extra_vectors(traffic, seconds)`` (optional): vectors to insert that
  the data must hold;
- ``setup(run)``: warm-up of every shape the window uses;
- ``window(run)``: the measured window; fills ``run.rec`` with at least
  ``attempted`` and ``failed``;
- ``collect(run)`` (optional): what the check needs from the system, read
  before the system is freed;
- ``teardown(run)`` (optional): stop what ``setup`` started, whatever
  happened;
- ``evaluate(run)``: (end-to-end values, numbers compared) from the plain
  reference, after the system is freed.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

from . import check, host, manifest
from . import data as datalib
from .trace import Tracer

CACHE_DIR = manifest.ROOT / ".bench_torch_cache"


def pin_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)


class Run:
    """Everything one run of a cell holds."""

    def __init__(self, man: dict, cell_name: str, seed: int, seconds: float,
                 trace: bool, device, cfg_override: dict | None = None,
                 traffic_override: dict | None = None):
        self.manifest = man
        self.cell = manifest.cell(man, cell_name)
        self.name = cell_name
        self.cfg = manifest.config(man, self.cell["config"])
        if cfg_override:
            self.cfg = merged(self.cfg, cfg_override)
        self.traffic = manifest.traffic(self.cell["traffic"])
        if traffic_override:
            self.traffic = merged(self.traffic, traffic_override)
        self.driver = manifest.driver(self.traffic["driver"])
        self.reference = manifest.reference(self.cfg["reference"])
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.cuda = getattr(device, "type", str(device)) == "cuda"
        self.tracer = Tracer(trace, CACHE_DIR / "trace.json")
        self.data = None
        self.system = None
        self.info: dict = {}
        self.rec: dict = {}

    @property
    def trace(self):
        return self.tracer.trace

    def say(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys set, nested dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(
            base.get(k), dict) else v
    return out


def execute(run: Run, t_start: float) -> dict:
    """Run the cell once; the result line as a dict."""
    import torch

    drv = run.driver
    h_start = host.Snapshot()
    n_extra = (drv.extra_vectors(run.traffic, run.seconds)
               if hasattr(drv, "extra_vectors") else 0)
    if run.tracer.on:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
    run.data = datalib.make(run.cfg, run.seed, run.device, n_extra)
    if run.cuda:
        torch.cuda.empty_cache()
    if drv.SYSTEM != run.cfg["system"]:
        raise ValueError(f"driver {run.traffic['driver']} drives "
                         f"{drv.SYSTEM}, the configuration runs "
                         f"{run.cfg['system']}")
    run.system = manifest.system(run.cfg["system"]).build(
        run.cfg, run.data, run.device)
    try:
        run.info = dict(run.system.info)
        drv.setup(run)
        run.sync()
        setup_s = time.monotonic() - t_start
        h_setup = host.Snapshot()
        with run.tracer.window():
            drv.window(run)
        h_window = host.Snapshot()
        run.say(f"host in set-up: {host.describe(h_start, h_setup)}")
        run.say(f"host in the window: {host.describe(h_setup, h_window)}")
        peak = torch.cuda.max_memory_allocated() if run.cuda else 0
        if hasattr(drv, "collect"):
            drv.collect(run)
    finally:
        if hasattr(drv, "teardown"):
            drv.teardown(run)
        run.system.close()
        run.system = None
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()

    e2e, numbers = drv.evaluate(run)
    e2e["setup_s"] = setup_s
    correct, checks = check.verdict(numbers, manifest.limits(run.name))

    metrics = {}
    if run.tracer.on:
        for m in manifest.metrics_for(run.manifest, run.name, "per_layer"):
            v = manifest.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in manifest.metrics_for(run.manifest, run.name, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": (torch.cuda.get_device_name(run.device) if run.cuda
                       else "cpu"),
              "count": run.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(run.rec["attempted"]),
              "failed": int(run.rec["failed"]), "metrics": metrics,
              "device": device}
    if run.tracer.on:
        tr = run.trace
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    run.say(f"setup_s {setup_s:.3f}; memory_peak_bytes {peak}; "
            f"attempted {result['attempted']}; failed {result['failed']}")
    for name, c in checks.items():
        run.say(f"check {name} {c['value']} limit {c['limit']}")
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    import torch

    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload}: needs {cell['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(man, args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda"))
    result = execute(run, t_start)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0
