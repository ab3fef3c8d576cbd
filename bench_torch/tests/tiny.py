"""Running a cell on the CPU at a size a test can hold: the same harness,
drivers and checks, with the configuration's scale and the traffic's load
cut down."""

import time

import torch

from harness import manifest, runner

CFG = {"n": 3000, "dim": 16, "data": {"n_clusters": 30, "pool_queries": 512}}
TRAFFIC = {"batch": {"batch": 256},
           "update": {"check_pool_queries": 128, "max_batches": 64}}


def make_run(cell: str, seed: int = 11, seconds: float = 1.5,
             trace: bool = False, cfg=None) -> runner.Run:
    man = manifest.load()
    traffic = manifest.cell(man, cell)["traffic"]
    over = runner.merged(CFG, cfg) if cfg else CFG
    return runner.Run(man, cell, seed, seconds, trace, torch.device("cpu"),
                      cfg_override=over, traffic_override=TRAFFIC[traffic])


def run_cell(cell: str, **kw) -> dict:
    return runner.execute(make_run(cell, **kw), time.monotonic())
