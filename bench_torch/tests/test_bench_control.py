"""The control at a test size on the CPU: the program's bfloat16 store and
the TF32 reference in its place must fail the cells' limits where the
program as configured passes them (``control.py`` reads the same on the
card at the cells' own sizes)."""

import math

import pytest
import torch

import control
from harness import manifest
from tiny import CFG, TRAFFIC

CONFIGS = {"sift1m-slim": ["sift1m-slim.batch"],
           "sift1m-server": ["sift1m-server.update"]}
# the planted faults whose readings set a limit's upper end, as control.py
# plants them on the card (ef32 changes too little at a test size)
PLANTED = {"sift1m-slim": ["stop1"], "sift1m-server": ["stop1", "unlinked"]}


def _traffic(cells):
    man = manifest.load()
    return {c: TRAFFIC[manifest.cell(man, c)["traffic"]] for c in cells}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_control_fails_where_the_program_passes(config):
    man = manifest.load()
    cells = CONFIGS[config]
    rows = []
    for variant in ("program", "bf16"):
        rows += control.one_seed(man, cells, 31, 1.5, variant,
                                 torch.device("cpu"),
                                 traffic_override=_traffic(cells),
                                 cfg_override=CFG)
    for cell in cells:
        limits = manifest.limits(cell)
        mine = [r for r in rows if r["cell"] == cell]
        prog = next(r for r in mine if r["variant"] == "program")
        assert all(prog["numbers"][n] <= lim for n, lim in limits.items())
        for variant in ("bf16", "tf32"):
            ctl = next(r for r in mine if r["variant"] == variant)
            assert any(not math.isfinite(v) or v > limits[n]
                       for n, v in ctl["numbers"].items()
                       if n in limits), (cell, variant, ctl["numbers"])


@pytest.mark.parametrize("config,fault", [(c, f) for c, fs in PLANTED.items()
                                          for f in fs])
def test_planted_fault_fails_a_number(config, fault):
    man = manifest.load()
    cells = CONFIGS[config]
    rows = control.one_seed(man, cells, 32, 1.5, fault, torch.device("cpu"),
                            traffic_override=_traffic(cells),
                            cfg_override=CFG)
    for r in rows:
        limits = manifest.limits(r["cell"])
        assert r["variant"] == fault
        assert any(not math.isfinite(v) or v > limits[n]
                   for n, v in r["numbers"].items()), (fault, r["numbers"])
