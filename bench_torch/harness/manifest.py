"""Find a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, their
configurations and the metrics. Everything that belongs to one of them is a
file of its own under ``bench_torch/``:

- a configuration: ``configs/<config>.json`` (the file its entry names);
- a traffic mix: ``traffic/<traffic>.json``, which names its driver;
- a traffic driver: ``drivers/<driver>.py``;
- the system a configuration runs: ``systems/<system>.py``;
- a configuration's plain reference: ``reference/<reference>.py``;
- a per-layer metric's reader: ``metrics/<metric>.py``;
- a cell's correctness limits: ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    """BENCHMARK.json."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(manifest["configs"], name, "config")
    with open(root / entry["file"]) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell_name: str) -> dict:
    return _json("limits", cell_name)


def metrics_for(manifest: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that the cell reports: those
    whose ``workloads`` list it, or that have no such list."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", [cell_name])]


def driver(name: str):
    return importlib.import_module(f"drivers.{name}")


def system(name: str):
    return importlib.import_module(f"systems.{name}")


def reference(name: str):
    return importlib.import_module(f"reference.{name}")


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (a metric's name may hold dots, so
    it is loaded from its path)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
