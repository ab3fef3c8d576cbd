"""The SlimQ cell on the CPU at a test size (``tiny.CFG``'s scale, 256-query
calls): whole, it is ``correct``; with its timed path broken underneath
(the ex planes of the code rows zeroed, the rerank skipped, half of a batch
answered for the rest, one answer altered, the beam stopped after one step)
it is not; traced, it reports the readers of the quantized path with the
port's ``index.rotate`` spans inside their calls; ``control_slimq.py``'s
readings fail the limits where the program passes them. Beside them, the
estimate scan's work count and the reader's kernel-name parse."""

import math
import time

import numpy as np
import pytest
import torch

import control
import control_slimq
from harness import manifest, runner
from hnsw_slim_tpu_torch.config import SearchConfig
from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
from hnsw_slim_tpu_torch.utils import trace as port_trace
from roofline.estimate_scan import estimate_scan_work
from tiny import CFG

CELL = "sift1m-slimq.batch"
CONFIG = "sift1m-slimq"
TRAFFIC = {"batch": 256}


def make_run(seed: int, trace: bool = False) -> runner.Run:
    return runner.Run(manifest.load(), CELL, seed, 1.5, trace,
                      torch.device("cpu"), cfg_override=CFG,
                      traffic_override=TRAFFIC)


def run_cell(seed: int, trace: bool = False) -> dict:
    return runner.execute(make_run(seed, trace), time.monotonic())


def _ex_zeroed(mp):
    mp.setattr(HnswSlimQIndex, "_packed_rows", HnswSlimQIndex._packed_rows)
    control_slimq.ex_zeroed()  # monkeypatch puts the plain method back


def _rerank_skipped(mp):
    plain = HnswSlimQIndex.search
    mp.setattr(HnswSlimQIndex, "search",
               lambda self, q, k, rerank=True: plain(self, q, k, False))


def _half(mp):
    plain = HnswSlimQIndex.search

    def search(self, queries, k, rerank=True):
        q = np.asarray(queries)
        h = max(1, (len(q) + 1) // 2)
        d, i = plain(self, q[:h], k, rerank)
        rep = np.arange(len(q)) % h
        return d[rep], i[rep]
    mp.setattr(HnswSlimQIndex, "search", search)


def _altered(mp):
    plain = HnswSlimQIndex.search

    def search(self, queries, k, rerank=True):
        d, i = plain(self, queries, k, rerank)
        i = i.copy()
        i[len(i) // 2, k // 2] = (i[len(i) // 2, k // 2] + 1) % self.graph.n
        return d, i
    mp.setattr(HnswSlimQIndex, "search", search)


def _stops_early(mp):
    mp.setattr(SearchConfig, "iters", lambda self: 1)


FAULTS = {"ex_zeroed": _ex_zeroed, "rerank_skipped": _rerank_skipped,
          "half": _half, "altered": _altered, "stops_early": _stops_early}


def test_the_unbroken_cell_is_correct():
    res = run_cell(seed=2**31 + 41)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"dist_err", "recall_miss", "code_miss",
                                  "factor_err"}
    assert res["checks"]["code_miss"]["value"] == 0.0
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_cell(seed=42)
    assert res["correct"] is False, (fault, res["checks"])


def test_the_code_fault_is_seen_on_every_row(monkeypatch):
    """The answers keep exact distances under the code fault (the rerank
    reads the raw rows); the check of the codes sees every sampled row."""
    _ex_zeroed(monkeypatch)
    res = run_cell(seed=43)
    checks = res["checks"]
    assert checks["code_miss"]["value"] == 1.0
    assert checks["dist_err"]["value"] <= checks["dist_err"]["limit"]


def test_traced_run_reads_the_quantized_path():
    port_trace.drain()
    run = make_run(seed=44, trace=True)
    res = runner.execute(run, time.monotonic())
    assert res["correct"] is True
    listed = {m["name"] for m in manifest.metrics_for(
        manifest.load(), CELL, "per_layer")}
    for name in ("kernel.rerank_per_query", "index.rotate_ms.slimq",
                 "kernel.beam_dcomp_per_query", "index.upload_idle_ms.batch",
                 "index.launch_idle_ms.batch", "index.readback_idle_ms.batch",
                 "index.glue_ms.batch"):
        assert name in listed, name
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] > 0, name
    # one rerank distance a pop: ef pops or more a query at this size
    assert res["metrics"]["kernel.rerank_per_query"]["value"] >= \
        run.cfg["search"]["ef"]
    # no card: no device trace for the roofline
    assert "kernel.estimate_scan_roofline" in listed
    assert "kernel.estimate_scan_roofline" not in res["metrics"]
    tr = run.trace
    calls = [(a, b) for a, b in tr.spans["search_call"] if a >= tr.window[0]]
    mine = run._program["spans"]["index.rotate"]
    assert len(mine) == len(calls) == len(run._program["spans"][
        "index.search"])
    for (a, b), (s, e) in zip(calls, mine):
        assert a <= s <= e <= b


def test_untraced_run_records_nothing():
    port_trace.drain()
    res = run_cell(seed=45)
    assert res["correct"] is True
    assert port_trace.drain() == {"spans": [], "counters": {}}


def _readings(variants, seed, monkeypatch):
    man = manifest.load()
    for name, fault in control_slimq.faults(
            manifest.config(man, CONFIG)).items():
        monkeypatch.setitem(control.FAULTS, name, fault)
    monkeypatch.setattr(HnswSlimQIndex, "_packed_rows",
                        HnswSlimQIndex._packed_rows)
    rows = []
    for v in variants:
        rows += control.one_seed(man, [CELL], seed, 1.5, v,
                                 torch.device("cpu"),
                                 traffic_override={CELL: TRAFFIC},
                                 cfg_override=CFG)
    return rows


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not math.isfinite(v) or v > limits[n]
               for n, v in numbers.items() if n in limits)


def test_control_fails_where_the_program_passes(monkeypatch):
    """The program passes every limit; its bfloat16 store (codes and rerank
    from the rounded rows) and the TF32 reference in its place do not."""
    rows = _readings(("program", "bf16"), 46, monkeypatch)
    limits = manifest.limits(CELL)
    by = {r["variant"]: r["numbers"] for r in rows}
    assert set(by["program"]) == set(limits)
    assert not _fails(by["program"], limits), by["program"]
    for variant in ("bf16", "tf32"):
        assert _fails(by[variant], limits), (variant, by[variant])
    assert by["bf16"]["code_miss"] > limits["code_miss"]


@pytest.mark.parametrize("fault", ["stop1", "ex_zeroed"])
def test_planted_fault_fails_a_number(fault, monkeypatch):
    """control_slimq.py's planted faults, as it plants them on the card
    (``ef_half`` changes too little at a test size)."""
    (row,) = _readings((fault,), 47, monkeypatch)
    assert row["variant"] == fault
    assert _fails(row["numbers"], manifest.limits(CELL)), row["numbers"]


def test_control_slimq_registers_its_faults():
    cfg = manifest.config(manifest.load(), CONFIG)
    got = control_slimq.faults(cfg)
    assert got["ef_half"] == {"search": {"ef": cfg["search"]["ef"] // 2}}
    assert callable(got["ex_zeroed"])


def test_estimate_scan_work_count():
    flops, nbytes = estimate_scan_work(4096, 31250, 128, 16, 32)
    assert flops == 2 * 4096 * 31250 * 128
    # queries and their sums, 28 B a row, g_add, the seeds out
    assert nbytes == (4096 * 129 * 4 + 31250 * 28 + 4096 * 16 * 4
                      + 4096 * 32 * 8)


def test_the_roofline_reader_tells_the_estimate_scan_by_its_name():
    rd = manifest.reader("kernel.estimate_scan_roofline")
    est = ("void (anonymous namespace)::scan_kernel<(anonymous namespace)::"
           "Tile<64, 128, 4, 8, 2, false>, true, unsigned int>(float const*, "
           "float const*, unsigned int const*)")
    exact = est.replace(", true, unsigned int>", ", false, float>")
    assert rd.template_args(est, "scan_kernel") == [
        "(anonymous namespace)::Tile<64, 128, 4, 8, 2, false>", "true",
        "unsigned int"]
    assert rd.estimate_scan(est) and not rd.estimate_scan(exact)
    assert not rd.estimate_scan("topk_merge<2>(float const*)")
