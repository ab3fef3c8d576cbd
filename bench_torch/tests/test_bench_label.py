"""The label-filtered cell on the CPU at a test size (``tiny.CFG``'s scale,
256-query calls, ef 256, where the tiny graph's window holds enough allowed
rows): whole, it is ``correct``, with no answered id outside its query's
predicate; with the predicate ignored it answers ids of other labels and is
not; traced, it reports the admitted share of the beam's work and the Slim
cell's readers; a port without ``set_tags`` fails before it builds; and
``control_label.py``'s readings fail the limits where the program passes
them."""

import math
import time

import numpy as np
import pytest
import torch

import control
import control_label
from drivers import closed_batch_label
from harness import manifest, runner
from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
from hnsw_slim_tpu_torch.utils import trace as port_trace
from tiny import CFG

CELL = "sift1m-slim-label12.batch"
CONFIG = "sift1m-slim-label12"
TINY = runner.merged(CFG, {"search": {"ef": 256}})
TRAFFIC = {"batch": 256}


def make_run(seed: int, trace: bool = False) -> runner.Run:
    return runner.Run(manifest.load(), CELL, seed, 1.5, trace,
                      torch.device("cpu"), cfg_override=TINY,
                      traffic_override=TRAFFIC)


def run_cell(seed: int, trace: bool = False) -> dict:
    return runner.execute(make_run(seed, trace), time.monotonic())


def test_the_unbroken_cell_is_correct():
    res = run_cell(seed=2**31 + 51)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"dist_err", "recall_miss", "filter_miss"}
    assert res["checks"]["filter_miss"]["value"] == 0.0
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def test_an_ignored_predicate_is_not_correct():
    undo = control_label.predicate_ignored()
    try:
        res = run_cell(seed=52)
    finally:
        undo()
    assert res["correct"] is False
    # about 11 of 12 answered ids have another label
    assert res["checks"]["filter_miss"]["value"] > 0.5


def test_labels_are_one_hot_and_drawn_from_the_seed():
    run = make_run(seed=53)
    run.info = {"n": 3000}
    run.data = type("D", (), {"pool_n": 512})()
    tags, need = closed_batch_label.labels(run)
    again = closed_batch_label.labels(run)
    assert np.array_equal(tags, again[0]) and np.array_equal(need, again[1])
    assert tags.dtype == np.uint32 and len(tags) == 3000 and len(need) == 512
    for w in (tags, need):
        assert set(np.unique(w).tolist()) == {1 << j for j in range(12)}


def test_short_rows_are_recall_misses_and_bad_rows_are_malformed():
    """The scorer reads -1 at inf after the ids as a short answer, and an
    id after a -1, a repeat or an id of another label as what they are."""
    run = make_run(seed=54)
    run.data = __import__("harness.data", fromlist=["make"]).make(
        run.cfg, run.seed, run.device)
    run.info = {"n": run.cfg["n"]}
    tags, need = closed_batch_label.labels(run)
    run.rec.update(tags=tags, need=need)
    ref = run.reference
    base = ref.to_device(run.data.base, run.device)
    pool = ref.to_device(run.data.pool[:2], run.device)
    d, i = ref.filtered_topk(base, pool, ref.words(tags), ref.words(need[:2]),
                             10)
    d, i = d.numpy(), i.numpy().astype(np.int32)
    whole = closed_batch_label.score(run, [0, 1], i, d)
    assert (whole["recall"], whole["filter_miss"], whole["short"]) == (
        1.0, 0.0, 0)
    assert whole["dist_err"] < 1e-6
    s_d, s_i = d.copy(), i.copy()
    s_d[0, 7:], s_i[0, 7:] = np.inf, -1
    short = closed_batch_label.score(run, [0, 1], s_i, s_d)
    assert short["short"] == 1 and short["malformed"] == 0
    assert short["recall"] == 17 / 20
    assert short["dist_err"] == whole["dist_err"]
    hole_d, hole_i = s_d.copy(), s_i.copy()
    hole_i[0, 8], hole_d[0, 8] = i[0, 7], d[0, 7]
    assert math.isinf(closed_batch_label.score(run, [0, 1], hole_i,
                                               hole_d)["dist_err"])
    other = np.nonzero(tags != need[0])[0][0]
    o_i = i.copy()
    o_i[0, 9] = other
    o_d = d.copy()
    o_d[0, 9] = ((run.data.base[other] - run.data.pool[0]) ** 2).sum()
    assert closed_batch_label.score(run, [0, 1], o_i, o_d)[
        "filter_miss"] == 1 / 20


def test_traced_run_reads_the_admitted_share():
    port_trace.drain()
    run = make_run(seed=55, trace=True)
    res = runner.execute(run, time.monotonic())
    assert res["correct"] is True
    listed = {m["name"] for m in manifest.metrics_for(
        manifest.load(), CELL, "per_layer")}
    for name in ("kernel.filter_admit_share", "kernel.beam_dcomp_per_query",
                 "index.upload_idle_ms.batch", "index.launch_idle_ms.batch",
                 "index.readback_idle_ms.batch", "index.glue_ms.batch"):
        assert name in listed, name
        assert res["metrics"][name]["value"] > 0, name
    # predicate-blind traversal: about one candidate in 12 passes
    share = res["metrics"]["kernel.filter_admit_share"]["value"]
    assert 0.05 < share < 0.12
    # no card: no device trace for the roofline, no graph to replay
    assert "kernel.seed_scan_roofline" in listed
    assert "kernel.seed_scan_roofline" not in res["metrics"]
    assert "index.replay_share.batch" not in res["metrics"]
    c = run._program["counters"]
    assert c["index.filter_queries"] == c["index.queries"]
    assert c["index.filter_short"] == 0


def test_untraced_run_records_nothing():
    port_trace.drain()
    res = run_cell(seed=56)
    assert res["correct"] is True
    assert port_trace.drain() == {"spans": [], "counters": {}}


def test_a_port_without_set_tags_fails_before_the_build(monkeypatch):
    monkeypatch.delattr(HnswSlimIndex, "set_tags")
    built = []
    monkeypatch.setattr(HnswSlimIndex, "build",
                        classmethod(lambda cls, *a, **k: built.append(1)))
    with pytest.raises(RuntimeError, match="set_tags"):
        run_cell(seed=57)
    assert not built


def _readings(variants, seed, monkeypatch):
    man = manifest.load()
    for name, fault in control_label.faults(
            manifest.config(man, CONFIG)).items():
        monkeypatch.setitem(control.FAULTS, name, fault)
    monkeypatch.setattr(control, "tf32_numbers", control_label.tf32_numbers)
    rows = []
    for v in variants:
        rows += control.one_seed(man, [CELL], seed, 1.5, v,
                                 torch.device("cpu"),
                                 traffic_override={CELL: TRAFFIC},
                                 cfg_override=TINY)
    return rows


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not math.isfinite(v) or v > limits[n]
               for n, v in numbers.items() if n in limits)


def test_control_fails_where_the_program_passes(monkeypatch):
    """The program passes every limit; the TF32 reference in its place does
    not (its distances), nor does the ignored predicate."""
    rows = _readings(("program", "predicate_ignored"), 58, monkeypatch)
    limits = manifest.limits(CELL)
    by = {r["variant"]: r["numbers"] for r in rows}
    assert set(by["program"]) == set(by["tf32"]) == set(limits)
    assert not _fails(by["program"], limits), by["program"]
    assert by["tf32"]["dist_err"] > limits["dist_err"], by["tf32"]
    assert by["tf32"]["filter_miss"] == 0.0
    assert by["predicate_ignored"]["filter_miss"] > limits["filter_miss"]


def test_control_label_registers_its_faults():
    cfg = manifest.config(manifest.load(), CONFIG)
    got = control_label.faults(cfg)
    assert got["ef_half"] == {"search": {"ef": cfg["search"]["ef"] // 2}}
    assert callable(got["predicate_ignored"])
