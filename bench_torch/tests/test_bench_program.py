"""The readers of the port's own spans and counters (``harness/program.py``
and the metrics that use it), each cell run on the CPU at a test size: with
``--trace 1`` every such metric is reported, the port's spans sit on the
trace's clock inside the benchmark's spans, and the breakdown names them;
with ``--trace 0`` the port records nothing."""

import time

import pytest

from harness import manifest, program, runner
from harness.trace import Trace
from hnsw_slim_tpu_torch.utils import trace as port_trace
from tiny import make_run, run_cell

# per cell: the benchmark's span around a call, the port's span inside it,
# and the metrics that read the port
PROGRAM = {
    "sift1m-slim.batch": ("search_call", "index.search", (
        "index.upload_idle_ms.batch", "index.launch_idle_ms.batch",
        "index.readback_idle_ms.batch", "kernel.beam_dcomp_per_query")),
    "sift1m-server.update": ("sync_patches", "client.sync", (
        "update.server_insert_s", "update.server_reprune_s",
        "update.client_store_copy_s", "update.client_rebuild_s",
        "update.patch_bytes")),
}


@pytest.mark.parametrize("cell", sorted(PROGRAM))
def test_traced_run_reads_the_program(cell):
    port_trace.drain()
    run = make_run(cell, trace=True)
    res = runner.execute(run, time.monotonic())
    assert res["correct"] is True
    outer, inner, names = PROGRAM[cell]
    listed = {m["name"] for m in manifest.metrics_for(
        manifest.load(), cell, "per_layer")}
    for name in names:
        assert name in listed, name
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] >= 0, name
    tr = run.trace
    # the port's spans, shifted onto the trace's clock, sit inside the
    # benchmark's span around the same call
    w0, w1 = tr.window
    # the benchmark's spans of the set-up (before the window) aside
    calls = [(a, b) for a, b in tr.spans[outer] if a >= w0]
    mine = run._program["spans"][inner]
    assert len(mine) == len(calls)
    for (a, b), (s, e) in zip(calls, mine):
        assert a <= s <= e <= b
    # the breakdown labels a gap with the innermost span at its midpoint:
    # a program span wherever one covers it
    edges = [w0] + [t for iv in tr.busy for t in iv] + [w1]
    labels = {n for n, _ in res["breakdown"]["idle_gaps"]}
    program = set(run._program["spans"])
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        mid = (g0 + g1) // 2
        if g1 > g0 and any(s <= mid <= e for n in program
                           for s, e in run._program["spans"][n]):
            assert labels & program
    assert program <= set(tr.spans)


@pytest.mark.parametrize("cell", sorted(PROGRAM))
def test_untraced_run_records_nothing(cell):
    port_trace.drain()
    res = run_cell(cell, trace=False)
    assert res["correct"] is True
    assert port_trace.drain() == {"spans": [], "counters": {}}


def test_each_call_is_placed_by_its_own_query_copy():
    # the marker's shift (window start less t0) is 500 us; the trace's clock
    # reads 120 us more than the host's at the first call and 1120 us more
    # at the second (its device times stray), and each query copy ends as
    # its upload span does
    t0 = 500_000
    mk = port_trace.Span
    spans = [mk("index.search", 9_990_000, 14_000_000, 1, 0, 1, {}),
             mk("index.upload", 10_000_000, 10_400_000, 2, 1, 1, {}),
             mk("index.beam", 11_000_000, 11_200_000, 3, 1, 1, {}),
             mk("index.search", 19_990_000, 24_000_000, 4, 0, 1, {}),
             mk("index.upload", 20_000_000, 20_400_000, 5, 4, 1, {})]
    copy = "Memcpy HtoD (Pageable -> Device)"
    ops = [(copy, 10_300_000, 10_520_000),
           ("scan_kernel", 10_600_000, 12_000_000),
           (copy, 21_300_000, 21_520_000)]
    tr = Trace((1_000_000, 100_000_000), ops, {})
    assert program.anchors(tr, t0, spans) == [(10_000_000, 120_000),
                                              (20_000_000, 1_120_000)]
    assert program.shift(tr, t0, spans) == [120_000] * 3 + [1_120_000] * 2
    # where the copies and the upload spans do not pair one to one, every
    # span takes the marker's shift
    extra = Trace((1_000_000, 100_000_000),
                  ops + [(copy, 30_000_000, 30_100_000)], {})
    assert program.anchors(extra, t0, spans) == []
    assert program.shift(extra, t0, spans) == [500_000] * 5
    assert program.shift(tr, t0, []) == []
