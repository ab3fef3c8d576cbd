"""The harness's own arithmetic and lookups, on the CPU."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import check, manifest, stats
from harness import data as datalib
from harness.trace import Trace
from reference.exact_knn import exact_topk, pair_dist, round_tf32
from roofline.topk_dist import seed_scan_work


def test_window_rate_is_all_work_over_all_time():
    assert stats.window_rate(4096 * 3, 0.5) == 4096 * 3 / 0.5
    with pytest.raises(ValueError):
        stats.window_rate(1, 0.0)


def test_p95_counts_from_due_and_failures_as_misses():
    due = np.arange(100, dtype=float)
    done = due + np.linspace(0.001, 0.1, 100)  # 1 .. 100 ms
    ok = np.ones(100, bool)
    assert stats.p95_ms(due, done, ok) == pytest.approx(95.0)
    # a request that waited behind a stall counts the wait from its due time
    done2 = done.copy()
    done2[:10] = 10.5
    assert stats.p95_ms(due, done2, ok) > 1000
    # six failures rank above every answer: the 95th of 100 is a failure
    ok[:6] = False
    p = stats.p95_ms(due, done, ok)
    assert p >= (done.max() - due.min()) * 1e3
    assert math.isfinite(p)
    ok[:6] = True
    ok[:4] = False  # four failures: the 95th is still an answer
    assert stats.p95_ms(due, done, ok) == pytest.approx(99.0)


def test_nearest_rank_and_spread():
    assert stats.nearest_rank([3, 1, 2, 4], 50) == 2
    assert stats.nearest_rank([1.0, math.inf], 95) == math.inf
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = __import__("statistics").quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_seed_scan_work_count():
    flops, nbytes = seed_scan_work(4096, 31250, 128, 32)
    assert flops == 2 * 4096 * 31250 * 128
    assert nbytes == 4096 * 128 * 4 + 31250 * 129 * 4 + 4096 * 32 * 8


def test_cells_configs_and_metrics_are_found_by_name():
    man = manifest.load()
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for c in man["workloads"]:
        cfg = manifest.config(man, c["config"])
        traffic = manifest.traffic(c["traffic"])
        drv = manifest.driver(traffic["driver"])
        assert drv.SYSTEM == cfg["system"]
        assert hasattr(manifest.system(cfg["system"]), "build")
        assert hasattr(manifest.reference(cfg["reference"]), "exact_topk")
        assert manifest.limits(c["name"])
        reported = {m["name"] for m in manifest.metrics_for(
            man, c["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layers = manifest.metrics_for(man, c["name"], "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in reported, (c["name"], m["name"])
    for m in man["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
    with pytest.raises(KeyError):
        manifest.cell(man, "no-such-cell")


def test_device_data_is_the_seeds():
    dev = torch.device("cpu")
    a = datalib.clustered(500, 8, 20, 10, 0.3, 2**31 + 5, dev, 30)
    b = datalib.clustered(500, 8, 20, 10, 0.3, 2**31 + 5, dev, 30)
    c = datalib.clustered(500, 8, 20, 10, 0.3, 2**31 + 6, dev, 30)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert [t.shape for t in a] == [(500, 8), (20, 8), (30, 8)]
    cfg = {"n": 500, "dim": 8, "data": {"n_clusters": 10, "scale": 0.3,
                                         "pool_queries": 20}}
    d = datalib.make(cfg, 3, dev)
    assert np.array_equal(d.queries(15, 10), np.concatenate(
        [d.pool[15:20], d.pool[:5]]))


def test_trace_reduction():
    ms = 1_000_000
    ops = [("void ns::beam_kernel<float, false>(float const*)", 10 * ms,
            30 * ms),
           ("scan_kernel<1>", 25 * ms, 40 * ms),
           ("Memcpy DtoH", 60 * ms, 70 * ms)]
    spans = {"bench_window": [(0, 100 * ms)],
             "search_call": [(5 * ms, 50 * ms), (55 * ms, 80 * ms)]}
    tr = Trace((0, 100 * ms), ops, spans)
    assert tr.busy_s == pytest.approx(0.040)
    assert tr.idle_pct() == pytest.approx(60.0)
    assert tr.op_seconds(r"\bbeam_kernel\b") == pytest.approx(0.020)
    # search spans: 45 ms with 30 busy, 25 ms with 10 busy
    assert tr.span_self_ms("search_call") == pytest.approx((15 + 15) / 2)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["beam_kernel", 0.020]
    gaps = dict(bd["idle_gaps"])
    # idle 0-10 ms (midpoint 5, in the first call), 40-60 (midpoint 50, the
    # first call's end), 70-100 (midpoint 85, no span)
    assert gaps["search_call"] == pytest.approx(0.010 + 0.020)
    assert gaps["no_span"] == pytest.approx(0.030)


def test_reference_topk_and_checks():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(2000, 16, generator=g)
    q = torch.randn(64, 16, generator=g)
    d, i = exact_topk(base, q, 10, x_block=300, q_block=17)
    full = torch.cdist(q.double(), base.double()) ** 2
    assert torch.equal(i, torch.topk(full, 10, largest=False).indices)
    assert torch.allclose(pair_dist(base, q, i).double(),
                          torch.gather(full, 1, i), rtol=1e-5)
    rows = np.arange(64)
    good = check.score_answers(base, q, rows, i.numpy(), d.numpy(), gt_ids=i)
    assert good["recall"] == 1.0 and good["dist_err"] < 1e-5
    bad_ids = i.numpy().copy()
    bad_ids[3, 4] = bad_ids[3, 4] + 1  # an answer altered where produced
    bad = check.score_answers(base, q, rows, bad_ids, d.numpy())
    assert bad["dist_err"] > 1e-2
    dup = i.numpy().copy()
    dup[0, 1] = dup[0, 0]
    assert check.score_answers(base, q, rows, dup, d.numpy())[
        "dist_err"] == math.inf
    # the 11th to 20th neighbours: valid ids, exact distances, none of the
    # top 10
    d20, i20 = exact_topk(base, q, 20)
    far = check.score_answers(base, q, rows, i20[:, 10:].numpy(),
                              d20[:, 10:].numpy(), gt_ids=i)
    assert far["dist_err"] < 1e-5 and check.recall_miss(far["recall"]) == 1.0
    assert check.recall_miss(good["recall"]) == 0.0
    assert check.recall_miss(None) == math.inf
    # the control: TF32 products, emulated on the CPU
    dt, it = exact_topk(base * 30, q * 30, 10, tf32=True)
    ctl = check.score_answers(base * 30, q * 30, rows, it.numpy(), dt.numpy())
    assert ctl["dist_err"] > 50 * good["dist_err"]
    # TF32 keeps 10 mantissa bits: a step of 2**-9 at 2 to 4
    x = torch.tensor([1.0 + 2**-12, -3.0 - 3 * 2**-11])
    assert torch.equal(round_tf32(x), torch.tensor([1.0, -3.0 - 2**-9]))


def test_copy_err_and_verdict():
    a = np.ones((5, 3), np.float32)
    assert check.copy_err(a, a.copy(), True) == 0.0
    assert check.copy_err(a, a.copy(), False) == math.inf
    assert check.copy_err(a[:4], a, True) == math.inf
    b = a.copy()
    b[2, 1] = 1.5
    assert check.copy_err(b, a, True) == 0.5
    ok, out = check.verdict({"x": 1e-6, "y": 0.0}, {"x": 1e-5, "y": 0.0})
    assert ok and out["x"] == {"value": 1e-6, "limit": 1e-5}
    ok, out = check.verdict({"x": math.inf}, {"x": 1e-5})
    assert not ok and out["x"]["value"] == "inf"


def test_run_without_a_card_prints_no_result(tmp_path):
    r = subprocess.run([sys.executable, str(manifest.BENCH / "run.py"),
                        "--workload", "sift1m-slim.batch", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=manifest.ROOT,
                       timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_cpu_run_reports_what_the_manifest_lists():
    from tiny import run_cell

    res = run_cell("sift1m-slim.batch")
    assert res["correct"] is True
    assert set(res["metrics"]) == {"qps", "recall_at_10", "setup_s"}
    assert list(res)[-1] == "checks"
    json.dumps(res)


def test_nothing_the_harness_runs_imports_jax():
    import re

    rx = re.compile(r"^\s*(import|from)\s+(jax|hnsw_slim_tpu)(\s|\.|$)", re.M)
    for p in manifest.BENCH.rglob("*.py"):
        assert not rx.search(p.read_text()), p
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from harness import manifest, runner\n"
            "man = manifest.load()\n"
            "for c in man['workloads']:\n"
            "    t = manifest.traffic(c['traffic'])\n"
            "    manifest.driver(t['driver'])\n"
            "    cfg = manifest.config(man, c['config'])\n"
            "    manifest.system(cfg['system']); manifest.reference(cfg['reference'])\n"
            "for m in man['per_layer']:\n"
            "    manifest.reader(m['name'])\n"
            "import control\n"
            "import hnsw_slim_tpu_torch.index.slim, hnsw_slim_tpu_torch.serve.server\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'hnsw_slim_tpu' or m.startswith('hnsw_slim_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code, str(manifest.BENCH),
                        str(manifest.ROOT)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
