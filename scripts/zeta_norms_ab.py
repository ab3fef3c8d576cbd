#!/usr/bin/env python3
"""Kξ (row_norms), Kζ (rev_connect: the insert apply's reverse connects),
K1 (point_dist) and K19 (shard_merge) of two or more copies of the port, on
the same inputs, in one process on one card, and the whole 1M insertion
build of each copy.

    python3 scripts/zeta_norms_ab.py --pkg parent=_archive/parent \\
        --pkg new=. [--order parent,new,new,parent] [--n 1000000] \\
        [--reps 20] [--out zeta_norms_ab.json]

Each ``--pkg LABEL=DIR`` loads DIR/hnsw_slim_tpu_torch under a name of its
own, with its own kernel library built from DIR's sources. The inputs are
made once, with the package of this checkout, at chip_smoke.py's shapes:
clustered(N, 128) and its 4096 queries, HnswConfig(M=30,
ef_construction=128) built by insertion with one 4096-insert batch's
level-0 apply recorded, as chip_smoke.py records it.

Cases: Kξ on the 4096 queries and on the N-row store (fp32), beside
``torch.sum(x * x, -1)`` and ``torch.linalg.vector_norm``; Kζ's calls of
the recorded level-0 apply (a package's appends, overflow targets and
candidate rows, then the write-back of fixed re-pruned rows: three calls
in a package that has them as three, two in one with ``append_overflow``)
and the whole apply (``apply_insert``, both Kγ prunes and Kι included);
K1 (the 4096 queries' entry distances, one row each by id) and K19 (the
merge of [4, 4096, 10] per-shard lists). Each is timed in the turns of
``--order`` in two ways: device-only, CUDA events around one call recorded
while the card still sleeps (``torch.cuda._sleep``), so that they time the
card's work and not the wrapper's host code, median of ``--reps`` calls;
and host-inclusive, CUDA events around ``--reps`` eager calls back to back
(as chip_smoke.py's ``cuda_ms``), so that a call costs whatever the host
or the card takes longer for. Per package the median over its turns. The
gap is the wrapper's host cost. Every output of every package must be
equal to the first package's (norms; Kζ's adjacency, degrees, targets,
base ids, candidate rows and counters; K1's distances; K19's lists): the
script fails otherwise.

Then each package builds the whole N-point insertion graph from the same
data in the same turns: its adjacency and its degree arrays must be equal
at every level; the build's seconds, its phase split and its Kζ and Kι
launches per apply are reported. Last, the host cost of four ways to read
PyTorch's current stream handle, and of Kξ's call on the queries taken
apart (the whole call of each package, the output allocation, the launch
alone) beside ``torch.sum`` and ``vector_norm``.

Prints the card (nvidia-smi name, power limit), one line per case, and one
JSON object as the last line; writes the same object to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLEEP_CYCLES = 2_000_000  # about 1 ms of the card's clock before each call
sys.path.insert(0, ROOT)


def load_pkg(label: str, root: str, build: bool):
    """The package at root/hnsw_slim_tpu_torch, imported as hs_zn_<label>."""
    name = f"hs_zn_{label}"
    pkg_dir = os.path.join(os.path.abspath(root), "hnsw_slim_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    sub = {s: importlib.import_module(f"{name}.{s}")
           for s in ("graph.revconn", "graph.heuristic", "graph.search",
                     "index.hnsw", "ops.cuda", "ops.distance",
                     "parallel.merge", "config")}
    if build:
        sub["ops.cuda"].build()
        sub["ops.cuda"].lib()
    return sub


def zeta_tail(rv, adj, deg, us, ps, of_t: int, new_w: int):
    """Kζ's part of one apply before the overflow prune, through a
    package's revconn: (ut, base, candidate rows, of_edges, of_targets);
    adj and deg change in place."""
    if hasattr(rv, "append_overflow"):
        return rv.append_overflow(adj, deg, us, ps, of_t, new_w)
    ovf = rv.rev_append(adj, deg, us, ps)
    of_u, of_p, ut, of_e, of_tc = rv.overflow_targets(us, ps, ovf, of_t,
                                                      adj.shape[0])
    base, ocand = rv.overflow_rows(adj, of_u, of_p, ut, new_w)
    return ut, base, ocand, of_e, of_tc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pkg", action="append", required=True,
                    help="LABEL=DIR, DIR holding a hnsw_slim_tpu_torch copy")
    ap.add_argument("--order", default="",
                    help="turns, comma separated labels (default: each "
                         "label, then the labels reversed)")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-build", action="store_true",
                    help="skip the whole-build case")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal of "
                    "the control flow on the plain versions, host-clock "
                    "times, no kernel library")
    args = ap.parse_args()

    import numpy as np
    import torch

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("zeta_norms_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hnsw_slim_tpu_torch.config import HnswConfig
    from hnsw_slim_tpu_torch.graph import heuristic, revconn
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.utils.data import clustered

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if on_card else "cpu rehearsal"
    print(card, flush=True)
    pkgs = {}
    for spec_ in args.pkg:
        label, root = spec_.split("=", 1)
        t0 = time.perf_counter()
        pkgs[label] = load_pkg(label, root, on_card)
        print(f"package {label} ({root}): library ready in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    labels = list(pkgs)
    order = args.order.split(",") if args.order else labels + labels[::-1]
    dev = torch.device(args.device)
    n, nq, reps = args.n, cs.NQ, args.reps

    def sync():
        if on_card:
            torch.cuda.synchronize()

    class Clock:
        """CUDA events on the card, the host clock in a CPU rehearsal."""

        def record(self):
            self.t = time.perf_counter()
            if on_card:
                self.ev = torch.cuda.Event(enable_timing=True)
                self.ev.record()

        def ms_to(self, end) -> float:
            if on_card:
                end.ev.synchronize()
                return self.ev.elapsed_time(end.ev)
            return 1e3 * (end.t - self.t)

    # ---- inputs (this checkout's package) --------------------------------
    t_in = time.perf_counter()
    base, queries = clustered(n, 128, n_queries=nq,
                              n_clusters=max(64, n // 1000), seed=7,
                              scale=0.3)
    hcfg = HnswConfig(M=30, ef_construction=128)
    rec = cs.BatchRecorder(max(1, cs.full_batches(n) // 2), hcfg.maxM0)
    with rec.installed():
        h = HnswIndex(hcfg, device=dev, strategy="insert")
        h.build(base)
    if "adj0" not in rec.rec:
        raise SystemExit(f"N={n} made no 4096-insert batch to record")
    r = rec.rec
    x, xn = h.vectors, h.vn
    qall = torch.as_tensor(queries, device=dev)
    kw = r["ap_kw"]
    a_ids, cand = r["a_ids"], r["cand"]
    cap0, M = r["adj0"].shape[1], kw["M"]
    sel, cnt = heuristic.rng_prune(
        x, xn, a_ids, cand, torch.full((len(a_ids),), M, dtype=torch.int32,
                                       device=dev),
        keep_all_under_m=True, keep_pruned=False, out_width=M, m_max=M)
    pre_a, pre_d = r["adj0"].clone(), r["deg0"].clone()
    pre_a[a_ids.long()] = torch.nn.functional.pad(sel, (0, cap0 - M),
                                                  value=-1)
    pre_d[a_ids.long()] = cnt
    us, ps = revconn.reverse_edges(a_ids, sel, n)
    a_, d_ = pre_a.clone(), pre_d.clone()
    ut0, base0, ocand0, _, _ = zeta_tail(revconn, a_, d_, us, ps, kw["of_t"],
                                         kw["new_w"])
    osel, ocnt = heuristic.rng_prune(
        x, xn, base0, ocand0, torch.full((len(ut0),), cap0,
                                         dtype=torch.int32, device=dev),
        keep_all_under_m=False, keep_pruned=False, out_width=cap0,
        m_max=cap0)
    del a_, d_
    # K1: each query's entry row by id; K19: four sorted per-shard lists
    rng = np.random.default_rng(3)
    qn_all = (qall * qall).sum(1)
    ent = torch.as_tensor(rng.integers(0, n, (nq, 1)), dtype=torch.int32,
                          device=dev)
    s_, k_ = 4, 10
    md = torch.sort(torch.as_tensor(rng.random((s_, nq, k_)),
                                    dtype=torch.float32, device=dev),
                    dim=2).values
    mi = torch.as_tensor(rng.integers(0, n // s_, (s_, nq, k_)),
                         dtype=torch.int32, device=dev)
    gid = torch.as_tensor(rng.permutation(n)[:s_ * (n // s_)].reshape(
        s_, n // s_), dtype=torch.int32, device=dev)
    mh = torch.as_tensor(rng.integers(0, 500, (s_, nq)), dtype=torch.int32,
                         device=dev)
    mc = torch.as_tensor(rng.integers(0, 5000, (s_, nq)), dtype=torch.int32,
                         device=dev)
    sync()
    print(f"inputs: {time.perf_counter() - t_in:.1f} s; the apply: "
          f"{len(us)} edge slots, of_t {kw['of_t']}, new_w {kw['new_w']}",
          flush=True)

    # ---- cases: name -> (prepare() -> state, call(p, state) -> outputs) ---
    cases = []
    lib_calls = {  # library yardsticks timed in every turn beside Kξ
        "torch.sum(x * x, -1)": lambda t: torch.sum(t * t, -1),
        "vector_norm": lambda t: torch.linalg.vector_norm(
            t, dim=-1, dtype=torch.float32)}

    def norms_case(name, t):
        cases.append((name, None, lambda p, _: (
            p["ops.distance"].sq_norms(t),), t))

    norms_case(f"row_norms {nq} queries", qall)
    norms_case(f"row_norms {n} x 128 store", x)

    def zeta_prep():
        return pre_a.clone(), pre_d.clone()

    def zeta_call(p, st):
        a, g = st
        rv = p["graph.revconn"]
        ut, b_, oc, e_, t_ = zeta_tail(rv, a, g, us, ps, kw["of_t"],
                                       kw["new_w"])
        rv.write_rows(a, g, ut, osel, ocnt)
        return a, g, ut, b_, oc, e_.reshape(1), t_.reshape(1)

    cases.append(("rev_connect level-0 apply tail", zeta_prep, zeta_call,
                  None))

    def apply_prep():
        return r["adj0"].clone(), r["deg0"].clone()

    def apply_call(p, st):
        a, g = st
        e_, t_ = p["graph.revconn"].apply_insert(a, g, x, xn, a_ids, cand,
                                                 **kw)
        return a, g, e_.reshape(1), t_.reshape(1)

    cases.append(("whole level-0 apply", apply_prep, apply_call, None))
    cases.append(("point_dist 4096 entry rows", None, lambda p, _: (
        p["ops.distance"].gathered_dist(qall, x, qn=qn_all, vn=xn,
                                        ids=ent),), None))
    cases.append(("shard_merge [4, 4096, 10]", None, lambda p, _: tuple(
        p["parallel.merge"].merge_topk(md, mi, gid, mh, mc)), None))

    def device_ms(fn, prep):
        out = []
        for _ in range(reps):
            st = prep() if prep else None
            sync()
            ev = [Clock(), Clock()]
            if on_card:
                torch.cuda._sleep(SLEEP_CYCLES)
            ev[0].record()
            fn(st)
            ev[1].record()
            out.append(ev[0].ms_to(ev[1]))
        return statistics.median(out)

    def host_ms(fn, prep):
        sts = [prep() if prep else None for _ in range(reps)]
        sync()
        ev = [Clock(), Clock()]
        ev[0].record()
        for st in sts:
            fn(st)
        ev[1].record()
        return ev[0].ms_to(ev[1]) / reps

    results = {}
    for name, prep, call, lib_in in cases:
        outs, dev_t, host_t = {}, {}, {}
        for lb in order:
            p = pkgs[lb]
            o = tuple(call(p, prep() if prep else None))  # warm-up
            sync()
            outs.setdefault(lb, o)
            dev_t.setdefault(lb, []).append(
                device_ms(lambda st: call(p, st), prep))
            host_t.setdefault(lb, []).append(
                host_ms(lambda st: call(p, st), prep))
            if lib_in is not None:
                for ln, lf in lib_calls.items():
                    lf(lib_in)
                    dev_t.setdefault(ln, []).append(
                        device_ms(lambda st: lf(lib_in), None))
                    host_t.setdefault(ln, []).append(
                        host_ms(lambda st: lf(lib_in), None))
        ref = outs[labels[0]]
        equal = {lb: len(o) == len(ref) and all(
            torch.equal(a, b) for a, b in zip(o, ref))
            for lb, o in outs.items()}
        row = dict(equal=equal,
                   device_ms={k: statistics.median(v)
                              for k, v in dev_t.items()},
                   host_ms={k: statistics.median(v)
                            for k, v in host_t.items()},
                   turns_device_ms=dev_t, turns_host_ms=host_t)
        if name.startswith("rev_connect"):
            row["of_edges"], row["of_targets"] = int(ref[5]), int(ref[6])
        results[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
        del outs

    # ---- the whole insertion build of each package -------------------------
    builds = {}
    if not args.no_build:
        ref_adj = ref_deg = None
        for lb in order:
            p = pkgs[lb]
            rv, cu = p["graph.revconn"], p["ops.cuda"]
            seen, applies = [], [0]
            real = rv.apply_insert

            def keep(adj, deg, *a, _real=real, **k):
                seen.append((adj, deg))
                applies[0] += 1
                return _real(adj, deg, *a, **k)

            rv.apply_insert = keep
            try:
                cu.reset_launches()
                sync()
                t0 = time.perf_counter()
                hb = p["index.hnsw"].HnswIndex(
                    p["config"].HnswConfig(M=30, ef_construction=128),
                    device=dev, strategy="insert")
                hb.build(base)
                sync()
                wall = time.perf_counter() - t0
            finally:
                rv.apply_insert = real
            adjs = [a.clone() for a in hb.graph.adjs]
            # a level no apply touched (only the entry point) keeps zeros
            degs = [next((dg.clone() for ad, dg in seen if ad is lv),
                         torch.zeros(lv.shape[0], dtype=torch.int32,
                                     device=dev)) for lv in hb.graph.adjs]
            if ref_adj is None:
                ref_adj, ref_deg = adjs, degs
            eq = len(adjs) == len(ref_adj) and all(
                torch.equal(a, b) for a, b in zip(adjs, ref_adj)) and all(
                torch.equal(a, b) for a, b in zip(degs, ref_deg))
            b_ = builds.setdefault(lb, dict(equal=True, wall_s=[],
                                            phase_s=[]))
            b_["equal"] &= bool(eq)
            b_["wall_s"].append(wall)
            b_["phase_s"].append(hb.build_stats["phase_s"])
            b_["applies"] = applies[0]
            b_["per_apply"] = {k: cu.launches[k] / applies[0] for k in (
                "rev_connect", "radix_sort.ids", "rng_prune")}
            print(f"build {lb}: {wall:.3f} s, equal {eq}, phases "
                  f"{json.dumps(hb.build_stats['phase_s'])}, per apply "
                  f"{json.dumps(b_['per_apply'])}", flush=True)
            del hb, adjs, degs, seen
        results["whole insertion build"] = dict(
            equal={lb: b["equal"] for lb, b in builds.items()},
            builds=builds)

    # ---- the stream handle: host microseconds a read ------------------------
    ways = {
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream(_cuda_getDevice())":
            lambda: torch._C._cuda_getCurrentRawStream(
                torch._C._cuda_getDevice()),
        "_cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
    }
    def host_us(fn, calls: int) -> float:
        """Best of 5 runs of ``calls`` back-to-back calls, microseconds a
        call on the host clock (a sync at the end of each run)."""
        best = None
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync()
            us_ = (time.perf_counter() - t0) * 1e6 / calls
            best = us_ if best is None else min(best, us_)
        return best

    stream_us = {way: host_us(fn, 100_000) for way, fn in ways.items()} \
        if on_card else {}
    print(f"stream handle, host us a read (best of 5 x 100000): "
          f"{json.dumps(stream_us)}", flush=True)
    # Kξ's call on the 4096 queries taken apart: each package's whole
    # call, the allocation forms, and one launch of the last package's
    # lean path into a preallocated output
    cu, dist_ = pkgs[labels[-1]]["ops.cuda"], pkgs[labels[-1]]["ops.distance"]
    out = torch.empty(nq, dtype=torch.float32, device=dev)
    parts = {f"sq_norms ({lb})": (lambda p=p: p["ops.distance"].sq_norms(
        qall)) for lb, p in pkgs.items()}
    parts.update({
        "torch.empty((n,), dtype, device)": lambda: torch.empty(
            (nq,), dtype=torch.float32, device=qall.device),
        "x.new_empty(n, dtype)": lambda: qall.new_empty(
            nq, dtype=torch.float32),
        "cuda.launch(row_norms) alone": lambda: cu.launch(
            "row_norms", qall.data_ptr(), nq, 128, 128, out.data_ptr()),
        "torch.sum(x * x, -1)": lambda: torch.sum(qall * qall, -1),
        "vector_norm": lambda: torch.linalg.vector_norm(
            qall, dim=-1, dtype=torch.float32)})
    if not on_card:
        parts.pop("cuda.launch(row_norms) alone")
    dist_.sq_norms(qall)
    norm_parts_us = {k: host_us(f, 2000) for k, f in parts.items()}
    print(f"sq_norms of {nq} queries by part, host us a call (best of 5 x "
          f"2000, back to back): {json.dumps(norm_parts_us)}", flush=True)

    bad = [k for k, v in results.items() if not all(v["equal"].values())]
    summary = dict(card=card, n=n, reps=reps, order=order,
                   packages=dict(s.split("=", 1) for s in args.pkg),
                   cases=results, stream_us=stream_us,
                   norm_parts_us=norm_parts_us, unequal=bad)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
