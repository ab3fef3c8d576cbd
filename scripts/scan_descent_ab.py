#!/usr/bin/env python3
"""Kα (topk_dist: the fused distance + top-k scan) and Kε (greedy_descent)
of two or more copies of the port, on the same inputs, in one process on
one card.

    python3 scripts/scan_descent_ab.py --pkg parent=_archive/parent \\
        --pkg new=. [--order parent,new,new,parent] [--n 1000000] \\
        [--reps 10] [--cases scan,descent] [--out scan_descent_ab.json]

Each ``--pkg LABEL=DIR`` loads DIR/hnsw_slim_tpu_torch under a name of its
own, with its own kernel library built from DIR's sources, so two versions
of a kernel run side by side. The inputs are made once, with the package of
this checkout, at chip_smoke.py's shapes: clustered(N, 128) with
HnswConfig(M=30, ef_construction=128) built by insertion (one 4096-insert
batch recorded, as chip_smoke.py phase 7 records it), its Slim conversion
with both dense layouts (the seed table of every level>=1 node), a bf16 copy
of the store, and the SlimQ index on manifold data.

Kα cases: ground truth (512 and 4096 queries over all N, k 10), the seed
scan (4096 queries, and batches of 48, 24 and 12 queries as the server
makes them, over the seed table, k 32),
strata (4 segments x 8 seeds), a self-masked subset kNN (k 64, n_valid,
self_offset), estimate mode (the SlimQ seed table, k 32), one KMeans
assignment chunk (262144 rows x 16 centroids, k 1), and bf16 rows (strata
and exact). Kε cases: the recorded insert batch's descent (levels top..1,
its own active rows) per level and as one launch, the vanilla serving
descent, the Slim graph's descent through rank rows and through CHAL
slices, the SlimQ descent on estimates (the entry point scored by the
kernel), and the bf16 store's descent. A package without
``greedy_descent_levels`` runs a "fused" case as the level-by-level loop
of its per-level launches, so that case compares one launch with the
launches it replaces.

Each case is timed for each package in the turns of ``--order``: CUDA
events around each call, recorded while the card still sleeps
(``torch.cuda._sleep``) so that they time the card's work and not the
wrapper's host code; median of ``--reps`` calls after a warm-up, per
package the median over its turns. The outputs of every package must be
equal (ids and distances; cur, curdist, hops and dcomp): the script fails
otherwise.

A package copy whose library exports ``hs_phase_read`` (a copy instrumented
by scripts/instrument_phases.py: per-phase clock64 sums of its kernels,
copied out and zeroed by that call) has those sums printed for each case
after its first turn.

Prints the card (nvidia-smi name, power limit), one line per case, and one
JSON object as the last line; writes the same object to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
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
    """The package at root/hnsw_slim_tpu_torch, imported as hs_sd_<label>."""
    name = f"hs_sd_{label}"
    pkg_dir = os.path.join(os.path.abspath(root), "hnsw_slim_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    sub = {s: importlib.import_module(f"{name}.{s}")
           for s in ("graph.search", "index.bruteforce", "ops.cuda")}
    if build:
        _, usage = sub["ops.cuda"].build()
        lines = usage.splitlines()
        for a, b in zip(lines, lines[1:]):  # "Compiling ..." then "Used ..."
            if "scan" in a or "greedy" in a or "descent" in a:
                print(f"  {label} ptxas {a.split()[-1][:70]}: {b}",
                      flush=True)
        sub["ops.cuda"].lib()
    return sub


def descend_levels(gs, vectors, q, qn, fetches, top, cur, curdist,
                   stop=None, metric="l2", scorer=None):
    """One descent through ``fetches`` (levels top, top-1, ...): the
    package's fused launch, or its per-level launches where it has none.
    Returns (cur, curdist, hops, dcomp) with hops and dcomp summed."""
    fn = getattr(gs, "greedy_descent_levels", None)
    if fn is not None:
        return fn(vectors, q, qn, fetches, top, cur, curdist, stop=stop,
                  metric=metric, scorer=scorer)
    import torch

    hops = torch.zeros(cur.shape[0], dtype=torch.int32, device=cur.device)
    dcomp = torch.zeros_like(hops)
    for i, f in enumerate(fetches):
        act = None if stop is None else stop < top - i
        cur, curdist, h, dc = gs.greedy_descent(vectors, q, qn, f, cur,
                                                curdist, act, metric, scorer)
        hops, dcomp = hops + h, dcomp + dc
    return cur, curdist, hops, dcomp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pkg", action="append", required=True,
                    help="LABEL=DIR, DIR holding a hnsw_slim_tpu_torch copy")
    ap.add_argument("--order", default="",
                    help="turns, comma separated labels (default: each "
                         "label, then the labels reversed)")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default="", help="comma separated case "
                    "name prefixes to run (default: all)")
    ap.add_argument("--no-slimq", action="store_true",
                    help="skip the SlimQ index and its cases")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal of "
                    "the control flow on the plain versions, host-clock "
                    "times, no kernel library")
    args = ap.parse_args()

    import numpy as np
    import torch

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("scan_descent_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hnsw_slim_tpu_torch.config import HnswConfig, QuantConfig, SlimConfig
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu_torch.quant import estimator as qest
    from hnsw_slim_tpu_torch.quant import kmeans as qkm
    from hnsw_slim_tpu_torch.quant import rotator as qrot
    from hnsw_slim_tpu_torch.utils.data import clustered, manifold

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
    n, nq = args.n, cs.NQ

    def sync():
        if on_card:
            torch.cuda.synchronize()

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
    xb = x.to(torch.bfloat16)
    xbn = (xb.float() ** 2).sum(1)
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    idx.densify_level0()
    idx.densify_upper()
    sq = None
    if not args.no_slimq:
        mbase, mq = manifold(n, 128, latent_dim=24, n_queries=nq,
                             n_clusters=250, seed=5)
        sq = HnswSlimQIndex.build(
            mbase, hnsw_cfg=HnswConfig(M=32, ef_construction=128),
            slim_cfg=SlimConfig(top_M0=32, low_m0=8, top_M=16, low_m=4),
            quant_cfg=QuantConfig(total_bits=4), strategy="insert",
            device=dev)
        sq.densify_upper()
    sync()
    print(f"inputs: {time.perf_counter() - t_in:.1f} s", flush=True)

    qall = torch.as_tensor(queries, device=dev)
    qn_all = (qall * qall).sum(1)
    q512 = qall[:512].contiguous()
    up_vecs, up_vn, up_ids = idx._seed_table()
    up16 = up_vecs.to(torch.bfloat16)
    up16n = (up16.float() ** 2).sum(1)
    cases = []  # (name, kernel, call(pkg) -> outputs)

    def scan_case(name, fn_name, *a, **kw):
        def call(p):
            return getattr(p["index.bruteforce"], fn_name)(*a, **kw)
        cases.append((name, "topk_dist", call))

    # ---- Kα ---------------------------------------------------------------
    scan_case("scan gt 512xN k10", "topk_dist", q512, x, xn, 10)
    scan_case("scan gt 4096xN k10", "topk_dist", qall, x, xn, 10)
    scan_case("scan seeds 4096 k32", "topk_dist", qall, up_vecs, up_vn, 32,
              row_ids=up_ids)
    for b in (48, 24, 12):
        scan_case(f"scan seeds {b} k32", "topk_dist",
                  qall[:b].contiguous(), up_vecs, up_vn, 32, row_ids=up_ids)
    scan_case("scan strata 4x8", "topk_dist_strata", qall, up_vecs, up_vn,
              up_ids, 32, 4)
    sub = x[1000:1000 + 4096].contiguous()
    scan_case("scan self-masked 4096 k64", "topk_dist", sub, up_vecs, up_vn,
              64, n_valid=up_vecs.shape[0] - 1000, self_offset=1000)
    scan_case("scan bf16 strata 4x8", "topk_dist_strata", qall, up16, up16n,
              up_ids, 32, 4)
    scan_case("scan bf16 seeds k32", "topk_dist", qall, up16, up16n, 32,
              row_ids=up_ids)
    chunk = x[:min(n, 262144)].contiguous()
    cent, _ = qkm.kmeans(chunk[:65536], k=16, iters=2)
    cent = torch.as_tensor(cent, device=dev)
    scan_case("scan kmeans k1", "topk_dist", chunk, cent, (cent * cent).sum(1),
              1)
    if sq is not None:
        mq_t = torch.as_tensor(mq, device=dev)
        nbq, exq = int(sq.codes.bin_code.shape[1]), int(sq.codes.ex_bits)
        up_rows, up_ids_q = sq._seed_table()

        def scorer_for(use_ex):
            q_rot = sq.rotator.rotate(mq_t)
            sumq, g_add = qrot.g_tables(q_rot, sq.centroids_rot)
            return qest.QuantScorer(sq._packed_rows(), nbq, exq, use_ex,
                                    q_rot, sumq, g_add)

        sc1 = scorer_for(False)
        scan_case("scan estimate k32", "topk_estimate",
                  sc1._replace(rows=up_rows), up_ids_q, 32)

    # ---- Kε ---------------------------------------------------------------
    def descent_case(name, vecs, q, qn, fetches, top, cur, curdist,
                     stop=None, scorer=None, fused=True):
        if fused:
            def call(p):
                m = p["graph.search"]
                return descend_levels(m, vecs, q, qn,
                                      [f(m) for f in fetches], top, cur,
                                      curdist, stop=stop, scorer=scorer)
        else:
            def call(p):
                m = p["graph.search"]
                outs, c, dd = [], cur, curdist
                for i, f in enumerate(fetches):
                    act = None if stop is None else stop < top - i
                    o = m.greedy_descent(vecs, q, qn, f(m), c, dd, act,
                                         scorer=scorer)
                    outs += list(o)
                    c, dd = o[0], o[1]
                return tuple(outs)
        cases.append((name, "greedy_descent", call))

    def dense(rows):
        return lambda m: m.dense_fetch(rows)

    q4, adjs, act = r["q"], r["adjs"], r["active"]
    qn4 = (q4 * q4).sum(1)
    top = len(adjs) - 1
    c4, d4 = gs.entry_dist(x, xn, q4, qn4, r["entry"])
    stop4 = torch.where(act, 0, top).to(torch.int32)
    ins = [dense(adjs[lv]) for lv in range(top, 0, -1)]
    descent_case("descent insert per-level", x, q4, qn4, ins, top, c4, d4,
                 stop4, fused=False)
    descent_case("descent insert fused", x, q4, qn4, ins, top, c4, d4, stop4)
    # an upper-level insert batch: each query stops at a level of its own
    lvl = torch.as_tensor(np.random.default_rng(1).integers(
        0, top + 1, len(q4)), dtype=torch.int32, device=dev)
    descent_case("descent insert stop levels fused", x, q4, qn4, ins, top,
                 c4, d4, lvl)
    g = h.graph
    van = [dense(g.adjs[lv]) for lv in range(g.max_level, 0, -1)]
    vc, vd = gs.entry_dist(x, xn, qall, qn_all, g.entry)
    descent_case("descent vanilla per-level", x, qall, qn_all, van,
                 g.max_level, vc, vd, fused=False)
    descent_case("descent vanilla fused", x, qall, qn_all, van, g.max_level,
                 vc, vd)
    gq = idx.graph
    sc_, sd_ = gs.entry_dist(x, xn, qall, qn_all, gq.entry)
    rank = [(lambda lv: lambda m: m.rank_fetch(idx.rank_up,
                                               idx.dense_up[lv - 1]))(lv)
            for lv in range(gq.max_level, 0, -1)]
    chal = [(lambda lv: lambda m: m.chal_fetch(gq.nbr, gq.lvl_off, lv,
                                               gq.cap))(lv)
            for lv in range(gq.max_level, 0, -1)]
    descent_case("descent rank fused", x, qall, qn_all, rank, gq.max_level,
                 sc_, sd_)
    descent_case("descent chal fused", x, qall, qn_all, chal, gq.max_level,
                 sc_, sd_)
    bc, bd = gs.entry_dist(xb, xbn, qall, qn_all, g.entry)
    descent_case("descent bf16 fused", xb, qall, qn_all, van, g.max_level,
                 bc, bd)
    if sq is not None:
        gsq = sq.graph
        ent = torch.full((nq,), gsq.entry, dtype=torch.int32, device=dev)
        qrk = [(lambda lv: lambda m: m.rank_fetch(sq.rank_up,
                                                  sq.dense_up[lv - 1]))(lv)
               for lv in range(gsq.max_level, 0, -1)]
        descent_case("descent quant fused", None, None, None, qrk,
                     gsq.max_level, ent, None, scorer=sc1)

    # ---- the turns ----------------------------------------------------------
    want = [c for c in args.cases.split(",") if c]
    results = {}
    for name, kernel, call in cases:
        if want and not any(name.startswith(w) for w in want):
            continue
        outs, times = {}, {lb: [] for lb in labels}
        phases = {}
        for lb in order:
            p = pkgs[lb]
            lib = p["ops.cuda"].lib() if on_card else None
            o = tuple(call(p))  # the warm-up call
            sync()
            if lb not in outs:
                outs[lb] = o
            if hasattr(lib, "hs_phase_read") and lb not in phases:
                buf = np.zeros(16, dtype=np.uint64)
                lib.hs_phase_read(ctypes.c_void_p(buf.ctypes.data))
                call(p)
                sync()
                lib.hs_phase_read(ctypes.c_void_p(buf.ctypes.data))
                phases[lb] = [int(v) for v in buf]
            for _ in range(args.reps):
                if not on_card:
                    t0 = time.perf_counter()
                    call(p)
                    times[lb].append(1e3 * (time.perf_counter() - t0))
                    continue
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                # the card sleeps while the host enqueues the call, so the
                # events time the card's work, not the wrapper's host code
                torch.cuda._sleep(SLEEP_CYCLES)
                ev[0].record()
                call(p)
                ev[1].record()
                ev[1].synchronize()
                times[lb].append(ev[0].elapsed_time(ev[1]))
        ref = outs[labels[0]]
        equal = {lb: len(o) == len(ref) and all(
            torch.equal(a, b) for a, b in zip(o, ref)) for lb, o in
            outs.items()}
        row = dict(kernel=kernel, equal=equal,
                   ms={lb: statistics.median(t) for lb, t in times.items()},
                   spread={lb: [min(t), max(t)] for lb, t in times.items()})
        if phases:
            row["phases"] = phases
        if kernel == "greedy_descent":
            row["hops"] = int(sum(int(t.sum()) for t in ref[2::4]))
            row["dcomp"] = int(sum(int(t.sum()) for t in ref[3::4]))
        results[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
        del outs
    bad = [k for k, v in results.items() if not all(v["equal"].values())]
    summary = dict(card=card, n=n, reps=args.reps, order=order,
                   packages=dict(s.split("=", 1) for s in args.pkg),
                   cases=results, unequal=bad)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
