#!/usr/bin/env python3
"""Kβ (beam_search) and Kγ (rng_prune) of two or more copies of the port,
on the same inputs, in one process on one card.

    python3 scripts/beam_prune_ab.py --pkg parent=_archive/parent \\
        --pkg new=. [--order parent,new,new,parent] [--n 1000000] \\
        [--reps 10] [--out beam_prune_ab.json]

Each ``--pkg LABEL=DIR`` loads DIR/hnsw_slim_tpu_torch under a name of its
own, with its own kernel library built from DIR's sources, so two versions
of a kernel run side by side. The inputs are made once, with the package of
this checkout, at chip_smoke.py's shapes: clustered(N, 128) with
HnswConfig(M=30, ef_construction=128) built by insertion (one 4096-insert
batch recorded, as chip_smoke.py phase 7 records it), the Slim conversion
with both dense layouts, the SlimZero conversion (the guarded 8192-row
chunk chip_smoke.py records), the SlimQ index on manifold data, and the NN-descent
kNN. Every Kβ mode (build E 8, carried buffer E 1, vanilla and Slim serving
at ef 32..320, CHAL, rank, filtered, quant, quant_ex with the rerank track,
bf16) and every Kγ mode (insert forward, overflow, conversion stage 2,
guarded, bf16, NN-descent) is then timed for each package in the turns of
``--order``: CUDA events around each call, recorded while the card still
sleeps (``torch.cuda._sleep``) so that they time the card's work and not
the wrapper's host code; median of ``--reps`` calls after a warm-up, per
package the median over its turns. Every prune passes ``m_max``, as the
insertion build does, so that no wrapper reads the card back. The outputs of every
package must be equal (ids, distances, hops, dcomp; kept rows and counts):
the script fails otherwise.

A package copy whose library exports ``hs_phase_read`` (an instrumented
copy: per-phase clock64 sums of its kernels, copied out and zeroed by that
call) has those sums printed for each case after its first turn.

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
    """The package at root/hnsw_slim_tpu_torch, imported as hs_ab_<label>."""
    name = f"hs_ab_{label}"
    pkg_dir = os.path.join(os.path.abspath(root), "hnsw_slim_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    sub = {s: importlib.import_module(f"{name}.{s}")
           for s in ("graph.search", "graph.heuristic", "ops.cuda")}
    if build:
        _, usage = sub["ops.cuda"].build()
        lines = usage.splitlines()
        for a, b in zip(lines, lines[1:]):  # "Compiling ..." then "Used ..."
            if "beam_kernel" in a or "prune_kernel" in a:
                kind = "beam" if "beam_kernel" in a else "prune"
                kind += "<bf16>" if "nv_bfloat16" in a else \
                    "<quant>" if "ILb1E" in a else ""
                print(f"  {label} ptxas {kind}: {b}", flush=True)
        sub["ops.cuda"].lib()
    return sub


def flat(out):
    """A call's outputs as a flat tuple of tensors (a PopTrack's d, ids)."""
    res = []
    for o in out if isinstance(out, tuple) else (out,):
        if hasattr(o, "_fields") and hasattr(o, "ids"):
            res += [o.d, o.ids]
        elif o is not None:
            res.append(o)
    return tuple(res)


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
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal of "
                    "the control flow on the plain versions, host-clock "
                    "times, no kernel library")
    args = ap.parse_args()

    import numpy as np
    import torch

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("beam_prune_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hnsw_slim_tpu_torch.config import (HnswConfig, QuantConfig,
                                            SearchConfig, SlimConfig)
    from hnsw_slim_tpu_torch.graph import build as tb
    from hnsw_slim_tpu_torch.graph import heuristic, nnd, prune, revconn
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu_torch.index.slimzero import HnswSlimZeroIndex
    from hnsw_slim_tpu_torch.quant import estimator as qest
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
    d = x.shape[1]
    xb = x.to(torch.bfloat16)
    xbn = (xb.float() ** 2).sum(1)
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    idx.densify_level0()
    idx.densify_upper()
    g_rec = {}
    guarded = prune.prune_batch_guarded
    g_which = [max(1, n // prune.GUARD_CHUNK // 2)]  # chip_smoke's chunk

    def g_wrap(vectors, vn, base_ids, cand, valid, guard, **kw):
        g_which[0] -= 1
        if g_which[0] == 0 and len(base_ids) == prune.GUARD_CHUNK:
            g_rec.update(b=base_ids.clone(), c=cand.clone(), g=guard.clone(),
                         m=kw["m_per_row"].clone(), w=kw["out_width"])
        return guarded(vectors, vn, base_ids, cand, valid, guard, **kw)

    prune.prune_batch_guarded = g_wrap
    try:
        HnswSlimZeroIndex.from_hnsw(h, SlimConfig.from_ratios())
    finally:
        prune.prune_batch_guarded = guarded
    mbase, mq = manifold(n, 128, latent_dim=24, n_queries=nq, n_clusters=250,
                         seed=5)
    sq = HnswSlimQIndex.build(
        mbase, hnsw_cfg=HnswConfig(M=32, ef_construction=128),
        slim_cfg=SlimConfig(top_M0=32, low_m0=8, top_M=16, low_m=4),
        quant_cfg=QuantConfig(total_bits=4), strategy="insert", device=dev)
    sq.densify_level0()
    knn, _ = nnd.nn_descent(x, xn, k=max(hcfg.maxM0, 48), rounds=25,
                            metric="l2", seed=hcfg.seed)
    sync()
    print(f"inputs: {time.perf_counter() - t_in:.1f} s", flush=True)

    qall = torch.as_tensor(queries, device=dev)
    qn_all = (qall * qall).sum(1)
    q4, adjs, act = r["q"], r["adjs"], r["active"]
    qn4 = (q4 * q4).sum(1)
    efc = hcfg.ef_construction
    up_vecs, up_vn, up_ids = idx._seed_table()

    def seeds(qt):
        s_d, s_pos = bf.topk_dist(qt, up_vecs, up_vn, 32, row_ids=up_ids)
        s_id = torch.where(s_pos >= 0, up_ids[s_pos.clamp(min=0).long()], -1)
        s_id = torch.where(torch.isinf(s_d), -1, s_id)
        return s_d.contiguous(), s_id.to(torch.int32).contiguous()

    s_all = seeds(qall)
    cases = []  # (name, kernel, call(pkg) -> outputs)

    def beam_case(name, vecs, q, qn, fetch_of, sd, si, **kw):
        def call(p):
            return p["graph.search"].beam_search(
                vecs, q, qn, fetch_of(p["graph.search"]), sd, si, **kw)
        cases.append((name, "beam_search", call))

    dense = lambda rows: (lambda m: m.dense_fetch(rows))  # noqa: E731

    # build mode: the recorded batch's level-0 beam
    top = len(adjs) - 1
    pc, pd = gs.entry_dist(x, xn, q4, qn4, r["entry"])
    for lv in range(top, 0, -1):
        pc, pd, _, _ = gs.greedy_descent(x, q4, qn4, adjs[lv], pc, pd, act)
    kw0 = dict(P=efc, ef_eff=efc, pop_width=tb.INSERT_POP_WIDTH,
               cw=gs.cand_width(efc, tb.INSERT_POP_WIDTH, adjs[0].shape[1],
                                0), max_iters=2 * efc + 64, k=efc)
    beam_case("beam build E8", x, q4, qn4, dense(adjs[0]),
              torch.where(act, pd, float("inf"))[:, None].contiguous(),
              torch.where(act, pc, -1)[:, None].contiguous(), **kw0)
    # the carried buffer, E 1, one level up
    lv = min(2, top)
    cc, cd = gs.entry_dist(x, xn, q4, qn4, r["entry"])
    for l_ in range(top, lv, -1):
        cc, cd, _, _ = gs.greedy_descent(x, q4, qn4, adjs[l_], cc, cd)
    buf_d, buf_id = gs.beam_init(cc, cd, efc)
    if lv == 2:
        buf_d, buf_id, _, _ = gs.beam_level(
            x, q4, qn4, adjs[2], buf_d, buf_id,
            torch.ones(len(q4), dtype=torch.bool, device=dev),
            max_iters=2 * efc + 64)
    beam_case("beam carried E1", x, q4, qn4, dense(adjs[1]),
              buf_d.contiguous(), buf_id.contiguous(), P=efc, ef_eff=efc,
              pop_width=1, cw=adjs[1].shape[1], max_iters=2 * efc + 64,
              k=efc)
    # serving: vanilla (pop 4, from the greedy descent) and Slim (pop 8,
    # seeded), all 4096 queries
    g = h.graph
    vc, vd = gs.entry_dist(x, xn, qall, qn_all, g.entry)
    for l_ in range(g.max_level, 0, -1):
        vc, vd, _, _ = gs.greedy_descent(x, qall, qn_all, g.adjs[l_], vc, vd)
    vc, vd = vc[:, None].contiguous(), vd[:, None].contiguous()

    def slim_kw(ef, pop=8, width=None):
        P = gs.buffer_width(ef)
        return dict(P=P, ef_eff=ef, pop_width=pop,
                    cw=gs.cand_width(P, pop, width or idx.dense0.shape[1], 0),
                    max_iters=SearchConfig(ef=ef, pop_width=pop).iters(),
                    k=10)

    for ef in (32, 64, 128, 256, 320):
        beam_case(f"beam vanilla ef{ef}", x, qall, qn_all, dense(g.adjs[0]),
                  vd, vc, P=ef, ef_eff=ef, pop_width=4,
                  cw=gs.cand_width(ef, 4, g.adjs[0].shape[1], 0),
                  max_iters=SearchConfig(ef=ef, pop_width=4).iters(), k=10)
        beam_case(f"beam slim ef{ef}", x, qall, qn_all, dense(idx.dense0),
                  *s_all, **slim_kw(ef))
    gq = idx.graph
    beam_case("beam chal ef64", x, qall, qn_all,
              lambda m: m.chal_fetch(gq.nbr, gq.lvl_off, 0, gq.cap0), *s_all,
              **slim_kw(64))
    # rank rows: level 1 of the Slim graph, from the descent to level 2
    c1, d1 = gs.entry_dist(x, xn, qall, qn_all, gq.entry)
    for l_ in range(gq.max_level, 1, -1):
        c1, d1, _, _ = gs.greedy_descent(
            x, qall, qn_all, gs.rank_fetch(idx.rank_up, idx.dense_up[l_ - 1]),
            c1, d1)
    beam_case("beam rank ef64", x, qall, qn_all,
              lambda m: m.rank_fetch(idx.rank_up, idx.dense_up[0]),
              d1[:, None].contiguous(), c1[:, None].contiguous(),
              **dict(slim_kw(64, width=gq.cap), k=64))
    gen = torch.Generator(device=dev).manual_seed(3)
    for share in (0.5, 0.1):
        allowed = torch.rand(n, generator=gen, device=dev) < share
        t_d, t_i = gs.filter_track_init(allowed, s_all[1][:, 0],
                                        s_all[0][:, 0], 64)
        kw_f = dict(slim_kw(64),
                    max_iters=int(slim_kw(64)["max_iters"] / share) + 8,
                    allowed=allowed, track_d=t_d, track_id=t_i)
        beam_case(f"beam filtered {share}", x, qall, qn_all,
                  dense(idx.dense0), *s_all, **kw_f)
    beam_case("beam bf16 slim ef64", xb, qall, qn_all, dense(idx.dense0),
              *s_all, **slim_kw(64))
    # SlimQ: quant, quant_ex, and quant with the rerank track, ef 64
    mq_t = torch.as_tensor(mq, device=dev)
    nbq, exq = int(sq.codes.bin_code.shape[1]), int(sq.codes.ex_bits)
    up_rows, up_ids_q = sq._seed_table()

    def scorer_for(use_ex):
        q_rot = sq.rotator.rotate(mq_t)
        sumq, g_add = qrot.g_tables(q_rot, sq.centroids_rot)
        return qest.QuantScorer(sq._packed_rows(), nbq, exq, use_ex, q_rot,
                                sumq, g_add)

    sc1 = scorer_for(False)
    e_d, e_pos = bf.topk_estimate(sc1._replace(rows=up_rows), up_ids_q, 32)
    e_id = torch.where(e_pos >= 0, up_ids_q[e_pos.clamp(min=0).long()], -1)
    e_id = torch.where(torch.isinf(e_d), -1, e_id).to(torch.int32)
    kw_q = dict(P=64, ef_eff=64, pop_width=8,
                cw=gs.cand_width(64, 8, sq.graph.cap0, 0),
                max_iters=SearchConfig(ef=64, pop_width=8).iters(), k=64)
    for name, sc_, trk in (
            ("beam quant ef64", sc1, None),
            ("beam quant_ex ef64", scorer_for(True), None),
            ("beam quant+rerank ef64", sc1,
             gs.pop_track_init(sq._dataset_dev, mq_t, 16))):
        beam_case(name, None, None, None, dense(sq.dense0),
                  e_d.contiguous(), e_id.contiguous(), scorer=sc_,
                  pop_track=trk, **kw_q)

    # ---- Kγ ---------------------------------------------------------------
    def prune_case(name, vecs, vn_, b_ids, cnd, m_row, **kw):
        def call(p):
            return p["graph.heuristic"].rng_prune(vecs, vn_, b_ids, cnd,
                                                  m_row, **kw)
        cases.append((name, "rng_prune", call))

    kw_ap = r["ap_kw"]
    a_ids, cand = r["a_ids"], r["cand"]
    M, cap0 = kw_ap["M"], r["adj0"].shape[1]
    m_fwd = torch.full((len(a_ids),), M, dtype=torch.int32, device=dev)
    fwd = dict(keep_all_under_m=True, keep_pruned=False, out_width=M)
    prune_case("prune forward 4096x128", x, xn, a_ids, cand, m_fwd, m_max=M,
               **fwd)
    sel, cnt = heuristic.rng_prune(x, xn, a_ids, cand, m_fwd, **fwd)
    adj, deg = r["adj0"].clone(), r["deg0"].clone()
    adj[a_ids.long()] = torch.nn.functional.pad(sel, (0, cap0 - M),
                                                value=-1)
    deg[a_ids.long()] = cnt
    us, ps = revconn.reverse_edges(a_ids, sel, adj.shape[0])
    ut, bk, ck, _, _ = revconn.append_overflow(adj, deg, us, ps,
                                               kw_ap["of_t"], kw_ap["new_w"])
    prune_case("prune overflow", x, xn, bk, ck,
               torch.full((len(ut),), cap0, dtype=torch.int32, device=dev),
               m_max=cap0, keep_all_under_m=False, keep_pruned=False,
               out_width=cap0)
    cfg = SlimConfig.from_ratios()
    pick = torch.as_tensor(np.random.default_rng(0).choice(n, 4096, False),
                           device=dev)
    adj_np = [a.cpu().numpy() for a in g.adjs]
    thr = prune.degree_thresholds(adj_np, h.levels, adj_np[0].shape[1], cfg)
    deg0 = (adj_np[0] >= 0).sum(1)
    budget = torch.as_tensor(np.where(deg0 > thr[0], cfg.top_M0, cfg.low_m0)
                             .astype(np.int32), device=dev)
    s2 = (pick.to(torch.int32), g.adjs[0][pick].contiguous(),
          budget[pick].contiguous())
    kw_s2 = dict(keep_all_under_m=False, keep_pruned=False,
                 out_width=cfg.top_M0, m_max=cfg.top_M0)
    prune_case("prune conversion stage 2", x, xn, *s2, **kw_s2)
    prune_case("prune bf16 stage 2", xb, xbn, *s2, **kw_s2)
    prune_case("prune guarded chunk", x, xn, g_rec["b"], g_rec["c"],
               g_rec["m"], keep_all_under_m=False, keep_pruned=False,
               out_width=g_rec["w"], guard=g_rec["g"])
    cand0 = torch.as_tensor(tb.level0_candidates(knn.cpu().numpy(), 16,
                                                 hcfg.seed), device=dev)
    prune_case("prune nnd knn_to_level0", x, xn, pick.to(torch.int32),
               cand0[pick].contiguous(),
               torch.full((4096,), hcfg.M, dtype=torch.int32, device=dev),
               m_max=hcfg.M, keep_all_under_m=True, keep_pruned=True,
               out_width=hcfg.M)

    # ---- the turns ----------------------------------------------------------
    want = [c for c in args.cases.split(",") if c]
    results = {}
    for name, kernel, call in cases:
        if want and not any(name.startswith(w) for w in want):
            continue
        outs, times = {}, {lb: [] for lb in labels}
        phases = {}
        for turn, lb in enumerate(order):
            p = pkgs[lb]
            lib = p["ops.cuda"].lib() if on_card else None
            o = flat(call(p))  # the warm-up call
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
        if kernel == "beam_search":
            row["hops"] = int(ref[2].sum())
            row["dcomp"] = int(ref[3].sum())
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
