#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py            # 1M x 128, 4096 queries
    python3 chip_smoke.py --n 20000  # a short rehearsal at a smaller N
                                     # (printed as a CUT line)

Phases (one line each on stdout, the kernel table second to last):
  1. the card (nvidia-smi name, power limit) and the kernel build;
  2. the insertion path, as the JAX package runs it at this size, its
     kernel launch counts reset before and read after:
     HnswIndex(HnswConfig(M=30, ef_construction=128)) with strategy "auto"
     (insertion rounds from 200k points) -> check_integrity -> exact ground
     truth -> vanilla HNSW sweep (pop 4) at ef 32..320 -> Slim conversion
     + dense level-0 rows -> seeded Slim sweep (seed_width 32, pop 8);
     build seconds split into the device spans of the batches' searches
     (level-0-only and upper-level inserts) and applies and the rest
     (host), and the reverse-connect overflow counters;
  3. the NN-descent path (strategy "nnd") -> conversion -> seeded sweep,
     with its own launch counts;
  4. each kernel against its plain PyTorch version on the card: Kε, Kβ in
     build mode, Kγ and Kζ on one 4096-insert batch recorded during the
     insertion build (its pre-batch graph and inputs), Kα and Kβ on the
     serving paths, Kγ on the NND build's and conversion's prunes, Kδ on an
     NND chunk; both times, agreement, and the least time the card could
     take (bytes over 3.35 TB/s or fp32 flops over 67 TFLOP/s, the larger);
  5. output checks (finite, in range, true distances, recall sanity, the
     insertion-built Slim index above the NND-built one at ef=320).
Any failed check exits non-zero before the last line, which is
{"ok": true, "device": {...}}. Without a CUDA card it exits 2 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

ROUTES = {  # kernel: (source, the JAX program it replaces)
    "topk_dist": ("hnsw_slim_tpu_torch/csrc/topk_dist.cu",
                  "hnsw_slim_tpu/index/bruteforce.py:85"),
    "beam_search": ("hnsw_slim_tpu_torch/csrc/beam_search.cu",
                    "hnsw_slim_tpu/graph/search.py:297"),
    "rng_prune": ("hnsw_slim_tpu_torch/csrc/rng_prune.cu",
                  "hnsw_slim_tpu/graph/heuristic.py:242"),
    "cand_merge": ("hnsw_slim_tpu_torch/csrc/cand_merge.cu",
                   "hnsw_slim_tpu/graph/nnd.py:45"),
    "greedy_descent": ("hnsw_slim_tpu_torch/csrc/greedy_descent.cu",
                       "hnsw_slim_tpu/graph/search.py:101"),
    "rev_connect": ("hnsw_slim_tpu_torch/csrc/rev_connect.cu",
                    "hnsw_slim_tpu/graph/revconn.py:47"),
}
INSERT_PATH = ("topk_dist", "beam_search", "rng_prune", "greedy_descent",
               "rev_connect")
NND_PATH = ("topk_dist", "beam_search", "rng_prune", "cand_merge")
EFS = (32, 64, 128, 256, 320)
NQ = 4096
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, flop/s


def say(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up
    call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over the memory rate and
    fp32 operations over the card's fp32 rate."""
    tb, to = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def recall(ids, gt) -> float:
    import numpy as np

    k = gt.shape[1]
    hits = sum(len(set(a[:k].tolist()) & set(b.tolist()))
               for a, b in zip(np.asarray(ids), gt))
    return hits / gt.size


def tie_ok(ids_a, ids_b, d_ref, k: int) -> float:
    """Fraction of rows whose top-k id sets agree, counting as agreeing a row
    whose k-th and (k+1)-th reference distances lie within 1e-5 relative
    (d_ref holds k+1 sorted columns)."""
    import numpy as np

    same = np.array([set(a.tolist()) == set(b.tolist())
                     for a, b in zip(ids_a[:, :k], ids_b[:, :k])])
    gap = np.abs(d_ref[:, k] - d_ref[:, k - 1])
    near = gap <= 1e-5 * np.maximum(1.0, np.abs(d_ref[:, k - 1]))
    return float((same | near).mean())


def full_batches(n: int, max_batch: int = 4096) -> int:
    """How many insert batches of max_batch points the build makes."""
    done, k = 1, 0
    while done < n:
        b = min(max(1, min(done, max_batch)), n - done)
        k += b == max_batch
        done += b
    return k


class BatchRecorder:
    """Records one 4096-insert batch of the insertion build: wraps
    HnswBuilder's level-0 search (_build_search0) and revconn.apply_insert,
    and on the `which`-th batch of 4096 clones the pre-batch graph, the
    search inputs and the level-0 apply inputs. The wrapped calls run
    unchanged."""

    def __init__(self, which: int, cap0: int):
        self.which, self.cap0 = which, cap0
        self.n_search = self.n_apply = 0
        self.rec: dict = {}

    @contextlib.contextmanager
    def installed(self):
        from hnsw_slim_tpu_torch.graph import build as tb
        from hnsw_slim_tpu_torch.graph import revconn

        s0, ap = tb._build_search0, revconn.apply_insert

        def s0_w(adjs, entry, vectors, vn, q, active, **kw):
            if q.shape[0] == 4096:
                self.n_search += 1
                if self.n_search == self.which:
                    self.rec.update(adjs=[a.clone() for a in adjs],
                                    entry=entry, q=q.clone(),
                                    active=active.clone(), s0_kw=kw)
            return s0(adjs, entry, vectors, vn, q, active, **kw)

        def ap_w(adj, deg, vecs, vn, a_ids, cand, **kw):
            if adj.shape[1] == self.cap0 and a_ids.shape[0] == 4096:
                self.n_apply += 1
                if self.n_apply == self.which:
                    self.rec.update(adj0=adj.clone(), deg0=deg.clone(),
                                    a_ids=a_ids.clone(), cand=cand.clone(),
                                    ap_kw=kw)
            return ap(adj, deg, vecs, vn, a_ids, cand, **kw)

        tb._build_search0, revconn.apply_insert = s0_w, ap_w
        try:
            yield self
        finally:
            tb._build_search0, revconn.apply_insert = s0, ap


def serve_sweep(idx, queries, gt, base, make_cfg, label: str) -> list:
    """search() at each ef of EFS: recall@10, QPS (best of 3 after a warm
    call, host clock, device synchronised), hops, distance computations;
    checks shapes, ranges and true distances."""
    import numpy as np
    import torch

    n = len(base)
    rows = []
    for ef in EFS:
        idx.scfg = make_cfg(ef)
        d, ids = idx.search(queries, k=10)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx.search(queries, k=10)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        row = {"ef": ef, "recall@10": round(recall(ids, gt), 4),
               "qps": round(len(queries) / min(times), 1),
               "hops": idx.last_stats["hops"],
               "dcomp": idx.last_stats["distance_computations"]}
        rows.append(row)
        say(f"{label} {json.dumps(row)}")
        check(d.shape == (len(queries), 10) and np.isfinite(d).all(),
              f"{label} ef={ef}: non-finite or misshapen distances")
        check(((ids >= 0) & (ids < n)).all(), f"{label} ef={ef}: id range")
        true_d = ((queries[:, None, :] - base[ids]) ** 2).sum(-1)
        check(np.allclose(d, true_d, rtol=1e-3, atol=1e-3),
              f"{label} ef={ef}: returned distances are not the true ones")
    rec = [r["recall@10"] for r in rows]
    check(rec[-1] >= 0.5 and rec[-1] >= rec[0] - 0.01,
          f"{label}: recall sweep implausible: {rec}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hnsw_slim_tpu_torch.config import HnswConfig, SearchConfig, SlimConfig
    from hnsw_slim_tpu_torch.graph import build as tb
    from hnsw_slim_tpu_torch.graph import heuristic, nnd, prune, revconn
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index.hnsw import (HnswIndex,
                                                resolve_build_strategy)
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.utils.data import clustered

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
            "nvidia-smi: no output")
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built, usage = cuda.build()
    cuda.lib()
    say(f"kernel build: {built:.1f} s of parallel nvcc + link "
        f"({time.perf_counter() - t0:.1f} s with load)")
    for line in usage.splitlines():
        if line.startswith("Compiling"):
            fn = line.split("'")[1] if "'" in line else line
            kernel = next((k for k in ("topk_scan", "topk_merge",
                                       "beam_kernel", "prune_kernel",
                                       "merge_kernel", "greedy_kernel",
                                       "append_kernel", "degree_kernel",
                                       "rows_kernel", "write_kernel")
                           if k in fn), "?")
        elif line.startswith("Used"):
            say(f"  ptxas {kernel}: {line}")

    n = args.n
    base, queries = clustered(n, 128, n_queries=NQ,
                              n_clusters=max(64, n // 1000), seed=7,
                              scale=0.3)
    if n != 1_000_000:
        say(f"CUT: N={n} (the slice's size is 1,000,000)")
    hcfg = HnswConfig(M=30, ef_construction=128)
    def scfg_slim(ef):
        return SearchConfig(ef=ef, pop_width=8, scan_width=0, seed_width=32)
    t0 = time.perf_counter()
    gt_d, gt = bf.BruteForceIndex(base, device=dev).search(queries, k=10)
    say(f"ground truth: {time.perf_counter() - t0:.3f} s for {NQ} x {n}")
    check(np.all(np.diff(gt_d, axis=1) >= 0), "ground truth not sorted")

    # ---- 2. the insertion path -------------------------------------------
    strategy = "auto" if resolve_build_strategy("auto", n) == "insert" \
        else "insert"
    if strategy != "auto":
        say(f"CUT: strategy='insert' forced (auto picks NN-descent at N={n})")
    recorder = BatchRecorder(max(1, full_batches(n) // 2), hcfg.maxM0)
    cuda.reset_launches()
    with recorder.installed():
        t0 = time.perf_counter()
        h = HnswIndex(hcfg, device=dev, strategy=strategy)
        h.build(base)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    ph, ov = h.build_stats["phase_s"], h.build_stats["overflow"]
    say(f"insert build: {t_build:.2f} s, max_level {h.graph.max_level}, "
        f"split (s) {json.dumps({k: round(v, 3) for k, v in ph.items()})}, "
        f"overflow {json.dumps(ov)}")
    check(ov["truncated_applies"] == 0, f"reverse-connect truncated: {ov}")
    t0 = time.perf_counter()
    integ_h = h.check_integrity()
    say(f"insert graph integrity: {integ_h} ({time.perf_counter() - t0:.2f} "
        "s, the host mirror's pull included)")
    vanilla = serve_sweep(h, queries, gt, base,
                          lambda ef: SearchConfig(ef=ef, pop_width=4),
                          "vanilla")
    t0 = time.perf_counter()
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    dense_bytes = idx.densify_level0()
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    integ_s = idx.check_integrity()
    say(f"insert slim: conversion+densify {t_conv:.2f} s, index_size "
        f"{idx.index_size()} B, dense0 {dense_bytes} B, integrity {integ_s}")
    slim_ins = serve_sweep(idx, queries, gt, base, scfg_slim, "slim(insert)")
    launch_ins = dict(cuda.launches)
    say(f"insertion-path launches: {launch_ins}")
    for name in INSERT_PATH:
        check(launch_ins[name] > 0, f"{name} never launched on the "
                                    "insertion path")
    check(bool(recorder.rec.get("adj0") is not None
               and recorder.rec.get("q") is not None),
          "no 4096-insert batch was recorded")

    # ---- 3. the NN-descent path -------------------------------------------
    cuda.reset_launches()
    t0 = time.perf_counter()
    h2 = HnswIndex(hcfg, strategy="nnd", device=dev)
    h2.build(base)
    torch.cuda.synchronize()
    t_build2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx2 = HnswSlimIndex.from_hnsw(h2, SlimConfig.from_ratios())
    dense2 = idx2.densify_level0()
    torch.cuda.synchronize()
    t_conv2 = time.perf_counter() - t0
    integ2 = idx2.check_integrity()
    say(f"nnd: build {t_build2:.2f} s, conversion+densify {t_conv2:.2f} s, "
        f"index_size {idx2.index_size()} B, dense0 {dense2} B, integrity "
        f"{integ2}, max_level {idx2.graph.max_level}")
    slim_nnd = serve_sweep(idx2, queries, gt, base, scfg_slim, "slim(nnd)")
    launch_nnd = dict(cuda.launches)
    say(f"nnd-path launches: {launch_nnd}")
    for name in NND_PATH:
        check(launch_nnd[name] > 0, f"{name} never launched on the NND path")
    say(f"recall@10 at ef={EFS[-1]}: insertion-built Slim "
        f"{slim_ins[-1]['recall@10']}, NND-built Slim "
        f"{slim_nnd[-1]['recall@10']}")
    if n == 1_000_000:  # smaller sets saturate both near 1.0
        check(slim_ins[-1]["recall@10"] > slim_nnd[-1]["recall@10"],
              "the insertion-built Slim index does not beat the NND-built "
              f"one at ef={EFS[-1]}")

    # ---- 4. each kernel against its plain version -------------------------
    report = {}
    x, xn = h.vectors, h.vn
    d = x.shape[1]
    r = recorder.rec
    q4, adjs, entry = r["q"], r["adjs"], r["entry"]
    qn4 = (q4 * q4).sum(1)
    act = r["active"]
    efc = hcfg.ef_construction

    # Kε: the recorded batch's descent, levels max_level..1, its own active
    # rows (the level-0-only inserts), each level from the plain state
    top = len(adjs) - 1
    pc, pd = gs.entry_dist(x, xn, q4, qn4, entry)
    eq, tot, err, k_ms, p_ms, e_bytes, e_flops = 0, 0, 0.0, 0.0, 0.0, 0, 0
    for l in range(top, 0, -1):
        st = (x, q4, qn4, adjs[l], pc, pd, act)
        kc, kd, kh, kdc = gs.greedy_descent(*st)
        k_ms += cuda_ms(lambda: gs.greedy_descent(*st))
        p_ms += cuda_ms(lambda: gs.greedy_descent_plain(*st), 1)
        npc, npd, _, _ = gs.greedy_descent_plain(*st)
        same = kc == npc
        eq, tot = eq + int(same.sum()), tot + len(same)
        if same.any():
            err = max(err, float((kd - npd)[same].abs().max()))
        e_bytes += (int(kh.sum()) * adjs[l].shape[1] * 4
                    + int(kdc.sum()) * d * 4 + q4.numel() * 4 + len(q4) * 16)
        e_flops += int(kdc.sum()) * 4 * d
        pc, pd = npc, npd
    report["greedy_descent"] = dict(
        agree=eq / max(1, tot), max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound=bound(e_bytes, e_flops),
        shapes=f"{len(q4)} queries of one insert batch, levels {top}..1, "
               f"{int(act.sum())} active")
    check(eq / max(1, tot) >= 0.99,
          f"greedy_descent disagrees: {report['greedy_descent']}")

    # Kβ in build mode: _build_search0's level-0 beam from the greedy seeds
    # (S=1, P=efc, E=8), on the recorded pre-batch graph
    pop = tb.INSERT_POP_WIDTH
    kw0 = dict(P=efc, ef_eff=efc, pop_width=pop,
               cw=gs.cand_width(efc, pop, adjs[0].shape[1], 0),
               max_iters=2 * efc + 64, k=efc)
    b_args = (x, q4, qn4, adjs[0],
              torch.where(act, pd, float("inf"))[:, None].contiguous(),
              torch.where(act, pc, -1)[:, None].contiguous())
    bd, bi, bh, bc = gs.beam_search(*b_args, **kw0)
    pbd, pbi, _, pbc = gs.beam_search_plain(*b_args, **kw0)
    same = bi == pbi
    slots = float(same[act].float().mean())
    b_bytes = (int(bh.sum()) * adjs[0].shape[1] * 4 + int(bc.sum()) * d * 4
               + q4.numel() * 4 + len(q4) * (8 + efc * 8))
    report["beam_search"] = dict(
        agree=slots, max_abs_err=float(
            (bd - pbd)[same & act[:, None] & torch.isfinite(pbd)].abs().max()),
        ms=cuda_ms(lambda: gs.beam_search(*b_args, **kw0)),
        plain_ms=cuda_ms(lambda: gs.beam_search_plain(*b_args, **kw0), 1),
        bound=bound(b_bytes, int(bc.sum()) * 4 * d),
        shapes=f"build mode: {int(act.sum())} of {len(q4)} queries, efc "
               f"{efc}, E=8, cw {kw0['cw']}; dcomp {int(bc.sum())} vs "
               f"{int(pbc.sum())}")
    check(slots >= 0.99, f"beam_search (build) disagrees: "
                         f"{report['beam_search']}")
    # Kβ from a carried buffer, E=1, one level up: the level-2 beam's buffer
    # (or a fresh seed when the graph has one upper level) seeds level 1
    lv = min(2, top)
    cc, cd = gs.entry_dist(x, xn, q4, qn4, entry)
    for l in range(top, lv, -1):
        cc, cd, _, _ = gs.greedy_descent(x, q4, qn4, adjs[l], cc, cd)
    buf_d, buf_id = gs.beam_init(cc, cd, efc)
    if lv == 2:
        buf_d, buf_id, _, _ = gs.beam_level(
            x, q4, qn4, adjs[2], buf_d, buf_id,
            torch.ones(len(q4), dtype=torch.bool, device=dev),
            max_iters=2 * efc + 64)
    kw1 = dict(P=efc, ef_eff=efc, pop_width=1, cw=adjs[1].shape[1],
               max_iters=2 * efc + 64, k=efc)
    c_args = (x, q4, qn4, adjs[1], buf_d.contiguous(), buf_id.contiguous())
    cdk, cik, _, _ = gs.beam_search(*c_args, **kw1)
    cdp, cip, _, _ = gs.beam_search_plain(*c_args, **kw1)
    c_slots = float((cik == cip).float().mean())
    c_ms = cuda_ms(lambda: gs.beam_search(*c_args, **kw1))
    c_pms = cuda_ms(lambda: gs.beam_search_plain(*c_args, **kw1), 1)
    report["beam_search"]["shapes"] += (
        f"; carried buffer at level 1 (E=1, S=P={efc}, {len(q4)} queries): "
        f"slots {c_slots:.5f}, {c_ms:.3f} ms vs plain {c_pms:.3f} ms")
    check(c_slots >= 0.99, f"beam_search (carried buffer) disagrees: "
                           f"{c_slots}")

    # Kγ and Kζ: the recorded batch's level-0 apply, on copies of its
    # pre-apply adjacency and degrees
    kw = r["ap_kw"]
    a_ids, cand, adj0, deg0 = r["a_ids"], r["cand"], r["adj0"], r["deg0"]
    cap0, M = adj0.shape[1], kw["M"]
    b4 = len(a_ids)
    m_fwd = torch.full((b4,), M, dtype=torch.int32, device=dev)
    fwd = dict(keep_all_under_m=True, keep_pruned=False, out_width=M)
    kg_parts = []

    def kg_part(what, x, xn, b_ids, cnd, m_row, kw_g):
        """Kγ and its plain version on one prune call's real rows: report
        and check agreement and times; returns the kernel's (sel, cnt)."""
        ks, kc = heuristic.rng_prune(x, xn, b_ids, cnd, m_row, **kw_g)
        ps_, pc_ = heuristic.rng_prune_plain(x, xn, b_ids, cnd, m_row, **kw_g)
        valid = int((cnd >= 0).sum())
        part = dict(
            what=what, rows=len(b_ids), C=cnd.shape[1],
            rows_agree=float((ks == ps_).all(dim=1).float().mean()),
            counts_agree=float((kc == pc_).float().mean()),
            max_abs_err=float((kc - pc_).abs().max()),
            ms=cuda_ms(lambda: heuristic.rng_prune(x, xn, b_ids, cnd, m_row,
                                                   **kw_g)),
            plain_ms=cuda_ms(lambda: heuristic.rng_prune_plain(
                x, xn, b_ids, cnd, m_row, **kw_g), 1),
            bound=bound(cnd.numel() * 4 + valid * (d + 1) * 4
                        + len(b_ids) * (d + 2 + kw_g["out_width"]) * 4,
                        valid * 2 * d), **kw_g)
        kg_parts.append(part)
        say(f"kernel rng_prune part: {json.dumps(part)}")
        if len(b_ids) >= 1000:
            check(part["rows_agree"] >= 0.99 and part["counts_agree"] >= 0.99,
                  f"rng_prune disagrees with its plain version: {part}")
        return ks, kc

    sel, cnt = kg_part("insert forward prune, m=M", x, xn, a_ids, cand,
                       m_fwd, fwd)

    def forward(adj, deg):
        adj[a_ids.long()] = torch.nn.functional.pad(sel, (0, cap0 - M),
                                                    value=-1)
        deg[a_ids.long()] = cnt

    us, ps = revconn.reverse_edges(a_ids, sel)
    pre_a, pre_d = adj0.clone(), deg0.clone()
    forward(pre_a, pre_d)
    ak, dk = pre_a.clone(), pre_d.clone()
    pa, pdg = pre_a.clone(), pre_d.clone()
    ovf_k = revconn.rev_append(ak, dk, us, ps)
    ovf_p = revconn.rev_append_plain(pa, pdg, us, ps)
    z_eq = [bool(torch.equal(ovf_k, ovf_p)), bool(torch.equal(ak, pa)),
            bool(torch.equal(dk, pdg))]
    of_u, of_p, ut, of_e, of_tc = revconn.overflow_targets(us, ps, ovf_k,
                                                           kw["of_t"])
    bk, ck = revconn.overflow_rows(ak, of_u, of_p, ut, kw["new_w"])
    bp, cp = revconn.overflow_rows_plain(pa, of_u, of_p, ut, kw["new_w"])
    z_eq += [bool(torch.equal(bk, bp)), bool(torch.equal(ck, cp))]
    n_t = int(of_tc)
    m_of = torch.full((len(ut),), cap0, dtype=torch.int32, device=dev)
    ofw = dict(keep_all_under_m=False, keep_pruned=False, out_width=cap0)
    osel, ocnt = kg_part(f"insert overflow re-prune ({n_t} targets of "
                         f"{len(ut)} rows), m=cap", x, xn, bk, ck, m_of, ofw)
    revconn.write_rows(ak, dk, ut, osel, ocnt)
    revconn.write_rows_plain(pa, pdg, ut, osel, ocnt)
    z_eq += [bool(torch.equal(ak, pa)), bool(torch.equal(dk, pdg))]
    fa, fd = adj0.clone(), deg0.clone()
    revconn.apply_insert(fa, fd, x, xn, a_ids, cand, **kw)
    z_eq += [bool(torch.equal(fa, ak)), bool(torch.equal(fd, dk))]

    def zeta_ms(kernel: bool, reps: int = 5) -> float:
        """Kζ's three calls on fresh copies of the post-forward state: the
        summed time of the calls alone (CUDA events around each)."""
        app = revconn.rev_append if kernel else revconn.rev_append_plain
        rows = revconn.overflow_rows if kernel else \
            revconn.overflow_rows_plain
        wr = revconn.write_rows if kernel else revconn.write_rows_plain
        tot_ms = 0.0
        for rep in range(reps + 1):
            a, g = pre_a.clone(), pre_d.clone()
            evs = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            evs[0].record()
            o = app(a, g, us, ps)
            evs[1].record()
            fu, fp, tt, _, _ = revconn.overflow_targets(us, ps, o, kw["of_t"])
            evs[2].record()
            rows(a, fu, fp, tt, kw["new_w"])
            evs[3].record()
            evs[4].record()
            wr(a, g, tt, osel, ocnt)
            evs[5].record()
            torch.cuda.synchronize()
            if rep:  # the first pass warms up
                tot_ms += sum(evs[i].elapsed_time(evs[i + 1])
                              for i in (0, 2, 4))
        return tot_ms / reps

    # the least bytes Kζ's function moves, each once: per edge us and ps
    # read and its overflow flag written; per target run deg read and
    # written; per appended edge one adj word; per valid overflow target
    # (padding rows need no memory) its id, its row and the new edges it
    # takes read, its candidate row and base id written, the pruned row and
    # count read, and its row and degree written
    e = len(us)
    valid_e = us < 2**30
    appended = int((~ovf_k & valid_e).sum())
    runs = int(torch.unique(us[valid_e]).numel())
    valid_t = min(n_t, len(ut))
    new_w = kw["new_w"]
    vt = ut[:valid_t]
    taken = int((torch.searchsorted(of_u, vt, right=True)
                 - torch.searchsorted(of_u, vt)).clamp(max=new_w).sum())
    z_bytes = (e * 9 + runs * 8 + appended * 4
               + valid_t * (4 + cap0 * 4 + (cap0 + new_w) * 4 + 4)
               + taken * 4 + valid_t * (cap0 * 8 + 8))
    report["rev_connect"] = dict(
        agree=float(all(z_eq)), max_abs_err=0.0 if all(z_eq) else 1.0,
        ms=zeta_ms(True), plain_ms=zeta_ms(False), bound=bound(z_bytes, 0),
        shapes=f"one level-0 apply of {b4} inserts: {e} reverse edges, "
               f"{appended} appended, {int(of_e)} overflowing into {n_t} "
               f"targets; equal {z_eq}")
    check(all(z_eq), f"rev_connect differs from its plain version: {z_eq}")

    # Kα: ground truth (512 queries over all N) and the seed block (k=32) of
    # the insertion-built Slim index
    up_vecs, up_vn, up_ids = idx._seed_table()
    qall = torch.as_tensor(queries, device=dev)
    q512 = qall[:512].contiguous()
    kd, ki = bf.topk_dist(q512, x, xn, 10)
    pd_, pi = bf.topk_dist_plain(q512, x, xn, 11)
    agree_gt = tie_ok(ki.cpu().numpy(), pi.cpu().numpy(), pd_.cpu().numpy(),
                      10)
    err_gt = float((kd - pd_[:, :10]).abs().max())
    sd, si = bf.topk_dist(qall, up_vecs, up_vn, 32, row_ids=up_ids)
    psd, psi = bf.topk_dist_plain(qall, up_vecs, up_vn, 33, row_ids=up_ids)
    agree_seed = tie_ok(si.cpu().numpy(), psi.cpu().numpy(),
                        psd.cpu().numpy(), 32)
    err_seed = float((sd - psd[:, :32]).abs().max())
    seed_ms = cuda_ms(lambda: bf.topk_dist(qall, up_vecs, up_vn, 32,
                                           row_ids=up_ids))
    report["topk_dist"] = dict(
        agree=min(agree_gt, agree_seed), max_abs_err=max(err_gt, err_seed),
        ms=cuda_ms(lambda: bf.topk_dist(q512, x, xn, 10)),
        plain_ms=cuda_ms(lambda: bf.topk_dist_plain(q512, x, xn, 10), 1),
        bound=bound(x.numel() * 4 + n * 4 + q512.numel() * 4 + 512 * 80,
                    2 * 512 * n * d),
        shapes=f"GT 512x{n} k=10 (agree {agree_gt:.4f}); seeds {NQ}x"
               f"{up_vecs.shape[0]} k=32 (agree {agree_seed:.4f}, kernel "
               f"{seed_ms:.3f} ms)")
    check(min(agree_gt, agree_seed) >= 0.99 and
          max(err_gt, err_seed) <= 1e-4 * (1 + float(pd_.abs().max())),
          f"topk_dist disagrees with its plain version: {report['topk_dist']}")

    # Kβ serving: 512 queries, ef=64, pop 8, seeds as chal_search makes them;
    # and where a Slim search() call's time goes per ef
    def seeds(qt):
        s_d, s_pos = bf.topk_dist(qt, up_vecs, up_vn, 32, row_ids=up_ids)
        s_id = torch.where(s_pos >= 0, up_ids[s_pos.clamp(min=0).long()], -1)
        s_id = torch.where(torch.isinf(s_d), -1, s_id)
        return s_d, s_id.to(torch.int32).contiguous()

    def beam_kw(ef):
        P = gs.bitonic_buffer_width(ef) if ef >= 256 and \
            not gs._is_bitonic_width(ef) else ef
        return dict(P=P, ef_eff=ef, pop_width=8,
                    cw=gs.cand_width(P, 8, idx.dense0.shape[1], 0),
                    max_iters=SearchConfig(ef=ef, pop_width=8).iters(), k=10)

    s_all = seeds(qall)
    qn_all = (qall * qall).sum(-1)
    for row in slim_ins:
        beam_ms = cuda_ms(lambda: gs.beam_search(
            x, qall, qn_all, idx.dense0, *s_all, **beam_kw(row["ef"])))
        say(f"time split slim(insert) ef={row['ef']}: seeds {seed_ms:.3f} ms,"
            f" beam {beam_ms:.3f} ms, search() {1e3 * NQ / row['qps']:.3f} ms"
            f" for {NQ} queries")
    # where a vanilla search() call's time goes: the greedy descent (Kε,
    # levels max..1) and the level-0 beam (Kβ, pop 4) on the card
    g = h.graph

    def descend():
        cur, dist = gs.entry_dist(x, xn, qall, qn_all, g.entry)
        for l in range(g.max_level, 0, -1):
            cur, dist, _, _ = gs.greedy_descent(x, qall, qn_all, g.adjs[l],
                                                cur, dist)
        return cur[:, None].contiguous(), dist[:, None].contiguous()

    greedy_ms = cuda_ms(descend)
    v_cur, v_dist = descend()
    for row in vanilla:
        ef = row["ef"]
        beam_ms = cuda_ms(lambda: gs.beam_search(
            x, qall, qn_all, g.adjs[0], v_dist, v_cur, P=ef, ef_eff=ef,
            pop_width=4, cw=gs.cand_width(ef, 4, g.adjs[0].shape[1], 0),
            max_iters=SearchConfig(ef=ef, pop_width=4).iters(), k=10))
        say(f"time split vanilla ef={ef}: greedy {greedy_ms:.3f} ms, beam "
            f"{beam_ms:.3f} ms, search() {1e3 * NQ / row['qps']:.3f} ms for "
            f"{NQ} queries")
    kw_s = beam_kw(64)
    args_s = (x, q512, qn_all[:512], idx.dense0, *seeds(q512))
    sbd, sbi, _, sbc = gs.beam_search(*args_s, **kw_s)
    _, spi, _, spc = gs.beam_search_plain(*args_s, **kw_s)
    s_slots = float((sbi == spi).float().mean())
    s_ms = cuda_ms(lambda: gs.beam_search(*args_s, **kw_s))
    s_pms = cuda_ms(lambda: gs.beam_search_plain(*args_s, **kw_s), 1)
    report["beam_search"]["shapes"] += (
        f"; serving 512 q ef=64 pop 8 on the insertion Slim graph: slots "
        f"{s_slots:.5f}, {s_ms:.3f} ms vs plain {s_pms:.3f} ms, dcomp "
        f"{int(sbc.sum())} vs {int(spc.sum())}")
    check(s_slots >= 0.99, f"beam_search (serving) disagrees: {s_slots}")

    # Kγ on the NND build's and the conversion's prunes, 4096 real rows each
    x2, xn2 = h2.vectors, h2.vn
    cfg = SlimConfig.from_ratios()
    sel_rows = np.random.default_rng(0).choice(n, min(4096, n),
                                               replace=False)
    pick = torch.as_tensor(sel_rows, device=dev)
    b_sel = pick.to(torch.int32)
    knn, _ = nnd.nn_descent(x2, xn2, k=max(hcfg.maxM0, 48), rounds=25,
                            metric=hcfg.metric, seed=hcfg.seed)
    cand0 = torch.as_tensor(tb.level0_candidates(knn.cpu().numpy(), 16,
                                                 hcfg.seed), device=dev)
    all_ids = torch.arange(n, dtype=torch.int32, device=dev)
    sel0 = heuristic.prune_all(
        x2, xn2, all_ids, cand0,
        torch.full((n,), hcfg.M, dtype=torch.int32, device=dev),
        M=hcfg.M, keep_all_under_m=True, keep_pruned=True)
    u_rows, u_m = tb.level0_union(x2, xn2, sel0, hcfg.maxM0, hcfg.metric)
    adj_np = [a.cpu().numpy() for a in h2.graph.adjs]
    thr = prune.degree_thresholds(adj_np, h2.levels, adj_np[0].shape[1], cfg)
    deg_0 = (adj_np[0] >= 0).sum(1)
    budget = torch.as_tensor(np.where(deg_0 > thr[0], cfg.top_M0, cfg.low_m0)
                             .astype(np.int32), device=dev)
    pruned = heuristic.prune_all(x2, xn2, all_ids, h2.graph.adjs[0], budget,
                                 M=cfg.top_M0, keep_all_under_m=False,
                                 out_width=cfg.top_M0)
    p_np = pruned.cpu().numpy()
    s_ids = np.repeat(np.arange(n), cfg.top_M0)[p_np.ravel() >= 0]
    t_ids = p_np.ravel()[p_np.ravel() >= 0].astype(np.int64)
    key = np.unique(np.concatenate([(s_ids << 31) | t_ids,
                                    (t_ids << 31) | s_ids]))
    rows_u, counts = prune._group_rows(
        key >> 31, (key & ((1 << 31) - 1)).astype(np.int32),
        np.arange(n), n)
    over = np.argsort(-counts)[: min(32, int((counts > 60).sum()))]
    kg_in = [  # (what, base ids, candidates, budgets, flags)
        ("nnd knn_to_level0 prune", b_sel, cand0[pick].contiguous(),
         torch.full((len(sel_rows),), hcfg.M, dtype=torch.int32, device=dev),
         dict(keep_all_under_m=True, keep_pruned=True, out_width=hcfg.M)),
        ("nnd union re-prune", b_sel, u_rows[pick].contiguous(),
         u_m[pick].contiguous(),
         dict(keep_all_under_m=True, keep_pruned=False,
              out_width=hcfg.maxM0)),
        ("nnd conversion stage 2", b_sel,
         h2.graph.adjs[0][pick].contiguous(), budget[pick].contiguous(),
         dict(keep_all_under_m=False, keep_pruned=False,
              out_width=cfg.top_M0)),
    ]
    if len(over):
        kg_in.append((
            "nnd conversion stage 4 hub rows",
            torch.as_tensor(over.astype(np.int32), device=dev),
            torch.as_tensor(rows_u[over], device=dev),
            torch.full((len(over),), 60, dtype=torch.int32, device=dev),
            dict(keep_all_under_m=False, keep_pruned=False, out_width=60)))
    for what, b_ids, cnd, m_row, kw_g in kg_in:
        kg_part(what, x2, xn2, b_ids, cnd, m_row, kw_g)
    first = kg_parts[0]
    tot_rows = sum(p["rows"] for p in kg_parts)
    report["rng_prune"] = dict(
        rows_agree=sum(p["rows_agree"] * p["rows"] for p in kg_parts)
        / tot_rows,
        counts_agree=sum(p["counts_agree"] * p["rows"] for p in kg_parts)
        / tot_rows,
        max_abs_err=max(p["max_abs_err"] for p in kg_parts),
        ms=first["ms"], plain_ms=first["plain_ms"], bound=first["bound"],
        shapes=f"{len(kg_parts)} parts; max_abs_err is the largest "
               "kept-count difference; ms, plain_ms and bound of the first "
               f"part; widest stage-4 row {int(counts.max())} ids")
    check(report["rng_prune"]["rows_agree"] >= 0.99
          and report["rng_prune"]["counts_agree"] >= 0.99,
          f"rng_prune disagrees with its plain version: {report['rng_prune']}")

    # Kδ: one NND chunk (8192 nodes) of a real round
    gen = torch.Generator(device=dev).manual_seed(0)
    st_i, st_d, st_f = nnd.rp_init(gen, x2, xn2, n, k=60, n_proj=4,
                                   metric="l2")
    cnd, st_f = nnd._nnd_candidates(st_i, st_f, n, s_fwd=60, r_rev=30,
                                    draws=nnd.nnd_draws(gen, n, 60, 60,
                                                        30, dev))
    c = min(8192, n)
    ch = (x2, xn2, st_i[:c].contiguous(), st_d[:c].contiguous(),
          st_f[:c].contiguous(), cnd[:c].contiguous())
    ki_, kd_, kf_, kins = nnd._chunked_cand_merge(*ch)
    pi_, pd2, pf_, pins = nnd.cand_merge_plain(*ch, chunk=c)
    rows_eq = (ki_ == pi_).all(dim=1)
    fin = torch.isfinite(pd2) & rows_eq[:, None]
    ins_diff = abs(int(kins) - int(pins)) / max(1, int(pins))
    valid_c = int((ch[5] >= 0).sum())
    report["cand_merge"] = dict(
        agree=float(rows_eq.float().mean()),
        max_abs_err=float((kd_ - pd2)[fin].abs().max()) if fin.any() else 0.0,
        ms=cuda_ms(lambda: nnd._chunked_cand_merge(*ch)),
        plain_ms=cuda_ms(lambda: nnd.cand_merge_plain(*ch, chunk=c), 1),
        bound=bound(valid_c * (d + 1) * 4 + ch[5].numel() * 4
                    + c * 60 * 12 * 2 + c * d * 4, valid_c * 2 * d),
        shapes=f"{c} rows K=60 C={cnd.shape[1]}; inserted {int(kins)} vs "
               f"{int(pins)}")
    check(report["cand_merge"]["agree"] >= 0.99 and ins_diff <= 0.01,
          f"cand_merge disagrees with its plain version: "
          f"{report['cand_merge']}")
    for name, rep in report.items():
        say(f"kernel {name}: {json.dumps(rep)}")

    # ---- 5. summary --------------------------------------------------------
    kernels = [{
        "name": name, "route": "cuda", "source": ROUTES[name][0],
        "replaces": ROUTES[name][1],
        "launches": launch_ins[name] + launch_nnd[name],
        "max_abs_err": report[name]["max_abs_err"],
        "ms": round(report[name]["ms"], 4),
        "plain_ms": round(report[name]["plain_ms"], 4),
        "bound_ms": round(report[name]["bound"][0], 4),
        "bound_by": report[name]["bound"][1],
        "library_ms": None,  # no single PyTorch call computes these
    } for name in ROUTES]
    say(json.dumps({
        "insert": {"n": n, "build_s": round(t_build, 2),
                   "build_split_s": {k: round(v, 3) for k, v in ph.items()},
                   "overflow": ov, "convert_s": round(t_conv, 2),
                   "index_size": idx.index_size(), "vanilla": vanilla,
                   "slim": slim_ins, "launches": launch_ins},
        "nnd": {"n": n, "build_s": round(t_build2, 2),
                "convert_s": round(t_conv2, 2),
                "index_size": idx2.index_size(), "slim": slim_nnd,
                "launches": launch_nnd},
        "nq": NQ, "wall_s": round(time.perf_counter() - t_start, 1)}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: CHECK FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
