#!/usr/bin/env python3
"""Kβ's and Kε's quantized modes of two or more copies of the port, on the
same SlimQ inputs, in one process on one card.

    python3 scripts/slimq_beam_ab.py --pkg parent=_archive/parent \\
        --pkg new=. [--order parent,new,new,parent] [--n 1000000] \\
        [--reps 10] [--seed 1] [--out slimq_beam_ab.json]

Each ``--pkg LABEL=DIR`` loads DIR/hnsw_slim_tpu_torch under a name of its
own, with its own kernel library built from DIR's sources
(scripts/beam_prune_ab.py load_pkg). The inputs are made once, with the
package of this checkout:

- the ``sift1m-slimq`` cell's index (``bench_torch/configs/sift1m-slimq.json``:
  its data from ``--seed`` by the benchmark's generator, ``HnswSlimQIndex.build``
  with its configuration, both dense layouts) and 4096 of its pool queries,
  seeded as the cell's search seeds them (1-bit Kα estimate over the seed
  table); cases: the cell's Kβ call (``quant_ex`` with the rerank track,
  ef 128, pop 8), the same without the track, and Kε on estimates over the
  upper levels (the entry point scored by the kernel);
- the SlimQ index of scripts/beam_prune_ab.py (manifold data, M 32) with
  its cases ``beam quant ef64`` and ``beam quant_ex ef64``: the shapes of
  PERF.md's kernel table (4096 queries, ef 64, no track).

Every case is timed for each package in the turns of ``--order``: CUDA
events around each call, recorded while the card sleeps
(``torch.cuda._sleep``), median of ``--reps`` calls after a warm-up, per
package the median over its turns. The outputs of every package must be
equal (ids, estimates, hops, dcomp, the track): the script fails otherwise.
A package copy instrumented by scripts/instrument_phases.py (``--design
current``) has its per-phase clock64 sums printed for each Kβ case, with
slot 10 the iterations the queries took. Each package's library is listed
by ``cuobjdump --dump-resource-usage`` for its Kβ and Kε kernels.

Prints the card (nvidia-smi name, power limit), one line per case, and one
JSON object as the last line; writes the same object to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "bench_torch"))
SLEEP_CYCLES = 2_000_000  # about 1 ms of the card's clock before each call
KERNELS = ("beam_kernel", "greedy_kernel")


def resource_usage(lib_path: str) -> list[str]:
    """``cuobjdump --dump-resource-usage`` of a library: each Kβ / Kε
    function's line and its resource line, then each one's count of local
    loads and stores (LDL, STL) in ``cuobjdump -sass``."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                       "cuobjdump")
    try:
        out = subprocess.run([exe, "--dump-resource-usage", lib_path],
                             capture_output=True, text=True,
                             timeout=120).stdout.splitlines()
        sass = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                              text=True, timeout=300).stdout.splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return [f"cuobjdump failed: {e}"]
    keep = []
    for a, b in zip(out, out[1:]):
        if "Function" in a and any(k in a for k in KERNELS):
            keep += [a.strip(), b.strip()]
    fn, counts = None, {}
    for line in sass:
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if any(k in fn for k in KERNELS) else None
            if fn:
                counts[fn] = [0, 0]
        elif fn:
            counts[fn][0] += " LDL" in line
            counts[fn][1] += " STL" in line
    keep += [f"{fn}: LDL {n[0]} STL {n[1]}" for fn, n in counts.items()]
    return keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pkg", action="append", required=True,
                    help="LABEL=DIR, DIR holding a hnsw_slim_tpu_torch copy")
    ap.add_argument("--order", default="",
                    help="turns, comma separated labels (default: each "
                         "label, then the labels reversed)")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--nq", type=int, default=4096, help="queries a call")
    ap.add_argument("--seed", type=int, default=1,
                    help="the cell's data seed")
    ap.add_argument("--cases", default="", help="comma separated case "
                    "name prefixes to run (default: all)")
    ap.add_argument("--no-manifold", action="store_true",
                    help="skip the manifold index and its cases")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal of "
                    "the control flow on the plain versions, host-clock "
                    "times, no kernel library")
    args = ap.parse_args()

    import numpy as np
    import torch

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("slimq_beam_ab: no CUDA device", file=sys.stderr)
        return 2
    from beam_prune_ab import flat, load_pkg
    from harness import data as hdata
    from hnsw_slim_tpu_torch.config import (HnswConfig, QuantConfig,
                                            SearchConfig, SlimConfig)
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu_torch.quant import rotator as qrot
    from hnsw_slim_tpu_torch.utils.data import manifold

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if on_card else "cpu rehearsal"
    print(card, flush=True)
    pkgs, usage = {}, {}
    for spec_ in args.pkg:
        label, root = spec_.split("=", 1)
        t0 = time.perf_counter()
        pkgs[label] = load_pkg(label, root, on_card)
        pkgs[label]["quant.estimator"] = importlib.import_module(
            f"hs_ab_{label}.quant.estimator")
        usage[label] = resource_usage(
            str(pkgs[label]["ops.cuda"]._lib_path())) if on_card else []
        print(f"package {label} ({root}): library ready in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in usage[label]:
            print(f"  {label} {line}", flush=True)
    labels = list(pkgs)
    order = args.order.split(",") if args.order else labels + labels[::-1]
    dev = torch.device(args.device)
    nq = args.nq

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- inputs (this checkout's package) --------------------------------
    t_in = time.perf_counter()
    with open(os.path.join(ROOT, "bench_torch", "configs",
                           "sift1m-slimq.json")) as fh:
        cfg = json.load(fh)
    cfg["n"] = args.n
    data = hdata.make(cfg, args.seed, dev)
    cell = HnswSlimQIndex.build(
        data.base, hnsw_cfg=HnswConfig(**cfg["hnsw"]),
        slim_cfg=SlimConfig.from_ratios(**cfg["slim"]),
        quant_cfg=QuantConfig(**cfg["quant"]), device=dev)
    cell.densify_level0()
    cell.densify_upper()
    scfg = SearchConfig(**cfg["search"])
    indexes = [("cell", cell, torch.as_tensor(data.queries(0, nq),
                                              device=dev), scfg)]
    if not args.no_manifold:
        mbase, mq = manifold(args.n, 128, latent_dim=24, n_queries=nq,
                             n_clusters=250, seed=5)
        sq = HnswSlimQIndex.build(
            mbase, hnsw_cfg=HnswConfig(M=32, ef_construction=128),
            slim_cfg=SlimConfig(top_M0=32, low_m0=8, top_M=16, low_m=4),
            quant_cfg=QuantConfig(total_bits=4), strategy="insert",
            device=dev)
        sq.densify_level0()
        sq.densify_upper()
        indexes.append(("manifold", sq, torch.as_tensor(mq, device=dev),
                        None))
    sync()
    print(f"inputs: {time.perf_counter() - t_in:.1f} s", flush=True)

    cases = []  # (name, kernel, call(pkg) -> outputs)

    def scorer_in(p, sc):
        """``sc`` as package p's QuantScorer (the same tensors)."""
        return p["quant.estimator"].QuantScorer(*sc)

    def beam_case(name, idx, sc, sd, si, track, **kw):
        def call(p):
            return p["graph.search"].beam_search(
                None, None, None, p["graph.search"].dense_fetch(idx.dense0),
                sd, si, scorer=scorer_in(p, sc), pop_track=track, **kw)
        cases.append((name, "beam_search", call))

    for tag, idx, q, sc_cfg in indexes:
        nb, exb = int(idx.codes.bin_code.shape[1]), int(idx.codes.ex_bits)
        q_rot = idx.rotator.rotate(q)
        sumq, g_add = qrot.g_tables(q_rot, idx.centroids_rot)
        sc1 = gs.QuantScorer(idx._packed_rows(), nb, exb, False, q_rot, sumq,
                             g_add)
        up_rows, up_ids = idx._seed_table()
        sd, pos = bf.topk_estimate(sc1._replace(rows=up_rows), up_ids, 32)
        si = torch.where(pos >= 0, up_ids[pos.clamp(min=0).long()], -1)
        si = torch.where(torch.isinf(sd), -1, si).to(torch.int32)
        sd, si = sd.contiguous(), si.contiguous()
        if tag == "cell":
            ef, pop = sc_cfg.ef, sc_cfg.pop_width
            P = gs.buffer_width(ef)
            kw = dict(P=P, ef_eff=ef, pop_width=pop,
                      cw=gs.cand_width(P, pop, idx.dense0.shape[1],
                                       sc_cfg.scan_width),
                      max_iters=sc_cfg.iters(), k=P)
            scx = sc1._replace(use_ex=True)
            # the rerank track of the cell's k = 10: max(k, 16) wide
            beam_case(f"cell quant_ex+rerank ef{ef}", idx, scx, sd, si,
                      gs.pop_track_init(idx._dataset_dev, q, 16), **kw)
            beam_case(f"cell quant_ex ef{ef}", idx, scx, sd, si, None, **kw)
            g = idx.graph
            levels = range(g.max_level, 0, -1)
            cur = torch.full((nq,), g.entry, dtype=torch.int32, device=dev)
            for use_ex in (False, True):
                sce = sc1._replace(use_ex=use_ex)

                def dcall(p, sce=sce, idx=idx, g=g):
                    m = p["graph.search"]
                    return m.greedy_descent_levels(
                        None, None, None,
                        [m.rank_fetch(idx.rank_up, idx.dense_up[lv - 1])
                         for lv in levels], g.max_level, cur, None,
                        scorer=scorer_in(p, sce))
                mode = "quant_ex" if use_ex else "quant"
                cases.append((f"cell descent {mode} levels {len(levels)}",
                              "greedy_descent", dcall))
        else:
            kw = dict(P=64, ef_eff=64, pop_width=8,
                      cw=gs.cand_width(64, 8, idx.graph.cap0, 0),
                      max_iters=SearchConfig(ef=64, pop_width=8).iters(),
                      k=64)
            beam_case("beam quant ef64", idx, sc1, sd, si, None, **kw)
            beam_case("beam quant_ex ef64", idx, sc1._replace(use_ex=True),
                      sd, si, None, **kw)

    # ---- the turns ----------------------------------------------------------
    want = [c for c in args.cases.split(",") if c]
    results = {}
    for name, kernel, call in cases:
        if want and not any(name.startswith(w) for w in want):
            continue
        outs, times, phases = {}, {lb: [] for lb in labels}, {}
        for lb in order:
            p = pkgs[lb]
            lib = p["ops.cuda"].lib() if on_card else None
            o = flat(call(p))  # the warm-up call
            sync()
            outs.setdefault(lb, o)
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
                   spread={lb: [min(t), max(t)] for lb, t in times.items()},
                   hops=int(ref[2].sum()), dcomp=int(ref[3].sum()),
                   queries=int(ref[2].shape[0]))
        if phases:
            row["phases"] = phases
        results[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
        del outs
    bad = [k for k, v in results.items() if not all(v["equal"].values())]
    summary = dict(card=card, n=args.n, seed=args.seed, reps=args.reps,
                   order=order,
                   packages=dict(s.split("=", 1) for s in args.pkg),
                   resource_usage=usage, cases=results, unequal=bad)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
