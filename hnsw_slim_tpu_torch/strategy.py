"""Benchmark strategies + CLI (port of hnsw_slim_tpu/strategy.py).

Port of the reference's include/strategy/* (SolveStrategy, brute_force,
hnsw, hnsw_slim, hnsw_slimzero and hnsw_slimq strategies) and its gflags
entry point main.cc: load fvecs base + queries, build or load the index
under a parameter-encoded filename, run all queries, print build / convert
/ solve costs and recall, save the knn results.

    python -m hnsw_slim_tpu_torch.strategy --dataset sift --data_dir DIR \\
        --solve_strategy bruteforce     # 100-NN ground truth (Kα, k = 100)
    python -m hnsw_slim_tpu_torch.strategy --dataset sift --data_dir DIR

The flags are the JAX CLI's, plus ``--device``: the indexes live on the
CUDA card unless it names another device (``--device cpu``). Costs are host
milliseconds after the card has finished the step's work.
``--profile_dir`` writes a torch.profiler Chrome trace of ``solve()``
(CPU and, on the card, CUDA activity) into that directory, with the
program's spans (``utils/trace.py``: ``cli.build``, ``cli.convert``,
``cli.load``, ``cli.search`` and the index's own) on the trace's clock.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .config import HnswConfig, QuantConfig, SlimConfig
from .eval.recall import recall_at_k
from .index.bruteforce import BruteForceIndex
from .index.hnsw import HnswIndex
from .index.slim import HnswSlimIndex
from .index.slimq import HnswSlimQIndex
from .index.slimzero import HnswSlimZeroIndex
from .ops.cuda import resolve_device
from .persist import checkpoint
from .utils import trace
from .utils.io import Timer, read_fvecs, read_ivecs, write_ivecs


class SolveStrategy:
    """Base: data loading + query loop + recall (solve_strategy.h)."""

    def __init__(self, args):
        self.args = args
        self.device = resolve_device(args.device or None)
        self.base = read_fvecs(args.source_path, max_num=args.max_base or None)
        self.queries = read_fvecs(args.query_path)
        self.k = args.k
        self.knn: np.ndarray | None = None

    def solve(self):
        raise NotImplementedError

    def ms(self, t: Timer) -> float:
        """Host milliseconds since ``t``, once the card is idle."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return t.ms()

    def recall(self) -> float:
        gt = read_ivecs(self.args.gt_path)
        r = recall_at_k(
            self.knn, gt, self.queries, self.base, self.k,
            metric=self.args.metric,
        )
        print(f"Recall: {r:.6f}")
        return r

    def save_knn(self):
        if self.args.knn_path:
            write_ivecs(self.args.knn_path, self.knn)


class BruteForceStrategy(SolveStrategy):
    """Exact top-100 ground-truth generator (brute_force_strategy.h): one
    Kα scan with k = 100 on the card."""

    BRUTE_K = 100

    def solve(self):
        t = Timer()
        with trace.span("cli.search"):
            bf = BruteForceIndex(self.base, metric=self.args.metric,
                                 device=self.device)
            _, ids = bf.search(self.queries,
                               k=min(self.BRUTE_K, len(self.base)))
        print(f"solve cost: {self.ms(t):.1f} ms")
        write_ivecs(self.args.gt_path, ids)
        self.knn = ids[:, : self.k]


class HnswStrategy(SolveStrategy):
    def solve(self):
        a = self.args
        idx_path = Path(a.index_path) if a.index_path else None
        t = Timer()
        if idx_path and idx_path.exists():
            with trace.span("cli.load"):
                self.index = checkpoint.load_hnsw(idx_path,
                                                  device=self.device)
            print(f"load cost: {self.ms(t):.1f} ms")
        else:
            with trace.span("cli.build"):
                self.index = HnswIndex(
                    _hnsw_cfg(a), max_batch=a.max_batch,
                    strategy=a.build_strategy, device=self.device,
                )
                self.index.build(self.base, verbose=a.verbose)
            print(f"build cost: {self.ms(t):.1f} ms")
            if idx_path:
                checkpoint.save_hnsw(idx_path, self.index)
        self.index.set_ef(a.ef_search)
        t = Timer()
        with trace.span("cli.search"):
            _, self.knn = self.index.search(self.queries, k=self.k)
        print(f"solve cost: {self.ms(t):.1f} ms")


class HnswSlimStrategy(SolveStrategy):
    """Build/load HNSW -> convert -> search (hnsw_slim_strategy.h)."""

    slim_cls = HnswSlimIndex

    def solve(self):
        a = self.args
        idx_path = Path(a.index_path) if a.index_path else None
        if idx_path and idx_path.exists():
            t = Timer()
            with trace.span("cli.load"):
                self.index = checkpoint.load_slim(idx_path,
                                                  device=self.device)
            print(f"load cost: {self.ms(t):.1f} ms")
        else:
            t = Timer()
            with trace.span("cli.build"):
                hnsw = HnswIndex(
                    _hnsw_cfg(a), max_batch=a.max_batch,
                    strategy=a.build_strategy, device=self.device,
                )
                hnsw.build(self.base, verbose=a.verbose)
            print(f"build cost: {self.ms(t):.1f} ms")
            t = Timer()
            with trace.span("cli.convert"):
                self.index = self.slim_cls.from_hnsw(hnsw, _slim_cfg(a))
            print(f"convert cost: {self.ms(t):.1f} ms")
            if idx_path:
                checkpoint.save_slim(idx_path, self.index)
        print(f"index size: {self.index.index_size()} bytes")
        self.index.set_ef(a.ef_search)
        t = Timer()
        with trace.span("cli.search"):
            _, self.knn = self.index.search(self.queries, k=self.k)
        print(f"solve cost: {self.ms(t):.1f} ms")


class HnswSlimZeroStrategy(HnswSlimStrategy):
    slim_cls = HnswSlimZeroIndex

    def solve(self):
        super().solve()
        est = HnswSlimZeroIndex.size_estimate(
            len(self.base), self.args.branching_factor, _slim_cfg(self.args)
        )
        print(f"estimation index size: {est:.0f} bytes")


class HnswSlimQStrategy(SolveStrategy):
    def solve(self):
        a = self.args
        t = Timer()
        with trace.span("cli.build"):
            self.index = HnswSlimQIndex.build(
                self.base, _hnsw_cfg(a), _slim_cfg(a),
                QuantConfig(total_bits=a.total_bits), device=self.device,
            )
        print(f"build cost: {self.ms(t):.1f} ms")
        print(f"index size: {self.index.index_size()} bytes")
        self.index.set_ef(a.ef_search)
        self.index.use_ex = a.use_ex  # searchBaseLayerST<use_ex> toggle
        t = Timer()
        with trace.span("cli.search"):
            _, self.knn = self.index.search(self.queries, k=self.k)
        print(f"solve cost: {self.ms(t):.1f} ms")


STRATEGIES = {
    "bruteforce": BruteForceStrategy,
    "hnsw": HnswStrategy,
    "hnsw_slim": HnswSlimStrategy,
    "hnsw_slimzero": HnswSlimZeroStrategy,
    "hnsw_slimq": HnswSlimQStrategy,
}


def _hnsw_cfg(a) -> HnswConfig:
    return HnswConfig(
        M=a.m, M0=a.m0, ef_construction=a.ef_construction,
        ef_search=a.ef_search, branching_factor=a.branching_factor,
        metric=a.metric,
    )


def _slim_cfg(a) -> SlimConfig:
    return SlimConfig.from_ratios(
        top_M0=a.top_M0, level_ratio=a.level_ratio, Mm_ratio=a.Mm_ratio,
        top_degree_percent0=a.top_degree_percent0,
        threshold_level=a.threshold_level,
        min_indegree0=a.min_indegree0, min_indegree=a.min_indegree,
    )


def build_parser() -> argparse.ArgumentParser:
    """Flags mirror main.cc, plus --device."""
    p = argparse.ArgumentParser("hnsw-slim-tpu benchmark CLI (PyTorch)")
    p.add_argument("--dataset", default="sift")
    p.add_argument("--data_dir", default="../data")
    p.add_argument("--solve_strategy", default="hnsw_slim",
                   choices=sorted(STRATEGIES))
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--m", type=int, default=30)
    p.add_argument("--m0", type=int, default=0)
    p.add_argument("--ef_construction", type=int, default=128)
    p.add_argument("--ef_search", type=int, default=128)
    p.add_argument("--branching_factor", default="32")
    p.add_argument("--threshold_level", type=int, default=0)
    p.add_argument("--top_degree_percent0", type=float, default=0.02)
    p.add_argument("--top_M0", type=int, default=32)
    p.add_argument("--level_ratio", type=int, default=50)
    p.add_argument("--Mm_ratio", type=int, default=25)
    p.add_argument("--min_indegree0", type=int, default=8)
    p.add_argument("--min_indegree", type=int, default=4)
    p.add_argument("--total_bits", type=int, default=4)
    p.add_argument("--use_ex", action="store_true",
                   help="SlimQ: traverse on ex-bit estimates "
                        "(hnswalg_slimq.h searchBaseLayerST<use_ex=true>)")
    p.add_argument("--metric", default="l2", choices=["l2", "ip"])
    # auto = NND below 200k points, insertion rounds at scale
    p.add_argument("--build_strategy", default="auto",
                   choices=["auto", "nnd", "insert"])
    p.add_argument("--max_batch", type=int, default=4096)
    p.add_argument("--max_base", type=int, default=0,
                   help="build from first N base vectors (main_partial.cc)")
    p.add_argument("--index_dir", default="")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler Chrome trace of solve() here")
    p.add_argument("--device", default="",
                   help="torch device of the indexes (default: the CUDA "
                        "card; 'cpu' to run on the CPU)")
    return p


def resolve_paths(a) -> None:
    """Dataset path scheme + parameter-encoded index filename (main.cc)."""
    d = Path(a.data_dir) / a.dataset
    a.source_path = str(d / f"{a.dataset}_base.fvecs")
    a.query_path = str(d / f"{a.dataset}_query.fvecs")
    a.gt_path = str(d / f"{a.dataset}_groundtruth.ivecs")
    a.knn_path = str(d / f"{a.dataset}_knn.ivecs")
    if a.index_dir:
        suffix = (
            f"{a.solve_strategy}_{a.ef_construction}_{a.m}_"
            f"{a.branching_factor}_{a.threshold_level}_"
            f"{a.top_degree_percent0}_{a.top_M0}.npz"
        )
        a.index_path = str(Path(a.index_dir) / a.dataset / suffix)
        Path(a.index_path).parent.mkdir(parents=True, exist_ok=True)
    else:
        a.index_path = ""


def profiled(strat: SolveStrategy, profile_dir: str) -> None:
    """strat.solve() under torch.profiler; the Chrome trace goes to
    ``profile_dir``/trace.json (CPU activity, and CUDA activity on a CUDA
    device), with the program's spans of the solve placed on its clock by
    an anchor range entered at a known host time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if strat.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    trace.drain()  # only this solve's spans
    with profile(activities=acts) as prof:
        t0 = time.monotonic_ns()
        with record_function(trace.ANCHOR):
            pass
        strat.solve()
        if strat.device.type == "cuda":
            torch.cuda.synchronize(strat.device)
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    trace.add_to_chrome_trace(path, trace.drain()["spans"], t0)


def main(argv=None) -> float:
    a = build_parser().parse_args(argv)
    resolve_paths(a)
    strat = STRATEGIES[a.solve_strategy](a)
    if a.profile_dir:
        profiled(strat, a.profile_dir)
    else:
        strat.solve()
    strat.save_knn()
    if a.solve_strategy != "bruteforce":
        return strat.recall()
    return 1.0


if __name__ == "__main__":
    main()
