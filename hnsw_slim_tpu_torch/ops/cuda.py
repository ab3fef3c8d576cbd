"""Build, load and launch-count the hand-written CUDA kernels (``csrc/``).

Each kernel source compiles to an object with its own ``nvcc``, all started
together, and one more ``nvcc`` links them into one shared library with a
plain C interface, loaded through ctypes (pointers as ``c_void_p``, the
launch stream is PyTorch's current stream). The library is built at first
use from the checkout's sources alone, into ``_build/`` beside this package
(listed in ``.gitignore``); its file name carries a hash of the sources, so an
edited kernel is rebuilt rather than reloaded stale.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises on a non-zero code. ``launches`` counts, per kernel, the
wrapper calls that launched it, and per kernel mode (``kernel.mode``: a fetch
form, the filtered beam, stratified seeds, the guarded prune, the quantized
scorers and the rerank track of SlimQ, ``bf16`` for rows read from a
bfloat16 vector store, the dedup mode of the run scatter, the join mode
of the NN-descent candidates, the ids map of the radix sort and ``k128``
for a scan whose top-k lists take 128 slots) the launches made in that
mode:
``reset_launches`` before a run and read the counts after it to show which
kernels and modes the run went through. ``launch_shapes`` splits the
launches of Kα, Kβ, Kγ and Kε by their shape class (scan mode, tile and k;
pop width, ef and seeds; prune form and width; one level or a run of
levels) under a caller's ``tagged`` label. Inside ``held`` (a CUDA graph
capture, which runs nothing) a thread's launches are collected instead, and
the graph's owner counts them with ``counted`` each time it replays them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("topk_dist.cu", "beam_search.cu", "rng_prune.cu", "cand_merge.cu",
           "greedy_descent.cu", "rev_connect.cu", "fht_rotate.cu",
           "row_deg.cu", "point_dist.cu", "shard_merge.cu",
           "radix_sort.cu", "run_scatter.cu", "nnd_cand.cu", "rp_window.cu",
           "row_norms.cu", "patch_apply.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

KERNELS = ("topk_dist", "beam_search", "rng_prune", "cand_merge",
           "greedy_descent", "rev_connect", "fht_rotate", "row_deg",
           "point_dist", "shard_merge", "radix_sort",
           "run_scatter", "nnd_cand", "rp_window", "row_norms",
           "patch_apply")
MODES = ("topk_dist.strata", "beam_search.chal", "beam_search.rank",
         "beam_search.filtered", "greedy_descent.chal", "greedy_descent.rank",
         "rng_prune.guarded", "topk_dist.estimate", "beam_search.quant",
         "beam_search.quant_ex", "beam_search.rerank", "greedy_descent.quant",
         "fht_rotate.g_tables", "topk_dist.bf16", "beam_search.bf16",
         "greedy_descent.bf16", "rng_prune.bf16", "point_dist.bf16",
         "run_scatter.dedup", "nnd_cand.join", "radix_sort.ids",
         "topk_dist.k128", "row_norms.bf16")
launches = dict.fromkeys(KERNELS + MODES, 0)
# launches by the shape a wrapper reports (``launch(shape=)``) under the
# caller's tag (``tagged``): "kernel[tag] shape" -> count
launch_shapes: dict[str, int] = {}
_tag = ""
_local = threading.local()  # .held: the list ``held`` collects into

P, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# the quantized scorer (quant/estimator.py QuantScorer.args): packed rows,
# row stride in words, nb, ex_bits, use_ex, q_rot, sumq, g_add, C
_SCORER = [P, I32, I32, I32, I32, P, P, P, I32]
_FETCH = [P, P, I32, I32, I32, I32]  # rows, aux, mode, W, level, stride

# C signatures: every function returns a cudaError_t as int
_SIGNATURES = {
    # q, qn, x, xn, row_ids, B, N, D, n_valid, self_offset, k, metric,
    # the plan's tile, splits and smem bytes (index/bruteforce.py
    # scan_plan), part_d, part_i, the splits' thresholds u64[B], out_d,
    # out_i, stream
    "hs_topk_dist": [P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32,
                     I32, I32, P, P, P, P, P, P],
    # q, qn, x, xn, row_ids, B, N, D, seeds per segment, strata, metric,
    # tile, smem, part_d, part_i, out_d, out_id, stream
    "hs_topk_strata": [P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32,
                       P, P, P, P, P],
    # vectors, D, fetch (rows, aux, mode, W, level, stride), q, qn, seed_d,
    # seed_id, B, S, P, ef_eff, E, cw, max_iters, k, metric, allowed,
    # track_d, track_id, out_d, out_id, hops, dcomp, track_d_out,
    # track_id_out, stream
    "hs_beam_search": [P, I32, P, P, I32, I32, I32, I32, P, P, P, P, I32,
                       I32, I32, I32, I32, I32, I32, I32, I32, P, P, P, P, P,
                       P, P, P, P, P],
    # vectors, vn, D, base_ids, cand, m_per_row, B, C, m_max,
    # keep_all_under_m, keep_pruned, out_width, metric, guard, ring rows,
    # threads, smem bytes (graph/heuristic.py prune_plan), out, cnt, stream
    "hs_rng_prune": [P, P, I32, P, P, P, I32, I32, I32, I32, I32, I32, I32,
                     P, I32, I32, I32, P, P, P],
    # vectors, vn, D, row0, ids, dists, newf, cand, n, K, C, metric,
    # out_ids, out_d, out_nf, inserted, stream
    "hs_cand_merge": [P, P, I32, I32, P, P, P, P, I32, I32, I32, I32, P, P,
                      P, P, P],
    # vectors, D, levels, top, level fetch pointers i64[levels, 2] and
    # (mode, W, level, stride) i32[levels, 4] in host memory, q, qn, stop,
    # B, metric, cur, curdist, hops, dcomp, stream
    "hs_greedy_levels": [P, I32, I32, I32, P, P, P, P, P, I32, I32, P, P, P,
                         P, P],
    # scorer, levels, top, the two host arrays, stop, B, score_cur, cur,
    # curdist, hops, dcomp, stream
    "hs_greedy_levels_quant": _SCORER + [I32, I32, P, P, P, I32, I32, P, P, P,
                                         P, P],
    # x, signs, fac, B, D, P, out, stream
    "hs_fht_rotate": [P, P, F32, I32, I32, I32, P, P],
    # q_rot, centroids_rot, B, C, P, metric, sumq, g_add, stream
    "hs_g_tables": [P, P, I32, I32, I32, I32, P, P, P],
    # scorer, fetch, seed_d, seed_id, B, S, P, ef_eff, E, cw, max_iters, k,
    # metric, dataset, Dr, q_raw, qn_raw, kk, track d in, track id in, out_d,
    # out_id, hops, dcomp, track d out, track id out, stream
    "hs_beam_search_quant": _SCORER + _FETCH + [
        P, P, I32, I32, I32, I32, I32, I32, I32, I32, I32, P, I32, P, P, I32,
        P, P, P, P, P, P, P, P, P],
    # packed table rows, stride, nb, ex_bits, q_rot, sumq, g_add, C, row_ids,
    # B, N, k, tile, splits, smem, part_d, part_i, thresholds, out_d, out_i,
    # stream
    "hs_topk_estimate": [P, I32, I32, I32, P, P, P, I32, P, I32, I32, I32,
                         I32, I32, I32, P, P, P, P, P, P],
    # us, ps, E, adj, deg, cap, T, new_w, ut, base, ocand, ticket,
    # look-back words, tiles, counters, stream
    "hs_rev_apply": [P, P, I32, P, P, I32, I32, I32, P, P, P, P, P, I32, P,
                     P],
    # adj, deg, cap, ut, T, osel, ocnt, stream
    "hs_rev_write_rows": [P, P, I32, P, I32, P, P, P],
    # a, N, cap, deg, stream
    "hs_row_deg": [P, I32, I32, P, P],
    # q, qn, x, xn, ids, B, W, D, metric, diff, out, stream
    "hs_point_dist": [P, P, P, P, P, I32, I32, I32, I32, I32, P, P],
    # d, ids, shard stride, query stride, gid, gid stride, hops, dcomp,
    # their shard and query strides, S, B, k, out_d, out_id, out_hops,
    # out_dcomp, stream
    "hs_shard_merge": [P, P, I64, I64, P, I64, P, P, I64, I64, I32, I32, I32,
                       P, P, P, P, P],
    # keys, payload, E, key_bits, key_map, keys_out, payload_out,
    # keys_tmp, payload_tmp, lookback, bases, accumulator, stream
    "hs_radix_sort": [P, P, I32, I32, I32, P, P, P, P, P, P, P, P],
    # keys, payload, E, n, R, n_valid, rows, stream
    "hs_run_scatter": [P, P, I32, I32, I32, I32, P, P],
    # keys, vals, E, n, out, stream
    "hs_run_dedup": [P, P, I32, I32, P, P],
    # ids, newf, rand_key, r2, n, k, s_fwd, C, cand, newf_out, stream
    "hs_nnd_pivot": [P, P, P, P, I32, I32, I32, I32, P, P, P],
    # ids, rev, r3, r4, n, k, s_fwd, r_rev, C, cand, stream
    "hs_nnd_join": [P, P, P, P, I32, I32, I32, I32, I32, P, P],
    # order, rnd, n, n_valid, P, w, R, C, cand, stream
    "hs_rp_window": [P, P, I32, I32, I32, I32, I32, I32, P, P],
    # x, rows, D, row stride (elements), out, stream
    "hs_row_norms": [P, I32, I32, I64, P, P],
    # record ids, R, rec_of, n_total, look-back words, tiles, stream
    "hs_patch_map": [P, I32, P, I32, P, I32, P],
    # rec_of, the records (levels, rel, its columns, starts, ids), the old
    # graph (nbr, lvl_off, its columns, level, count, max level, row
    # width), n_total, new level, new lvl_off, its columns, look-back
    # words, tiles, counters, stream
    "hs_patch_scan": [P, P, P, I32, P, P, P, P, I32, P, I32, I32, I32, I32,
                      P, P, I32, P, I32, P, P],
    # as scan up to the new lvl_off's columns, then the new max level, new
    # nbr, the id total, its padded length, stream
    "hs_patch_copy": [P, P, P, I32, P, P, P, P, I32, P, I32, I32, I32, I32,
                      P, P, I32, I32, P, I64, I64, P],
}
# the kernels that read rows of the vector store have a bfloat16 entry
# point of the same signature (``<name>_bf16``)
for _name in ("hs_topk_dist", "hs_topk_strata", "hs_beam_search",
              "hs_rng_prune", "hs_greedy_levels", "hs_point_dist",
              "hs_row_norms"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name]

_LIB = None
# the C entry points, bound once when the library loads: "name" (without
# the hs_ prefix) -> the ctypes function with its argtypes set
_FN: dict = {}
# the current device's index and its current stream as a raw handle, bound
# when the library loads (a CPU-only PyTorch has neither)
_device = _raw_stream = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""
    ]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhs_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[float, str]:
    """Compile the kernels if the library for these sources is missing: one
    nvcc per source, all at once, then a link. Returns (seconds spent,
    ptxas's per-kernel register and shared-memory report); (0.0, "") when
    already built."""
    out = _lib_path()
    if out.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    t0 = time.perf_counter()
    jobs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o),
         str(CSRC / s)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for s, o in zip(SOURCES, objs)]
    logs = []
    try:
        for s, job in zip(SOURCES, jobs):
            _, err = job.communicate(timeout=900)
            if job.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {s} ({job.returncode}):\n{err[-8000:]}")
            logs.append(err)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objs)], capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr[-8000:]}")
        os.replace(tmp, out)
    finally:
        for job in jobs:
            if job.poll() is None:
                job.kill()
                job.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    usage = [line.split("ptxas info    : ")[-1]
             for err in logs for line in err.splitlines()
             if "Compiling entry function" in line or "Used " in line]
    return time.perf_counter() - t0, "\n".join(usage)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB, _device, _raw_stream
    if _LIB is None:
        _device = torch._C._cuda_getDevice
        _raw_stream = torch._C._cuda_getCurrentRawStream
        build()
        handle = ctypes.CDLL(str(_lib_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FN[name[3:]] = fn
        handle.hs_error_string.argtypes = [ctypes.c_int]
        handle.hs_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().hs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def launch(name: str, *args, entry: str | None = None,
           modes: tuple = (), shape: str = "") -> None:
    """Call C entry point ``hs_<entry or name>`` on PyTorch's current stream
    of the current device (where a wrapper's tensors lie: a kernel launches
    on the current device), raise on a launch error, and count one launch
    of kernel ``name``, of each of its ``modes`` this launch ran in and,
    where given, of its ``shape`` under the current tag.

    The lean path every wrapper shares: the bound function comes from a
    table filled when the library loads, and the stream handle is read as a
    raw integer, without a ``torch.cuda.Stream`` object a call."""
    key = entry or name
    fn = _FN.get(key)
    if fn is None:
        lib()
        fn = _FN[key]
    err = fn(*args, _raw_stream(_device()))
    if err:
        check(err, key)
    held_ = getattr(_local, "held", None)
    if held_ is None:
        counted([(name, modes, shape)])
    else:
        held_.append((name, modes, shape))


def counted(calls) -> None:
    """Count ``calls``, [(name, modes, shape)] as ``launch`` takes them, as
    launched now: in ``launches`` and, under the current tag, in
    ``launch_shapes``."""
    for name, modes, shape in calls:
        launches[name] += 1
        for mode in modes:
            launches[name + "." + mode] += 1
        if shape:
            cls = f"{name}[{_tag}] {shape}"
            launch_shapes[cls] = launch_shapes.get(cls, 0) + 1


@contextlib.contextmanager
def held():
    """Collect this thread's launches as [(name, modes, shape)], in order,
    instead of counting them: under a CUDA graph capture no kernel runs,
    and the graph's owner counts the list with ``counted`` after each
    replay, so that the counts follow the launches that ran."""
    calls: list = []
    prev = getattr(_local, "held", None)
    _local.held = calls
    try:
        yield calls
    finally:
        _local.held = prev


def resolve_device(device=None) -> torch.device:
    """The given device, else the first CUDA card. Without a card it raises:
    the CPU is used only when the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


@contextlib.contextmanager
def tagged(tag: str):
    """Count the launches made inside under ``tag`` in launch_shapes (the
    caller names the work: an insertion build, a conversion, ...)."""
    global _tag
    old, _tag = _tag, tag
    try:
        yield
    finally:
        _tag = old


ROW_TYPES = (torch.float32, torch.bfloat16)  # the vector store's row types


def row_type(vectors: torch.Tensor, entry: str, modes: tuple = ()):
    """(C entry point, modes) of a launch that reads rows of ``vectors``:
    ``entry`` for an fp32 store, ``entry_bf16`` and the ``bf16`` mode for a
    bfloat16 one."""
    if vectors.dtype == torch.bfloat16:
        return f"{entry}_bf16", modes + ("bf16",)
    return entry, modes


def require(t: torch.Tensor, dtype, name: str,
            shape: tuple | None = None) -> None:
    """Validate a tensor handed to a kernel: on CUDA, dtype (one dtype, or a
    tuple of the accepted ones), contiguity and (where given, -1 = any)
    shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and (
        t.dim() != len(shape)
        or any(s != -1 and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
