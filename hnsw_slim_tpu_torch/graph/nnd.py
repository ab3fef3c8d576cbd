"""NN-descent kNN-graph construction (port of hnsw_slim_tpu/graph/nnd.py).

Random-projection warm start, then rounds of candidate generation (forward
2-hop with new-entry pivots, reverse edges, local join) and a per-node merge
of the candidates into a sorted top-K list with new-flags. On the card every
device program is a hand-written kernel:

  rp_init      per projection a stable sort of n f32 keys (Kκ), the window
               candidates and random fill (Kν, ``rp_window``), the merge (Kδ)
  a round      pivots, forward 2-hop and cleared flags (Kλ pivot mode,
               ``nnd_pivot``), the reverse-edge sort of n*k (target, source)
               pairs (Kκ), run rank + scatter into rev (Kμ), local join
               and the candidate row (Kλ join mode, ``nnd_join``), merge (Kδ)

Each wrapper runs its plain PyTorch version when handed CPU tensors.

Random draws come from an explicit ``torch.Generator``; ``rp_draws`` and
``nnd_draws`` make them as tensors, so that a test can feed in the draws
the JAX code makes from a key.
"""

from __future__ import annotations

import torch

from ..ops import cuda
from ..ops.distance import gathered_dist_plain
from ..ops.sort import kv_radix_sort, run_scatter, sorted_run_rank  # noqa: F401

INF = float("inf")
BIG = 2**30


def cand_merge_plain(vectors, vn, ids, dists, newf, cand, chunk: int = 8192,
                     metric: str = "l2", row0: int = 0):
    """Plain PyTorch Kδ: the JAX chunk loop. Row r of ids/dists/newf/cand
    belongs to node row0 + r. Returns (ids, dists, newf, n_inserted)."""
    n, k = ids.shape
    outs_i, outs_d, outs_n = [], [], []
    inserted = torch.zeros((), dtype=torch.int64, device=ids.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        idc, dc, nc, cc = ids[s:e], dists[s:e], newf[s:e], cand[s:e]
        b = e - s
        self_ids = torch.arange(row0 + s, row0 + e, dtype=torch.int32,
                                device=ids.device)[:, None]
        sc = torch.sort(torch.where(cc < 0, BIG, cc), dim=1).values
        dup_in = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                        device=ids.device),
                            sc[:, 1:] == sc[:, :-1]], dim=1)
        sc = torch.where(dup_in | (sc == BIG), -1, sc)
        known = (sc[:, :, None] == idc[:, None, :]).any(dim=2)
        valid = (sc >= 0) & ~known & (sc != self_ids)
        safe = sc.clamp(min=0).long()
        rows = torch.arange(row0 + s, row0 + e, device=ids.device)
        d = gathered_dist_plain(vectors[rows], vectors[safe], metric,
                                qn=vn[rows], vn=vn[safe])
        d = torch.where(valid, d, INF)
        cat_d = torch.cat([dc, d], dim=1)
        cat_i = torch.cat([idc, torch.where(valid, sc, -1)], dim=1)
        cat_n = torch.cat([nc, torch.full_like(sc, 2)], dim=1)
        sd, order = torch.sort(cat_d, dim=1, stable=True)
        sd = sd[:, :k]
        si = torch.gather(cat_i, 1, order[:, :k])
        sn = torch.gather(cat_n, 1, order[:, :k])
        inserted += ((sn == 2) & (sd < INF)).sum()
        outs_i.append(si)
        outs_d.append(sd)
        outs_n.append(torch.where(sn == 2, 1, sn))
    return (torch.cat(outs_i), torch.cat(outs_d), torch.cat(outs_n),
            inserted)


def _chunked_cand_merge(vectors, vn, ids, dists, newf, cand,
                        chunk: int = 8192, metric: str = "l2", row0: int = 0):
    """Kδ: score candidates cand i32[n, C] against each node's own vector and
    merge them into its sorted top-K state (ids, dists, new flags). Returns
    (ids, dists, newf, n_inserted) as new tensors. CUDA tensors run
    csrc/cand_merge.cu (all rows in one launch), CPU tensors the plain
    chunk loop."""
    if not ids.is_cuda:
        return cand_merge_plain(vectors, vn, ids, dists, newf, cand, chunk,
                                metric, row0)
    n, k = ids.shape
    c = cand.shape[1]
    d = vectors.shape[1]
    cuda.require(vectors, torch.float32, "vectors", (-1, d))
    cuda.require(vn, torch.float32, "vn", (vectors.shape[0],))
    cuda.require(ids, torch.int32, "ids", (n, k))
    cuda.require(dists, torch.float32, "dists", (n, k))
    cuda.require(newf, torch.int32, "newf", (n, k))
    cuda.require(cand, torch.int32, "cand", (n, c))
    if row0 + n > vectors.shape[0]:
        raise ValueError("cand_merge: rows run past the vector table")
    out_i = torch.empty_like(ids)
    out_d = torch.empty_like(dists)
    out_n = torch.empty_like(newf)
    ins = torch.empty((n,), dtype=torch.int32, device=ids.device)
    if n:
        cuda.launch(
            "cand_merge", vectors.data_ptr(), vn.data_ptr(), d, row0,
            ids.data_ptr(), dists.data_ptr(), newf.data_ptr(),
            cand.data_ptr(), n, k, c, int(metric == "ip"), out_i.data_ptr(),
            out_d.data_ptr(), out_n.data_ptr(), ins.data_ptr(),
        )
    return out_i, out_d, out_n, ins.sum()


def rp_draws(gen, n: int, d: int, k: int, n_proj: int,
             n_valid: int | None = None):
    """The random inputs of rp_init: (dirs f32[d, n_proj] normal, rnd
    i64[n, k - 2w*n_proj] uniform in [0, n_valid)), drawn in that order."""
    w = max(2, k // (2 * n_proj))
    dirs = torch.randn((d, n_proj), generator=gen, device=gen.device)
    rnd = torch.randint(0, n if n_valid is None else n_valid,
                        (n, max(0, k - 2 * w * n_proj)), generator=gen,
                        device=gen.device)
    return dirs, rnd


def rp_window_plain(orders, rnd, n_valid: int, w: int):
    """Plain PyTorch Kν: per projection the inverse permutation, the window
    gather and the padding mask, then the random fill."""
    n = orders.shape[1]
    offs = torch.cat([torch.arange(-w, 0), torch.arange(1, w + 1)]).to(
        orders.device)
    cands = []
    for order in orders.long():
        rank = torch.argsort(order, stable=True)
        pos = (rank[:, None] + offs[None, :]).clamp(0, n - 1)
        c = order[pos]
        cands.append(torch.where(c < n_valid, c, -1))
    return torch.cat(cands + [rnd], dim=1).to(torch.int32).contiguous()


def rp_window(orders, rnd, n_valid: int, w: int):
    """Kν (csrc/rp_window.cu): the warm start's candidates i32[n, P*2w + R]
    from the sorted orders i32[P, n] of the P projections (node ids in key
    order) and the random fill rnd i64[n, R]. CPU tensors run
    ``rp_window_plain``."""
    if not orders.is_cuda:
        return rp_window_plain(orders, rnd, n_valid, w)
    p_, n = orders.shape
    r = rnd.shape[1]
    cuda.require(orders, torch.int32, "orders", (p_, n))
    cuda.require(rnd, torch.int64, "rnd", (n, r))
    c = p_ * 2 * w + r
    cand = torch.empty((n, c), dtype=torch.int32, device=orders.device)
    if n and p_:
        cuda.launch("rp_window", orders.data_ptr(), rnd.data_ptr(), n,
                    n_valid, p_, w, r, c, cand.data_ptr())
    return cand


def rp_candidates(proj, n_valid: int, w: int, rnd):
    """The warm start's candidate rows from the projections f32[n, P]: per
    projection a stable sort of the keys (rows >= n_valid pushed to the end
    with +inf) carrying node ids (Kκ), then the windows and random fill
    (Kν)."""
    n, n_proj = proj.shape
    iota = torch.arange(n, dtype=torch.int32, device=proj.device)
    orders = torch.stack([
        kv_radix_sort(torch.where(iota < n_valid, proj[:, p], INF)
                      .contiguous(), iota, 32, "f32")[1]
        for p in range(n_proj)])
    return rp_window(orders, rnd, n_valid, w)


def rp_init(gen, vectors, vn, n_valid: int, *, k: int, n_proj: int,
            metric: str, draws=None):
    """Random-projection warm start: each node's initial candidates are its
    window neighbors in n_proj global sorted orders (+ random fill).
    ``draws`` = (dirs, rnd) as rp_draws makes them (default: drawn from
    gen)."""
    n, d = vectors.shape
    dev = vectors.device
    dirs, rnd = draws if draws is not None else rp_draws(
        gen, n, d, k, n_proj, n_valid)
    proj = vectors.float() @ dirs.to(dev)
    cand = rp_candidates(proj, n_valid, max(2, k // (2 * n_proj)),
                         rnd.to(dev))
    init_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    init_d = torch.full((n, k), INF, device=dev)
    init_n = torch.zeros((n, k), dtype=torch.int32, device=dev)
    ids, dists, newf, _ = _chunked_cand_merge(
        vectors, vn, init_i, init_d, init_n, cand, metric=metric)
    return ids, dists, newf


def nnd_draws(gen, n: int, k: int, s_fwd: int, r_rev: int, device):
    """The random inputs of one _nnd_candidates call: (rand_key f32[n, k],
    r2 i64[n, s_fwd] in [0, k), r3 in [0, r_rev), r4 in [0, k))."""
    def ri(hi):
        return torch.randint(0, hi, (n, s_fwd), generator=gen, device=device)

    rand_key = torch.rand((n, k), generator=gen, device=device)
    return rand_key, ri(k), ri(r_rev), ri(k)


def nnd_pivot_plain(ids, newf, rand_key, r2, cand):
    """Plain PyTorch Kλ, pivot mode: writes cand[:, :s_fwd] and returns the
    flags with the sampled pivots cleared."""
    k = ids.shape[1]
    s_fwd = r2.shape[1]
    pivot_score = torch.where(newf == 1, rand_key, rand_key + 2.0)
    pivot_score = torch.where(ids >= 0, pivot_score, INF)
    piv = torch.argsort(pivot_score, dim=1, stable=True)[:, :s_fwd]
    mid = torch.gather(ids, 1, piv)
    flat = ids.reshape(-1)
    cand[:, :s_fwd] = torch.where(
        mid >= 0, flat[mid.clamp(min=0).long() * k + r2.long()], -1)
    cleared = torch.zeros_like(newf)
    cleared.scatter_(1, piv, 1)
    return torch.where(cleared == 1, 0, newf)


def nnd_pivot(ids, newf, rand_key, r2, cand):
    """Kλ pivot mode (csrc/nnd_cand.cu): per node, the s_fwd = r2.shape[1]
    best pivot positions (new entries first, by the random score; stable),
    the forward 2-hop candidates ids[mid, r2] written into cand[:, :s_fwd]
    (in place), and the flags with every pivot cleared (returned). CPU
    tensors run ``nnd_pivot_plain``."""
    if not ids.is_cuda:
        return nnd_pivot_plain(ids, newf, rand_key, r2, cand)
    n, k = ids.shape
    s_fwd = r2.shape[1]
    c = cand.shape[1]
    cuda.require(ids, torch.int32, "ids", (n, k))
    cuda.require(newf, torch.int32, "newf", (n, k))
    cuda.require(rand_key, torch.float32, "rand_key", (n, k))
    cuda.require(r2, torch.int64, "r2", (n, s_fwd))
    cuda.require(cand, torch.int32, "cand", (n, c))
    if k > 64 or s_fwd > min(k, c):
        raise ValueError(f"nnd_pivot: k={k} (<= 64), s_fwd={s_fwd}")
    newf_out = torch.empty_like(newf)
    if n:
        cuda.launch("nnd_cand", ids.data_ptr(), newf.data_ptr(),
                    rand_key.data_ptr(), r2.data_ptr(), n, k, s_fwd, c,
                    cand.data_ptr(), newf_out.data_ptr(), entry="nnd_pivot")
    return newf_out


def nnd_join_plain(ids, rev, r3, r4, cand):
    """Plain PyTorch Kλ, join mode: cand[:, s_fwd:] = [rev, join]."""
    k = ids.shape[1]
    s_fwd, r_rev = r3.shape[1], rev.shape[1]
    jrev = torch.gather(rev, 1, r3.long())
    flat = ids.reshape(-1)
    cand[:, s_fwd:s_fwd + r_rev] = rev
    cand[:, s_fwd + r_rev:] = torch.where(
        jrev >= 0, flat[jrev.clamp(min=0).long() * k + r4.long()], -1)


def nnd_join(ids, rev, r3, r4, cand):
    """Kλ join mode (csrc/nnd_cand.cu): writes the reverse samples
    rev i32[n, r_rev] into cand[:, s_fwd:s_fwd + r_rev] and the local-join
    candidates ids[rev[:, r3], r4] (or -1) after them, in place (s_fwd =
    r3.shape[1]). CPU tensors run ``nnd_join_plain``."""
    if not ids.is_cuda:
        return nnd_join_plain(ids, rev, r3, r4, cand)
    n, k = ids.shape
    s_fwd, r_rev = r3.shape[1], rev.shape[1]
    c = cand.shape[1]
    cuda.require(ids, torch.int32, "ids", (n, k))
    cuda.require(rev, torch.int32, "rev", (n, r_rev))
    cuda.require(r3, torch.int64, "r3", (n, s_fwd))
    cuda.require(r4, torch.int64, "r4", (n, s_fwd))
    cuda.require(cand, torch.int32, "cand", (n, 2 * s_fwd + r_rev))
    if n:
        cuda.launch("nnd_cand", ids.data_ptr(), rev.data_ptr(), r3.data_ptr(),
                    r4.data_ptr(), n, k, s_fwd, r_rev, c, cand.data_ptr(),
                    entry="nnd_join", modes=("join",))


def _nnd_candidates(ids, newf, n_valid: int, *, s_fwd: int, r_rev: int,
                    draws):
    """Candidate generation (forward 2-hop, reverse, local join). Returns
    (cand i32[n, 2*s_fwd + r_rev], newf with the sampled pivots cleared).
    Kλ pivot mode, Kκ over the (target, source) edge list (empty slots take
    target n and sort last), Kμ into rev i32[n, r_rev] (sources >= n_valid
    dropped), Kλ join mode."""
    n, k = ids.shape
    dev = ids.device
    rand_key, r2, r3, r4 = draws
    cand = torch.empty((n, 2 * s_fwd + r_rev), dtype=torch.int32, device=dev)
    newf = nnd_pivot(ids, newf, rand_key, r2, cand)
    tgt_s = torch.where(ids >= 0, ids, n).reshape(-1)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    st, ss = kv_radix_sort(tgt_s, src, max(1, n.bit_length()))
    rev = run_scatter(st, ss, n, r_rev, n_valid)
    nnd_join(ids, rev, r3, r4, cand)
    return cand, newf


def nn_descent(vectors, vn, k: int = 64, rounds: int = 30,
               s_fwd: int | None = None, r_rev: int | None = None,
               metric: str = "l2", seed: int = 0,
               min_change_frac: float = 0.002, verbose: bool = False):
    """Approximate kNN graph: (ids i32[N, K], dists f32[N, K]) sorted
    ascending, on the device of ``vectors``."""
    n = vectors.shape[0]
    s_fwd = s_fwd or k
    r_rev = r_rev or k // 2
    gen = torch.Generator(device=vectors.device).manual_seed(seed)
    ids, dists, newf = rp_init(gen, vectors, vn, n, k=k, n_proj=4,
                               metric=metric)
    for r in range(rounds):
        cand, newf = _nnd_candidates(
            ids, newf, n, s_fwd=s_fwd, r_rev=r_rev,
            draws=nnd_draws(gen, n, k, s_fwd, r_rev, vectors.device))
        ids, dists, newf, inserted = _chunked_cand_merge(
            vectors, vn, ids, dists, newf, cand, metric=metric)
        c = int(inserted)
        if verbose:
            print(f"  nnd round {r}: {c} insertions")
        if c < min_change_frac * n * k:
            break
    return ids, dists
