"""NN-descent kNN-graph construction (port of hnsw_slim_tpu/graph/nnd.py).

Random-projection warm start, then rounds of candidate generation (forward
2-hop with new-entry pivots, reverse edges, local join) and a per-node merge
of the candidates into a sorted top-K list with new-flags. The merge runs on
kernel Kδ (``_chunked_cand_merge``); projection sorts and candidate
generation are PyTorch tensor code.

Random draws come from an explicit ``torch.Generator``; ``_nnd_candidates``
takes its draws as tensors so that a test can feed it the draws the JAX code
makes from a key.
"""

from __future__ import annotations

import torch

from ..ops import cuda
from ..ops.distance import gathered_dist_plain

INF = float("inf")
BIG = 2**30


def sorted_run_rank(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal values (keys sorted
    ascending)."""
    iota = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    start = torch.searchsorted(keys, keys, side="left").to(torch.int32)
    return iota - start


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


def rp_init(gen, vectors, vn, n_valid: int, *, k: int, n_proj: int,
            metric: str):
    """Random-projection warm start: each node's initial candidates are its
    window neighbors in n_proj global sorted orders (+ random fill)."""
    n, d = vectors.shape
    dev = vectors.device
    dirs = torch.randn((d, n_proj), generator=gen, device=dev)
    proj = vectors.float() @ dirs
    w = max(2, k // (2 * n_proj))
    offs = torch.cat([torch.arange(-w, 0), torch.arange(1, w + 1)]).to(dev)
    iota = torch.arange(n, device=dev)
    cands = []
    for p in range(n_proj):
        keyv = torch.where(iota < n_valid, proj[:, p], INF)
        order = torch.argsort(keyv, stable=True)
        rank = torch.argsort(order, stable=True)
        pos = (rank[:, None] + offs[None, :]).clamp(0, n - 1)
        c = order[pos]
        cands.append(torch.where(c < n_valid, c, -1))
    rnd = torch.randint(0, n_valid, (n, max(0, k - 2 * w * n_proj)),
                        generator=gen, device=dev)
    cand = torch.cat(cands + [rnd], dim=1).to(torch.int32).contiguous()
    init_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    init_d = torch.full((n, k), INF, device=dev)
    init_n = torch.zeros((n, k), dtype=torch.int32, device=dev)
    ids, dists, newf, _ = _chunked_cand_merge(
        vectors, vn, init_i, init_d, init_n, cand, metric=metric)
    return ids, dists, newf


def nnd_draws(gen, n: int, k: int, s_fwd: int, r_rev: int, device):
    """The random inputs of one _nnd_candidates call: (rand_key f32[n, k],
    r2 i32[n, s_fwd] in [0, k), r3 in [0, r_rev), r4 in [0, k))."""
    def ri(hi):
        return torch.randint(0, hi, (n, s_fwd), generator=gen, device=device)

    rand_key = torch.rand((n, k), generator=gen, device=device)
    return rand_key, ri(k), ri(r_rev), ri(k)


def _nnd_candidates(ids, newf, n_valid: int, *, s_fwd: int, r_rev: int,
                    draws):
    """Candidate generation (forward 2-hop, reverse, local join). Returns
    (cand i32[n, 2*s_fwd + r_rev], newf with the sampled pivots cleared)."""
    n, k = ids.shape
    dev = ids.device
    rand_key, r2, r3, r4 = draws
    pivot_score = torch.where(newf == 1, rand_key, rand_key + 2.0)
    pivot_score = torch.where(ids >= 0, pivot_score, INF)
    piv = torch.argsort(pivot_score, dim=1, stable=True)[:, :s_fwd]
    mid = torch.gather(ids, 1, piv)
    flat = ids.reshape(-1)
    fwd = torch.where(mid >= 0, flat[mid.clamp(min=0).long() * k + r2], -1)

    cleared = torch.zeros_like(newf)
    cleared.scatter_(1, piv, 1)
    newf = torch.where(cleared == 1, 0, newf)

    tgt = ids.reshape(-1)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    tgt_s = torch.where(tgt >= 0, tgt, n)
    st, order = torch.sort(tgt_s, stable=True)
    ss = src[order]
    rank = sorted_run_rank(st)
    keep = (rank < r_rev) & (st < n) & (ss < n_valid)
    rev = torch.full((n + 1, r_rev), -1, dtype=torch.int32, device=dev)
    rev[st[keep].long(), rank[keep].long()] = ss[keep]
    rev = rev[:n]

    jrev = torch.gather(rev, 1, r3.long())
    join = torch.where(jrev >= 0, flat[jrev.clamp(min=0).long() * k + r4], -1)
    cand = torch.cat([fwd, rev, join], dim=1).to(torch.int32).contiguous()
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
