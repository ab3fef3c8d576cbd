"""The port's CUDA kernels (Kα–Kζ) against their plain PyTorch versions on
the card. Marked ``cuda``; each test skips when no CUDA device is present.
The machine with the card has no JAX, so run these without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: ids equal on >= 99% of rows/slots (near-ties in fp32 summation
order may reorder), distances within 1e-4 * (1 + |d|); Kζ moves integers
only and must be exactly equal.
"""

import numpy as np
import pytest
import torch

from hnsw_slim_tpu_torch.utils.data import clustered

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def data():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base, q = clustered(20000, 128, n_queries=512, n_clusters=40, seed=1,
                        scale=0.3)
    x = torch.as_tensor(base, device="cuda")
    return x, (x * x).sum(1), torch.as_tensor(q, device="cuda")


def _close(a, b):
    return bool(((a - b).abs() <= 1e-4 * (1 + b.abs())).all())


@pytest.mark.parametrize("k,self_mask", [(10, False), (64, True)])
def test_topk_dist_kernel_matches_plain(data, k, self_mask):
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    x, xn, q = data
    if self_mask:
        q = x[1000:1512]
    kw = dict(self_offset=1000 if self_mask else -1, n_valid=19000)
    kd, ki = bf.topk_dist(q, x, xn, k, **kw)
    pd, pi = bf.topk_dist_plain(q, x, xn, k, **kw)
    assert (ki == pi).float().mean() >= 0.99
    assert _close(kd, pd)


def test_beam_search_kernel_matches_plain(data):
    from hnsw_slim_tpu_torch.config import HnswConfig, SearchConfig, SlimConfig
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex

    x, _, q = data
    h = HnswIndex(HnswConfig(M=16, ef_construction=64), strategy="nnd",
                  device="cuda")
    h.build(x.cpu().numpy())
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    idx.densify_level0()
    up_vecs, up_vn, up_ids = idx._seed_table()
    for ef, pop, scan in [(64, 8, 0), (320, 16, 96), (32, 1, 0)]:
        sd, sp = bf.topk_dist_plain(q, up_vecs, up_vn, 32, row_ids=up_ids)
        si = torch.where(sp >= 0, up_ids[sp.clamp(min=0).long()], -1)
        si = si.to(torch.int32).contiguous()
        P = gs.bitonic_buffer_width(ef) if ef == 320 else ef
        kw = dict(P=P, ef_eff=ef, pop_width=pop,
                  cw=gs.cand_width(P, pop, idx.dense0.shape[1], scan),
                  max_iters=SearchConfig(ef=ef, pop_width=pop).iters(), k=10)
        args = (idx.vectors, q, (q * q).sum(1), idx.dense0, sd.contiguous(),
                si)
        kd, ki, kh, kc = gs.beam_search(*args, **kw)
        pd, pi, ph, pc = gs.beam_search_plain(*args, **kw)
        assert (ki == pi).float().mean() >= 0.99, (ef, pop, scan)
        same = ki == pi
        assert _close(kd[same], pd[same])
        assert abs(int(kc.sum()) - int(pc.sum())) <= 0.01 * int(pc.sum())


@pytest.mark.parametrize("keep_all_under_m,keep_pruned",
                         [(False, False), (True, True)])
def test_rng_prune_kernel_matches_plain(data, keep_all_under_m, keep_pruned):
    from hnsw_slim_tpu_torch.graph import heuristic as th

    x, xn, _ = data
    g = torch.Generator(device="cuda").manual_seed(0)
    b, c = 2048, 96
    base = torch.randint(0, len(x), (b,), generator=g, device="cuda",
                         dtype=torch.int32)
    near = torch.topk(-(x[base.long()] @ x.T * -2 + xn), c // 2).indices
    far = torch.randint(-1, len(x), (b, c - c // 2), generator=g,
                        device="cuda")
    cand = torch.cat([near, far], 1).to(torch.int32).contiguous()
    m = torch.randint(2, 40, (b,), generator=g, device="cuda",
                      dtype=torch.int32)
    kw = dict(keep_all_under_m=keep_all_under_m, keep_pruned=keep_pruned,
              out_width=48)
    ks, kc = th.rng_prune(x, xn, base, cand, m, **kw)
    ps, pc = th.rng_prune_plain(x, xn, base, cand, m, **kw)
    assert (ks == ps).all(1).float().mean() >= 0.99
    assert (kc == pc).float().mean() >= 0.99


def test_cand_merge_kernel_matches_plain(data):
    from hnsw_slim_tpu_torch.graph import nnd

    x, xn, _ = data
    n = len(x)
    g = torch.Generator(device="cuda").manual_seed(0)
    ids, dists, newf = nnd.rp_init(g, x, xn, n, k=32, n_proj=4, metric="l2")
    cand, newf = nnd._nnd_candidates(
        ids, newf, n, s_fwd=32, r_rev=16,
        draws=nnd.nnd_draws(g, n, 32, 32, 16, "cuda"))
    ki, kd, kf, kn = nnd._chunked_cand_merge(x, xn, ids, dists, newf, cand)
    pi, pd, pf, pn = nnd.cand_merge_plain(x, xn, ids, dists, newf, cand)
    rows = (ki == pi).all(1)
    assert rows.float().mean() >= 0.99
    fin = torch.isfinite(pd) & rows[:, None]
    assert _close(kd[fin], pd[fin])
    assert abs(int(kn) - int(pn)) <= 0.01 * int(pn)
    assert np.isclose(float(rows.float().mean()), 1.0, atol=0.01)


@pytest.fixture(scope="module")
def insert_index(data):
    """An insertion-built HnswIndex of the 20k vectors on the card, with the
    kernel launches its build made."""
    from hnsw_slim_tpu_torch.config import HnswConfig
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.ops import cuda

    x, _, _ = data
    cuda.reset_launches()
    h = HnswIndex(HnswConfig(M=16, ef_construction=64), strategy="insert",
                  device="cuda")
    h.build(x.cpu().numpy())
    torch.cuda.synchronize()
    return h, dict(cuda.launches)


def test_insert_build_on_card(data, insert_index):
    """The insertion build goes through Kε, Kβ, Kγ and Kζ, keeps the graph
    invariants, and serves recall@10 >= 0.95 at ef=64 (vanilla path)."""
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    x, xn, q = data
    h, launched = insert_index
    for name in ("greedy_descent", "beam_search", "rng_prune", "rev_connect"):
        assert launched[name] > 0, name
    assert h.check_integrity()["connections"] > 0
    assert h.build_stats["overflow"]["truncated_applies"] == 0
    _, gt = bf.topk_dist_plain(q, x, xn, 10)
    h.set_ef(64)
    _, ids = h.search(q.cpu().numpy(), 10)
    gt = gt.cpu().numpy()
    hits = sum(len(set(a) & set(b)) for a, b in zip(ids, gt))
    assert hits / gt.size >= 0.95


def test_greedy_descent_kernel_matches_plain(data, insert_index):
    """Kε vs its plain version level by level (both from the plain
    version's state), all queries active and then half: cur equal on
    >= 99% of queries, distances close, hops equal where cur is."""
    from hnsw_slim_tpu_torch.graph import search as gs

    x, xn, q = data
    h, _ = insert_index
    g = h.graph
    qn = (q * q).sum(1)
    half = torch.arange(len(q), device="cuda") % 2 == 0
    for active in (None, half):
        pc, pd = gs.entry_dist(x, xn, q, qn, g.entry)
        for l in range(g.max_level, 0, -1):
            kc, kd, kh, _ = gs.greedy_descent(x, q, qn, g.adjs[l], pc, pd,
                                              active)
            pc, pd, ph, _ = gs.greedy_descent_plain(x, q, qn, g.adjs[l], pc,
                                                    pd, active)
            same = kc == pc
            assert same.float().mean() >= 0.99, l
            assert _close(kd[same], pd[same])
            assert (kh[same] == ph[same]).all()
            if active is not None:
                assert (kh[~active] == 0).all()


def test_rev_connect_kernel_matches_plain():
    """Kζ append, overflow-row assembly and write-back against their plain
    versions on one synthetic batch whose edges crowd a few hundred
    targets: adjacency, degrees, flags and rows exactly equal."""
    from hnsw_slim_tpu_torch.graph import revconn

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    n, cap, b, m = 5000, 16, 512, 8
    old = n - b
    deg = torch.randint(0, cap + 1, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    deg[old:] = 0
    adj = torch.randint(0, old, (n, cap), generator=g, device="cuda",
                        dtype=torch.int32)
    adj[torch.arange(cap, device="cuda")[None, :] >= deg[:, None].long()] = -1
    a_ids = torch.arange(old, n, dtype=torch.int32, device="cuda")
    hot = torch.rand((b, 300), generator=g, device="cuda").argsort(1)
    sel = hot[:, :m].to(torch.int32)
    cnt = torch.randint(0, m + 1, (b, 1), generator=g, device="cuda")
    sel[torch.arange(m, device="cuda")[None, :] >= cnt] = -1
    us, ps = revconn.reverse_edges(a_ids, sel)
    ak, dk, ap, dp = adj.clone(), deg.clone(), adj.clone(), deg.clone()
    ok = revconn.rev_append(ak, dk, us, ps)
    op = revconn.rev_append_plain(ap, dp, us, ps)
    assert torch.equal(ok, op) and torch.equal(ak, ap) and torch.equal(dk, dp)
    assert int(ok.sum()) > 0
    of_u, of_p, ut, _, n_t = revconn.overflow_targets(us, ps, ok, 4096)
    bk, ck = revconn.overflow_rows(ak, of_u, of_p, ut, 64)
    bp, cp = revconn.overflow_rows_plain(ap, of_u, of_p, ut, 64)
    assert torch.equal(bk, bp) and torch.equal(ck, cp) and int(n_t) > 0
    osel = torch.randint(-1, old, (ut.shape[0], cap), generator=g,
                         device="cuda", dtype=torch.int32)
    ocnt = torch.randint(0, cap, (ut.shape[0],), generator=g, device="cuda",
                         dtype=torch.int32)
    revconn.write_rows(ak, dk, ut, osel, ocnt)
    revconn.write_rows_plain(ap, dp, ut, osel, ocnt)
    assert torch.equal(ak, ap) and torch.equal(dk, dp)
