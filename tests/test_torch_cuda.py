"""The port's CUDA kernels (Kα–Kξ, and their fetch-form, filtered, tag,
strata, guarded, quantized-scorer, rerank-track, collect, join and dedup modes)
against their plain PyTorch versions on the card. Marked ``cuda``; each test skips when no CUDA device is present.
The machine with the card has no JAX, so run these without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: ids equal on >= 99% of rows/slots (near-ties in fp32 summation
order may reorder), distances and estimates within 1e-4 * (1 + |d|); Kζ
and Kκ–Kν move integers only and Kη adds in the plain version's order: they
must be exactly equal.
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


def _crowded_apply(n, cap, b, m, hot, seed):
    """A synthetic level apply on the card: (adj, deg, us, ps) after the
    forward scatter of b inserted nodes (the last b ids) whose m forward
    edges each (-1 padded) crowd ``hot`` targets, old rows partly full."""
    from hnsw_slim_tpu_torch.graph import revconn

    g = torch.Generator(device="cuda").manual_seed(seed)
    old = n - b
    deg = torch.randint(0, cap + 1, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    deg[old:] = 0
    adj = torch.randint(0, old, (n, cap), generator=g, device="cuda",
                        dtype=torch.int32)
    adj[torch.arange(cap, device="cuda")[None, :] >= deg[:, None].long()] = -1
    a_ids = torch.arange(old, n, dtype=torch.int32, device="cuda")
    if b:
        sel = torch.rand((b, hot), generator=g, device="cuda").argsort(1)[
            :, :m].to(torch.int32)
        cnt = torch.randint(0, m + 1, (b, 1), generator=g, device="cuda")
        sel[torch.arange(m, device="cuda")[None, :] >= cnt] = -1
    else:
        sel = torch.zeros((0, m), dtype=torch.int32, device="cuda")
    us, ps = revconn.reverse_edges(a_ids, sel, n)
    return adj, deg, us, ps


def _settle_pair(adj, deg, us, ps, of_t, new_w, seed=0):
    """Kζ (append + settle, then the write-back of random re-pruned rows)
    against the plain composition on copies of one state: every output
    exactly equal. Returns the counters."""
    from hnsw_slim_tpu_torch.graph import revconn
    from hnsw_slim_tpu_torch.ops import cuda

    ak, dk, ap, dp = adj.clone(), deg.clone(), adj.clone(), deg.clone()
    before = cuda.launches["rev_connect"]
    zk = revconn.append_overflow(ak, dk, us, ps, of_t, new_w)
    assert cuda.launches["rev_connect"] - before == 1
    zp = revconn.append_overflow_plain(ap, dp, us, ps, of_t, new_w)
    torch.cuda.synchronize()
    for a, b in zip(zk, zp):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(ak, ap) and torch.equal(dk, dp)
    ut, t = zk[0], zk[0].shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    osel = torch.randint(-1, adj.shape[0], (t, adj.shape[1]), generator=g,
                         device="cuda", dtype=torch.int32)
    ocnt = torch.randint(0, adj.shape[1], (t,), generator=g, device="cuda",
                         dtype=torch.int32)
    revconn.write_rows(ak, dk, ut, osel, ocnt)
    revconn.write_rows_plain(ap, dp, ut, osel, ocnt)
    assert torch.equal(ak, ap) and torch.equal(dk, dp)
    return int(zk[3]), int(zk[4])


def test_rev_connect_kernel_matches_plain():
    """Kζ append + settle and write-back against their plain versions on one
    synthetic batch whose edges crowd a few hundred targets: adjacency,
    degrees, targets, base ids, candidate rows and counters exactly
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    of_e, of_tc = _settle_pair(*_crowded_apply(5000, 16, 512, 8, 300, 1),
                               4096, 64)
    assert of_e > 0 and of_tc > 0


# (N, cap, inserts, edges a row, hot targets, of_t, new_w): E = inserts x
# edges; the settle launch takes tiles of 1024 edges
SETTLE_CASES = {
    # two targets half the inserts link to: runs of ~3000 edges, 3+ tiles
    "hub runs over several tiles": (20000, 16, 6000, 2, 2, 4096, 8),
    # runs of ~30 edges, many across a tile edge
    "runs straddling tile edges": (20000, 16, 3000, 8, 700, 4096, 32),
    "E not a multiple of the tile": (9000, 8, 777, 5, 400, 4096, 4),
    "of_t truncating": (20000, 16, 3000, 8, 700, 40, 32),
    "of_t padding": (9000, 32, 777, 5, 3000, 100000, 64),
    "no edges": (500, 8, 0, 4, 100, 4096, 8),
}


@pytest.mark.parametrize("case", list(SETTLE_CASES))
def test_append_overflow_tiles_match_plain(case):
    """Kζ's two launches and the write-back against the plain composition
    (the JAX program's sorts) where the settle launch's tiles and look-back
    matter: exactly equal outputs."""
    _card()
    n, cap, b, m, hot, of_t, new_w = SETTLE_CASES[case]
    state = _crowded_apply(n, cap, b, m, hot, 3)
    of_e, of_tc = _settle_pair(*state, of_t, new_w)
    us, e = state[2], b * m
    edges = us[1024:e:1024]  # the first edge of every tile but the first
    if case == "no edges":
        assert (of_e, of_tc) == (0, 0)
    else:
        assert of_tc > 0
    if case == "hub runs over several tiles":
        assert int((us == us[0]).sum()) > 2048
    if case == "runs straddling tile edges":
        assert int((edges == us[1023:e - 1:1024]).sum()) > 5
    if case == "E not a multiple of the tile":
        assert e % 1024 != 0
    if case == "of_t truncating":
        assert of_tc > of_t
    if case == "of_t padding":
        assert of_tc < min(of_t, e)


# ---- fetch forms, the filtered beam, stratified seeds, the guarded prune


@pytest.fixture(scope="module")
def slim_index(data):
    """A Slim index of the 20k vectors on the card (NN-descent build) with
    both dense serving layouts, and its exact seeds for the 512 queries."""
    from hnsw_slim_tpu_torch.config import HnswConfig, SlimConfig
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex

    x, _, q = data
    h = HnswIndex(HnswConfig(M=16, ef_construction=64), strategy="nnd",
                  device="cuda")
    h.build(x.cpu().numpy())
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    idx.densify_level0()
    idx.densify_upper()
    up_vecs, up_vn, up_ids = idx._seed_table()
    sd, sp = bf.topk_dist_plain(q, up_vecs, up_vn, 32, row_ids=up_ids)
    si = torch.where(sp >= 0, up_ids[sp.clamp(min=0).long()], -1)
    return h, idx, sd.contiguous(), si.to(torch.int32).contiguous()


def _level_fetches(idx, l):
    from hnsw_slim_tpu_torch.graph import search as gs

    g = idx.graph
    chal = gs.chal_fetch(g.nbr, g.lvl_off, l, g.cap if l else g.cap0)
    if l == 0:
        return {"chal": chal, "dense": gs.dense_fetch(idx.dense0)}
    return {"chal": chal,
            "rank": gs.rank_fetch(idx.rank_up, idx.dense_up[l - 1])}


def test_fetch_forms_on_card(data, slim_index):
    """Kβ at level 0 and Kε at level 1 over every fetch form: each kernel
    agrees with its plain version (>= 99%) and gives exactly the same
    result whatever the form."""
    from hnsw_slim_tpu_torch.config import SearchConfig
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.ops import cuda

    x, xn, q = data
    _, idx, sd, si = slim_index
    qn = (q * q).sum(1)
    kw = dict(P=64, ef_eff=64, pop_width=8,
              cw=gs.cand_width(64, 8, idx.graph.cap0, 0),
              max_iters=SearchConfig(ef=64, pop_width=8).iters(), k=10)
    cuda.reset_launches()
    outs = {}
    for name, f in _level_fetches(idx, 0).items():
        kd, ki, kh, kc = gs.beam_search(x, q, qn, f, sd, si, **kw)
        pd, pi, ph, pc = gs.beam_search_plain(x, q, qn, f, sd, si, **kw)
        assert (ki == pi).float().mean() >= 0.99, name
        assert _close(kd[ki == pi], pd[ki == pi])
        outs[name] = (ki, kh, kc)
    assert torch.equal(outs["chal"][0], outs["dense"][0])
    assert torch.equal(outs["chal"][1], outs["dense"][1])
    assert torch.equal(outs["chal"][2], outs["dense"][2])
    assert cuda.launches["beam_search.chal"] == 1
    cur0, dist0 = gs.entry_dist(x, xn, q, qn, idx.graph.entry)
    res = {}
    for name, f in _level_fetches(idx, 1).items():
        kc_, kd_, kh_, _ = gs.greedy_descent(x, q, qn, f, cur0, dist0)
        pc_, pd_, ph_, _ = gs.greedy_descent_plain(x, q, qn, f, cur0, dist0)
        same = kc_ == pc_
        assert same.float().mean() >= 0.99, name
        assert _close(kd_[same], pd_[same])
        assert (kh_[same] == ph_[same]).all()
        res[name] = kc_
    assert torch.equal(res["chal"], res["rank"])
    assert cuda.launches["greedy_descent.chal"] == 1
    assert cuda.launches["greedy_descent.rank"] == 1


@pytest.mark.parametrize("share", [0.5, 0.1])
def test_filtered_beam_on_card(data, slim_index, share):
    """Kβ's filtered mode against its plain version at 50% and 10% allowed:
    track ids equal on >= 99% of slots, hops equal on >= 99% of queries,
    every id allowed."""
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index.hnsw import filter_iters

    x, _, q = data
    _, idx, sd, si = slim_index
    qn = (q * q).sum(1)
    g = torch.Generator(device="cuda").manual_seed(4)
    allowed = torch.rand(len(x), generator=g, device="cuda") < share
    trk = gs.filter_track_init(allowed, si[:, 0], sd[:, 0], 64)
    kw = dict(P=64, ef_eff=64, pop_width=8,
              cw=gs.cand_width(64, 8, idx.graph.cap0, 0),
              max_iters=filter_iters(24, allowed.cpu().numpy()), k=10,
              allowed=allowed, track_d=trk[0], track_id=trk[1])
    k_out = gs.beam_search(x, q, qn, idx.dense0, sd, si, **kw)
    p_out = gs.beam_search_plain(x, q, qn, idx.dense0, sd, si, **kw)
    ki, pi = k_out[5], p_out[5]
    assert (ki == pi).float().mean() >= 0.99
    assert (k_out[2] == p_out[2]).float().mean() >= 0.99
    fin = (ki == pi) & torch.isfinite(p_out[4])
    assert _close(k_out[4][fin], p_out[4][fin])
    assert allowed[ki[ki >= 0].long()].all()
    assert (ki[:, :10] >= 0).all()


@pytest.mark.parametrize("strata", [2, 4])
def test_strata_seeds_on_card(data, slim_index, strata):
    """Kα's strata mode against its plain version: ids equal on >= 99% of
    slots, distances close."""
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    _, _, q = data
    _, idx, _, _ = slim_index
    up_vecs, up_vn, up_ids = idx._seed_table()
    kd, ki = bf.topk_dist_strata(q, up_vecs, up_vn, up_ids, 32, strata)
    pd, pi = bf.topk_dist_strata_plain(q, up_vecs, up_vn, up_ids, 32, strata)
    assert kd.shape == pd.shape == (len(q), 32)
    assert (ki == pi).float().mean() >= 0.99
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin) and _close(kd[fin], pd[fin])


def test_guarded_prune_on_card(data, slim_index):
    """Kγ's guarded mode against its plain version on the level-0 rows of
    the unpruned graph with random guards and budgets: rows and counts equal
    on >= 99% of rows; some rows keep more than their budget."""
    from hnsw_slim_tpu_torch.graph import heuristic as th

    x, xn, _ = data
    h, _, _, _ = slim_index
    g = torch.Generator(device="cuda").manual_seed(2)
    base = torch.randperm(len(x), generator=g, device="cuda")[:4096]
    cand = h.graph.adjs[0][base].contiguous()
    guard = torch.rand(cand.shape, generator=g, device="cuda") < 0.3
    m = torch.randint(1, 9, (len(base),), generator=g, device="cuda",
                      dtype=torch.int32)
    w = cand.shape[1]
    args = (x, xn, base.to(torch.int32), cand, cand >= 0, guard)
    ks, kc = th.prune_batch_guarded(*args, M=w, out_width=w, m_per_row=m)
    ps, pc = th.rng_prune_plain(
        x, xn, base.to(torch.int32), cand, m, keep_all_under_m=False,
        keep_pruned=False, out_width=w, guard=guard)
    assert (ks == ps).all(1).float().mean() >= 0.99
    assert (kc == pc).float().mean() >= 0.99
    assert (kc > m).any()


def test_query_surface_on_card(data, slim_index):
    """Through the entry points: identical ids over the three serving
    layouts (seeded and greedy), filtered results all allowed and full,
    search_async equal to search, a SlimZero conversion that passes
    check_integrity and serves."""
    import dataclasses

    from hnsw_slim_tpu_torch.config import SearchConfig, SlimConfig
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.index.slimzero import HnswSlimZeroIndex

    x, _, q = data
    h, idx, _, _ = slim_index
    qs = q.cpu().numpy()
    for seed_width in (32, 0):
        scfg = SearchConfig(ef=64, pop_width=8, seed_width=seed_width)
        outs = []
        for layout in ("chal", "dense0", "dense"):
            v = HnswSlimIndex(metric="l2", search_cfg=scfg, device="cuda")
            v.graph, v.vectors, v.vn = idx.graph, idx.vectors, idx.vn
            if layout != "chal":
                v.dense0 = idx.dense0
            if layout == "dense":
                v.dense_up, v.rank_up = idx.dense_up, idx.rank_up
            outs.append(v.search(qs, 10)[1])
        assert (outs[0] == outs[1]).all() and (outs[0] == outs[2]).all()
    idx.scfg = SearchConfig(ef=64, pop_width=8, seed_width=32)
    mask = np.random.default_rng(0).random(len(x)) < 0.1
    for engine in (idx, h):
        engine.scfg = dataclasses.replace(engine.scfg, ef=64)
        _, ids = engine.search(qs, 10, filter_mask=mask)
        assert (ids >= 0).all() and mask[ids].all()
    d, ids = idx.search(qs, 10)
    ad, ai, _, _ = idx.search_async(qs, 10)
    assert (ai.cpu().numpy() == ids).all() and (ad.cpu().numpy() == d).all()
    z = HnswSlimZeroIndex.from_hnsw(h, SlimConfig.from_ratios(),
                                    search_cfg=idx.scfg)
    assert z.check_integrity()["edges"] > 0
    z.densify_level0()
    _, zi = z.search(qs, 10)
    assert ((zi >= 0) & (zi < len(x))).all()


# ---- SlimQ: the rotator, the quantized scorers, the rerank track


def test_fht_rotate_kernel_matches_plain(data):
    """Kη vs its plain version at dim 128 and at a padded dim (100 -> 128):
    bit-equal (same butterfly order, one rounded operation per element and
    stage); the g_add table and sumq within 1e-5 * (1 + |v|)."""
    from hnsw_slim_tpu_torch.quant import rotator as rt

    x, _, q = data
    for dim in (128, 100):
        rot = rt.FhtKacRotator(dim, seed=3, device="cuda")
        xs = x[:4099, :dim].contiguous()
        got = rt.fht_rotate(xs, rot.signs, rot.fac)
        want = rt._rotate(torch.nn.functional.pad(xs, (0, 128 - dim)),
                          rot.signs, rot.fac)
        assert got.shape == want.shape == (4099, 128)
        assert torch.equal(got, want)
    q_rot = rot.rotate(q[:, :100])
    cent = rot.rotate(x[:16, :100])
    for metric in ("l2", "ip"):
        ks, kg = rt.g_tables(q_rot, cent, metric)
        ps, pg = rt.g_tables_plain(q_rot, cent, metric)
        assert ((ks - ps).abs() <= 1e-5 * (1 + ps.abs())).all()
        assert ((kg - pg).abs() <= 1e-5 * (1 + pg.abs())).all()


def test_kmeans_assign_on_card(data):
    """K18 on Kα (k = 1, a 16-row table): equal to the plain version on
    >= 0.999 of rows."""
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.quant import kmeans as km

    x, _, _ = data
    cent = x[::1250].contiguous()
    assert cent.shape[0] == 16
    got = km._assign(x, cent)
    want = bf.topk_dist_plain(x, cent, (cent * cent).sum(1), 1)[1][:, 0]
    assert (got == want.long()).float().mean() >= 0.999


@pytest.fixture(scope="module")
def slimq_index(data):
    """A SlimQ index of the 20k vectors built on the card (4 bits) with both
    dense layouts, and the launches its build made."""
    from hnsw_slim_tpu_torch.config import HnswConfig, QuantConfig
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu_torch.ops import cuda

    x, _, _ = data
    cuda.reset_launches()
    idx = HnswSlimQIndex.build(
        x.cpu().numpy(), hnsw_cfg=HnswConfig(M=16, ef_construction=64),
        quant_cfg=QuantConfig(total_bits=4), device="cuda")
    launched = dict(cuda.launches)
    idx.densify_level0()
    idx.densify_upper()
    return idx, launched


def _scorer(idx, q, use_ex):
    from hnsw_slim_tpu_torch.quant.estimator import QuantScorer
    from hnsw_slim_tpu_torch.quant.rotator import g_tables

    q_rot = idx.rotator.rotate(q)
    sumq, g_add = g_tables(q_rot, idx.centroids_rot)
    c = idx.codes
    return QuantScorer(idx._packed_rows(), int(c.bin_code.shape[1]),
                       int(c.ex_bits), use_ex, q_rot, sumq, g_add)


def _est_close(a, b):
    return bool(((a - b).abs() <= 1e-4 * (1 + b.abs())).all())


def test_slimq_build_on_card(data, slimq_index):
    """The build goes through Kη and K18's Kα; codes equal the host
    quantizer's on the kernel-rotated rows."""
    idx, launched = slimq_index
    x, _, _ = data
    assert launched["fht_rotate"] > 0 and launched["topk_dist"] > 0
    assert idx.index_size() < 0.35 * x.numel() * 4
    assert set(idx.build_stats) == {"hnsw_s", "convert_s", "kmeans_s",
                                    "rotate_s", "quantize_s"}


@pytest.mark.parametrize("use_ex", [False, True])
def test_quant_estimate_kernels_match_plain(data, slimq_index, use_ex):
    """The scorer in Kε (greedy descent on estimates over rank and CHAL
    rows, the kernel scoring the entry point itself; with no query active
    the entry's estimate alone) and in Kα's estimate mode, each against its
    plain version."""
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.quant import estimator as est

    _, _, q = data
    idx, _ = slimq_index
    sc = _scorer(idx, q, use_ex)
    cur = torch.full((len(q),), idx.graph.entry, dtype=torch.int32,
                     device="cuda")
    dist = est.packed_estimate_plain(sc, cur[:, None])[:, 0]
    idle = torch.zeros(len(q), dtype=torch.bool, device="cuda")
    res = {}
    for name, f in _level_fetches(idx, 1).items():
        ec, ed, eh, en = gs.greedy_descent(None, None, None, f, cur, None,
                                           idle, scorer=sc)
        assert torch.equal(ec, cur) and _est_close(ed, dist)
        assert not eh.any() and not en.any()
        kc, kd, kh, kn = gs.greedy_descent(None, None, None, f, cur, None,
                                           scorer=sc)
        pc, pd, ph, pn = gs.greedy_descent_plain(None, None, None, f, cur,
                                                 None, scorer=sc)
        same = kc == pc
        assert same.float().mean() >= 0.99, name
        assert _est_close(kd[same], pd[same])
        assert (kh[same] == ph[same]).all()
        gc, gd, _, _ = gs.greedy_descent(None, None, None, f, cur, ed,
                                         scorer=sc)
        assert torch.equal(gc, kc) and torch.equal(gd, kd)
        res[name] = kc
    assert torch.equal(res["chal"], res["rank"])
    rows, up_ids = idx._seed_table()
    st = sc._replace(rows=rows)
    kd, kp = bf.topk_estimate(st, up_ids, 32)
    pd, pp = bf.topk_estimate_plain(st, up_ids, 32)
    assert (kp == pp).float().mean() >= 0.99
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin) and _est_close(kd[fin], pd[fin])


@pytest.mark.parametrize("use_ex,pop,ef", [(False, 8, 64), (True, 8, 64),
                                           (False, 1, 32), (False, 16, 320)])
def test_quant_beam_kernel_matches_plain(data, slimq_index, use_ex, pop, ef):
    """Kβ's quantized mode with the rerank track against its plain version,
    seeded as the SlimQ search seeds it: buffer ids and track ids equal on
    >= 99% of slots, track distances the true ones, hops equal on >= 99% of
    queries; without the track the same buffer."""
    from hnsw_slim_tpu_torch.config import SearchConfig
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    x, _, q = data
    idx, _ = slimq_index
    sc = _scorer(idx, q, use_ex)
    rows, up_ids = idx._seed_table()
    sd, sp = bf.topk_estimate_plain(sc._replace(rows=rows), up_ids, 32)
    si = torch.where(sp >= 0, up_ids[sp.clamp(min=0).long()], -1)
    si = si.to(torch.int32).contiguous()
    P = gs.bitonic_buffer_width(ef) if ef == 320 else ef
    kw = dict(P=P, ef_eff=ef, pop_width=pop,
              cw=gs.cand_width(P, pop, idx.graph.cap0, 0),
              max_iters=SearchConfig(ef=ef, pop_width=pop).iters(), k=P,
              scorer=sc)
    args = (None, None, None, idx.dense0, sd.contiguous(), si)
    track = gs.pop_track_init(x, q, 16)
    k_o = gs.beam_search(*args, **kw, pop_track=track)
    p_o = gs.beam_search_plain(*args, **kw, pop_track=track)
    assert (k_o[1] == p_o[1]).float().mean() >= 0.99
    assert (k_o[2] == p_o[2]).float().mean() >= 0.99
    kt, pt = k_o[4], p_o[4]
    assert (kt.ids == pt.ids).float().mean() >= 0.99
    ok = kt.ids >= 0
    true_d = ((q[:, None, :] - x[kt.ids.clamp(min=0).long()]) ** 2).sum(-1)
    assert _close(kt.d[ok], true_d[ok])
    assert (kt.d[:, 1:] >= kt.d[:, :-1]).all()
    n_o = gs.beam_search(*args, **kw)
    assert len(n_o) == 4 and torch.equal(n_o[1], k_o[1])
    # the CHAL form gives the same result as the dense rows
    c_o = gs.beam_search(None, None, None, _level_fetches(idx, 0)["chal"],
                         sd.contiguous(), si, **kw, pop_track=track)
    assert torch.equal(c_o[1], k_o[1]) and torch.equal(c_o[4].ids, kt.ids)


def test_slimq_search_on_card(data, slimq_index):
    """Through the entry points: every mode launched, rerank distances the
    true ones, identical ids with and without the dense layouts, a
    save_slimq -> load_slimq round trip with identical ids."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from hnsw_slim_tpu_torch.config import SearchConfig
    from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.persist.checkpoint import load_slimq, save_slimq

    x, _, q = data
    idx, _ = slimq_index
    qs, xs = q.cpu().numpy(), x.cpu().numpy()
    cuda.reset_launches()
    outs = {}
    for seed_width in (32, 0):
        for use_ex in (False, True):
            idx.scfg = SearchConfig(ef=64, pop_width=8, seed_width=seed_width,
                                    use_ex=use_ex)
            d, ids = idx.search(qs, 10)
            assert ((ids >= 0) & (ids < len(xs))).all()
            true_d = ((qs[:, None, :] - xs[ids]) ** 2).sum(-1)
            assert np.allclose(d, true_d, rtol=1e-3, atol=1e-3)
            outs[(seed_width, use_ex)] = ids
            _, e_ids = idx.search(qs, 10, rerank=False)
            assert ((e_ids >= 0) & (e_ids < len(xs))).all()
    for mode in ("topk_dist.estimate", "beam_search.quant",
                 "beam_search.quant_ex", "beam_search.rerank",
                 "greedy_descent.quant", "fht_rotate",
                 "fht_rotate.g_tables"):
        assert cuda.launches[mode] > 0, mode
    bare = HnswSlimQIndex(search_cfg=idx.scfg, device="cuda")
    for f in ("graph", "codes", "rotator", "cluster_ids", "centroids_rot",
              "dataset"):
        setattr(bare, f, getattr(idx, f))
    assert (bare.search(qs, 10)[1] == outs[(0, True)]).all()
    with tempfile.TemporaryDirectory() as tmp:
        save_slimq(Path(tmp) / "q.npz", idx)
        back = load_slimq(Path(tmp) / "q.npz",
                          search_cfg=dataclasses.replace(idx.scfg))
    back.set_dataset(xs)
    assert (back.search(qs, 10)[1] == outs[(0, True)]).all()


# ---- the update path: Kθ row_deg, Kι kv_sort (Kκ's ids map), collect-mode
# applies


@pytest.mark.parametrize("n,cap", [(0, 60), (1, 60), (1000, 30), (4097, 60),
                                   (20000, 7), (3, 100)])
def test_row_deg_kernel_matches_plain(n, cap):
    """Kθ against (a >= 0).sum(1): integers, exactly equal; rows with
    holes, empty rows, widths below and above a warp."""
    from hnsw_slim_tpu_torch.index import hnsw as thnsw

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(n + cap)
    a = torch.randint(-1, 1000, (n, cap), generator=g, device="cuda",
                      dtype=torch.int32)
    a[torch.rand((n, cap), generator=g, device="cuda") < 0.3] = -1
    if n > 1:
        a[0], a[1] = -1, 5
    got = thnsw._row_deg(a)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, thnsw.row_deg_plain(a))


@pytest.mark.parametrize("e", [0, 1, 2, 777, 4096, 4097, 30000, 122880,
                               300001])
@pytest.mark.parametrize("keys", ["ties", "equal", "padding", "spread",
                                  "negative"])
def test_kv_sort_kernel_matches_plain(e, keys):
    """Kι (Kκ's ids map with n, its signed map without) against
    torch.sort(stable=True): keys and payload exactly equal for sizes that
    are 0, 1, a tile, not a power of two and beyond one tile, with many
    ties, all keys equal, all keys the 2^30 padding, keys spread over
    [0, 2^30] and negative keys (signed map only); and the key-only
    form."""
    from hnsw_slim_tpu_torch.graph import revconn

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(e)
    hi = {"ties": 40, "spread": revconn.BIG + 1}.get(keys, 2)
    u = torch.randint(0, hi, (e,), generator=g, device="cuda",
                      dtype=torch.int32)
    if keys == "ties":
        u[torch.rand((e,), generator=g, device="cuda") < 0.25] = revconn.BIG
    elif keys == "equal":
        u.fill_(7)
    elif keys == "padding":
        u.fill_(revconn.BIG)
    elif keys == "negative":
        u = u * -2000000000 + torch.randint(-5, 5, (e,), generator=g,
                                            device="cuda", dtype=torch.int32)
    p = torch.randint(0, 10**6, (e,), generator=g, device="cuda",
                      dtype=torch.int32)
    # the node count the ids map is given: ids below it, 2^30 the padding
    n = {"ties": 40, "equal": 8, "padding": 2, "spread": revconn.BIG}.get(keys)
    pu, pp = revconn.kv_sort_plain(u, p)
    for n_ in (None, n) if n else (None,):
        ku, kp = revconn.kv_sort(u, p, n_)
        k_only, none = revconn.kv_sort(u, None, n_)
        torch.cuda.synchronize()
        assert torch.equal(ku, pu) and torch.equal(kp, pp), n_
        assert torch.equal(k_only, pu) and none is None, n_


@pytest.mark.parametrize("case", ["equal", "descending", "odd_offset",
                                  "ids_padding"])
@pytest.mark.parametrize("with_payload", [True, False])
def test_radix_sort_maps_match_torch_sort(case, with_payload):
    """Kκ's u32, signed, f32 and ids maps, with payload and key-only, at
    2^21 + 3 elements (257 tiles, the last one partial) against
    torch.sort(stable=True) + gather, exactly equal: all keys equal (one
    digit run through every tile: the longest look-back chain), strictly
    descending keys, views at an odd element offset (no 16-byte aligned
    start), and ids below N = 10^6 with a 25% share of 2^30 padding."""
    from hnsw_slim_tpu_torch.ops import sort

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    e = 2**21 + 3
    g = torch.Generator(device="cuda").manual_seed(e)

    def rand(lo, hi, size=e):
        return torch.randint(lo, hi, (size,), generator=g, device="cuda",
                             dtype=torch.int32)

    p = rand(0, 10**6, e + 3)[3:] if case == "odd_offset" else rand(0, 10**6)
    if case == "equal":
        runs = [(torch.full((e,), 12345, dtype=torch.int32, device="cuda"),
                 m, b) for m, b in (("u32", 14), ("signed", 32),
                                    ("ids", 20))]
    elif case == "descending":
        desc = torch.arange(e - 1, -1, -1, dtype=torch.int32, device="cuda")
        runs = [(desc, "u32", 22), (desc - e // 2, "signed", 32),
                (desc, "ids", e.bit_length()),
                (desc.float() / 7 - 1000, "f32", 32)]
    elif case == "odd_offset":
        w = rand(-(2**31), 2**31 - 1, e + 1)[1:]
        f = (rand(-50, 50, e + 1).float() / 4)[1:]
        runs = [(w, "u32", 32), (w, "signed", 32), (f, "f32", 32)]
    else:
        ids = rand(0, 10**6)
        ids[torch.rand((e,), generator=g, device="cuda") < 0.25] = 2**30
        runs = [(ids, "ids", (10**6).bit_length())]
    pay = p if with_payload else None
    for keys, key_map, bits in runs:
        assert keys.is_contiguous() and p.is_contiguous()
        ku, kp = sort.kv_radix_sort(keys, pay, bits, key_map=key_map)
        torch.cuda.synchronize()
        pu, pp = sort.kv_radix_sort_plain(keys, pay, bits, key_map=key_map)
        assert torch.equal(ku.view(torch.int32), pu.view(torch.int32)), \
            key_map
        if with_payload:
            assert torch.equal(kp, pp), key_map
        else:
            assert kp is None


def test_collect_mode_apply_matches_plain(data, insert_index):
    """One level-0 apply in collect mode (of_t 16384, new_w 32) into the
    20k graph, its reverse edges crowded onto 2000 targets so that their
    rows overflow: Kζ and Kγ
    through apply_insert against the plain versions on copies of the same
    state: adjacency, degrees and both counters exactly equal."""
    from hnsw_slim_tpu_torch.graph import heuristic, revconn
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index.hnsw import _row_deg
    from hnsw_slim_tpu_torch.ops import cuda

    x, xn, _ = data
    h, _ = insert_index
    n = h.graph.n
    a_ids = torch.arange(n - 1000, n, dtype=torch.int32, device="cuda")
    # candidates among 2000 nodes only, so that their rows overflow
    _, cand = bf.topk_dist(x[n - 1000:], x[:2000].contiguous(),
                           xn[:2000].contiguous(), 64)
    cand = cand.to(torch.int32).contiguous()
    kw = dict(M=h.cfg.M, cap=h.cfg.maxM0, metric="l2", of_t=16384, new_w=32)
    adj_k = h.graph.adjs[0].clone()
    adj_k[n - 1000:] = -1
    adj_k[(adj_k >= n - 1000)] = -1
    from hnsw_slim_tpu_torch.graph.build import _compact_rows
    adj_k = torch.as_tensor(_compact_rows(adj_k.cpu().numpy()), device="cuda")
    adj_p = adj_k.clone()
    deg_k, deg_p = _row_deg(adj_k), _row_deg(adj_p)
    cuda.reset_launches()
    ek, tk = revconn.apply_insert(adj_k, deg_k, x, xn, a_ids, cand, **kw)
    # one Kι sort (the reverse edges); Kζ's append + settle and write-back
    assert cuda.launches["radix_sort.ids"] == 1
    assert cuda.launches["rev_connect"] == 2
    names = ("rng_prune", "kv_sort", "append_overflow", "write_rows")
    real = {k: getattr(revconn, k) for k in names}
    plain = dict(
        rng_prune=lambda *a, m_max=None, **k: heuristic.rng_prune_plain(
            *a, **k),
        kv_sort=revconn.kv_sort_plain,
        append_overflow=revconn.append_overflow_plain,
        write_rows=revconn.write_rows_plain)
    try:
        for k, v in plain.items():
            setattr(revconn, k, v)
        ep, tp = revconn.apply_insert(adj_p, deg_p, x, xn, a_ids, cand, **kw)
    finally:
        for k, v in real.items():
            setattr(revconn, k, v)
    assert int(ek) > 0 and int(tk) > 100
    assert (int(ek), int(tk)) == (int(ep), int(tp))
    same = (adj_k == adj_p).all(dim=1)
    assert same.float().mean() >= 0.999  # a near-tie may keep another id
    assert torch.equal(deg_k[same], deg_p[same])
    assert torch.equal(deg_k, _row_deg(adj_k))


def test_add_points_and_update_round_on_card(data):
    """One add_points + IncrementalSlim.update round at 20k points on the
    card: the update path launches Kθ, Kι, Kζ, Kγ, Kβ and Kε, the mirror
    equals the device graph, the incremental graph equals a fresh
    convert_to_slim, the patch applies onto a client copy, and the new
    points are found."""
    from hnsw_slim_tpu_torch.config import (HnswConfig, SearchConfig,
                                            SlimConfig)
    from hnsw_slim_tpu_torch.graph.incremental import IncrementalSlim
    from hnsw_slim_tpu_torch.graph.prune import convert_to_slim
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.persist import patch as tpatch

    x, _, _ = data
    base = x.cpu().numpy()
    h = HnswIndex(HnswConfig(M=16, ef_construction=64), strategy="insert",
                  device="cuda")
    h.build(base[:19000])
    scfg = SlimConfig.from_ratios()
    inc = IncrementalSlim(scfg)

    def args():
        return (h.host_adj(), h.levels, int(h.graph.entry), h.vectors, h.vn)

    g0 = inc.full(*args())
    cuda.reset_launches()
    touched = h.add_points(base[19000:])
    g1, changed = inc.update(*args(), touched=touched)
    torch.cuda.synchronize()
    for name in ("row_deg", "radix_sort.ids", "rev_connect", "rng_prune",
                 "beam_search", "greedy_descent"):
        assert cuda.launches[name] > 0, name
    assert h.graph.n == 20000 and h.graph.level.shape[0] == 32768
    for m, dv in zip(h.host_adj(), h.graph.adjs):
        assert np.array_equal(m, dv.cpu().numpy())
    h.check_integrity()
    assert h.last_update_stats["overflow"]["truncated_applies"] == 0
    fresh = convert_to_slim(h.graph, h.vectors, h.vn, scfg)
    cf, ci = tpatch.to_np(fresh), inc.host_chal
    for l in range(fresh.max_level + 1):
        cap_l = fresh.cap0 if l == 0 else fresh.cap
        a = tpatch._level_rows(cf, l, 20000, cap_l)
        b = tpatch._level_rows(ci, l, 20000, cap_l)
        assert (a == b).all(axis=1).mean() >= 0.999, l
    old = [int(v) for v in changed if v < 19000]
    w = tpatch.PatchWriter(g1, old, list(range(19000, 20000)), vectors=base,
                           host_chal=inc.host_chal)
    blob, finished = w.next_chunk()
    client, vecs = tpatch.apply_patch(g0, blob, base[:19000].copy())
    assert finished and client.n == 20000 and np.array_equal(vecs, base)
    cc = tpatch.to_np(client)
    for l in range(g1.max_level + 1):
        cap_l = g1.cap0 if l == 0 else g1.cap
        assert np.array_equal(tpatch._level_rows(cc, l, 20000, cap_l),
                              tpatch._level_rows(ci, l, 20000, cap_l))
    s = HnswSlimIndex(search_cfg=SearchConfig(ef=64, pop_width=8,
                                              seed_width=32), device="cuda")
    s.graph, s.vectors, s.vn, s.host_chal = g1, h.vectors, h.vn, ci
    _, ids = s.search(base[19000:], 1)
    assert (ids[:, 0] == np.arange(19000, 20000)).mean() >= 0.9


# ---- K1, K19, bfloat16 store rows, union and sharded serving


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_point_dist_kernel_matches_plain(data, dtype, metric):
    """K1 against its plain version: rows by id from the store (a negative
    id gives +inf), with and without stored norms, rows already gathered,
    the rowwise difference form, and an odd width (no 4-wide loads); the
    bf16 mode counts only bf16 launches."""
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.ops import distance as dist

    x, _, q = data
    xs = x.to(getattr(torch, dtype))
    xn = dist.sq_norms(xs)
    g = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(-1, len(x), (len(q), 9), generator=g, device="cuda",
                        dtype=torch.int32)
    fin = ids >= 0
    cuda.reset_launches()
    for vn in (xn, None):
        kd = dist.gathered_dist(q, xs, metric, vn=vn, ids=ids)
        pd = dist.gathered_dist_plain(q, xs, metric, vn=vn, ids=ids)
        assert torch.equal(torch.isinf(kd), ~fin)
        assert _close(kd[fin], pd[fin])
    rows = xs[ids.clamp(min=0).long()]
    assert _close(dist.gathered_dist(q, rows, metric)[fin],
                  dist.gathered_dist_plain(q, rows, metric)[fin])
    b = xs[:len(q)]
    assert _close(dist.point_dist(q, b, metric),
                  dist.point_dist_plain(q, b, metric))
    q98, x98 = q[:, :98].contiguous(), xs[:, :98].contiguous()
    assert _close(dist.gathered_dist(q98, x98, metric, ids=ids)[fin],
                  dist.gathered_dist_plain(q98, x98, metric, ids=ids)[fin])
    assert cuda.launches["point_dist"] == 5
    assert cuda.launches["point_dist.bf16"] == 5 * (dtype == "bfloat16")


@pytest.mark.parametrize("s,k,ties", [(1, 8, True), (4, 10, True),
                                      (4, 10, False), (16, 5, True),
                                      (32, 16, False)])
def test_shard_merge_kernel_matches_plain(s, k, ties):
    """K19 against its plain version (a stable sort of the shard-major
    concatenation) on adversarial lists: ties within and across shards, -1
    ids with +inf tails, padded gids (-1) inside lists, an all-inf row;
    per-shard gid tables, and one flat table over a [B, S, k] layout
    permuted without a copy: exactly equal."""
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.parallel.merge import merge_topk, merge_topk_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(s * 100 + k)
    b, n_per = 3000, 500
    if ties:
        d = rng.integers(0, 6, (s, b, k)).astype(np.float32) / 4
    else:
        d = rng.random((s, b, k)).astype(np.float32)
    d = np.sort(d, axis=2)
    ids = rng.integers(0, n_per, (s, b, k)).astype(np.int32)
    cut = np.where(rng.random((s, b)) < 0.3, rng.integers(0, k, (s, b)), k)
    tail = np.arange(k)[None, None, :] >= cut[:, :, None]
    ids[tail], d[tail] = -1, np.inf
    ids[:, 0], d[:, 0] = -1, np.inf
    gid = np.arange(s * n_per, dtype=np.int32).reshape(s, n_per)
    gid[rng.random((s, n_per)) < 0.1] = -1
    hops = rng.integers(0, 100, (s, b)).astype(np.int32)
    dcomp = rng.integers(0, 1000, (s, b)).astype(np.int32)
    dev = [torch.as_tensor(a, device="cuda") for a in (d, ids, gid, hops,
                                                       dcomp)]
    cuda.reset_launches()
    got = merge_topk(*dev)
    want = merge_topk_plain(*dev)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    flat = dev[2].reshape(-1)
    fids = torch.where(dev[1] >= 0, dev[1] + (torch.arange(
        s, device="cuda", dtype=torch.int32) * n_per)[:, None, None], -1)
    qd = dev[0].permute(1, 0, 2).contiguous().permute(1, 0, 2)
    qi = fids.permute(1, 0, 2).contiguous().permute(1, 0, 2)
    qh = dev[3].T.contiguous().T
    qc = dev[4].T.contiguous().T
    got = merge_topk(qd, qi, flat, qh, qc)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert cuda.launches["shard_merge"] == 2


@pytest.fixture(scope="module")
def bf16_index(data):
    """An insertion-built HnswIndex of the 20k vectors with a bfloat16
    store, its Slim conversion with both dense layouts, and the launches
    the conversion made."""
    from hnsw_slim_tpu_torch.config import HnswConfig, SlimConfig
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.ops import cuda

    x, _, _ = data
    h = HnswIndex(HnswConfig(M=16, ef_construction=64,
                             store_dtype="bfloat16"), strategy="insert",
                  device="cuda")
    h.build(x.cpu().numpy())
    cuda.reset_launches()
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    torch.cuda.synchronize()
    launched = dict(cuda.launches)
    idx.densify_level0()
    idx.densify_upper()
    return h, idx, launched


def test_bf16_store_serves_on_card(data, insert_index, bf16_index):
    """The bfloat16 store: rows rounded to nearest even, half the bytes,
    the vanilla graph equal to the fp32 build's on >= 99% of rows (it is
    built from the fp32 rows), a conversion through Kγ's bf16 mode, and
    vanilla and seeded Slim recall@10 at ef=64 within 0.02 of the fp32
    index's."""
    from hnsw_slim_tpu_torch.config import SearchConfig
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    x, xn, q = data
    hf, _ = insert_index
    h, idx, launched = bf16_index
    assert h.vectors.dtype == torch.bfloat16
    assert torch.equal(h.vectors, x.to(torch.bfloat16))
    assert 2 * h.vectors.nbytes == hf.vectors.nbytes
    rows = [(a == b).all(1).float().mean() for a, b in
            zip(h.graph.adjs, hf.graph.adjs)]
    assert min(rows) >= 0.99, rows
    assert launched["rng_prune.bf16"] > 0 and launched["rng_prune"] > 0
    _, gt = bf.topk_dist_plain(q, x, xn, 10)
    gt = gt.cpu().numpy()
    qs = q.cpu().numpy()

    def rec(ids):
        return sum(len(set(a) & set(b)) for a, b in zip(ids, gt)) / gt.size

    for eng, scfg in ((h, SearchConfig(ef=64, pop_width=4)),
                      (idx, SearchConfig(ef=64, pop_width=8, seed_width=32))):
        eng.scfg = scfg
        r16 = rec(eng.search(qs, 10)[1])
        hf.scfg = SearchConfig(ef=64, pop_width=4)
        assert r16 >= rec(hf.search(qs, 10)[1]) - 0.02 and r16 >= 0.9


def test_bf16_modes_match_plain(data, bf16_index):
    """Kα (exact and strata), Kβ (dense and CHAL rows, filtered), Kε (each
    level) and Kγ (plain and guarded) over bfloat16 store rows against
    their plain versions: ids equal on >= 99% of slots, distances within
    1e-4 * (1 + |d|); each launch counted in the kernel's bf16 mode."""
    from hnsw_slim_tpu_torch.config import SearchConfig
    from hnsw_slim_tpu_torch.graph import heuristic as th
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.ops import cuda

    _, _, q = data
    h, idx, _ = bf16_index
    x, xn = h.vectors, h.vn
    qn = (q * q).sum(1)
    cuda.reset_launches()
    kd, ki = bf.topk_dist(q, x, xn, 10)
    pd, pi = bf.topk_dist_plain(q, x, xn, 10)
    assert (ki == pi).float().mean() >= 0.99 and _close(kd, pd)
    up_vecs, up_vn, up_ids = idx._seed_table()
    assert up_vecs.dtype == torch.bfloat16
    kd, ki = bf.topk_dist_strata(q, up_vecs, up_vn, up_ids, 32, 4)
    pd, pi = bf.topk_dist_strata_plain(q, up_vecs, up_vn, up_ids, 32, 4)
    fin = torch.isfinite(pd)
    assert (ki == pi).float().mean() >= 0.99
    assert torch.equal(torch.isfinite(kd), fin) and _close(kd[fin], pd[fin])
    sd, sp = bf.topk_dist_plain(q, up_vecs, up_vn, 32, row_ids=up_ids)
    si = torch.where(sp >= 0, up_ids[sp.clamp(min=0).long()], -1)
    si = si.to(torch.int32).contiguous()
    kw = dict(P=64, ef_eff=64, pop_width=8,
              cw=gs.cand_width(64, 8, idx.graph.cap0, 0),
              max_iters=SearchConfig(ef=64, pop_width=8).iters(), k=10)
    g = idx.graph
    for f in (gs.dense_fetch(idx.dense0),
              gs.chal_fetch(g.nbr, g.lvl_off, 0, g.cap0)):
        kd, ki, kh, _ = gs.beam_search(x, q, qn, f, sd.contiguous(), si, **kw)
        pd, pi, ph, _ = gs.beam_search_plain(x, q, qn, f, sd.contiguous(), si,
                                             **kw)
        assert (ki == pi).float().mean() >= 0.99
        assert _close(kd[ki == pi], pd[ki == pi])
    allowed = torch.rand(len(x), generator=torch.Generator(
        device="cuda").manual_seed(6), device="cuda") < 0.5
    trk = gs.filter_track_init(allowed, si[:, 0], sd[:, 0], 64)
    fkw = dict(kw, allowed=allowed, track_d=trk[0], track_id=trk[1])
    k_out = gs.beam_search(x, q, qn, idx.dense0, sd.contiguous(), si, **fkw)
    p_out = gs.beam_search_plain(x, q, qn, idx.dense0, sd.contiguous(), si,
                                 **fkw)
    assert (k_out[5] == p_out[5]).float().mean() >= 0.99
    hg = h.graph
    pc, pdist = gs.entry_dist(x, xn, q, qn, hg.entry)
    for l in range(hg.max_level, 0, -1):
        kc, kdist, kh, _ = gs.greedy_descent(x, q, qn, hg.adjs[l], pc, pdist)
        pc, pdist, ph, _ = gs.greedy_descent_plain(x, q, qn, hg.adjs[l], pc,
                                                   pdist)
        same = kc == pc
        assert same.float().mean() >= 0.99, l
        assert _close(kdist[same], pdist[same])
        assert (kh[same] == ph[same]).all()
    gen = torch.Generator(device="cuda").manual_seed(7)
    base = torch.randperm(len(x), generator=gen, device="cuda")[:4096]
    cand = hg.adjs[0][base].contiguous()
    m = torch.randint(1, 9, (len(base),), generator=gen, device="cuda",
                      dtype=torch.int32)
    w = cand.shape[1]
    b32 = base.to(torch.int32)
    for guard in (None, torch.rand(cand.shape, generator=gen,
                                   device="cuda") < 0.3):
        fl = dict(keep_all_under_m=False, keep_pruned=False, out_width=w,
                  guard=guard)
        ks, kc = th.rng_prune(x, xn, b32, cand, m, **fl)
        ps, pc_ = th.rng_prune_plain(x, xn, b32, cand, m, **fl)
        assert (ks == ps).all(1).float().mean() >= 0.99
        assert (kc == pc_).float().mean() >= 0.99
    for mode in ("topk_dist", "beam_search", "greedy_descent", "rng_prune",
                 "point_dist"):
        assert cuda.launches[f"{mode}.bf16"] > 0, mode
    assert cuda.launches["topk_dist.strata"] == 1
    assert cuda.launches["rng_prune.guarded"] == 1


def test_union_and_sharded_on_card(data):
    """Four round-robin shards of the 20k vectors served as a FlatUnionIndex
    (both modes, fp32 and bf16 store) and as a one-card ShardedSlimIndex
    with and without dense layouts: sharded equal to the host merge of the
    per-shard searches and to the union with seed_width 0 (ids on every
    slot but near-ties, effort equal), K19 launched, recall@10 >= 0.9, the
    bf16 union's vectors half the bytes."""
    from hnsw_slim_tpu_torch.config import HnswConfig, SearchConfig, SlimConfig
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.parallel.flat_union import FlatUnionIndex
    from hnsw_slim_tpu_torch.parallel.merge import merge_topk_plain
    from hnsw_slim_tpu_torch.parallel.sharded import ShardedSlimIndex, make_mesh

    x, xn, q = data
    base, qs = x.cpu().numpy(), q.cpu().numpy()
    s = 4
    shards = []
    for si in range(s):
        gids = np.arange(si, len(base), s, dtype=np.int32)
        shards.append((HnswSlimIndex.build(
            base[gids], HnswConfig(M=16, ef_construction=64),
            SlimConfig.from_ratios(), device="cuda"),
            gids))
    _, gt = bf.topk_dist_plain(q, x, xn, 10)
    gt = gt.cpu().numpy()

    def rec(ids):
        return sum(len(set(a) & set(b)) for a, b in zip(ids, gt)) / gt.size

    def same(ia, da, ib, db):
        tie = np.abs(da - db) <= 1e-5 * (1 + np.abs(db))
        return bool(((ia == ib) | tie).all() and tie.all())

    scfg = SearchConfig(ef=64, pop_width=8, seed_width=0)
    u = FlatUnionIndex.from_indexes(shards, search_cfg=scfg, device="cuda")
    u.densify_level0()
    cuda.reset_launches()
    ud, ui = u.search(qs, 10)
    assert cuda.launches["shard_merge"] == 1
    sh = ShardedSlimIndex.from_indexes(make_mesh(s), shards, search_cfg=scfg,
                                       device="cuda")
    sd, si_ = sh.search(qs, 10)
    assert same(si_, sd, ui, ud) and sh.last_stats == u.last_stats
    per = []
    for sub, _ in shards:
        sub.scfg = scfg
        per.append(sub.search_async(qs, 10))
    gid = torch.as_tensor(np.stack([g for _, g in shards]))
    md, mi, mh, mc = merge_topk_plain(
        *(torch.stack([p[f] for p in per]).cpu() for f in range(2)), gid,
        *(torch.stack([p[f] for p in per]).cpu() for f in (2, 3)))
    assert same(si_, sd, mi.numpy(), md.numpy())
    assert sh.last_stats == {"hops": int(mh.sum()),
                             "distance_computations": int(mc.sum())}
    sh.densify_level0()
    sh.densify_upper()
    dd, di = sh.search(qs, 10)
    assert np.array_equal(di, si_) and rec(di) >= 0.9
    # 8 exact seeds a shard: the reference's rule, recall under the
    # greedy merge's (0.85 here at 5000 points a shard)
    u.scfg = SearchConfig(ef=64, pop_width=8, seed_width=32)
    assert rec(u.search(qs, 10)[1]) >= 0.8
    ub = FlatUnionIndex.from_indexes(shards, search_cfg=u.scfg,
                                     store_dtype="bfloat16", device="cuda")
    assert 2 * ub.vectors.nbytes == u.vectors.nbytes
    cuda.reset_launches()
    assert rec(ub.search(qs, 10)[1]) >= 0.8
    assert cuda.launches["topk_dist.bf16"] == 1
    assert cuda.launches["beam_search.bf16"] >= 1


# ---- the NN-descent build's sorts: Kκ radix_sort, Kλ nnd_cand, Kμ
# run_scatter, Kν rp_window


@pytest.mark.parametrize("e", [0, 1, 4095, 4097, 100003])
@pytest.mark.parametrize("key_bits", range(1, 33))
def test_radix_sort_kernel_matches_plain(e, key_bits):
    """Kκ against torch.sort(stable=True) + gather: keys and payload exactly
    equal at every digit count, at sizes that are 0, 1, below, at and past
    one 4096-element tile with a partial last tile; random keys below
    2^key_bits with many ties, and all keys equal."""
    from hnsw_slim_tpu_torch.ops import sort

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(e * 33 + key_bits)
    hi = 2 ** key_bits
    u = torch.randint(0, min(hi, 2**31 - 1), (e,), generator=g,
                      device="cuda", dtype=torch.int64)
    if key_bits == 32:  # the top bit too: words above 2^31 read as u32
        u = u * 2 + torch.randint(0, 2, (e,), generator=g, device="cuda")
    u = torch.where(torch.rand((e,), generator=g, device="cuda") < 0.3,
                    hi - 1, u)
    keys = ((u + 2**31) % 2**32 - 2**31).to(torch.int32)  # u32 words
    p = torch.randint(0, 10**6, (e,), generator=g, device="cuda",
                      dtype=torch.int32)
    for k_ in (keys, torch.full_like(keys, 3 % hi)):
        ku, kp = sort.kv_radix_sort(k_, p, key_bits)
        torch.cuda.synchronize()
        pu, pp = sort.kv_radix_sort_plain(k_, p, key_bits)
        assert torch.equal(ku, pu) and torch.equal(kp, pp)


@pytest.mark.parametrize("e", [1, 4097, 250000])
def test_radix_sort_float_keys_match_torch_sort(e):
    """Kκ on f32 keys (f32_sort_key's order): equal to torch.sort(stable=
    True) with -0.0 and +0.0 tied in input order, +-inf, small negatives
    and repeated values."""
    from hnsw_slim_tpu_torch.ops import sort

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(e)
    x = torch.randint(-20, 20, (e,), generator=g, device="cuda").float() / 8
    pick = torch.randint(0, 6, (e,), generator=g, device="cuda")
    x = torch.where(pick == 0, -0.0, x)
    x = torch.where(pick == 1, float("inf"), x)
    x = torch.where(pick == 2, -1e-7, x)
    x = torch.where(pick == 3, float("-inf"), x)
    p = torch.arange(e, dtype=torch.int32, device="cuda")
    kx, kp = sort.kv_radix_sort(x, p, 32, "f32")
    torch.cuda.synchronize()
    px, pp = sort.kv_radix_sort_plain(x, p, 32, "f32")
    assert torch.equal(kp, pp)
    assert torch.equal(kx.view(torch.int32), px.view(torch.int32))


@pytest.mark.parametrize("n,width,n_valid", [(1, 4, 1), (1000, 30, 1000),
                                             (5000, 76, 4000)])
def test_run_scatter_kernel_matches_plain(n, width, n_valid):
    """Kμ scatter mode against sorted_run_rank + the masked scatter (runs
    longer than width, the drop key n, payloads past n_valid), and the dedup
    mode against the adjacent-pair mark: exactly equal."""
    from hnsw_slim_tpu_torch.ops import sort

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(n)
    e = 40 * n + 3
    keys = torch.randint(0, n + 1, (e,), generator=g, device="cuda",
                         dtype=torch.int32)
    keys[: e // 5] = min(3, n)  # one long run
    vals = torch.randint(0, 6, (e,), generator=g, device="cuda",
                         dtype=torch.int32)
    sk, sv = sort.kv_radix_sort_plain(keys, vals)
    _, o = sort.lexsort_stable(keys, vals, 32)
    dk, dv = keys[o.long()], vals[o.long()]
    pay = torch.randint(0, n + 50, (e,), generator=g, device="cuda",
                        dtype=torch.int32)
    got = sort.run_scatter(sk, pay, n, width, n_valid)
    dd = sort.dedup_pairs(dk, dv, n)
    torch.cuda.synchronize()
    assert torch.equal(got, sort.run_scatter_plain(sk, pay, n, width,
                                                   n_valid))
    assert torch.equal(dd, sort.dedup_pairs_plain(dk, dv, n))


@pytest.mark.parametrize("k,s_fwd,r_rev", [(60, 60, 30), (32, 20, 16),
                                           (16, 16, 8), (64, 48, 32)])
def test_nnd_cand_and_rp_window_kernels_match_plain(data, k, s_fwd, r_rev):
    """Kν on the 20k set's projection orders, then Kλ in both modes on a
    partly filled NND state (empty rows, n_valid < n): the candidate rows
    and cleared flags exactly equal to the plain versions."""
    from hnsw_slim_tpu_torch.graph import nnd
    from hnsw_slim_tpu_torch.ops import sort

    x, xn, _ = data
    n = len(x)
    n_valid = n - 100
    g = torch.Generator(device="cuda").manual_seed(k)
    dirs, rnd = nnd.rp_draws(g, n, x.shape[1], k, 4, n_valid)
    proj = x @ dirs
    w = max(2, k // 8)
    iota = torch.arange(n, dtype=torch.int32, device="cuda")
    orders = torch.stack([sort.kv_radix_sort_plain(
        torch.where(iota < n_valid, proj[:, p], float("inf")), iota, 32,
        "f32")[1] for p in range(4)])
    kc = nnd.rp_window(orders, rnd, n_valid, w)
    torch.cuda.synchronize()
    assert torch.equal(kc, nnd.rp_window_plain(orders, rnd, n_valid, w))
    ids = torch.randint(0, n, (n, k), generator=g, device="cuda",
                        dtype=torch.int32)
    ids[torch.rand((n, k), generator=g, device="cuda") < 0.3] = -1
    ids[:50] = -1  # all-empty rows
    newf = torch.randint(0, 2, (n, k), generator=g, device="cuda",
                         dtype=torch.int32)
    rk, r2, r3, r4 = nnd.nnd_draws(g, n, k, s_fwd, r_rev, "cuda")
    c = 2 * s_fwd + r_rev
    ck = torch.full((n, c), -7, dtype=torch.int32, device="cuda")
    cp = ck.clone()
    fk = nnd.nnd_pivot(ids, newf, rk, r2, ck)
    fp = nnd.nnd_pivot_plain(ids, newf, rk, r2, cp)
    rev = torch.randint(-1, n, (n, r_rev), generator=g, device="cuda",
                        dtype=torch.int32)
    nnd.nnd_join(ids, rev, r3, r4, ck)
    nnd.nnd_join_plain(ids, rev, r3, r4, cp)
    torch.cuda.synchronize()
    assert torch.equal(fk, fp) and torch.equal(ck, cp)


def test_nnd_build_kernels_equal_plain_twins(data):
    """A whole NN-descent build (rp_init, rounds, mutual union at every
    level) with the kernels equals the build with every plain twin swapped
    in, row for row, from the same seed."""
    from hnsw_slim_tpu_torch.config import HnswConfig
    from hnsw_slim_tpu_torch.graph import build as tb
    from hnsw_slim_tpu_torch.graph import nnd
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.ops import sort

    x, _, _ = data
    base = x[:8000].cpu().numpy()
    cfg = HnswConfig(M=16, ef_construction=64)

    def build():
        h = HnswIndex(cfg, strategy="nnd", device="cuda")
        h.build(base)
        return [a.cpu() for a in h.graph.adjs]

    got = build()
    # lexsort_stable reads ops/sort.py's kv_radix_sort, so swapping it there
    # puts the union's lexsorts on the plain sort too
    swap = {sort: dict(kv_radix_sort=sort.kv_radix_sort_plain),
            nnd: dict(kv_radix_sort=sort.kv_radix_sort_plain,
                      run_scatter=sort.run_scatter_plain,
                      rp_window=nnd.rp_window_plain,
                      nnd_pivot=nnd.nnd_pivot_plain,
                      nnd_join=nnd.nnd_join_plain),
            tb: dict(dedup_pairs=sort.dedup_pairs_plain,
                     run_scatter=sort.run_scatter_plain)}
    saved = {m: {k: getattr(m, k) for k in d} for m, d in swap.items()}
    try:
        for m, d in swap.items():
            for k, v in d.items():
                setattr(m, k, v)
        want = build()
    finally:
        for m, d in saved.items():
            for k, v in d.items():
                setattr(m, k, v)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))



# ---- Kβ and Kγ at the shapes their redesign turns on, on exact data -----
# Coordinates that are multiples of 1/8 in [-4, 4]: every dot, norm and
# distance of such vectors is exact in fp32 (and their bf16 copies are the
# same values), so a kernel and its plain version compute the same
# distances, and where two distances tie, the tie rules alone decide. Ids,
# hops, dcomp, kept rows and counts must then be exactly equal.


def _dyadic(n, d, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.integers(-32, 33, (n, d)).astype(np.float32) / 8, device="cuda")


def _random_rows(n, w, seed, pool=None, hole=0.1):
    """i32[n, w] neighbor rows: ids drawn from [0, pool or n), a share
    ``hole`` of lanes -1."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, pool or n, (n, w))
    ids[rng.random((n, w)) < hole] = -1
    return torch.as_tensor(ids.astype(np.int32), device="cuda")


@pytest.fixture(scope="module")
def exact():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _dyadic(20000, 128, 11)
    return x, (x * x).sum(1), _dyadic(512, 128, 12)


def _seed(x, q, seed):
    """One seed a query: a random id and its exact distance."""
    g = np.random.default_rng(seed)
    si = torch.as_tensor(g.integers(0, len(x), (len(q), 1)).astype(np.int32),
                         device="cuda")
    sd = ((q[:, None, :] - x[si.long()].float()) ** 2).sum(-1)
    return sd.contiguous(), si


def _beam_equal(x, q, rows, sd, si, **kw):
    from hnsw_slim_tpu_torch.graph import search as gs

    qn = (q * q).sum(1)
    k_o = gs.beam_search(x, q, qn, rows, sd, si, **kw)
    p_o = gs.beam_search_plain(x, q, qn, rows, sd, si, **kw)
    for a, b in zip(k_o, p_o):
        assert torch.equal(a, b)
    return k_o


@pytest.mark.parametrize("case", ["cap", "prewindow", "dups",
                                  "dups_prewindow", "bf16"])
def test_beam_redesign_exactly_equal_plain(exact, case):
    """Kβ at the build shape (P 128, E 8, W 60, cw 256: after the first pop
    more than cw new ids arrive, so the cap's select runs), under the
    pre-window rule (P 64, cw 128: 2 cw < E W), with rows full of repeated
    ids (drawn from 300 ids: repeats within a row and across pops), and on
    a bf16 store: buffer distances and ids, hops and dcomp exactly equal to
    the plain version's."""
    from hnsw_slim_tpu_torch.graph import search as gs

    x, _, q = exact
    P = 64 if "prewindow" in case else 128
    rows = _random_rows(len(x), 60, 3, pool=300 if "dups" in case else None)
    cw = gs.cand_width(P, 8, 60, 0)
    assert (2 * cw < 480) == ("prewindow" in case)
    sd, si = _seed(x, q, 4)
    xs = x.to(torch.bfloat16) if case == "bf16" else x
    _beam_equal(xs, q, rows, sd, si, P=P, ef_eff=P, pop_width=8, cw=cw,
                max_iters=2 * P + 64, k=P)


def test_beam_carried_buffer_exactly_equal_plain(exact):
    """Kβ from a carried buffer (E 1, S = P = 128, cw = W = 60, the
    upper-level insert beam): a full buffer from one graph's beam seeds the
    beam over another graph; exactly equal to the plain version."""
    from hnsw_slim_tpu_torch.graph import search as gs

    x, xn, q = exact
    sd, si = _seed(x, q, 5)
    qn = (q * q).sum(1)
    kw = dict(P=128, ef_eff=128, max_iters=2 * 128 + 64, k=128)
    bd, bi, _, _ = gs.beam_search_plain(x, q, qn, _random_rows(len(x), 60, 6),
                                        sd, si, pop_width=8, cw=256, **kw)
    assert (bi >= 0).all()
    _beam_equal(x, q, _random_rows(len(x), 60, 7, pool=5000),
                bd.contiguous(), bi.contiguous(), pop_width=1, cw=60, **kw)


@pytest.mark.parametrize("share", [0.3, 0.05])
def test_filtered_beam_exactly_equal_plain(exact, share):
    """Kβ's filtered mode under the pre-window rule (P 64, E 8, W 60): the
    buffer, the allowed-only track, hops and dcomp exactly equal to the
    plain version's; every track id allowed."""
    from hnsw_slim_tpu_torch.graph import search as gs

    x, _, q = exact
    g = torch.Generator(device="cuda").manual_seed(8)
    allowed = torch.rand(len(x), generator=g, device="cuda") < share
    sd, si = _seed(x, q, 9)
    trk = gs.filter_track_init(allowed, si[:, 0], sd[:, 0], 64)
    out = _beam_equal(x, q, _random_rows(len(x), 60, 10), sd, si, P=64,
                      ef_eff=64, pop_width=8, cw=gs.cand_width(64, 8, 60, 0),
                      max_iters=400, k=10, allowed=allowed, track_d=trk[0],
                      track_id=trk[1])
    ti = out[5]
    assert allowed[ti[ti >= 0].long()].all()


@pytest.mark.parametrize("labels", [12, 32])
def test_tag_beam_exactly_equal_plain(exact, labels):
    """Kβ's tag mode (a u32 need word a query, predicates mixed in the
    batch) with per-query iteration caps, under the pre-window rule (P 64,
    E 8, W 60): the buffer, the track, hops, dcomp and the admitted counts
    exactly equal to the plain version's; every track id passes its
    query's predicate; the launch counts as the tag mode, not the
    allow-list's."""
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.ops import cuda

    x, _, q = exact
    rng = np.random.default_rng(13)

    def words(n):
        return torch.as_tensor((1 << rng.integers(0, labels, n)).astype(
            np.uint32).view(np.int32), device="cuda")

    tags, need = words(len(x)), words(len(q))
    iters = torch.as_tensor(rng.integers(0, 400, len(q)).astype(np.int32),
                            device="cuda")
    sd, si = _seed(x, q, 14)
    trk = gs.filter_track_init(None, si[:, 0], sd[:, 0], 64, tags, need)
    cuda.reset_launches()
    out = _beam_equal(x, q, _random_rows(len(x), 60, 15), sd, si, P=64,
                      ef_eff=64, pop_width=8, cw=gs.cand_width(64, 8, 60, 0),
                      max_iters=400, k=10, track_d=trk[0], track_id=trk[1],
                      tags=tags, need=need, iters=iters)
    assert cuda.launches["beam_search.tags"] == 1
    assert cuda.launches["beam_search.filtered"] == 0
    ti = out[5]
    t = tags[ti.clamp(min=0).long()]
    assert ((t & need[:, None]) == need[:, None])[ti >= 0].all()
    assert (out[6] <= out[3]).all() and out[6].sum() > 0


def test_quant_beam_prewindow_matches_plain(data, slimq_index):
    """Kβ's quantized mode with the rerank track under the pre-window rule
    (pop 16 over the SlimQ graph's level-0 rows, ef 64: 2 cw < E W): buffer
    and track ids equal on >= 99% of slots (estimates are summed in another
    order than the plain version's), hops on >= 99% of queries."""
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    x, _, q = data
    idx, _ = slimq_index
    sc = _scorer(idx, q, False)
    rows, up_ids = idx._seed_table()
    sd, sp = bf.topk_estimate_plain(sc._replace(rows=rows), up_ids, 32)
    si = torch.where(sp >= 0, up_ids[sp.clamp(min=0).long()], -1)
    si = si.to(torch.int32).contiguous()
    cw = gs.cand_width(64, 16, idx.graph.cap0, 0)
    assert 2 * cw < 16 * idx.graph.cap0
    kw = dict(P=64, ef_eff=64, pop_width=16, cw=cw, max_iters=200, k=64,
              scorer=sc, pop_track=gs.pop_track_init(x, q, 16))
    args = (None, None, None, idx.dense0, sd.contiguous(), si)
    k_o = gs.beam_search(*args, **kw)
    p_o = gs.beam_search_plain(*args, **kw)
    assert (k_o[1] == p_o[1]).float().mean() >= 0.99
    assert (k_o[2] == p_o[2]).float().mean() >= 0.99
    assert (k_o[4].ids == p_o[4].ids).float().mean() >= 0.99


# ---- the quantized scorer's one gather (csrc/common.cuh quant_score_rows)


def _random_codes(n, nb, ex_bits, C, seed):
    """Packed code rows i32[n, nb (1 + ex_bits) + 5] on the card: random bit
    planes, the four factors drawn from [0.25, 4), cluster ids below C."""
    g = np.random.default_rng(seed)
    stride = nb * (1 + ex_bits) + 5
    rows = g.integers(0, 1 << 32, (n, stride), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    fac = g.uniform(0.25, 4.0, (n, 4)).astype(np.float32)
    rows[:, stride - 5:stride - 1] = fac.view(np.uint32)
    rows[:, stride - 1] = g.integers(0, C, n)
    return torch.as_tensor(rows.view(np.int32), device="cuda")


def _random_scorer(rows, nb, ex_bits, use_ex, b, C, seed):
    """A QuantScorer over ``rows`` for b random rotated queries."""
    from hnsw_slim_tpu_torch.quant.estimator import QuantScorer

    g = np.random.default_rng(seed)
    q_rot = torch.as_tensor(
        g.standard_normal((b, 32 * nb)).astype(np.float32), device="cuda")
    g_add = torch.as_tensor(g.uniform(0.0, 4.0, (b, C)).astype(np.float32),
                            device="cuda")
    return QuantScorer(rows, nb, ex_bits, use_ex, q_rot,
                       q_rot.sum(1).contiguous(), g_add)


def _one_row_estimates(sc, fetch, ids):
    """The one-row scorer's estimate of ids i32[B, P] (-1 read as 0), query
    b's terms for row b: Kε's idle path, which scores each query's start
    node and walks no level."""
    from hnsw_slim_tpu_torch.graph import search as gs

    b, p = ids.shape
    rep = sc._replace(q_rot=sc.q_rot.repeat_interleave(p, 0),
                      sumq=sc.sumq.repeat_interleave(p, 0),
                      g_add=sc.g_add.repeat_interleave(p, 0))
    cur = ids.clamp(min=0).reshape(-1).contiguous()
    idle = torch.zeros(len(cur), dtype=torch.bool, device="cuda")
    _, d, hops, _ = gs.greedy_descent(None, None, None, fetch, cur, None,
                                      idle, scorer=rep)
    assert not hops.any()
    return d.view(b, p)


def _chal_of(rows):
    """The CHAL form (one level) of dense rows i32[N, W]: each row's valid
    lanes in order."""
    from hnsw_slim_tpu_torch.graph import search as gs

    valid = rows >= 0
    cnt = valid.sum(1)
    end = torch.cumsum(cnt, 0)
    lvl_off = torch.stack([end - cnt, end], 1).to(torch.int32).contiguous()
    return gs.chal_fetch(rows[valid].contiguous(), lvl_off, 0, rows.shape[1])


@pytest.mark.parametrize("nb,ex_bits,use_ex,pop,w,rounds", [
    (4, 3, False, 8, 32, 1),   # P = 128, the 1-bit mode: 9 words a row
    (4, 3, True, 8, 32, 1),    # P = 128, the whole 4-bit code: 21 words
    (4, 3, True, 1, 7, 1),     # E 1, W 7: at most 7 candidates an iteration
    (8, 3, True, 8, 32, 2),    # P = 256, the whole code: 37 words
    (32, 0, False, 8, 32, 2),  # P = 1024, a 1-bit code: 37 words
])
def test_quant_beam_estimates_equal_the_one_row_scorer(nb, ex_bits, use_ex,
                                                        pop, w, rounds):
    """Every estimate in Kβ's quantized buffer after a call is, bit for bit,
    the one-row scorer's estimate of the same id (Kε's idle path), and
    within 1e-4 relative of the plain version's; the CHAL form of the same
    rows gives the same buffer, hops and dcomp. Random code rows of widths
    whose rows arrive in one gather round and in two; with E 1 and W 7 an
    iteration scores at most 7 candidates, so a warp's last group holds
    fewer rows than it takes."""
    from hnsw_slim_tpu_torch.config import SearchConfig
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.quant import estimator as est

    _card()
    n, b, C, P = 20000, 256, 16, 64
    assert est.gather_rounds(nb, ex_bits, use_ex) == rounds
    rows = _random_codes(n, nb, ex_bits, C, seed=nb + ex_bits)
    sc = _random_scorer(rows, nb, ex_bits, use_ex, b, C, seed=7)
    adj = _random_rows(n, w, seed=w)
    dense = gs.dense_fetch(adj)
    si = torch.as_tensor(np.random.default_rng(3).integers(0, n, (b, 1))
                         .astype(np.int32), device="cuda")
    sd = _one_row_estimates(sc, dense, si).contiguous()
    kw = dict(P=P, ef_eff=P, pop_width=pop, cw=gs.cand_width(P, pop, w, 0),
              max_iters=SearchConfig(ef=P, pop_width=pop).iters(), k=P,
              scorer=sc)
    k_o = gs.beam_search(None, None, None, dense, sd, si, **kw)
    kd, ki = k_o[0], k_o[1]
    ok = ki >= 0
    assert ok.sum(1).min() > 1  # every query beamed past its seed
    one = _one_row_estimates(sc, dense, ki)
    assert torch.equal(kd[ok].view(torch.int32), one[ok].view(torch.int32))
    plain = est.packed_estimate_plain(sc, ki.clamp(min=0))
    assert _est_close(kd[ok], plain[ok])
    c_o = gs.beam_search(None, None, None, _chal_of(adj), sd, si, **kw)
    for a, c in zip(k_o, c_o):
        assert torch.equal(a, c)


def test_quant_launches_count_one_gather_round_on_card(data, slimq_index):
    """``index.quant_one_round`` counts every quantized Kβ and Kε launch of a
    SlimQ search at P = 128 and 4 bits (one gather round in both modes),
    eager, captured and replayed alike, and no launch over code rows of two
    rounds (P = 256)."""
    from torch.profiler import ProfilerActivity, profile

    from hnsw_slim_tpu_torch.config import SearchConfig
    from hnsw_slim_tpu_torch.graph import search as gs
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.utils import trace

    _, _, q = data
    idx, _ = slimq_index
    qs = q[:100].cpu().numpy()  # a batch size no other test replays
    quant = ("beam_search.quant", "beam_search.quant_ex",
             "greedy_descent.quant")
    trace.drain()
    for seed_width, use_ex in ((32, True), (0, False)):
        idx.scfg = SearchConfig(ef=64, pop_width=8, seed_width=seed_width,
                                use_ex=use_ex)
        cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):  # eager, captured, replayed
                idx.search(qs, 10)
        got = trace.drain()["counters"]
        assert got["index.replays"] == 2
        n_quant = sum(cuda.launches[m] for m in quant)
        assert n_quant >= 3
        assert got["index.quant_one_round"] == n_quant
    rows = _random_codes(2000, 8, 3, 16, seed=5)
    sc = _random_scorer(rows, 8, 3, True, 64, 16, seed=6)
    si = torch.zeros((64, 1), dtype=torch.int32, device="cuda")
    adj = _random_rows(2000, 16, seed=8)
    with profile(activities=[ProfilerActivity.CPU]):
        gs.beam_search(None, None, None, adj, torch.zeros((64, 1),
                       device="cuda"), si, P=32, ef_eff=32, pop_width=4,
                       cw=64, max_iters=100, k=32, scorer=sc)
    assert "index.quant_one_round" not in trace.drain()["counters"]


def _prune_equal(x, base, cand, m, **kw):
    from hnsw_slim_tpu_torch.graph import heuristic as th

    xn = (x.float() ** 2).sum(1)
    ks, kc = th.rng_prune(x, xn, base, cand, m, **kw)
    ps, pc = th.rng_prune_plain(x, xn, base, cand, m, **kw)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    return ks, kc


def _prune_rows(x, b, c, seed):
    g = np.random.default_rng(seed)
    base = g.integers(0, len(x), b).astype(np.int32)
    cand = g.integers(0, len(x), (b, c)).astype(np.int32)
    cand[g.random((b, c)) < 0.05] = -1
    cand[:, 0] = base  # the base itself is no candidate
    return (torch.as_tensor(base, device="cuda"),
            torch.as_tensor(cand, device="cuda"))


@pytest.mark.parametrize("keep_pruned", [False, True])
def test_prune_wide_rows_exactly_equal_plain(exact, keep_pruned):
    """Kγ with C 1024 at D 128 (32 rings of staged rows a row): rows and
    counts exactly equal to the plain version's."""
    from hnsw_slim_tpu_torch.graph import heuristic as th

    x, _, _ = exact
    assert th.prune_plan(1024, 128, 30).ring < 1024
    base, cand = _prune_rows(x, 96, 1024, 13)
    m = torch.full((96,), 30, dtype=torch.int32, device="cuda")
    _prune_equal(x, base, cand, m, keep_all_under_m=False,
                 keep_pruned=keep_pruned, out_width=40)


def test_guarded_prune_wide_rows_exactly_equal_plain():
    """Kγ's guarded mode with C 1024 (D 32: up to C kept rows, the walk
    over many rings): rows and counts exactly equal to the plain version's;
    some rows keep more than their budget."""
    from hnsw_slim_tpu_torch.graph import heuristic as th

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _dyadic(20000, 32, 14)
    assert th.prune_plan(1024, 32, 1024).ring < 1024
    base, cand = _prune_rows(x, 64, 1024, 15)
    g = torch.Generator(device="cuda").manual_seed(16)
    guard = torch.rand(cand.shape, generator=g, device="cuda") < 0.02
    m = torch.randint(1, 20, (64,), generator=g, device="cuda",
                      dtype=torch.int32)
    xn = (x * x).sum(1)
    ks, kc = th.rng_prune(x, xn, base, cand, m, keep_all_under_m=False,
                          keep_pruned=False, out_width=64, guard=guard)
    ps, pc = th.rng_prune_plain(x, xn, base, cand, m, keep_all_under_m=False,
                                keep_pruned=False, out_width=64, guard=guard)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    assert (kc > m).any()


def test_prune_all_conflicting_and_m1_exactly_equal_plain():
    """Kγ on rows whose candidates all lie close together and far from the
    base (each conflicts with the nearest one: one row kept), and with a
    budget of 1, with and without the backfill: exactly equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, c, d = 256, 128, 128
    rng = np.random.default_rng(17)
    pts = []
    for _ in range(b):
        far = rng.integers(-4, 5, d) * 4.0
        pts.append(rng.integers(-2, 3, (1, d)) / 8.0)  # the base
        pts.append(far + rng.integers(-1, 2, (c, d)) / 8.0)
    x = torch.as_tensor(np.concatenate(pts).astype(np.float32),
                        device="cuda")
    base = torch.arange(0, b * (c + 1), c + 1, dtype=torch.int32,
                        device="cuda")
    cand = (base[:, None] + 1 + torch.arange(c, device="cuda")).to(
        torch.int32).contiguous()
    m = torch.full((b,), 30, dtype=torch.int32, device="cuda")
    _, kc = _prune_equal(x, base, cand, m, keep_all_under_m=False,
                         keep_pruned=False, out_width=30)
    assert (kc == 1).all()
    x2 = _dyadic(20000, 128, 18)
    base2, cand2 = _prune_rows(x2, 1024, 128, 19)
    m1 = torch.ones(1024, dtype=torch.int32, device="cuda")
    for keep_pruned in (False, True):
        _, kc = _prune_equal(x2, base2, cand2, m1, keep_all_under_m=False,
                             keep_pruned=keep_pruned, out_width=8)
        assert (kc == 1).all()


@pytest.mark.parametrize("c", [60, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prune_forward_shape_exactly_equal_plain(exact, metric, dtype, c):
    """Kγ at the insert forward prune's shape (C 128, m = M = 30, the
    keep-all early-out; the walk reloads its ring of staged rows) and at a
    conversion row's width (C 60: every candidate staged in step 1), and
    with a budget past the kept rows and the backfill, over fp32 and bf16
    stores, L2 and inner product: rows and counts exactly equal to the
    plain version's."""
    x, _, _ = exact
    xs = x.to(getattr(torch, dtype))
    base, cand = _prune_rows(x, 2048, c, 20)
    m = torch.full((2048,), 30, dtype=torch.int32, device="cuda")
    _prune_equal(xs, base, cand, m, keep_all_under_m=True, keep_pruned=False,
                 out_width=30, metric=metric)
    _prune_equal(xs, base, cand, m, keep_all_under_m=False, keep_pruned=True,
                 out_width=30, metric=metric)


# ---- Kα and Kε redesigned: ragged shapes on exact data --------------------

SCAN_CASES = [  # (name, b, n, d, k, metric, store, extras)
    ("server batch", 12, 19993, 128, 32, "l2", "float32", "row_ids"),
    ("ground truth", 300, 20000, 128, 10, "l2", "float32", ""),
    ("k1 ip", 100, 20000, 128, 1, "ip", "float32", ""),
    ("k64 self", 257, 20000, 128, 64, "l2", "float32", "self"),
    ("d96", 130, 20000, 96, 32, "l2", "float32", "row_ids"),
    ("d99 scalar loads", 70, 5001, 99, 33, "l2", "float32", ""),
    ("wide rows", 40, 3000, 1000, 16, "l2", "float32", ""),
    ("d3072 chunked U", 40, 3000, 3072, 32, "l2", "float32", "row_ids"),
    ("d4096 chunked U", 12, 3000, 4096, 32, "ip", "float32", ""),
    ("d4096 chunked 200 queries", 200, 3000, 4096, 10, "l2", "float32", ""),
    ("d4096 chunked k64 self", 130, 3000, 4096, 64, "l2", "float32", "self"),
    ("kmeans", 3000, 16, 128, 1, "l2", "float32", ""),
    ("kmeans ragged", 1025, 27, 128, 3, "l2", "float32", ""),
    ("k over n", 5, 7, 16, 32, "l2", "float32", ""),
    ("bf16", 500, 20000, 128, 32, "l2", "bfloat16", "row_ids"),
    ("bf16 k64 ip", 33, 20000, 128, 64, "ip", "bfloat16", ""),
]


@pytest.mark.parametrize("name,b,n,d,k,metric,store,extra", SCAN_CASES,
                         ids=[c[0] for c in SCAN_CASES])
def test_topk_scan_exactly_equal_plain(exact, name, b, n, d, k, metric,
                                       store, extra):
    """Kα's tiles (L, M, U, T by the plan) at batches and tables that are
    no multiple of a tile, k of 1 to 64, n_valid, negative row ids and the
    self mask, D of 96, 99 (scalar loads), 128, 1000, 3072 and 4096 (U's
    query tile staged in chunks), fp32 and bf16 rows: distances and rows
    exactly equal to the plain version's."""
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    x = exact[0] if d == 128 else _dyadic(max(n, 3000), d, 30 + d)
    x = x[:n].contiguous()
    xs = x.to(getattr(torch, store))
    xn = (xs.float() ** 2).sum(1)
    q = _dyadic(b, d, 40 + b)
    kw = {}
    if extra == "row_ids":
        ids = torch.arange(n, dtype=torch.int32, device="cuda")
        kw["row_ids"] = torch.where(ids % 7 == 3, -1, ids)
    if extra == "self":
        q = x[1000:1000 + b].contiguous()
        kw.update(self_offset=1000, n_valid=n - 1000)
    if d > 1000:  # rows too wide for a resident query tile
        assert bf._plan(q, n, k).qdims < d
    kd, ki = bf.topk_dist(q, xs, xn, k, metric, **kw)
    pd, pi = bf.topk_dist_plain(q, xs.float(), xn, k, metric, **kw)
    assert torch.equal(ki, pi)
    assert torch.equal(kd, pd)


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("strata,width", [(4, 32), (8, 64), (3, 30)])
def test_topk_strata_exactly_equal_plain(exact, store, strata, width):
    """Kα in strata mode (one split per segment, then the stable sort of
    the picks), rows with negative ids: exactly equal to the plain
    version."""
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    x, _, q = exact
    n = 19998 // strata * strata
    xs = x[:n].to(getattr(torch, store)).contiguous()
    xn = (xs.float() ** 2).sum(1)
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    ids = torch.where(ids % 5 == 1, -1, ids)
    kd, ki = bf.topk_dist_strata(q[:300].contiguous(), xs, xn, ids, width,
                                 strata)
    pd, pi = bf.topk_dist_strata_plain(q[:300].contiguous(), xs.float(), xn,
                                       ids, width, strata)
    assert torch.equal(ki, pi)
    assert torch.equal(kd, pd)


def _level_forms(n, w, top, seed):
    """Per-level neighbor rows (levels top..1, holes and empty rows) in the
    three fetch forms: dense rows, rank + dense rows (some nodes without a
    row), CHAL slices (each node's valid ids in lane order)."""
    from hnsw_slim_tpu_torch.graph import search as gs

    rng = np.random.default_rng(seed)
    rows, ranks, dense = {}, {}, {}
    for lv in range(1, top + 1):
        r = rng.integers(0, n, (n, w)).astype(np.int32)
        r[rng.random((n, w)) < 0.15] = -1
        r[rng.random(n) < 0.03] = -1
        have = rng.random(n) < 0.9
        rank = np.full(n, -1, np.int32)
        rank[have] = np.arange(have.sum(), dtype=np.int32)
        ranks[lv], dense[lv] = rank, r[have]
        rows[lv] = np.where(have[:, None], r, -1)
    cnt = np.stack([(rows[lv] >= 0).sum(1) for lv in range(1, top + 1)],
                   1)  # [n, top]
    lvl_off = np.zeros((n, top + 2), np.int64)
    starts = np.concatenate([[0], np.cumsum(cnt.reshape(-1))])[:-1]
    lvl_off[:, 1:top + 1] = starts.reshape(n, top)
    lvl_off[:, 0] = lvl_off[:, 1]
    lvl_off[:, top + 1] = lvl_off[:, top] + cnt[:, top - 1]
    nbr = np.concatenate([rows[lv][v][rows[lv][v] >= 0] for v in range(n)
                          for lv in range(1, top + 1)]).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    lvls = range(top, 0, -1)
    return {
        "dense": [gs.dense_fetch(t(rows[lv])) for lv in lvls],
        "rank": [gs.rank_fetch(t(ranks[lv]), t(dense[lv])) for lv in lvls],
        "chal": [gs.chal_fetch(t(nbr), t(lvl_off.astype(np.int32)), lv, w)
                 for lv in lvls],
    }


@pytest.mark.parametrize("w", [30, 40])
@pytest.mark.parametrize("form", ["dense", "rank", "chal", "bf16"])
@pytest.mark.parametrize("stops", ["per query", "all walk", "none walk"])
def test_descent_levels_exactly_equal_plain(exact, form, w, stops):
    """Kε's one-launch descent over three levels of random rows (holes,
    empty rows, W 30 and 40: more than one 32-lane chunk and one group of
    16 rows), per-query stop levels, every query walking, none walking:
    cur, curdist, hops and dcomp exactly equal to the plain twin's and to
    the per-level launches' sums."""
    from hnsw_slim_tpu_torch.graph import search as gs

    x, xn, q = exact
    top, n = 3, len(x)
    fetches = _level_forms(n, w, top, 50 + w)[
        "dense" if form == "bf16" else form]
    xs = x.to(torch.bfloat16) if form == "bf16" else x
    qn = (q * q).sum(1)
    rng = np.random.default_rng(w)
    cur = torch.as_tensor(rng.integers(0, n, len(q)).astype(np.int32),
                          device="cuda")
    dist = ((q - xs[cur.long()].float()) ** 2).sum(1)
    stop = {"per query": rng.integers(0, top + 1, len(q)),
            "all walk": np.zeros(len(q)),
            "none walk": np.full(len(q), top)}[stops]
    stop = torch.as_tensor(stop.astype(np.int32), device="cuda")
    k_o = gs.greedy_descent_levels(xs, q, qn, fetches, top, cur, dist, stop)
    p_o = gs.greedy_descent_levels_plain(xs, q, qn, fetches, top, cur, dist,
                                         stop)
    for a, b in zip(k_o, p_o):
        assert torch.equal(a, b)
    c, dd = cur, dist
    hops = torch.zeros_like(cur)
    dcomp = torch.zeros_like(cur)
    for i, f in enumerate(fetches):
        c, dd, h, dc = gs.greedy_descent(xs, q, qn, f, c, dd, stop < top - i)
        hops, dcomp = hops + h, dcomp + dc
    for a, b in zip(k_o, (c, dd, hops, dcomp)):
        assert torch.equal(a, b)
    if stops == "none walk":
        assert torch.equal(k_o[0], cur) and int(k_o[2].sum()) == 0


@pytest.mark.parametrize("use_ex", [False, True])
def test_descent_levels_quant_on_card(data, slimq_index, use_ex):
    """Kε's one-launch descent on estimates (the entry point scored by the
    kernel) over the SlimQ graph's rank rows: equal to the per-level
    launches' sums, and to the plain twin on >= 99% of queries (the plain
    estimate sums in another order), hops and dcomp equal where cur is."""
    from hnsw_slim_tpu_torch.graph import search as gs

    _, _, q = data
    idx, _ = slimq_index
    g = idx.graph
    sc = _scorer(idx, q, use_ex)
    fetches = [gs.rank_fetch(idx.rank_up, idx.dense_up[lv - 1])
               for lv in range(g.max_level, 0, -1)]
    cur = torch.full((len(q),), g.entry, dtype=torch.int32, device="cuda")
    k_o = gs.greedy_descent_levels(None, None, None, fetches, g.max_level,
                                   cur, None, scorer=sc)
    c, dd = cur, None
    hops = torch.zeros_like(cur)
    dcomp = torch.zeros_like(cur)
    for f in fetches:
        c, dd, h, dc = gs.greedy_descent(None, None, None, f, c, dd,
                                         scorer=sc)
        hops, dcomp = hops + h, dcomp + dc
    for a, b in zip(k_o, (c, dd, hops, dcomp)):
        assert torch.equal(a, b)
    p_o = gs.greedy_descent_levels_plain(None, None, None, fetches,
                                         g.max_level, cur, None, scorer=sc)
    same = k_o[0] == p_o[0]
    assert same.float().mean() >= 0.99
    assert _close(k_o[1][same], p_o[1][same])
    assert torch.equal(k_o[2][same], p_o[2][same])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(0, 128), (1, 1), (4097, 3), (4097, 100),
                                 (20000, 128), (3000, 960), (5, 0), (33, 8)])
def test_row_norms_kernel_matches_plain(dtype, n, d):
    """Kξ against sq_norms_plain within 1e-6 relative (both sum the fp32
    squares of the same elements, in another order): contiguous rows,
    strided rows, rows that start off a 16-byte boundary (the one-element
    path) and a 1-D row; one launch a call, none for an empty batch."""
    _card()
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.ops import distance as dist

    rng = np.random.default_rng(n * 1009 + d)
    wide = torch.as_tensor((rng.standard_normal((n, d + 8)) * 3).astype(
        np.float32)).to(dtype).cuda()
    flat = torch.as_tensor(rng.standard_normal(n * d + 1).astype(
        np.float32)).to(dtype).cuda()
    views = [wide[:, :d].contiguous(), wide[:, :d], flat[1:].view(n, d)]
    if n:
        views.append(wide[0, :d])
    for v in views:
        before = cuda.launches["row_norms"]
        got = dist.sq_norms(v)
        want = dist.sq_norms_plain(v)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        assert cuda.launches["row_norms"] - before == int(got.numel() > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["strided", "odd width", "empty", "1-D",
                                   "3-D"])
def test_row_norms_short_path_matches_general_path(dtype, shape):
    """sq_norms' short path (a contiguous 2-D batch) against its general
    path on the same rows: bit-equal norms, one launch a non-empty call,
    the bf16 mode counted for bf16 rows. The strided rows keep 16-byte
    alignment (a row stride of 136 elements), so both paths load them the
    same way and sum in the same order (csrc/row_norms.cu)."""
    _card()
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.ops import distance as dist

    rng = np.random.default_rng(5)
    wide = torch.as_tensor(rng.standard_normal((300, 136)).astype(
        np.float32)).to(dtype).cuda()
    general = {"strided": wide[:, :128], "odd width": wide[:, :13][::2],
               "empty": wide[:0, :128], "1-D": wide[7, :128],
               "3-D": wide[:, :128].reshape(30, 10, 128)}[shape]
    rows = general.reshape(-1, general.shape[-1]).contiguous()
    before = dict(cuda.launches)
    got = dist.sq_norms(general)
    short = dist.sq_norms(rows)
    torch.cuda.synchronize()
    assert got.shape == general.shape[:-1]
    assert torch.equal(got.reshape(-1), short)
    n = int(rows.shape[0] > 0)
    assert cuda.launches["row_norms"] - before["row_norms"] == 2 * n
    assert cuda.launches["row_norms.bf16"] - before["row_norms.bf16"] == (
        2 * n if dtype == torch.bfloat16 else 0)


def test_launch_counts_unchanged_by_the_lean_path(data):
    """One call of a wrapper counts one launch of its kernel, each of its
    modes and its shape under the current tag, as before the launch table:
    Kξ, K1, Kα (with its shape class) and Kζ."""
    from hnsw_slim_tpu_torch.graph import revconn
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.ops import distance as dist

    x, xn, q = data
    ids = torch.zeros((q.shape[0], 1), dtype=torch.int32, device="cuda")
    cuda.reset_launches()
    with cuda.tagged("lean"):
        dist.sq_norms(q)
        dist.sq_norms(q.to(torch.bfloat16))
        dist.gathered_dist(q, x, qn=dist.sq_norms(q), vn=xn, ids=ids)
        bf.topk_dist(q, x, xn, 10)
        revconn.append_overflow(*_crowded_apply(5000, 16, 512, 8, 300, 1),
                                4096, 64)
    torch.cuda.synchronize()
    got = {k: v for k, v in cuda.launches.items() if v}
    assert got == {"row_norms": 4, "row_norms.bf16": 1, "point_dist": 1,
                   "topk_dist": 1, "rev_connect": 1, "radix_sort": 1,
                   "radix_sort.ids": 1}
    (shape, count), = cuda.launch_shapes.items()
    assert shape.startswith("topk_dist[lean] ") and count == 1


@pytest.mark.parametrize("k", [65, 100, 128])
@pytest.mark.parametrize("b,tile", [(512, "M"), (48, "U")])
def test_topk_dist_128_slot_lists_match_plain(data, k, b, tile):
    """Kα with 128-slot lists (64 < k <= 128) in tiles M and U against its
    plain version; k = 129 raises and names the limit."""
    from hnsw_slim_tpu_torch.index import bruteforce as bf
    from hnsw_slim_tpu_torch.ops import cuda

    x, xn, q = data
    q = q[:b].contiguous()
    assert bf._plan(q, x.shape[0], k).tile == tile
    before = cuda.launches["topk_dist.k128"]
    kd, ki = bf.topk_dist(q, x, xn, k, n_valid=19000)
    pd, pi = bf.topk_dist_plain(q, x, xn, k, n_valid=19000)
    assert cuda.launches["topk_dist.k128"] == before + 1
    assert (ki == pi).float().mean() >= 0.99
    assert _close(kd, pd) and bool((ki < 19000).all())
    with pytest.raises(ValueError, match=r"outside \[1, 128\]"):
        bf.topk_dist(q, x, xn, 129)


@pytest.mark.parametrize("k", [65, 100, 128])
def test_topk_estimate_128_slot_lists_match_plain(data, slimq_index, k):
    """Kα's estimate mode with 128-slot lists against its plain version."""
    from hnsw_slim_tpu_torch.index import bruteforce as bf

    _, _, q = data
    idx, _ = slimq_index
    rows, up_ids = idx._seed_table()
    st = _scorer(idx, q, False)._replace(rows=rows)
    kd, kp = bf.topk_estimate(st, up_ids, k)
    pd, pp = bf.topk_estimate_plain(st, up_ids, k)
    assert (kp == pp).float().mean() >= 0.99
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin) and _est_close(kd[fin], pd[fin])


# ---- Kπ patch_apply: a patch chunk applied on the card


def _port_update_chunks():
    """(graph before, {name: chunks}, store before) of one update round of
    the port on the CPU: 3000 points, 300 added; PatchWriter's chunks at a
    3000-byte limit and in one."""
    from hnsw_slim_tpu_torch.config import HnswConfig, SlimConfig
    from hnsw_slim_tpu_torch.graph.incremental import IncrementalSlim
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
    from hnsw_slim_tpu_torch.persist import patch as tpatch

    base, _ = clustered(3300, 16, n_queries=0, n_clusters=20, seed=5)
    h = HnswIndex(HnswConfig(M=12, ef_construction=48), strategy="insert",
                  device="cpu")
    h.build(base[:3000])
    inc = IncrementalSlim(SlimConfig.from_ratios())

    def args():
        return (h.host_adj(), h.levels, int(h.graph.entry), h.vectors, h.vn)

    g0 = inc.full(*args())
    touched = h.add_points(base[3000:])
    g1, changed = inc.update(*args(), touched=touched)
    old = [int(v) for v in changed if v < 3000]
    out = {}
    for name, limit in (("port update, chunks", 3000),
                        ("port update, one chunk", 1 << 30)):
        w = tpatch.PatchWriter(g1, old, list(range(3000, 3300)),
                               vectors=base, host_chal=inc.host_chal)
        out[name] = []
        finished = False
        while not finished:
            blob, finished = w.next_chunk(limit)
            out[name].append(blob)
    return g0, out, base[:3000]


def _patch_cases():
    """name -> (graph on the CPU, chunks, store before)."""
    from hnsw_slim_tpu_torch.graph.types import pad_chal_nodes
    from patch_cases import (random_chunk, random_graph, rule_chunks,
                             shuffled_rows)

    g0, port, x0 = _port_update_chunks()
    cases = {k: (g0, v, x0) for k, v in port.items()}
    cases["port graph, rows out of order"] = (
        shuffled_rows(g0, 1), port["port update, chunks"], x0)
    cases["port graph, node-padded"] = (
        pad_chal_nodes(g0, 4096), port["port update, one chunk"], x0)
    for n, cap0, cap, top in [(20000, 10, 6, 3), (20000, 32, 16, 4),
                              (9000, 33, 8, 2), (9000, 100, 40, 3),
                              (300000, 32, 16, 4)]:
        g = random_graph(n, cap0, cap, top, seed=n + cap0)
        x = np.random.default_rng(cap0).standard_normal((n, 8)).astype(
            np.float32)
        one = random_chunk(g, 1, n // 10, 500, 200, 8)
        two = random_chunk(g, 2, n // 20, 0, 100, 8)
        cases[f"random {n} x {cap0}"] = (g, [one, two, two], x)
    g = random_graph(5000, 40, 12, 3, seed=3)
    x = np.random.default_rng(3).standard_normal((5000, 8)).astype(
        np.float32)
    for name, chunks in rule_chunks(g, 4, 8).items():
        cases[name] = (g, chunks, x)
    return cases


PATCH_CASES = ("port update, chunks", "port update, one chunk",
               "port graph, rows out of order", "port graph, node-padded",
               "random 20000 x 10", "random 20000 x 32", "random 9000 x 33",
               "random 9000 x 100", "random 300000 x 32", "one id twice",
               "above the top level", "empty chunk")


@pytest.fixture(scope="module")
def patch_cases():
    _card()
    cases = _patch_cases()
    assert set(cases) == set(PATCH_CASES)
    return cases


def _on_card(graph):
    import dataclasses

    return dataclasses.replace(graph, nbr=graph.nbr.cuda(),
                               lvl_off=graph.lvl_off.cuda(),
                               level=graph.level.cuda())


@pytest.mark.parametrize("case", PATCH_CASES)
def test_patch_apply_kernel_matches_plain(patch_cases, case):
    """Kπ (apply_patch on a card graph: three launches a chunk) against its
    plain version (apply_patch on the CPU graph), after every chunk: nbr
    with its padding, lvl_off, level, the graph's scalars and the store's
    rows exactly equal, the store grown where it lives (a card tensor or a
    host array)."""
    from patch_cases import apply_all, assert_same, store_of

    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.persist import patch as tpatch

    graph, chunks, x = patch_cases[case]
    cuda.reset_launches()
    card = apply_all(tpatch.apply_patch, _on_card(graph), chunks,
                     store_of(x, "cuda"))
    torch.cuda.synchronize()
    assert cuda.launches["patch_apply"] == 3 * len(chunks)
    card_host = apply_all(tpatch.apply_patch, _on_card(graph), chunks,
                          store_of(x, None))
    plain = apply_all(tpatch.apply_patch, graph, chunks, store_of(x, "cpu"))
    for k, kh, p in zip(card, card_host, plain):
        assert k[0].nbr.is_cuda and k[1].is_cuda
        assert isinstance(kh[1], np.ndarray) and not p[0].nbr.is_cuda
        assert_same(k, p)
        assert_same(kh, p)


def test_patch_apply_refuses_rows_wider_than_it_sorts():
    """A card graph whose rows are wider than Kπ sorts raises, and is not
    sent to another path."""
    _card()
    from patch_cases import random_chunk, random_graph

    from hnsw_slim_tpu_torch.persist import patch as tpatch

    g = random_graph(64, tpatch.MAX_WIDTH + 6, 8, 1, seed=6)
    with pytest.raises(ValueError, match="sorts rows"):
        tpatch.apply_patch(_on_card(g), random_chunk(g, 1, 6, 2, 1, 0))


def test_sync_patches_on_a_card_copy_pulls_nothing():
    """A client copy on the card synced through several /getLastBatch
    chunks: every apply takes the card path (``client.apply_device`` per
    ``client.apply`` span, three Kπ launches each), no ``client.pull``
    span, and the copy's graph and rows equal the server's."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    from hnsw_slim_tpu_torch.config import HnswConfig, SlimConfig
    from hnsw_slim_tpu_torch.ops import cuda
    from hnsw_slim_tpu_torch.persist import patch as tpatch
    from hnsw_slim_tpu_torch.serve.client import SlimClient
    from hnsw_slim_tpu_torch.serve.server import SlimServer
    from hnsw_slim_tpu_torch.utils import trace

    base, _ = clustered(2200, 16, n_queries=0, n_clusters=20, seed=62)
    server = SlimServer(base[:2000], hnsw_cfg=HnswConfig(M=12,
                                                         ef_construction=64),
                        slim_cfg=SlimConfig.from_ratios(), host="127.0.0.1",
                        port=0, device="cpu", patch_chunk_bytes=3000)
    server.start_background()
    try:
        client = SlimClient(port=server._httpd.server_address[1])
        local = client.bootstrap(device="cuda")
        assert local.graph.nbr.is_cuda and local.vectors.is_cuda
        trace.drain()
        cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CPU]):
            blob, fin = client.update_index(ids=range(2000, 2200),
                                            vectors=base[2000:2200])
            local = client.sync_patches(local, blob, fin)
        torch.cuda.synchronize()
        got = trace.drain()
        names = [s.name for s in got["spans"]]
        applies = names.count("client.apply")
        assert applies > 1 and "client.pull" not in names
        assert got["counters"]["client.apply_device"] == applies
        assert cuda.launches["patch_apply"] == 3 * applies
        g = local.graph
        assert g.nbr.is_cuda and local.vectors.is_cuda and g.n == 2200
        c, w = tpatch.to_np(g), max(g.cap0, g.cap)
        for l in range(g.max_level + 1):
            np.testing.assert_array_equal(
                tpatch._level_rows(c, l, 2200, w),
                tpatch._level_rows(server.inc.host_chal, l, 2200, w))
        np.testing.assert_array_equal(local.vectors.cpu().numpy(),
                                      server.vectors_np[:2200])
    finally:
        server.shutdown()
