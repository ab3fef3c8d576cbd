"""Kα's launch plan (index/bruteforce.py scan_plan) and the plain twin of
Kε's one-launch descent (graph/search.py greedy_descent_levels_plain),
on the CPU.

The plan is a pure function of the call's shape: every mode and shape the
port launches (ground truth, seeds, a server batch, strata, estimate mode,
the KMeans assignment, wide rows) must get a tile whose shared memory fits
a block, at least one split, no more splits than row tiles, one split per
segment in strata mode, for batches of at most 64 queries a block on every
SM, and for rows too wide for a resident query tile a chunk of whole 32-dim
slabs of it.

The descent runs on a small seeded graph of random neighbor rows (holes,
empty rows) over vectors and queries whose coordinates are multiples of 1/8
in [-4, 4], so every distance and estimate is exact in fp32 whatever the
order of the sums: the port's twin, JAX's greedy_level (greedy_level_scored
with the SlimQ estimate scorer for the quant form) applied level by level
with the same per-query stop levels, and a numpy replay of JAX's loop must
give the same cur exactly and curdist within 1e-4 * (1 + |d|) (the
tolerance of the port's greedy_descent_plain tests); hops and dcomp, which
JAX's greedy_level does not return, are held exactly against the replay
(rows fetched: the moves plus the final look; valid ids of each row
fetched) and against the per-level plain calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.graph import search as jgs
from hnsw_slim_tpu.index.slimq import _unpack_fields as j_unpack
from hnsw_slim_tpu.quant import estimator as jest
from hnsw_slim_tpu_torch.graph import search as gs
from hnsw_slim_tpu_torch.index import bruteforce as bf
from hnsw_slim_tpu_torch.quant.estimator import QuantScorer

torch.set_num_threads(1)
SMS = 132  # the H100's SMs


# ---- the launch plan -----------------------------------------------------

SHAPES = [  # (case, b, n, d, k, extra plan arguments)
    ("ground truth 512", 512, 1_000_000, 128, 10, {}),
    ("ground truth 4096", 4096, 1_000_000, 128, 10, {}),
    ("ground truth 8192", 8192, 1_000_000, 128, 10, {}),
    ("seeds", 4096, 32768, 128, 32, {}),
    ("server batch", 12, 32768, 128, 32, {}),
    ("one query", 1, 32768, 128, 32, {}),
    ("64 queries", 64, 32768, 128, 32, {}),
    ("65 queries", 65, 32768, 128, 32, {}),
    ("strata 4 x 8", 4096, 32768, 128, 8, {"strata": 4}),
    ("strata 32 x 1", 4096, 32768, 128, 1, {"strata": 32}),
    ("estimate", 4096, 32768, 128, 32, {"c": 16}),
    ("estimate server", 12, 32768, 128, 32, {"c": 16}),
    ("kmeans", 262144, 16, 128, 1, {}),
    ("kmeans tail", 1000, 16, 128, 1, {}),
    ("subset self-masked k64", 8192, 100000, 128, 64, {}),
    ("bf16 seeds", 4096, 16384, 128, 32, {}),
    ("deep 96", 4096, 1_000_000, 96, 10, {}),
    ("gist 960", 4096, 1_000_000, 960, 10, {}),
    ("wide 2048", 4096, 100000, 2048, 64, {}),
    ("wide 3072 server", 12, 100000, 3072, 32, {}),
    ("wide 4096", 4096, 100000, 4096, 10, {}),
    ("wide 4096 estimate", 48, 100000, 4096, 32, {"c": 64}),
    ("tiny table", 100, 5, 16, 8, {}),
    ("k over n", 10, 7, 16, 32, {}),
]


@pytest.mark.parametrize("case,b,n,d,k,kw", SHAPES, ids=[s[0] for s in
                                                         SHAPES])
def test_scan_plan_fits_and_covers(case, b, n, d, k, kw):
    p = bf.scan_plan(b, n, d, k, SMS, **kw)
    _, bq, bn = bf.SCAN_TILES[p.tile]
    dp = -(-d // 32) * 32
    resident = bf.scan_smem(p.tile, d, k, kw.get("c", 0))
    assert p.qdims == dp if resident <= bf.SMEM_MAX else 32 <= p.qdims < dp
    assert p.qdims % 32 == 0
    assert p.smem == bf.scan_smem(p.tile, d, k, kw.get("c", 0), p.qdims)
    assert p.smem <= bf.SMEM_MAX
    assert p.blocks_per_sm >= 1
    assert (p.smem + 1024) * p.blocks_per_sm <= bf.SM_SMEM
    tiles = -(-n // bn)
    if "strata" in kw:
        assert p.splits == kw["strata"]
    else:
        assert 1 <= p.splits <= max(1, min(tiles, bf.MAX_SPLITS))
    qt = -(-b // bq)
    if b <= 64 and qt * tiles >= SMS and "strata" not in kw:
        assert qt * p.splits >= SMS  # a block on every SM
    # the query tile wastes at most 4x the batch (none above 64 queries)
    assert bq <= max(16, 4 * b) or p.tile in "LM"


def test_scan_plan_tiles_by_shape():
    assert bf.scan_plan(262144, 16, 128, 1, SMS).tile == "T"
    assert bf.scan_plan(4096, 1_000_000, 128, 10, SMS).tile == "L"
    assert bf.scan_plan(4096, 32768, 128, 32, SMS).tile == "M"
    assert bf.scan_plan(4096, 32768, 128, 64, SMS).blocks_per_sm == 2
    assert bf.scan_plan(48, 32768, 128, 32, SMS).tile == "U"
    assert bf.scan_plan(12, 32768, 128, 32, SMS).tile == "U"
    # rows too wide for a resident query tile fall to a smaller tile, and
    # past U's room U stages its queries in chunks: the most that leave two
    # blocks an SM
    for b, d, k, tile, qdims in [(4096, 960, 10, "U", 960),
                                 (4096, 4096, 32, "U", 1216),
                                 (4096, 4096, 64, "U", 1152),
                                 (48, 3000, 32, "U", 3008),
                                 (48, 4096, 32, "U", 1216)]:
        p = bf.scan_plan(b, 100000, d, k, SMS)
        assert (p.tile, p.qdims) == (tile, qdims)
        assert p.blocks_per_sm >= 2 or p.qdims == -(-d // 32) * 32
    # no room for L's g_add rows: the next tile
    assert bf.scan_plan(4096, 100000, 128, 10, SMS, c=400).tile == "U"


@pytest.mark.parametrize("sms", [1, 8, 66, 132, 264])
def test_scan_plan_splits_follow_the_card(sms):
    p = bf.scan_plan(12, 32768, 128, 32, sms)
    if sms <= 256:  # 256 row tiles: a block for every SM
        assert p.splits >= sms
    assert p.splits <= 256
    assert bf.scan_plan(4096, 32768, 128, 8, sms, strata=4).splits == 4


@pytest.mark.parametrize("k", [1, 10, 32, 33, 64])
def test_topk_dist_cpu_path_keeps_its_semantics(k):
    """The wrapper on CPU tensors: the plain version, (inf, -1) past the
    valid rows, self row masked, rows with a negative id masked."""
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.integers(-32, 33, (40, 16)) / 8, dtype=torch.float32)
    q = x[3:9].clone()
    xn = (x * x).sum(1)
    ids = torch.arange(40, dtype=torch.int32)
    ids[::5] = -1
    d, i = bf.topk_dist(q, x, xn, k, n_valid=30, row_ids=ids, self_offset=3)
    ok = i >= 0
    assert bool(((i < 30) | ~ok).all())
    assert bool((torch.isinf(d) == ~ok).all())
    assert not bool((i == torch.arange(3, 9)[:, None]).any())
    assert not bool(((i % 5 == 0) & ok).any())
    nvalid = 30 - 6 - 1  # rows under n_valid, minus the -1 ids and self
    assert int(ok.sum(1).min()) == min(k, nvalid)


# ---- the one-launch descent against JAX -----------------------------------

N, D, W, TOP, C = 400, 32, 12, 3, 4


def _dyadic(rng, *shape):
    return (rng.integers(-32, 33, shape) / 8).astype(np.float32)


@pytest.fixture(scope="module")
def graph():
    """Vectors, queries, per-level dense rows (levels TOP..1; holes, empty
    rows, ids out of the level as in a real graph's upper levels), the rank
    and CHAL forms of the same rows, entry points and stop levels."""
    rng = np.random.default_rng(7)
    x = _dyadic(rng, N, D)
    q = _dyadic(rng, 64, D)
    rows = {}
    for lv in range(1, TOP + 1):
        r = rng.integers(0, N, (N, W)).astype(np.int32)
        r[rng.random((N, W)) < 0.2] = -1
        r[rng.random(N) < 0.05] = -1  # empty rows
        rows[lv] = r
    # rank form: nodes absent from a level have no row (rank -1)
    ranks, dense = {}, {}
    for lv, r in rows.items():
        have = rng.random(N) < 0.9
        rank = np.full(N, -1, np.int32)
        rank[have] = np.arange(have.sum(), dtype=np.int32)
        ranks[lv], dense[lv] = rank, r[have]
        rows[lv] = np.where(have[:, None], r, -1)  # what every form reads
    # CHAL: node v's slice at level l holds its valid ids in lane order
    nbr, lvl_off = [], np.zeros((N, TOP + 2), np.int32)
    for v in range(N):
        lvl_off[v, 0] = lvl_off[v, 1] = len(nbr)  # no level-0 slice here
        for lv in range(1, TOP + 1):
            nbr += [int(t) for t in rows[lv][v] if t >= 0]
            lvl_off[v, lv + 1] = len(nbr)
    entry = rng.integers(0, N, 64).astype(np.int32)
    stop = rng.integers(0, TOP + 1, 64).astype(np.int32)
    stop[:4] = TOP  # some queries walk no level
    stop[4:8] = 0
    return dict(x=x, q=q, rows=rows, ranks=ranks, dense=dense,
                nbr=np.asarray(nbr, np.int32), lvl_off=lvl_off, entry=entry,
                stop=stop)


def _compacted(row):
    return row[row >= 0]


def _replay(g, dist, cur, curdist, stop):
    """numpy replay of JAX's greedy_level rule, level by level: (cur,
    curdist, hops, dcomp)."""
    cur, curdist = cur.copy(), curdist.copy()
    hops = np.zeros(len(cur), np.int32)
    dcomp = np.zeros(len(cur), np.int32)
    for lv in range(TOP, 0, -1):
        for b in range(len(cur)):
            if stop[b] >= lv:
                continue
            while True:
                hops[b] += 1
                ids = _compacted(g["rows"][lv][cur[b]])
                dcomp[b] += len(ids)
                if not len(ids):
                    break
                d = dist(b, ids)
                m = d.min()
                if not m < curdist[b]:
                    break
                cur[b], curdist[b] = ids[d == m].min(), m
    return cur, curdist, hops, dcomp


def _fetches(g, form):
    """(port fetches level TOP..1, JAX fetches level TOP..1)."""
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    if form == "dense":
        return ([t(g["rows"][lv]) for lv in range(TOP, 0, -1)],
                [jgs.make_dense_fetch(jnp.asarray(g["rows"][lv]))
                 for lv in range(TOP, 0, -1)])
    if form == "rank":
        return ([gs.rank_fetch(t(g["ranks"][lv]), t(g["dense"][lv]))
                 for lv in range(TOP, 0, -1)],
                [jgs.make_rank_fetch(jnp.asarray(g["ranks"][lv]),
                                     jnp.asarray(g["dense"][lv]))
                 for lv in range(TOP, 0, -1)])
    return ([gs.chal_fetch(t(g["nbr"]), t(g["lvl_off"]), lv, W)
             for lv in range(TOP, 0, -1)],
            [jgs.make_chal_fetch(jnp.asarray(g["nbr"]),
                                 jnp.asarray(g["lvl_off"]), lv, W)
             for lv in range(TOP, 0, -1)])


def _check(got, jax_cur, jax_d, rep, per_level):
    cur, curdist, hops, dcomp = (a.numpy() for a in got)
    np.testing.assert_array_equal(cur, np.asarray(jax_cur))
    np.testing.assert_array_equal(cur, rep[0])
    jd = np.asarray(jax_d)
    assert np.all(np.abs(curdist - jd) <= 1e-4 * (1 + np.abs(jd)))
    np.testing.assert_array_equal(hops, rep[2])
    np.testing.assert_array_equal(dcomp, rep[3])
    for a, b in zip(got, per_level):
        assert torch.equal(a, b)


def _per_level(vectors, q, qn, fetches, cur, curdist, stop, scorer=None):
    hops = torch.zeros(len(cur), dtype=torch.int32)
    dcomp = torch.zeros_like(hops)
    for i, f in enumerate(fetches):
        cur, curdist, h, dc = gs.greedy_descent_plain(
            vectors, q, qn, f, cur, curdist, stop < TOP - i, scorer=scorer)
        hops, dcomp = hops + h, dcomp + dc
    return cur, curdist, hops, dcomp


@pytest.mark.parametrize("form", ["dense", "rank", "chal"])
@pytest.mark.parametrize("stops", ["per query", "all walk", "none walk"])
def test_descent_levels_twin_matches_jax(graph, form, stops):
    g = graph
    stop = {"per query": g["stop"], "all walk": np.zeros(64, np.int32),
            "none walk": np.full(64, TOP, np.int32)}[stops]
    x, q = g["x"], g["q"]
    qn = (q.astype(np.float64) ** 2).sum(1).astype(np.float32)
    cur0 = g["entry"]
    d0 = ((q - x[cur0]) ** 2).sum(1).astype(np.float32)

    def dist(b, ids):
        return ((q[b] - x[ids]) ** 2).sum(1)

    rep = _replay(g, dist, cur0, d0, stop)
    pf, jf = _fetches(g, form)
    tx, tq = torch.as_tensor(x), torch.as_tensor(q)
    tqn = torch.as_tensor(qn)
    ts = torch.as_tensor(stop)
    got = gs.greedy_descent_levels(tx, tq, tqn, pf, TOP,
                                   torch.as_tensor(cur0),
                                   torch.as_tensor(d0), ts)
    jx, jq = jnp.asarray(x), jnp.asarray(q)
    jc, jd = jnp.asarray(cur0), jnp.asarray(d0)
    for i, f in enumerate(jf):
        jc, jd = jgs.greedy_level(
            f, jx, None, jq, jnp.asarray(qn), jc, jd,
            jnp.asarray(stop < TOP - i), "l2", jax.lax.Precision.HIGHEST)
    _check(got, jc, jd, rep, _per_level(tx, tq, tqn, pf, torch.as_tensor(cur0),
                                        torch.as_tensor(d0), ts))


@pytest.mark.parametrize("use_ex", [False, True])
def test_descent_levels_twin_matches_jax_on_estimates(graph, use_ex):
    """The quant form: packed code rows of random bits and dyadic factors,
    the entry point scored first (curdist None), per-query stop levels."""
    g = graph
    rng = np.random.default_rng(11)
    nb, ex_bits = D // 32, 2
    words = rng.integers(0, 2**32, (N, nb * (1 + ex_bits)), dtype=np.uint64)
    fac = np.stack([rng.integers(-64, 65, N) / 16,  # f_add
                    rng.integers(8, 33, N) / 16,    # f_rescale
                    rng.integers(-64, 65, N) / 16,  # f_add_ex
                    rng.integers(8, 33, N) / 16],   # f_rescale_ex
                   axis=1).astype(np.float32)
    cid = rng.integers(0, C, N).astype(np.uint32)
    packed = np.concatenate([words.astype(np.uint32), fac.view(np.uint32),
                             cid[:, None]], axis=1)
    q_rot = g["q"]
    sumq = q_rot.sum(1)
    g_add = _dyadic(rng, 64, C)
    stop = g["stop"]

    def unpack(u):  # bits of words u[..., nb] as {0, 1} floats, LSB first
        return ((u[..., None] >> np.arange(32)) & 1).reshape(
            *u.shape[:-1], -1).astype(np.float64)

    def dist(b, ids):
        r = packed[ids]
        ip = unpack(r[:, :nb]) @ q_rot[b]
        f = r[:, nb * (1 + ex_bits):nb * (1 + ex_bits) + 4].view(np.float32)
        ga = g_add[b, r[:, -1]]
        if not use_ex:
            return f[:, 0] + ga + f[:, 1] * (ip - 0.5 * sumq[b])
        ipx = sum(2.0 ** e * (unpack(r[:, nb * (1 + e):nb * (2 + e)])
                              @ q_rot[b]) for e in range(ex_bits))
        two = 2.0 ** ex_bits
        return f[:, 2] + ga + f[:, 3] * ((two * ip + ipx)
                                         - (two - 0.5) * sumq[b])

    cur0 = g["entry"]
    d0 = np.array([dist(b, cur0[b:b + 1])[0] for b in range(64)], np.float32)
    rep = _replay(g, dist, cur0, d0, stop)
    sc = QuantScorer(torch.as_tensor(packed.view(np.int32)), nb, ex_bits,
                     use_ex, torch.as_tensor(q_rot), torch.as_tensor(sumq),
                     torch.as_tensor(g_add))
    pf, jf = _fetches(g, "rank")
    ts = torch.as_tensor(stop)
    got = gs.greedy_descent_levels(None, None, None, pf, TOP,
                                   torch.as_tensor(cur0), None, ts,
                                   scorer=sc)
    jpacked = jnp.asarray(packed)
    jqr, jsq, jga = jnp.asarray(q_rot), jnp.asarray(sumq), jnp.asarray(g_add)

    def score(safe_ids, valid):  # JAX index/slimq.py _slimq_search_jit's
        bc, ex, fa, fr, fae, fre, ci = j_unpack(jpacked[safe_ids], nb,
                                                ex_bits)
        onehot = (ci[:, :, None] == jnp.arange(C)[None, None, :]).astype(
            jnp.float32)
        ga = jnp.einsum("bwc,bc->bw", onehot, jga)
        d = (jest.est_dist_ex(jqr, jsq, bc, ex, fae, fre, ga, ex_bits)
             if use_ex else jest.est_dist_1bit(jqr, jsq, bc, fa, fr, ga))
        return jnp.where(valid, d, jnp.inf)

    jc = jnp.asarray(cur0)
    jd = score(jc[:, None], jnp.ones((64, 1), bool))[:, 0]
    for i, f in enumerate(jf):
        jc, jd = jgs.greedy_level_scored(f, score, jc, jd,
                                         jnp.asarray(stop < TOP - i))
    _check(got, jc, jd, rep,
           _per_level(None, None, None, pf, torch.as_tensor(cur0), None, ts,
                      sc))


def test_descent_levels_twin_with_no_level_scores_the_entry(graph):
    """No level to walk: the entry's estimate only (the SlimQ search of a
    graph without upper levels), hops and dcomp zero."""
    g = graph
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 2**31, (N, 1 + 1 + 5)).astype(np.int32)
    packed[:, 2:6] = np.ones((N, 4), np.float32).view(np.int32)
    packed[:, 6] = rng.integers(0, C, N)
    sc = QuantScorer(torch.as_tensor(packed), 1, 1, False,
                     torch.as_tensor(g["q"]), torch.as_tensor(g["q"].sum(1)),
                     torch.as_tensor(_dyadic(rng, 64, C)))
    cur = torch.as_tensor(g["entry"])
    c, d, h, dc = gs.greedy_descent_levels(None, None, None, [], 0, cur, None,
                                           scorer=sc)
    assert torch.equal(c, cur)
    assert int(h.sum()) == 0 and int(dc.sum()) == 0
    c1, d1, _, _ = gs.greedy_descent_plain(None, None, None, torch.zeros(
        (N, 1), dtype=torch.int32), cur, None,
        torch.zeros(64, dtype=torch.bool), scorer=sc)
    assert torch.equal(d, d1)


@pytest.mark.parametrize("kernel", ["descent", "beam"])
def test_plain_seen_ids_are_the_calls_reads(graph, kernel):
    """The ``seen`` ids of the plain Kε and Kβ (what chip_smoke.py's bounds
    count once each): one fetched row a hop and one id a distance, every
    one a node of the level, equal to the replay's for the descent."""
    g = graph
    x, q = torch.as_tensor(g["x"]), torch.as_tensor(g["q"])
    qn = (q * q).sum(1)
    rows = torch.as_tensor(g["rows"][1])
    cur = torch.as_tensor(g["entry"])
    d0 = ((q - x[cur.long()]) ** 2).sum(1)
    seen = []
    if kernel == "descent":
        _, _, hops, dcomp = gs.greedy_descent_plain(x, q, qn, rows, cur, d0,
                                                    seen=seen)
    else:
        _, _, hops, dcomp = gs.beam_search_plain(
            x, q, qn, rows, d0[:, None], cur[:, None], P=16, ef_eff=16,
            pop_width=2, cw=gs.cand_width(16, 2, W, 0), max_iters=64, k=8,
            seen=seen)
    fetched = torch.cat([a for a, _ in seen])
    scored = torch.cat([b for _, b in seen])
    assert len(fetched) == int(hops.sum()) and len(scored) == int(dcomp.sum())
    assert bool((fetched >= 0).all()) and bool((scored >= 0).all())
    assert set(scored.tolist()) <= set(rows[fetched.long()].flatten().tolist())
    if kernel == "descent":  # the numpy replay, walking level TOP only
        one = {**g, "rows": {TOP: g["rows"][1]}}
        rep = _replay(one, lambda b, ids: ((g["q"][b] - g["x"][ids]) ** 2)
                      .sum(1), g["entry"], d0.numpy(), np.full(64, TOP - 1))
        np.testing.assert_array_equal(hops.numpy(), rep[2])
        np.testing.assert_array_equal(dcomp.numpy(), rep[3])
