"""The insert apply's reverse connects (graph/revconn.py apply_insert: on
the CPU, Kγ's and Kζ's plain versions, ``append_overflow_plain`` being the
JAX program's composition) against the JAX package's apply_insert on
crowded synthetic inputs, and the query norms a caller hands to the seed
scan (index/bruteforce.py topk_dist / topk_dist_strata ``qn``;
graph/search.py chal_search computes them once).

Inputs are made from a seed with numpy: 300 old nodes with partly filled
rows of cap ids, 64 inserted nodes whose candidates crowd 20 hot nodes, so
that several targets overflow their rows. Every case is exact: the
adjacency, the degrees and both overflow counters equal JAX's, and norms
handed in give bit-equal scans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.graph.revconn import apply_insert as jax_apply_insert
from hnsw_slim_tpu_torch.graph import revconn
from hnsw_slim_tpu_torch.graph import search as gs
from hnsw_slim_tpu_torch.index import bruteforce as bf
from hnsw_slim_tpu_torch.ops import distance as tdist
from torch_slice_util import dataset, jax_graph_dir, slim_pair

torch.set_num_threads(1)


def _crowded(seed: int, p_rows: int = 64, cap: int = 8, hot: int = 20,
             fill: int = 8, n_old: int = 300, d: int = 16, c: int = 12):
    """(vectors, adj, deg, a_ids, cand) as numpy: old rows left-packed with
    0..fill distinct old ids, candidates of each insert drawn first from
    the hot nodes, -1 padded."""
    rng = np.random.default_rng(seed)
    n = n_old + p_rows
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    adj = np.full((n, cap), -1, np.int32)
    deg = np.zeros(n, np.int32)
    for u in range(n_old):
        k = int(rng.integers(0, fill + 1))
        adj[u, :k] = rng.choice(np.delete(np.arange(n_old), u), k,
                                replace=False)
        deg[u] = k
    a_ids = np.arange(n_old, n, dtype=np.int32)
    cand = np.full((p_rows, c), -1, np.int32)
    for i in range(p_rows):
        k = int(rng.integers(1, c + 1))
        pool = np.concatenate([
            rng.choice(hot, min(hot, 6), replace=False),
            rng.choice(np.arange(hot, n_old), 6, replace=False)])
        cand[i, :k] = pool[:k]
    return vecs, adj, deg, a_ids, cand


def _both(vecs, adj, deg, a_ids, cand, *, of_t, new_w, M=4):
    """apply_insert of both engines on copies of the same state: (JAX adj,
    deg, of_edges, of_targets), (port's)."""
    vn = (vecs * vecs).sum(1)
    cap = adj.shape[1]
    kw = dict(M=M, cap=cap, metric="l2", of_t=of_t, new_w=new_w)
    ja, jd, je, jt = jax_apply_insert(
        jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(vecs),
        jnp.asarray(vn), jnp.asarray(a_ids), jnp.asarray(cand),
        jnp.int32(len(a_ids)), **kw)
    ta, td = torch.from_numpy(adj.copy()), torch.from_numpy(deg.copy())
    te, tt = revconn.apply_insert(
        ta, td, torch.from_numpy(vecs), torch.from_numpy(vn),
        torch.from_numpy(a_ids), torch.from_numpy(cand), **kw)
    return ((np.asarray(ja), np.asarray(jd), int(je), int(jt)),
            (ta.numpy(), td.numpy(), int(te), int(tt)))


# case: (seed, inserts, cap, hot nodes, old rows' most ids, of_t, new_w);
# of_t None: exactly the overflow target count, found by a first run
CASES = {
    "of_t below the targets": (0, 64, 8, 20, 8, 2, 8),
    "of_t at the targets": (0, 64, 8, 20, 8, None, 8),
    "of_t above the targets": (0, 64, 8, 20, 8, 4096, 8),
    "new_w below a target's overflow": (1, 64, 8, 20, 8, 4096, 1),
    "no overflow": (2, 16, 32, 200, 8, 4096, 8),
    "no edges": (3, 0, 8, 20, 8, 4096, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_insert_crowded_matches_jax(case):
    """apply_insert on crowded inputs: rows, degrees and both counters
    exactly equal to JAX's."""
    seed, p_rows, cap, hot, fill, of_t, new_w = CASES[case]
    state = _crowded(seed, p_rows, cap, hot, fill)
    if of_t is None:
        of_t = _both(*state, of_t=4096, new_w=new_w)[0][3]
    j, t = _both(*state, of_t=of_t, new_w=new_w)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2:] == j[2:]
    of_e, of_tc = j[2:]
    if case == "no overflow" or case == "no edges":
        assert of_e == 0 and of_tc == 0
    else:
        assert of_tc > 2 and of_e > of_tc  # a target overflows by several
    if case == "of_t at the targets":
        assert of_t == of_tc


def test_append_overflow_plain_numbers_targets_from_the_runs():
    """append_overflow_plain (the JAX program's two sorts) on a crowded
    batch: each target's overflow edges are the tail of its run in the
    sorted list, and the targets ascend — what the kernel's scan relies
    on."""
    vecs, adj, deg, a_ids, cand = (torch.from_numpy(a) for a in _crowded(0))
    vn = (vecs * vecs).sum(1)
    sel, cnt = revconn.rng_prune(
        vecs, vn, a_ids, cand, torch.full((len(a_ids),), 4,
                                          dtype=torch.int32),
        keep_all_under_m=True, keep_pruned=False, out_width=4, metric="l2",
        m_max=4)
    adj[a_ids.long()] = torch.nn.functional.pad(sel, (0, 4), value=-1)
    deg[a_ids.long()] = cnt
    us, ps = revconn.reverse_edges(a_ids, sel, adj.shape[0])
    deg0 = deg.clone()
    ut, base, rows, of_e, of_tc = revconn.append_overflow_plain(
        adj, deg, us, ps, 4096, 8)
    real = ut[ut < revconn.BIG]
    assert len(real) == int(of_tc) > 0 and bool((real[1:] > real[:-1]).all())
    assert torch.equal(base[:len(real)], real)
    for t, u in enumerate(real.tolist()):
        run = (us == u).nonzero()[:, 0]
        fit = 8 - int(deg0[u])
        tail = ps[run[fit:]][:8]
        assert torch.equal(rows[t, 8:8 + len(tail)], tail)
        assert bool((rows[t, 8 + len(tail):] == -1).all())
        assert torch.equal(rows[t, :8], adj[u])
    assert int(of_e) == int(sum(
        max(0, int((us == u).sum()) - (8 - int(deg0[u])))
        for u in real.tolist()))


@pytest.mark.parametrize("fn", ["topk_dist", "topk_dist_plain",
                                "topk_dist_strata", "topk_dist_strata_plain"])
def test_topk_scan_with_given_qn_is_bit_equal(fn):
    """The seed scans with the queries' norms handed in equal the scans that
    compute them (distances and ids bit for bit)."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((512, 24)).astype(np.float32))
    xn = tdist.sq_norms(x)
    ids = torch.arange(512, dtype=torch.int32)
    ids[::7] = -1
    qn = tdist.sq_norms(q)
    f = getattr(bf, fn)
    args = (q, x, xn, 16) if "strata" not in fn else (q, x, xn, ids, 16, 4)
    kw = dict(row_ids=ids) if "strata" not in fn else {}
    a = f(*args, **kw)
    b = f(*args, **kw, qn=qn)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("strata", [0, 4])
def test_seeded_search_takes_query_norms_once(tmp_path_factory, strata):
    """A seeded Slim search (seed table scan, then the beam) computes its
    queries' norms once: chal_search hands them to the seed scan."""
    from hnsw_slim_tpu_torch.config import SearchConfig

    _, idx = slim_pair(jax_graph_dir(tmp_path_factory) / "slim.npz",
                       "dense0")
    _, queries = dataset()
    idx.scfg = SearchConfig(ef=64, pop_width=8, seed_width=32,
                            seed_strata=strata)
    idx.search(queries, 10)  # builds the seed table and its norms
    calls = []
    real = tdist.sq_norms

    def counted(x):
        if tuple(x.shape) == queries.shape:
            calls.append(x)
        return real(x)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (tdist, gs, bf):
            mp.setattr(mod, "sq_norms", counted)
        _, ids = idx.search(queries, 10)
    assert len(calls) == 1
    assert (ids >= 0).all()
