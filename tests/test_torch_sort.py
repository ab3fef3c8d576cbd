"""Parity of the NN-descent build's sort kernels — Kκ radix_sort, Kλ
nnd_cand, Kμ run_scatter, Kν rp_window, through their plain versions on
the CPU — against the JAX package: rp_init given JAX's draws, candidate
generation and the mutual union exactly equal, and the f32 key order of
Kκ against torch.sort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.graph import build as jb
from hnsw_slim_tpu.graph import nnd as jn
from hnsw_slim_tpu.ops.distance import sq_norms as jax_sq_norms
from hnsw_slim_tpu.utils.data import clustered
from hnsw_slim_tpu_torch.graph import build as tb
from hnsw_slim_tpu_torch.graph import nnd as tn
from hnsw_slim_tpu_torch.ops import sort

torch.set_num_threads(1)


def _awkward_floats(n, seed):
    """f32 keys with -0.0 and +0.0, +-inf, tiny negatives and many ties."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-12, 12, n).astype(np.float32) / 4
    pick = rng.integers(0, 7, n)
    x[pick == 0] = -0.0
    x[pick == 1] = 0.0
    x[pick == 2] = np.inf
    x[pick == 3] = -np.inf
    x[pick == 4] = -1e-7
    return x


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_f32_sort_key_orders_as_torch_sort(n):
    """Sorting by f32_sort_key (stable, on the u32 words) gives
    torch.sort(stable=True)'s permutation: -0.0 and +0.0 tie in input
    order, +inf last, -inf first; the map is monotone."""
    x = torch.from_numpy(_awkward_floats(n, n))
    want = torch.sort(x, stable=True).indices
    got = torch.sort(sort.f32_sort_key(x), stable=True).indices
    assert torch.equal(got, want)
    key = sort.f32_sort_key(x)
    assert bool(((key[want][1:] - key[want][:-1]) >= 0).all())
    assert int(sort.f32_sort_key(torch.tensor([-0.0]))) == \
        int(sort.f32_sort_key(torch.tensor([0.0])))
    p = torch.arange(n, dtype=torch.int32)
    sk, sp = sort.kv_radix_sort(x, p, 32, "f32")
    assert torch.equal(sp.long(), want)


def _awkward_ints(n, seed):
    """i32 keys at both ends of the range, around zero, and many ties."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-5, 5, n)
    pick = rng.integers(0, 6, n)
    x[pick == 0] = -(2**31)
    x[pick == 1] = 2**31 - 1
    x[pick == 2] = rng.integers(-(2**31), 2**31, int((pick == 2).sum()))
    return x.astype(np.int32)


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_signed_sort_key_orders_as_torch_sort(n):
    """Sorting by signed_sort_key (stable, on the u32 words) gives
    torch.sort(stable=True)'s permutation of i32 keys, ties in input order;
    the signed map of kv_radix_sort gives it too, with and without
    payload."""
    x = torch.from_numpy(_awkward_ints(n, n))
    want = torch.sort(x, stable=True).indices
    key = sort.signed_sort_key(x)
    assert bool(((key >= 0) & (key < 2**32)).all())
    assert torch.equal(torch.sort(key, stable=True).indices, want)
    p = torch.arange(n, dtype=torch.int32)
    sk, sp = sort.kv_radix_sort(x, p, 32, key_map="signed")
    assert torch.equal(sp.long(), want) and torch.equal(sk, x[want])
    ko, none = sort.kv_radix_sort(x, None, 32, key_map="signed")
    assert torch.equal(ko, sk) and none is None


@pytest.mark.parametrize("n_nodes", [1, 2, 255, 256, 1000, 2**20])
def test_ids_sort_key_orders_as_torch_sort(n_nodes):
    """ids_sort_key over n.bit_length() bits on node ids below n with a 25%
    share of the 2^30 padding: every id below the top digit value, every
    padding word tied on it, and a stable sort by it gives
    torch.sort(stable=True)'s permutation of the i32 keys."""
    rng = np.random.default_rng(n_nodes)
    e = 3000
    x = rng.integers(0, n_nodes, e).astype(np.int32)
    x[rng.random(e) < 0.25] = 2**30
    x[:3] = [n_nodes - 1, 0, 2**30]
    t = torch.from_numpy(x)
    bits = max(1, n_nodes.bit_length())
    key = sort.ids_sort_key(t, bits)
    pad = t == 2**30
    assert bool((key[pad] == 2**bits - 1).all())
    assert bool((key[~pad] < 2**bits - 1).all())
    want = torch.sort(t, stable=True).indices
    assert torch.equal(torch.sort(key, stable=True).indices, want)
    sk, sp = sort.kv_radix_sort(t, torch.arange(e, dtype=torch.int32), bits,
                                key_map="ids")
    assert torch.equal(sp.long(), want) and torch.equal(sk, t[want])


@pytest.mark.parametrize("key_bits", [1, 11, 32])
def test_lexsort_and_kv_sort_plain_match_numpy(key_bits):
    """lexsort_stable's two stable passes equal numpy's lexsort, on int and
    on f32 secondary keys; kv_radix_sort reads i32 words as u32."""
    rng = np.random.default_rng(key_bits)
    hi = min(2 ** key_bits, 50)
    prim = rng.integers(0, hi, 3000).astype(np.int32)
    sec = rng.integers(0, hi, 3000).astype(np.int32)
    sp, perm = sort.lexsort_stable(torch.from_numpy(prim),
                                   torch.from_numpy(sec), key_bits)
    want = np.lexsort((sec, prim))
    assert np.array_equal(perm.numpy(), want)
    assert np.array_equal(sp.numpy(), prim[want])
    secf = _awkward_floats(3000, key_bits)
    _, perm = sort.lexsort_stable(torch.from_numpy(prim),
                                  torch.from_numpy(secf), key_bits)
    assert np.array_equal(perm.numpy(),
                          np.lexsort((np.where(secf == 0, 0, secf), prim)))
    words = torch.tensor([-1, 0, 2**31 - 1, -(2**31), 5], dtype=torch.int32)
    k, p = sort.kv_radix_sort(words, torch.arange(5, dtype=torch.int32))
    assert p.tolist() == [1, 4, 2, 3, 0]


def test_rp_init_with_jax_draws_matches_jax():
    """rp_init given the draws JAX makes (dirs and the random fill, split
    from the same key as nnd.py:103-104, 122): ids equal on >= 0.99 of rows
    (Kδ's tolerance: the projections' fp32 sums may reorder near-ties), and
    the candidate rows of the warm start exactly equal when both take JAX's
    projection."""
    base, _ = clustered(1024, 16, n_clusters=8, seed=4, scale=0.5)
    n, d = base.shape
    k, n_proj, n_valid = 24, 4, n - 24
    key = jax.random.PRNGKey(9)
    ji, jd, jf = jn.rp_init(key, jnp.asarray(base),
                            jax_sq_norms(jnp.asarray(base)),
                            jnp.int32(n_valid), k=k, n_proj=n_proj,
                            chunk=256, metric="l2")
    k1, k2 = jax.random.split(key)
    w = max(2, k // (2 * n_proj))
    dirs = np.array(jax.random.normal(k1, (d, n_proj), jnp.float32))
    rnd = np.array(jax.random.randint(
        k2, (n, max(0, k - 2 * w * n_proj)), 0, n_valid, dtype=jnp.int32))
    x = torch.from_numpy(base)
    pi, pd, pf = tn.rp_init(None, x, x.pow(2).sum(1), n_valid, k=k,
                            n_proj=n_proj, metric="l2",
                            draws=(torch.from_numpy(dirs),
                                   torch.from_numpy(rnd).long()))
    same = (pi.numpy() == np.asarray(ji)).all(axis=1)
    assert same.mean() >= 0.99
    assert (pf.numpy()[same] == np.asarray(jf)[same]).all()

    # the candidate rows alone, from one projection matrix
    proj = (base @ dirs).astype(np.float32)
    cand = tn.rp_candidates(torch.from_numpy(proj), n_valid, w,
                            torch.from_numpy(rnd).long())
    iota = np.arange(n)
    offs = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])
    cols = []
    for p in range(n_proj):
        order = np.asarray(jnp.argsort(jnp.where(iota < n_valid,
                                                 proj[:, p], jnp.inf)))
        rank = np.argsort(order, kind="stable")
        c = order[np.clip(rank[:, None] + offs[None], 0, n - 1)]
        cols.append(np.where(c < n_valid, c, -1))
    assert np.array_equal(cand.numpy(), np.concatenate(cols + [rnd], 1))


@pytest.mark.parametrize("k,s_fwd,r_rev,n_valid", [
    (16, 10, 8, 984), (16, 16, 8, 1024), (20, 5, 12, 1000), (64, 40, 32, 1024)])
def test_nnd_candidates_edge_cases_match_jax(k, s_fwd, r_rev, n_valid):
    """_nnd_candidates (Kλ both modes, Kκ, Kμ) given JAX's draws: candidates
    and cleared flags exactly equal, with s_fwd < k, n_valid < n, rows with
    every slot empty, rows with fewer filled slots than s_fwd (+inf pivots
    still cleared), and hub targets whose runs pass r_rev."""
    n = 1024
    rng = np.random.default_rng(k + s_fwd)
    ids = rng.integers(0, n, (n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.3] = -1
    ids[:30] = -1                      # all empty
    ids[30:60, 3:] = -1                # fewer filled than s_fwd
    ids[60:200, :4] = 7                # a hub target
    newf = rng.integers(0, 2, (n, k)).astype(np.int32)
    key = jax.random.PRNGKey(k)
    jc, jf = jn._nnd_candidates(key, jnp.asarray(ids), jnp.asarray(newf),
                                jnp.int32(n_valid), s_fwd=s_fwd, r_rev=r_rev)
    k1, k2, k3 = jax.random.split(key, 3)
    k4, k5 = jax.random.split(k3)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k1, (n, k)),
        jax.random.randint(k2, (n, s_fwd), 0, k),
        jax.random.randint(k4, (n, s_fwd), 0, r_rev),
        jax.random.randint(k5, (n, s_fwd), 0, k)))
    draws = draws[:1] + tuple(a.long() for a in draws[1:])
    pc, pf = tn._nnd_candidates(torch.from_numpy(ids),
                                torch.from_numpy(newf), n_valid,
                                s_fwd=s_fwd, r_rev=r_rev, draws=draws)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("case", ["signed_zeros", "negatives", "ties",
                                  "all_dropped"])
def test_mutual_union_edge_cases_match_jax(case):
    """mutual_union (Kκ lexsorts, Kμ dedup and scatter, Kθ counts) exactly
    equal to JAX's rows and counts: distances of -0.0 and +0.0 side by side,
    slightly negative distances (the norm expansion of _edge_dists), heavy
    ties, and runs whose every entry is dropped (-1 rows, repeated pairs)."""
    rng = np.random.default_rng(len(case))
    n, m = 700, 10
    sel = rng.integers(0, n, (n, m)).astype(np.int32)
    sel[rng.random((n, m)) < 0.2] = -1
    d_sel = (rng.integers(0, 6, (n, m)) / 4).astype(np.float32)
    if case == "signed_zeros":
        d_sel[rng.random((n, m)) < 0.4] = -0.0
        d_sel[rng.random((n, m)) < 0.2] = 0.0
    elif case == "negatives":
        d_sel -= 1e-6 * rng.integers(0, 3, (n, m))
    elif case == "ties":
        d_sel[:] = 1.0
        sel[:, 5:] = sel[:, :5]  # repeated pairs
    else:
        sel[: n // 2] = -1
        sel[n // 2:, :] = sel[n // 2:, :1]
    for w in (4, 26):
        jr, jc = jb.mutual_union(jnp.asarray(sel), jnp.asarray(d_sel),
                                 w_union=w)
        pr, pc = tb.mutual_union(torch.from_numpy(sel),
                                 torch.from_numpy(d_sel), w_union=w)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def test_run_scatter_and_dedup_plain_semantics():
    """Kμ's plain versions: a run's rank counts its dropped entries (payload
    >= n_valid, key n), kept entries land at (key, rank); a repeated pair is
    marked n."""
    keys = torch.tensor([0, 0, 0, 2, 2, 3, 3, 3], dtype=torch.int32)
    pay = torch.tensor([9, 1, 2, 4, 5, 6, 7, 8], dtype=torch.int32)
    rows = sort.run_scatter(keys, pay, 3, 2, n_valid=9)
    assert rows.tolist() == [[-1, 1], [-1, -1], [4, 5]]
    vals = torch.tensor([1, 1, 2, 3, 3, 3, 4, 4], dtype=torch.int32)
    assert sort.dedup_pairs(keys, vals, 9).tolist() == [0, 9, 0, 2, 9, 3, 3,
                                                        9]
