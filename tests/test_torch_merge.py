"""The plain versions of K19 (parallel/merge.py merge_topk_plain) and K1
(ops/distance.py gathered_dist_plain, point_dist_plain) against numpy and
the JAX package, the chunked sq_norms of a bfloat16 table, and the port's
package surface.

Tolerances: the merge is exact (ids, distances, sums); K1 within 1e-5 *
(1 + |d|) of JAX's einsum (fp32 sums in another order); sq_norms within
1e-6 relative."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.ops import distance as jdist
from hnsw_slim_tpu_torch.ops import distance as tdist
from hnsw_slim_tpu_torch.parallel.merge import merge_topk, merge_topk_plain

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _reference(d, ids, gid, shard_tables: bool):
    """numpy form of the JAX code: gid map, +inf where the global id is <
    0, stable sort by distance of the shard-major concatenation, first k."""
    s, b, k = d.shape
    if shard_tables:
        g = np.stack([gid[i][np.maximum(ids[i], 0)] for i in range(s)])
    else:
        g = gid[np.maximum(ids, 0)]
    gi = np.where(ids >= 0, g, -1)
    dd = np.where(gi >= 0, d, np.inf).astype(np.float32)
    cat_d = dd.transpose(1, 0, 2).reshape(b, s * k)
    cat_i = gi.transpose(1, 0, 2).reshape(b, s * k)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(cat_d, order, 1),
            np.take_along_axis(cat_i, order, 1))


def _lists(rng, s, b, k, n_per, ties: bool):
    """Per-shard sorted lists with the adversarial cases: distances drawn
    from a few values (ties within and across shards), -1 ids with inf
    tails, finite entries whose global id is padded (-1), all-inf rows."""
    if ties:
        d = rng.integers(0, 6, (s, b, k)).astype(np.float32) / 4
    else:
        d = rng.random((s, b, k)).astype(np.float32)
    d = np.sort(d, axis=2)
    ids = rng.integers(0, n_per, (s, b, k)).astype(np.int32)
    short = rng.random((s, b)) < 0.3  # a shard returning fewer than k
    cut = rng.integers(0, k, (s, b))
    tail = short[:, :, None] & (np.arange(k)[None, None, :] >= cut[:, :, None])
    ids[tail] = -1
    d[tail] = np.inf
    d[:, 0, :] = np.inf  # one query with nothing found on any shard
    ids[:, 0, :] = -1
    return d, ids


@pytest.mark.parametrize("s,k,ties", [(4, 10, True), (4, 10, False),
                                      (16, 5, True), (1, 8, True),
                                      (16, 32, False)])
def test_merge_topk_plain_matches_stable_sort(s, k, ties):
    """Exactly the numpy stable-sort merge, over per-shard gid tables with
    padded nodes (-1) and over one flat table; hops and dcomp summed."""
    rng = np.random.default_rng(s * 100 + k)
    b, n_per = 40, 50
    d, ids = _lists(rng, s, b, k, n_per, ties)
    gid = np.arange(s * n_per, dtype=np.int32).reshape(s, n_per)
    gid[rng.random((s, n_per)) < 0.1] = -1  # padded nodes inside lists
    hops = rng.integers(0, 100, (s, b)).astype(np.int32)
    dcomp = rng.integers(0, 1000, (s, b)).astype(np.int32)
    want_d, want_i = _reference(d, ids, gid, True)
    md, mi, mh, mc = merge_topk(*map(torch.from_numpy,
                                     (d, ids, gid, hops, dcomp)))
    np.testing.assert_array_equal(md.numpy(), want_d)
    np.testing.assert_array_equal(mi.numpy(), want_i)
    np.testing.assert_array_equal(mh.numpy(), hops.sum(0))
    np.testing.assert_array_equal(mc.numpy(), dcomp.sum(0))
    assert (mi.numpy()[0] == -1).all() and np.isinf(md.numpy()[0]).all()
    # one flat table indexed by flat ids (the union's layout), the lists
    # handed over as a [B, S, k] tensor permuted to [S, B, k]
    flat = gid.reshape(-1)
    fids = np.where(ids >= 0, ids + (np.arange(s) * n_per)[:, None, None],
                    -1).astype(np.int32)
    q_major = torch.from_numpy(d.transpose(1, 0, 2).copy())
    qi_major = torch.from_numpy(fids.transpose(1, 0, 2).copy())
    fd, fi, _, _ = merge_topk_plain(
        q_major.permute(1, 0, 2), qi_major.permute(1, 0, 2),
        torch.from_numpy(flat), torch.from_numpy(hops.T.copy()).T,
        torch.from_numpy(dcomp))
    np.testing.assert_array_equal(fd.numpy(), want_d)
    np.testing.assert_array_equal(fi.numpy(), want_i)


def test_merge_topk_plain_matches_jax_lax_sort():
    """On distinct distances the merge equals the JAX program's lax.sort
    merge (sharded.py _sharded_search_jit) exactly."""
    from jax import lax

    rng = np.random.default_rng(7)
    s, b, k, n_per = 4, 64, 10, 200
    d = np.sort(rng.random((s, b, k)).astype(np.float32), axis=2)
    ids = rng.integers(0, n_per, (s, b, k)).astype(np.int32)
    gid = np.arange(s * n_per, dtype=np.int32).reshape(s, n_per)
    gid[:, -7:] = -1
    g = jnp.asarray(gid)
    gi = jnp.stack([jnp.where(ids[i] >= 0, g[i][jnp.maximum(ids[i], 0)], -1)
                    for i in range(s)])
    dd = jnp.where(gi >= 0, d, jnp.inf)
    cat_d = jnp.moveaxis(dd, 0, 1).reshape(b, s * k)
    cat_i = jnp.moveaxis(gi, 0, 1).reshape(b, s * k)
    sd, si = lax.sort((cat_d, cat_i), dimension=1, num_keys=1)
    zeros = torch.zeros((s, b), dtype=torch.int32)
    md, mi, _, _ = merge_topk_plain(torch.from_numpy(d), torch.from_numpy(ids),
                                    torch.from_numpy(gid), zeros, zeros)
    np.testing.assert_array_equal(md.numpy(), np.asarray(sd[:, :k]))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(si[:, :k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gathered_dist_plain_matches_jax(dtype, metric):
    """K1's plain version on rows [B, W, d] and by id from a store, fp32 or
    bfloat16, against JAX's gathered_dist on the same (upcast) rows; a
    negative id gives +inf."""
    rng = np.random.default_rng(3)
    store = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((33, 24)).astype(np.float32)
    ids = rng.integers(-1, 500, (33, 7)).astype(np.int32)
    jstore = jnp.asarray(store)
    tstore = torch.from_numpy(store)
    if dtype == "bfloat16":
        jstore = jstore.astype(jnp.bfloat16)
        tstore = tstore.to(torch.bfloat16)
    jv = jstore[jnp.maximum(jnp.asarray(ids), 0)]
    jvn = jdist.sq_norms(jstore)
    want = np.asarray(jdist.gathered_dist(
        jnp.asarray(q), jv, metric, vn=jvn[jnp.maximum(jnp.asarray(ids), 0)]))
    want = np.where(ids >= 0, want, np.inf)
    tq, tvn = torch.from_numpy(q), tdist.sq_norms(tstore)
    got = tdist.gathered_dist(tq, tstore, metric, vn=tvn,
                              ids=torch.from_numpy(ids)).numpy()
    fin = ids >= 0
    assert (np.isinf(got) == ~fin).all()
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-5 * (1 + np.abs(want[fin])))
    rows = tstore[torch.from_numpy(np.maximum(ids, 0)).long()]
    got2 = tdist.gathered_dist(tq, rows, metric).numpy()
    assert np.all(np.abs(got2[fin] - want[fin])
                  <= 1e-5 * (1 + np.abs(want[fin])))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_point_dist_plain_matches_jax(metric):
    """The rowwise form (difference form for L2) against JAX's point_dist,
    on fp32 and bfloat16 rows."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((50, 20)).astype(np.float32)
    b = rng.standard_normal((50, 20)).astype(np.float32)
    for cast in (False, True):
        jb = jnp.asarray(b).astype(jnp.bfloat16) if cast else jnp.asarray(b)
        tb = torch.from_numpy(b).to(torch.bfloat16) if cast else \
            torch.from_numpy(b)
        want = np.asarray(jdist.point_dist(jnp.asarray(a), jb, metric))
        got = tdist.point_dist(torch.from_numpy(a), tb, metric).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sq_norms_of_a_bfloat16_table_is_chunked():
    """A bfloat16 table is reduced to the values JAX's sq_norms gives
    (within 1e-6 relative): the plain version widens it whole, Kξ on the
    card reads it in one pass, so no chunking is left; the bits of torch's
    cast equal JAX's (round to nearest even)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1000, 16)) * 3).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tx.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jx).view(np.uint16))
    np.testing.assert_array_equal(
        np.asarray(jx).view(np.uint16),
        x.astype(ml_dtypes.bfloat16).view(np.uint16))
    got = tdist.sq_norms(tx).numpy()
    np.testing.assert_allclose(got, np.asarray(jdist.sq_norms(jx)),
                               rtol=1e-6)


def test_package_exports_resolve_lazily():
    """The six index names of the JAX package resolve on the port's
    package, and importing the package alone loads no index module."""
    code = ("import sys, hnsw_slim_tpu_torch as p\n"
            "assert not [m for m in sys.modules if '.index.' in m "
            "or '.parallel.' in m], sorted(sys.modules)\n"
            "names = ['HnswIndex', 'HnswSlimIndex', 'HnswSlimZeroIndex', "
            "'HnswSlimQIndex', 'BruteForceIndex', 'ShardedSlimIndex']\n"
            "for n in names: assert getattr(p, n).__name__ == n\n"
            "assert set(names) <= set(p.__all__)\n"
            "assert 'hnsw_slim_tpu_torch.parallel.sharded' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    import hnsw_slim_tpu_torch as p

    with pytest.raises(AttributeError):
        p.NoSuchIndex  # noqa: B018
