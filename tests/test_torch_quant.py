"""Parity of the port's quantization stack (rotator Kη, KMeans assignment
K18 on Kα, RaBitQ quantizer, estimators K16, packed code rows) against the
JAX package, on the CPU: the wrappers run their plain PyTorch versions, the
JAX functions run on the CPU backend. Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.index import slimq as jslimq
from hnsw_slim_tpu.quant import estimator as jest
from hnsw_slim_tpu.quant import kmeans as jkm
from hnsw_slim_tpu.quant import rabitq as jrq
from hnsw_slim_tpu.quant.rotator import FhtKacRotator as JaxRotator
from hnsw_slim_tpu.utils.data import clustered
from hnsw_slim_tpu_torch.index import slimq as tslimq
from hnsw_slim_tpu_torch.index.bruteforce import topk_estimate
from hnsw_slim_tpu_torch.quant import estimator as test_
from hnsw_slim_tpu_torch.quant import kmeans as tkm
from hnsw_slim_tpu_torch.quant import rabitq as trq
from hnsw_slim_tpu_torch.quant.rotator import FhtKacRotator, g_tables

torch.set_num_threads(1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("dim", [24, 64, 100, 128])
def test_rotator_matches_jax(dim):
    """Kη's plain version vs the JAX rotator on unit-scale rows: max |Δ| <=
    1e-6 (the butterflies add and subtract in the same order, so the two
    agree to the last bits); the flip bits round-trip through state /
    from_state in both directions."""
    x = np.random.default_rng(dim).standard_normal((50, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    jr = JaxRotator(dim, seed=3)
    tr = FhtKacRotator(dim, seed=3, device="cpu")
    assert tr.padded_dim == jr.padded_dim
    np.testing.assert_array_equal(tr.state(), jr.state())
    want = np.asarray(jr.rotate(x))
    got = tr.rotate(x).numpy()
    assert got.shape == want.shape == (50, jr.padded_dim)
    assert np.abs(got - want).max() <= 1e-6
    back = FhtKacRotator.from_state(dim, jr.state(), device="cpu")
    np.testing.assert_array_equal(back.rotate(x).numpy(), got)
    jback = JaxRotator.from_state(dim, tr.state())
    np.testing.assert_array_equal(np.asarray(jback.rotate(x)), want)
    # one row, as a query arrives
    assert np.abs(tr.rotate(x[0]).numpy() - want[:1]).max() <= 1e-6


def test_assign_matches_jax():
    """K18: nearest of 16 centroids, same centroids in both engines:
    assignments equal on >= 0.999 of rows (near-ties may differ)."""
    base, _ = clustered(5000, 24, seed=7, n_clusters=16)
    cent = base[np.random.default_rng(1).choice(len(base), 16, replace=False)]
    xj = jnp.asarray(base)
    want = np.asarray(jkm._assign(xj, jnp.sum(xj * xj, axis=1),
                                  jnp.asarray(cent), 16))
    got = tkm._assign(torch.from_numpy(base), torch.from_numpy(cent)).numpy()
    assert (got == want).mean() >= 0.999


def test_kmeans_matches_jax():
    """Whole KMeans (same numpy generator for the initial centers and the
    reseeding): distortion within 1e-3 relative, centroids of the same
    shape."""
    base, _ = clustered(3000, 24, seed=7, n_clusters=16)
    jc, ja = jkm.kmeans(base, k=16, iters=15)
    tc, ta = tkm.kmeans(base, k=16, iters=15, device="cpu")
    assert tc.shape == jc.shape == (16, 24) and ta.dtype == np.int32
    dj = ((base - jc[ja]) ** 2).sum(-1).mean()
    dt = ((base - tc[ta]) ** 2).sum(-1).mean()
    assert abs(dt - dj) <= 1e-3 * dj
    assert (ta == ja).mean() >= 0.99


def _quant_inputs(metric="l2", dim=96, n=400, k=4):
    rng = np.random.default_rng(5)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((8, dim)).astype(np.float32)
    cent, asn = jkm.kmeans(base, k=k, iters=10)
    rot = JaxRotator(dim)
    rbase = np.asarray(rot.rotate(base))
    rcent = np.asarray(rot.rotate(cent))
    rq = np.asarray(rot.rotate(queries))
    return rbase, rcent, asn, rq


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("ex_bits", [0, 3])
def test_quantize_batch_matches_jax(ex_bits, metric):
    """quantize_batch fed the JAX-rotated array (in two chunks): codes and
    planes exactly equal, factors rtol 1e-6."""
    rbase, rcent, asn, _ = _quant_inputs(metric)
    jc = jrq.quantize_batch(rbase, rcent, asn, ex_bits, metric=metric)
    tc = trq.quantize_batch(rbase, rcent, asn, ex_bits, metric=metric,
                            chunk=256, device="cpu")
    assert tc.ex_bits == jc.ex_bits and tc.bytes() == jc.bytes()
    np.testing.assert_array_equal(_u32(tc.bin_code), np.asarray(jc.bin_code))
    np.testing.assert_array_equal(_u32(tc.ex_planes), np.asarray(jc.ex_planes))
    for f in ("f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex",
              "f_error_ex"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=1e-6)
    assert trq.const_scaling_factor(128, 3) == jrq.const_scaling_factor(128, 3)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_estimators_match_jax(metric):
    """centroid_g_tables / g_tables, est_dist_1bit, est_dist_ex on the same
    codes and rotated queries: within 1e-5 * (1 + |est|); unpack_bits
    exactly equal."""
    rbase, rcent, asn, rq = _quant_inputs(metric)
    rq = rq.copy()
    n = len(rbase)
    jc = jrq.quantize_batch(rbase, rcent, asn, 3, metric=metric)
    tc = trq.quantize_batch(rbase, rcent, asn, 3, metric=metric,
                            device="cpu")
    np.testing.assert_array_equal(
        test_.unpack_bits(tc.bin_code).numpy(),
        np.asarray(jest.unpack_bits(jc.bin_code)))
    tq, tcent = torch.from_numpy(rq), torch.from_numpy(rcent)
    jg, jerr = jest.centroid_g_tables(jnp.asarray(rq), jnp.asarray(rcent),
                                      metric)
    tg, terr = test_.centroid_g_tables(tq, tcent, metric)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-5)
    sumq, g_add = g_tables(tq, tcent, metric)
    np.testing.assert_array_equal(g_add.numpy(), tg.numpy())
    jsum = jnp.sum(jnp.asarray(rq), axis=1)
    np.testing.assert_allclose(sumq.numpy(), np.asarray(jsum), rtol=1e-5,
                               atol=1e-5)
    ids = np.broadcast_to(np.arange(n), (8, n))
    jga = jnp.take_along_axis(jg, jnp.asarray(asn)[ids], axis=1)
    tga = torch.gather(tg, 1, torch.from_numpy(asn.astype(np.int64))[ids])
    tid = torch.from_numpy(ids.copy())
    j1 = jest.est_dist_1bit(jnp.asarray(rq), jsum, jc.bin_code[ids],
                            jc.f_add[ids], jc.f_rescale[ids], jga)
    t1 = test_.est_dist_1bit(tq, sumq, tc.bin_code[tid], tc.f_add[tid],
                             tc.f_rescale[tid], tga)
    jx = jest.est_dist_ex(jnp.asarray(rq), jsum, jc.bin_code[ids],
                          jc.ex_planes[ids], jc.f_add_ex[ids],
                          jc.f_rescale_ex[ids], jga, 3)
    tx = test_.est_dist_ex(tq, sumq, tc.bin_code[tid], tc.ex_planes[tid],
                           tc.f_add_ex[tid], tc.f_rescale_ex[tid], tga, 3)
    # the two engines sum <q_rot, bits> in different orders: beside the
    # relative 1e-5, 1e-7 of the largest partial sum the estimate cancels
    absq = np.abs(rq).sum(1)[:, None]
    for t, j, fr, scale in ((t1, j1, tc.f_rescale, 1.0),
                            (tx, jx, tc.f_rescale_ex, 8.0)):
        j = np.asarray(j)
        mag = np.abs(fr.numpy())[ids] * scale * absq
        assert np.all(np.abs(t.numpy() - j) <= 1e-5 * (1 + np.abs(j))
                      + 1e-7 * mag)


@pytest.mark.parametrize("ex_bits", [0, 3])
def test_pack_code_rows_matches_jax(ex_bits):
    """pack_code_rows exactly equal to JAX's rows (as u32), _unpack_fields
    its inverse; the packed-row estimate (what the search kernels compute)
    equals the estimate from the separate arrays, and the estimate-mode
    top-k (the seed block) picks the rows of a full sort."""
    rbase, rcent, asn, rq = _quant_inputs()
    jc = jrq.quantize_batch(rbase, rcent, asn, ex_bits)
    tc = trq.quantize_batch(rbase, rcent, asn, ex_bits, device="cpu")
    jrows = np.asarray(jslimq.pack_code_rows(jc, jnp.asarray(asn)))
    cid = torch.from_numpy(asn.astype(np.int32))
    trows = tslimq.pack_code_rows(tc, cid)
    nb = rbase.shape[1] // 32
    assert trows.shape == (len(rbase), nb * (1 + ex_bits) + 5)
    np.testing.assert_array_equal(_u32(trows), jrows)
    bc, ex, fa, fr, fae, fre, c2 = tslimq._unpack_fields(trows[None], nb,
                                                         ex_bits)
    assert torch.equal(bc[0], tc.bin_code) and torch.equal(c2[0], cid)
    if ex_bits:
        assert torch.equal(ex[0], tc.ex_planes)
    else:
        assert ex is None
    for got, f in ((fa, "f_add"), (fr, "f_rescale"), (fae, "f_add_ex"),
                   (fre, "f_rescale_ex")):
        assert torch.equal(got[0], getattr(tc, f))
    tq, tcent = torch.from_numpy(rq), torch.from_numpy(rcent)
    sumq, g_add = g_tables(tq, tcent)
    ids = torch.arange(len(rbase), dtype=torch.int32).expand(8, -1)
    ga = g_add[:, cid.long()]
    for use_ex in (False, True):
        sc = test_.QuantScorer(trows, nb, ex_bits, use_ex, tq, sumq, g_add)
        got = test_.packed_estimate_plain(sc, ids.contiguous())
        il = ids.long()
        if use_ex:
            want = test_.est_dist_ex(
                tq, sumq, tc.bin_code[il], tc.ex_planes[il], tc.f_add_ex[il],
                tc.f_rescale_ex[il], ga, ex_bits)
        else:
            want = test_.est_dist_1bit(tq, sumq, tc.bin_code[il], tc.f_add[il],
                                       tc.f_rescale[il], ga)
        assert torch.equal(got, want)
    # the seed block: 1-bit estimates, odd rows masked, top-16
    row_ids = torch.arange(len(rbase), dtype=torch.int32)
    row_ids[1::2] = -1
    sc = test_.QuantScorer(trows, nb, ex_bits, True, tq, sumq, g_add)
    sd, pos = topk_estimate(sc, row_ids, 16)
    est = test_.packed_estimate_plain(sc._replace(use_ex=False), ids.contiguous())
    est[:, 1::2] = float("inf")
    order = torch.sort(est, dim=1, stable=True).indices[:, :16]
    assert torch.equal(pos.long(), order)
    assert torch.allclose(sd, torch.gather(est, 1, order), rtol=1e-5,
                          atol=1e-5)
