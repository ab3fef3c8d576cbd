"""The port's SlimQ stack against the plain RaBitQ reference
(``tests/plain_rabitq.py``), on the CPU with seeded data: the rotation
(Kη's plain version), the quantizer, the estimators (the packed-row scorer
and Kα's estimate mode) and a whole index whose reranked answers must carry
exact distances. The JAX package plays no part here; the benchmark's copy
of the reference (``bench_torch/reference/rabitq_knn.py``) must agree with
this one."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_rabitq as pr
from hnsw_slim_tpu_torch.config import (HnswConfig, QuantConfig, SearchConfig,
                                        SlimConfig)
from hnsw_slim_tpu_torch.index.bruteforce import topk_estimate
from hnsw_slim_tpu_torch.index.slimq import HnswSlimQIndex, pack_code_rows
from hnsw_slim_tpu_torch.quant import rabitq as trq
from hnsw_slim_tpu_torch.quant.estimator import (QuantScorer,
                                                 packed_estimate_plain)
from hnsw_slim_tpu_torch.quant.kmeans import kmeans
from hnsw_slim_tpu_torch.quant.rotator import FhtKacRotator, g_tables
from hnsw_slim_tpu_torch.utils.data import clustered

FACTORS = ("f_add", "f_rescale", "f_add_ex", "f_rescale_ex")


def _world(dim: int, n: int = 3000, seed: int = 5):
    """(raw rows, rotator, rotated rows, rotated centroids, cluster ids):
    clustered data, KMeans-16 and the rotation as the index builds them."""
    base, _ = clustered(n, dim, n_queries=0, seed=seed)
    cent, asn = kmeans(base, k=16, iters=10, device="cpu")
    rot = FhtKacRotator(dim, seed=seed + 1, device="cpu")
    return base, rot, rot.rotate(base), rot.rotate(cent), asn


@pytest.mark.parametrize("dim", [100, 128])
def test_rotation_is_the_reference_rotation(dim):
    """Kη's plain version and the reference rotation from the flip bits
    agree bit for bit: both add and subtract the butterflies in one order
    and scale by the same float32 factor. A row that is a unit vector stays
    one (the rotation is orthonormal; 1e-5 of fp32 rounding over P dims)."""
    x = torch.as_tensor(np.random.default_rng(dim).standard_normal(
        (64, dim)).astype(np.float32))
    rot = FhtKacRotator(dim, seed=3, device="cpu")
    want = pr.rotate(x, rot.flip_bits)
    assert want.shape == (64, pr.padded_dim(dim)) == (64, rot.padded_dim)
    assert torch.equal(rot.rotate(x), want)
    u = x / x.norm(dim=1, keepdim=True)
    assert torch.allclose(pr.rotate(u, rot.flip_bits).norm(dim=1),
                          torch.ones(64), atol=1e-5)


@pytest.mark.parametrize("ex_bits", [1, 2, 3])
@pytest.mark.parametrize("p", [64, 128])
def test_rescale_constant_is_rabitqlibs(p, ex_bits):
    """The reference's direct sweep and the port's incremental one pick the
    same rescale factor for every sampled direction, so the means agree to
    float64 rounding (1e-12)."""
    assert pr.rescale_constant(p, ex_bits) == pytest.approx(
        trq.const_scaling_factor(p, ex_bits), rel=1e-12)


@pytest.mark.parametrize("dim", [100, 128])
@pytest.mark.parametrize("ex_bits", [0, 3])
def test_quantize_batch_is_the_reference_code(ex_bits, dim):
    """quantize_batch (host float64) against the reference on the same
    rotated rows. In float64 the code words are equal and the factors equal
    after their float32 rounding (1e-6 relative: the two sum in other
    orders). In float32, the reference as the benchmark runs it, the 1-bit
    planes are equal (a difference of two float32 values keeps its sign) and
    the ex levels equal on at least 99% of rows (a level within float32
    rounding of a step may differ); each factor within 1e-5 of that
    factor's largest magnitude (an additive factor can cancel to near zero
    in one row)."""
    base, rot, xr, cr, asn = _world(dim)
    got = trq.quantize_batch(xr.numpy(), cr.numpy(), asn, ex_bits,
                             device="cpu")
    want = pr.rabitq_codes(xr.double(), cr, asn, ex_bits)
    assert torch.equal(got.bin_code, want["bin_code"])
    assert torch.equal(got.ex_planes, want["ex_planes"])
    for f in FACTORS:
        torch.testing.assert_close(getattr(got, f), want[f], rtol=1e-6,
                                   atol=0)
    f32 = pr.rabitq_codes(pr.rotate(torch.as_tensor(base), rot.flip_bits),
                          cr, asn, ex_bits)
    assert torch.equal(got.bin_code, f32["bin_code"])
    same = (got.ex_planes == f32["ex_planes"]).flatten(1).all(1)
    assert same.double().mean() >= 0.99
    for f in FACTORS:
        gap = (getattr(got, f) - f32[f]).abs().max()
        assert gap <= 1e-5 * f32[f].abs().max(), f


@pytest.mark.parametrize("use_ex", [False, True])
@pytest.mark.parametrize("dim", [100, 128])
def test_estimates_are_the_reference_estimate(dim, use_ex):
    """The packed-row scorer (Kβ's and Kε's plain version) and Kα's estimate
    mode against the reference's estimate of every row: equal within 1e-4
    of the largest estimate (both sum P float32 products, in other orders).
    The estimate-mode scan returns the rows with the lowest estimates: each
    of its k is within that tolerance of the reference's k lowest."""
    base, rot, xr, cr, asn = _world(dim)
    codes = trq.quantize_batch(xr.numpy(), cr.numpy(), asn, 3, device="cpu")
    rows = pack_code_rows(codes, torch.as_tensor(asn))
    queries = torch.as_tensor(clustered(10, dim, n_queries=32, seed=9)[1])
    q_rot = rot.rotate(queries)
    want = pr.estimate_l2(q_rot, pr.rabitq_codes(xr.double(), cr, asn, 3),
                          cr, asn, use_ex=use_ex)
    tol = 1e-4 * float(want.abs().max())
    sumq, g_add = g_tables(q_rot, cr)
    sc = QuantScorer(rows, codes.bin_code.shape[1], 3, use_ex, q_rot, sumq,
                     g_add)
    ids = torch.as_tensor(np.random.default_rng(2).integers(
        0, len(base), (32, 50)), dtype=torch.int32)
    got = packed_estimate_plain(sc, ids)
    torch.testing.assert_close(got, torch.gather(want, 1, ids.long()),
                               rtol=0, atol=tol)
    if not use_ex:
        row_ids = torch.arange(len(base), dtype=torch.int32)
        d, pos = topk_estimate(sc, row_ids, 16)
        torch.testing.assert_close(d, torch.gather(want, 1, pos.long()),
                                   rtol=0, atol=tol)
        kth = torch.sort(want, dim=1).values[:, 15]
        assert (d[:, -1] <= kth + tol).all()


def test_slimq_answers_carry_exact_distances():
    """A SlimQ index built and searched through its normal path at 3000 x
    64. The reranked answers hold the exact squared distances of their ids:
    each within 1e-6 of ||q||^2 + ||x||^2 of the float64 truth, the size of
    the terms the rerank's norm-expanded float32 distance rounds (it reads
    under 3e-7 there; against the distance alone up to 3e-5, where the
    terms cancel). They reach recall@10 0.95 of the exact kNN at ef 128
    (the reranked 1-bit beam reads 1.0 on these clusters; 0.95 leaves room
    for a seed's hard queries). Estimate-only answers (no rerank) hold
    valid ids, but their distances miss that bound."""
    base, queries = clustered(3000, 64, n_queries=128, seed=31)
    idx = HnswSlimQIndex.build(
        base, hnsw_cfg=HnswConfig(M=16, ef_construction=100),
        slim_cfg=SlimConfig.from_ratios(), quant_cfg=QuantConfig(),
        device="cpu")
    idx.densify_level0()
    idx.densify_upper()
    idx.scfg = SearchConfig(ef=128, pop_width=8, seed_width=32)
    b64 = torch.as_tensor(base).double()
    q64 = torch.as_tensor(queries).double()

    def gap(d, ids):
        x = b64[torch.as_tensor(ids).long()]
        true = ((q64[:, None, :] - x) ** 2).sum(-1)
        scale = (q64 * q64).sum(1, keepdim=True) + (x * x).sum(-1)
        return float(((torch.as_tensor(d).double() - true).abs()
                      / scale).max())

    d, ids = idx.search(queries, 10)
    assert (ids >= 0).all() and (ids < len(base)).all()
    assert (np.diff(d, axis=1) >= 0).all()
    assert gap(d, ids) <= 1e-6
    exact = torch.topk(torch.cdist(q64, b64), 10, largest=False).indices
    hits = (torch.as_tensor(ids).long()[:, :, None]
            == exact[:, None, :]).any(-1)
    assert hits.double().mean() >= 0.95
    d_est, ids_est = idx.search(queries, 10, rerank=False)
    assert (ids_est >= 0).all()
    assert gap(d_est, ids_est) > 1e-4


def test_the_benchmark_copy_is_this_reference():
    """bench_torch/reference/rabitq_knn.py is a copy: the same rotation,
    codes and estimates on the same inputs."""
    bench = Path(__file__).resolve().parents[1] / "bench_torch"
    sys.path.insert(0, str(bench))
    try:
        copy = importlib.import_module("reference.rabitq_knn")
    finally:
        sys.path.remove(str(bench))
    base, rot, xr, cr, asn = _world(100, n=500)
    x = torch.as_tensor(base)
    assert torch.equal(copy.rotate(x, rot.flip_bits),
                       pr.rotate(x, rot.flip_bits))
    a = copy.rabitq_codes(xr, cr, asn, 3)
    b = pr.rabitq_codes(xr, cr, asn, 3)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[f], b[f]) for f in a)
    q = xr[:7]
    for use_ex in (False, True):
        assert torch.equal(copy.estimate_l2(q, a, cr, asn, use_ex),
                           pr.estimate_l2(q, b, cr, asn, use_ex))
    assert callable(copy.exact_topk) and callable(copy.to_device)
