"""The port's limits and signatures against the JAX package's: Kα's top-k
lists of up to 128 (the CLI's 100-NN ground truth), the SlimQ centroid
check, ``BruteForceIndex``'s ``chunk`` and ``replace_points``' ``verbose``.
Inputs are made with numpy from a seed; the CPU runs the plain versions."""

import copy
import inspect

import numpy as np
import pytest
import torch

from hnsw_slim_tpu.index.bruteforce import BruteForceIndex as JaxBF
from hnsw_slim_tpu_torch.index import bruteforce as bf
from hnsw_slim_tpu_torch.index.slimq import check_centroids

torch.set_num_threads(1)


def test_scan_plan_places_the_100nn_ground_truth():
    """4096 queries over 1M x 128 at k = 100 on a 132-SM card: tile M, one
    block an SM, 128-slot lists in 132,096 shared bytes, within a block's
    232,448."""
    plan = bf.scan_plan(4096, 1_000_000, 128, 100, 132)
    assert (plan.tile, plan.smem, plan.blocks_per_sm, plan.qdims) == (
        "M", 132096, 1, 128)
    assert plan.smem <= bf.SMEM_MAX and 1 <= plan.splits <= bf.MAX_SPLITS
    assert bf.list_slots(100) == bf.list_slots(128) == 128
    assert bf.scan_smem("M", 128, 65) == plan.smem
    # the lists, not k, size the block: every k of one list width plans alike
    assert bf.scan_plan(4096, 1_000_000, 128, 65, 132) == plan


@pytest.mark.parametrize("k", [0, 129])
def test_k_outside_the_list_limit_raises(k):
    with pytest.raises(ValueError, match=r"outside \[1, 128\]"):
        bf.scan_plan(4096, 1_000_000, 128, k, 132)


@pytest.mark.parametrize("k", [65, 100, 128])
def test_topk_dist_plain_past_64_matches_jax(k):
    """The plain Kα at k > 64 (the card's 128-slot lists) gives JAX's
    exact_topk ids, near-ties aside, and distances within 1e-4 * (1 + |d|),
    also past the 300 rows (inf, -1)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((20, 24)).astype(np.float32)
    jd, ji = JaxBF(x, chunk=1024).search(q, k=min(k, 300))
    pd, pi = bf.BruteForceIndex(x, device="cpu").search(q, k=min(k, 300))
    assert (pi == ji).mean() >= 0.99
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-4)
    d, i = bf.BruteForceIndex(x[:90], device="cpu").search(q, k=k)
    assert (i[:, 90:] == -1).all() and np.isinf(d[:, 90:]).all()


def test_bruteforce_index_takes_the_reference_signature():
    """BruteForceIndex(vectors, metric, chunk) in the JAX positions, then
    device; chunk changes no id."""
    jp = list(inspect.signature(JaxBF).parameters)
    pp = list(inspect.signature(bf.BruteForceIndex).parameters)
    assert pp[:len(jp)] == jp == ["vectors", "metric", "chunk"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((800, 16)).astype(np.float32)
    q = rng.standard_normal((10, 16)).astype(np.float32)
    _, a = bf.BruteForceIndex(x, "l2", 1024, device="cpu").search(q, k=50)
    _, b = bf.BruteForceIndex(x, device="cpu").search(q, k=50)
    _, c = JaxBF(x, "l2", 1024).search(q, k=50)
    assert np.array_equal(a, b) and (a == c).mean() >= 0.99


@pytest.mark.parametrize("n_clusters,fits", [(16, True), (2925, True),
                                             (2926, False)])
def test_slimq_centroid_check(n_clusters, fits):
    """At 128 rotated dims and 32 seeds the estimate scan places the g_add
    rows of at most 2925 centroids; past that the check raises and names
    the limit, before any work."""
    if fits:
        check_centroids(n_clusters, 128, 32)
    else:
        with pytest.raises(ValueError, match="at most 2925"):
            check_centroids(n_clusters, 128, 32)


def test_replace_points_takes_verbose(capsys):
    """replace_points(slots, vectors, verbose=True) as in the JAX package:
    it prints its batches and step seconds and returns what the quiet call
    returns on an identical index."""
    from hnsw_slim_tpu.index.hnsw import HnswIndex as JaxHnsw
    from hnsw_slim_tpu_torch.config import HnswConfig
    from hnsw_slim_tpu_torch.index.hnsw import HnswIndex

    jp = list(inspect.signature(JaxHnsw.replace_points).parameters)
    pp = list(inspect.signature(HnswIndex.replace_points).parameters)
    assert pp == jp == ["self", "slots", "new_vectors", "verbose"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    new = rng.standard_normal((12, 16)).astype(np.float32)
    slots = np.arange(100, 112)
    built = HnswIndex(HnswConfig(M=8, ef_construction=32), strategy="insert",
                      max_batch=256, device="cpu")
    built.build(x)
    out = []
    for verbose in (False, True):
        h = copy.deepcopy(built)
        out.append(h.replace_points(slots, new, verbose=verbose))
        out.append([a.copy() for a in h.host_adj()])
    printed = capsys.readouterr().out
    assert "replaced 12/12" in printed and "replace_points:" in printed
    assert np.array_equal(out[0][0], out[2][0])
    assert np.array_equal(out[0][1], out[2][1])
    assert all(np.array_equal(a, b) for a, b in zip(out[1], out[3]))
