"""FlatUnionIndex (parallel/flat_union.py) against the JAX package's, on the
same four shard graphs (tests/test_flat_union.py's setup, built and saved by
the JAX package: torch_slice_util.jax_union_dir), in both search modes
(seed_width 0: one search per shard merged by K19's plain version;
seed_width 16: stratified exact seeds), on the flat CHAL arrays and with
both dense layouts, with an fp32 and a bfloat16 store.

Tolerances: ids equal on every slot whose distance is not within 1e-4 *
(1 + |d|) of a neighbour's (near-ties may order differently), distances
within 1e-4 * (1 + |d|) (the fp32 expansion |q|^2 + |x|^2 - 2 q.x cancels
terms far larger than d, and the engines sum in another order), hops and
distance computations equal with seed_width 0 and within 0.1% with seeds
(a near-tie in the seed scan may swap a seed), sizes equal to the byte,
the bfloat16 store bit-equal."""

import dataclasses

import numpy as np
import pytest
import torch

from hnsw_slim_tpu_torch.config import SearchConfig
from hnsw_slim_tpu_torch.parallel.flat_union import FlatUnionIndex
from hnsw_slim_tpu_torch.persist.checkpoint import load_slim
from torch_slice_util import (SHARD_S, UNION_EF, UNION_K, UNION_SW,
                              jax_union_dir, round_robin, union_dataset)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jrun(tmp_path_factory):
    d = jax_union_dir(tmp_path_factory)
    with np.load(d / "rec.npz") as z:
        return d, {k: z[k] for k in z.files}


def _shards(d):
    n = len(union_dataset()[0])
    return [(load_slim(d / f"shard{si}.npz", device="cpu"),
             round_robin(n, SHARD_S, si)) for si in range(SHARD_S)]


def assert_same_results(pd, pi, jd, ji, tol=1e-4):
    """ids equal except where the slot's distance ties (within tol) with a
    neighbouring slot; distances within tol * (1 + |d|) everywhere."""
    fin = np.isfinite(jd)
    assert (np.isfinite(pd) == fin).all()
    assert np.all(np.abs(pd[fin] - jd[fin]) <= tol * (1 + np.abs(jd[fin])))
    gap = np.abs(np.diff(jd, axis=1)) <= tol * (1 + np.abs(jd[:, 1:]))
    near = np.zeros_like(gap[:, :1])
    tie = np.concatenate([gap, near], 1) | np.concatenate([near, gap], 1)
    assert ((pi == ji) | tie).all(), np.argwhere((pi != ji) & ~tie)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_union_matches_jax(jrun, dtype):
    """Both modes, both layouts: results, hops and dcomp equal to the JAX
    union's; index_size and hbm_bytes equal; the bf16 store bit-equal to
    JAX's, half the bytes of the fp32 one; no padded or missing id."""
    d, rec = jrun
    _, queries = union_dataset()
    u = FlatUnionIndex.from_indexes(_shards(d),
                                    search_cfg=SearchConfig(ef=UNION_EF),
                                    store_dtype=dtype, device="cpu")
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(
        u.vectors.view(view).numpy().view(rec[f"{dtype}_bits"].dtype),
        rec[f"{dtype}_bits"])
    assert u.vectors.dtype == getattr(torch, dtype)
    assert u.index_size() == int(rec[f"{dtype}_index_size"])
    assert u.hbm_bytes() == int(rec[f"{dtype}_hbm_chal"])
    for lay in ("chal", "dense"):
        if lay == "dense":
            u.densify_level0()
            u.densify_upper()
            assert u.hbm_bytes() == int(rec[f"{dtype}_hbm_dense"])
        for sw in (0, UNION_SW):
            tag = f"{dtype}_{lay}_sw{sw}"
            u.scfg = dataclasses.replace(u.scfg, seed_width=sw)
            pd, pi = u.search(queries, UNION_K)
            assert pi.dtype == np.int32 and pi.shape == (len(queries),
                                                         UNION_K)
            assert_same_results(pd, pi, rec[f"{tag}_d"], rec[f"{tag}_i"])
            # seed_width 0: equal; with seeds a near-tie in the seed scan
            # may swap one seed, so within 0.1%
            slack = 0 if sw == 0 else 1e-3
            for key, want in (("hops", rec[f"{tag}_hops"]),
                              ("distance_computations", rec[f"{tag}_dcomp"])):
                got, want = u.last_stats[key], int(want)
                assert abs(got - want) <= slack * want, (tag, key, got, want)
            assert (pi >= 0).all() and (pi < len(union_dataset()[0])).all()


def test_bf16_union_halves_the_vector_bytes(jrun):
    """The bfloat16 union's store holds exactly half the fp32 union's
    bytes, and its hbm_bytes differ by exactly that."""
    d, rec = jrun
    f = FlatUnionIndex.from_indexes(_shards(d), device="cpu")
    h = FlatUnionIndex.from_indexes(_shards(d), store_dtype="bfloat16",
                                    device="cpu")
    fb = f.vectors.numel() * f.vectors.element_size()
    hb = h.vectors.numel() * h.vectors.element_size()
    assert 2 * hb == fb
    assert f.hbm_bytes() - h.hbm_bytes() == fb - hb
    with pytest.raises(ValueError, match="store_dtype"):
        FlatUnionIndex.from_indexes(_shards(d), store_dtype="float16",
                                    device="cpu")


def test_union_autotune_and_set_ef(jrun):
    """autotune calibrates on the union graph (it reads the union's graph,
    vectors and _dev, and searches through the union's own search) and
    leaves its knobs in scfg; set_ef changes ef only."""
    d, _ = jrun
    u = FlatUnionIndex.from_indexes(_shards(d), device="cpu")
    u.densify_level0()
    rep = u.autotune(UNION_EF, sample=32)
    assert rep["knobs"] == {k: getattr(u.scfg, k) for k in rep["knobs"]}
    assert u.scfg.ef == UNION_EF and rep["probe_recall"] >= 0.5
    u.set_ef(24)
    assert u.scfg.ef == 24 and u.scfg.pop_width == rep["knobs"]["pop_width"]
