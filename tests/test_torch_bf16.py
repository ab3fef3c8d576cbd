"""The bfloat16 vector store (HnswConfig.store_dtype="bfloat16") against
the JAX package, on tests/test_build.py's bf16 setup (clustered 3000 x 32,
M=16, ef_construction=100, max_batch 512), the JAX run made once per test
run (torch_slice_util.jax_bf16_dir): the store's bits, the graph built from
the fp32 rows, the Slim conversion that reads bf16 rows, vanilla and seeded
Slim searches, one add_points batch (the JAX insert batch's padding fault
replayed), and checkpoints in the JAX package's byte layout.

Tolerances: the store bit-equal (both round to nearest even); graphs and
conversion rows exactly equal; ids equal on every slot whose distance is not
within 1e-4 * (1 + |d|) of a neighbour's and distances within 1e-4 * (1 +
|d|) (fp32 sums of the widened rows in another order); norms within 1e-6
relative."""

import dataclasses

import numpy as np
import pytest
import torch

from hnsw_slim_tpu_torch.config import SearchConfig, SlimConfig
from hnsw_slim_tpu_torch.index.hnsw import HnswIndex
from hnsw_slim_tpu_torch.index.slim import HnswSlimIndex
from hnsw_slim_tpu_torch.ops.distance import sq_norms
from hnsw_slim_tpu_torch.persist.checkpoint import (load_hnsw, load_slim,
                                                    save_hnsw, save_slim)
from torch_slice_util import (BF16_CFG, bf16_dataset, jax_bf16_dir,
                              replay_padding_fault)

torch.set_num_threads(1)
SCFG = SearchConfig(ef=64, pop_width=8, seed_width=32)


@pytest.fixture(scope="module")
def jrun(tmp_path_factory):
    d = jax_bf16_dir(tmp_path_factory)
    with np.load(d / "rec.npz") as z:
        return d, {k: z[k] for k in z.files}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def assert_same_results(pd, pi, jd, ji, tol=1e-4):
    fin = np.isfinite(jd)
    assert (np.isfinite(pd) == fin).all()
    assert np.all(np.abs(pd[fin] - jd[fin]) <= tol * (1 + np.abs(jd[fin])))
    gap = np.abs(np.diff(jd, axis=1)) <= tol * (1 + np.abs(jd[:, 1:]))
    pad = np.zeros_like(gap[:, :1])
    tie = np.concatenate([gap, pad], 1) | np.concatenate([pad, gap], 1)
    assert ((pi == ji) | tie).all(), np.argwhere((pi != ji) & ~tie)


def test_bf16_build_store_and_graph(jrun):
    """The port's bf16 build: the store bit-equal to JAX's, norms from the
    bf16 rows, the vanilla graph equal to the port's fp32 build of the same
    points (the graph is built from the fp32 rows, as in the JAX package)."""
    _, rec = jrun
    base, _, _ = bf16_dataset()
    h = HnswIndex(BF16_CFG, max_batch=512, device="cpu")
    h.build(base)
    assert h.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(h.vectors), rec["bits"])
    np.testing.assert_allclose(h.vn.numpy(),
                               (h.vectors.float() ** 2).sum(1).numpy(),
                               rtol=1e-6)
    f = HnswIndex(dataclasses.replace(BF16_CFG, store_dtype="float32"),
                  max_batch=512, device="cpu")
    f.build(base)
    assert f.vectors.dtype == torch.float32
    assert h.graph.entry == f.graph.entry
    assert h.graph.max_level == f.graph.max_level
    for a, b in zip(h.graph.adjs, f.graph.adjs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="store_dtype"):
        HnswIndex(dataclasses.replace(BF16_CFG, store_dtype="float16"),
                  device="cpu").build(base[:100])


def test_bf16_conversion_and_search_match_jax(jrun):
    """On the JAX-built bf16 graph (loaded with its bf16 store): the port's
    Slim conversion equals JAX's array for array; the vanilla and the
    seeded Slim searches return JAX's results and effort."""
    d, rec = jrun
    _, queries, _ = bf16_dataset()
    h = load_hnsw(d / "hnsw.npz", device="cpu")
    assert h.vectors.dtype == torch.bfloat16
    assert dataclasses.asdict(h.cfg) == dataclasses.asdict(BF16_CFG)
    np.testing.assert_array_equal(_bits(h.vectors), rec["bits"])
    h.set_ef(64)
    pd, pi = h.search(queries, 10)
    assert_same_results(pd, pi, rec["vanilla_d"], rec["vanilla_i"])
    assert h.last_stats["hops"] == int(rec["vanilla_hops"])
    assert h.last_stats["distance_computations"] == int(rec["vanilla_dcomp"])
    s = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios(), search_cfg=SCFG)
    js = load_slim(d / "slim.npz", search_cfg=SCFG, device="cpu")
    for f in ("nbr", "lvl_off", "level"):
        assert torch.equal(getattr(s.graph, f), getattr(js.graph, f)), f
    assert s.graph.entry == js.graph.entry
    assert js.vectors.dtype == torch.bfloat16
    pd, pi = s.search(queries, 10)
    assert_same_results(pd, pi, rec["slim_d"], rec["slim_i"])
    for key, tag in (("hops", "slim_hops"),
                     ("distance_computations", "slim_dcomp")):
        got, want = s.last_stats[key], int(rec[tag])
        assert abs(got - want) <= 1e-3 * want, (key, got, want)


def test_bf16_add_points_matches_jax(jrun, monkeypatch):
    """One add_points batch on the bf16 index, the JAX insert batch's
    padding fault replayed: every row of every level, levels, entry and the
    touched set equal to JAX's; the new rows stored as bf16 bit-equal to
    JAX's."""
    d, rec = jrun
    replay_padding_fault(monkeypatch)
    _, _, add = bf16_dataset()
    h = load_hnsw(d / "hnsw.npz", device="cpu")
    h.max_batch = 512
    touched = h.add_points(add)
    j = load_hnsw(d / "hnsw_add.npz", device="cpu")
    np.testing.assert_array_equal(touched, rec["touched"])
    assert h.graph.n == j.graph.n == 3000 + len(add)
    assert h.graph.entry == j.graph.entry
    np.testing.assert_array_equal(h.levels[:h.graph.n], j.levels)
    for l, a in enumerate(j.host_adj()):
        np.testing.assert_array_equal(h.host_adj()[l][:h.graph.n], a)
    assert h.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(h.vectors[:h.graph.n]),
                                  _bits(j.vectors))
    h.check_integrity()


def test_bf16_checkpoints_round_trip(jrun, tmp_path):
    """save_hnsw / save_slim write the bf16 store as JAX's files hold it
    (2-byte raw words, the same bytes); loading gives the same bits and
    norms, and the Slim index serves the same ids."""
    d, _ = jrun
    _, queries, _ = bf16_dataset()
    h = load_hnsw(d / "hnsw.npz", device="cpu")
    save_hnsw(tmp_path / "h.npz", h)
    with np.load(tmp_path / "h.npz") as zp, np.load(d / "hnsw.npz") as zj:
        assert zp["vectors"].dtype.itemsize == 2
        assert zp["vectors"].dtype.kind == zj["vectors"].dtype.kind == "V"
        assert zp["vectors"].tobytes() == zj["vectors"].tobytes()
    h2 = load_hnsw(tmp_path / "h.npz", device="cpu")
    assert torch.equal(h2.vectors.view(torch.int16),
                       h.vectors.view(torch.int16))
    assert torch.equal(h2.vn, sq_norms(h.vectors))
    s = load_slim(d / "slim.npz", search_cfg=SCFG, device="cpu")
    save_slim(tmp_path / "s.npz", s)
    s2 = load_slim(tmp_path / "s.npz", search_cfg=SCFG, device="cpu")
    assert torch.equal(s2.vectors.view(torch.int16),
                       s.vectors.view(torch.int16))
    np.testing.assert_array_equal(s.search(queries, 10)[1],
                                  s2.search(queries, 10)[1])
