"""Parity of the PyTorch port's distance functions and kernel Kα (plain
version on the CPU) against the JAX package, plus the port's import
boundary (it never imports JAX or the JAX package)."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_slim_tpu.graph.build import _exact_knn_subset as jax_knn_subset
from hnsw_slim_tpu.index.bruteforce import BruteForceIndex as JaxBruteForce
from hnsw_slim_tpu.index.bruteforce import exact_topk as jax_exact_topk
from hnsw_slim_tpu.ops import distance as jd
from hnsw_slim_tpu.utils.data import clustered
from hnsw_slim_tpu_torch.graph.build import _exact_knn_subset
from hnsw_slim_tpu_torch.index.bruteforce import (BruteForceIndex,
                                                  exact_topk, topk_dist)
from hnsw_slim_tpu_torch.ops import distance as td

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _data(n=2000, d=32, nq=128, seed=3):
    return clustered(n, d, n_queries=nq, n_clusters=20, seed=seed, scale=0.5)


def _assert_topk_match(d_p, i_p, i_j, q, x, k, metric="l2"):
    """ids identical except rows whose k-th and (k+1)-th exact (float64)
    distances lie within 1e-5 relative; distances within
    1e-4 * (1 + |d|)."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    full = (1.0 - q64 @ x64.T) if metric == "ip" else (
        (q64 ** 2).sum(1)[:, None] + (x64 ** 2).sum(1)[None]
        - 2 * q64 @ x64.T)
    srt = np.sort(full, axis=1)
    for r in range(len(q)):
        if set(i_p[r].tolist()) != set(i_j[r].tolist()):
            gap = abs(srt[r, k] - srt[r, k - 1])
            assert gap <= 1e-5 * max(1.0, abs(srt[r, k - 1])), (r, gap)
    ok = i_p >= 0
    exact = np.take_along_axis(full, np.maximum(i_p, 0), axis=1)
    np.testing.assert_array_less(np.abs(d_p - exact)[ok],
                                 1e-4 * (1 + np.abs(exact[ok])))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distances_match_jax(metric):
    """sq_norms, pairwise_dist, gathered_dist, point_dist: max |Δ| <=
    1e-4 * (1 + |d|) against the JAX functions on the same inputs."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    rows = rng.standard_normal((64, 17, 32)).astype(np.float32)

    def close(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.all(np.abs(a - b) <= 1e-4 * (1 + np.abs(b)))

    tq, tx, tr = map(torch.from_numpy, (q, x, rows))
    close(td.sq_norms(tx), jd.sq_norms(jnp.asarray(x)))
    close(td.pairwise_dist(tq, tx, metric), jd.pairwise_dist(q, x, metric))
    close(td.gathered_dist(tq, tr, metric), jd.gathered_dist(q, rows, metric))
    close(td.point_dist(tq, tx[:64], metric),
          jd.point_dist(q, x[:64], metric))


@pytest.mark.parametrize("k,metric,n_valid", [(10, "l2", 0), (1, "l2", 1500),
                                              (64, "ip", 0)])
def test_exact_topk_matches_jax(k, metric, n_valid):
    """Kα plain version vs JAX exact_topk (near-tie rule of
    _assert_topk_match)."""
    base, q = _data()
    jd_, ji = jax_exact_topk(jnp.asarray(base), jd.sq_norms(jnp.asarray(base)),
                             jnp.asarray(q), k=k, metric=metric, chunk=512,
                             n_valid=n_valid)
    x = torch.from_numpy(base)
    pd_, pi = exact_topk(x, td.sq_norms(x), torch.from_numpy(q), k, metric,
                         n_valid=n_valid)
    nv = n_valid or len(base)
    _assert_topk_match(pd_.numpy(), pi.numpy(), np.asarray(ji), q, base[:nv],
                       k, metric)


def test_bruteforce_index_matches_jax():
    """BruteForceIndex: same ids as the JAX index up to near-ties, and the
    JAX index's own distances within 1e-4 * (1 + |d|)."""
    base, q = _data(seed=5)
    jd_, ji = JaxBruteForce(base, chunk=1024).search(q, k=10)
    pd_, pi = BruteForceIndex(base, device="cpu").search(q, k=10)
    _assert_topk_match(pd_, pi, ji, q, base, 10)
    same = pi == ji
    assert np.all(np.abs(pd_[same] - jd_[same]) <= 1e-4 * (1 + np.abs(jd_[same])))


def test_seed_block_matches_jax():
    """The exact seed block of chal_search (top-32 over a -1 padded table of
    upper-level vectors) against JAX's lax.top_k form, near-tie rule of
    _assert_topk_match."""
    base, q = _data(seed=9)
    ids = np.arange(0, len(base), 17, dtype=np.int32)  # 118 "upper" nodes
    up_ids = np.full(128, -1, np.int32)
    up_ids[: len(ids)] = ids
    up_vecs = base[np.maximum(up_ids, 0)]
    dmat = jd.pairwise_dist(jnp.asarray(q), jnp.asarray(up_vecs))
    dmat = jnp.where((jnp.asarray(up_ids) >= 0)[None, :], dmat, jnp.inf)
    negd, pos = jax.lax.top_k(-dmat, 32)
    j_ids = np.where(np.isinf(-np.asarray(negd)), -1,
                     up_ids[np.asarray(pos)])
    uv = torch.from_numpy(up_vecs)
    sd, spos = topk_dist(torch.from_numpy(q), uv, td.sq_norms(uv), 32,
                         row_ids=torch.from_numpy(up_ids))
    p_ids = np.where(np.isinf(sd.numpy()), -1,
                     up_ids[np.maximum(spos.numpy(), 0)])
    _assert_topk_match(sd.numpy(), spos.numpy(), np.asarray(pos), q,
                       base[ids], 32)
    assert (p_ids == j_ids).mean() >= 0.99


def test_exact_knn_subset_matches_jax():
    """_exact_knn_subset (Kα with the self mask): same neighbor ids as JAX
    up to near-ties; self never returned."""
    base, _ = _data(seed=11)
    sub = np.arange(3, len(base), 7, dtype=np.int32)
    x = torch.from_numpy(base)
    pi, pd_ = _exact_knn_subset(x, td.sq_norms(x), sub, 12, "l2")
    ji, jd_ = jax_knn_subset(jnp.asarray(base), jd.sq_norms(jnp.asarray(base)),
                             sub, 12, "l2")
    assert not (pi == sub[:, None]).any()
    same = (pi == ji).all(axis=1)
    assert same.mean() >= 0.99
    assert np.all(np.abs(pd_[same] - jd_[same]) <= 1e-4 * (1 + np.abs(jd_[same])))


def _is_reference(mod: str) -> bool:
    """True for JAX and for the JAX package (hnsw_slim_tpu, not the port)."""
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "hnsw_slim_tpu")


def test_port_imports_no_jax():
    """Importing every module of the port loads neither JAX nor the JAX
    package."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "hnsw_slim_tpu_torch").rglob("*.py")
    )
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hnsw_slim_tpu')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no JAX module and nothing of the JAX package in
    any import statement, top level or inside a function."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert "hnsw_slim_tpu_torch.index.slim" in mods
    assert "hnsw_slim_tpu_torch.serve.server" in mods
    assert "hnsw_slim_tpu_torch.serve.client" in mods
    assert not [m for m in mods if _is_reference(m)]


@pytest.mark.parametrize("rel", ["config.py", "utils/data.py",
                                 "utils/native.py", "eval/__init__.py",
                                 "eval/recall.py", "utils/io.py",
                                 "tools.py"])
def test_shared_module_copy_is_byte_equal(rel):
    """The port keeps its own copy of the JAX package's jax-free modules
    (configuration dataclasses, synthetic data, the native data plane's
    bindings, fvecs I/O, recall scoring and the CLI tools) so that it never
    imports the JAX package; each copy stays byte-equal to the reference's
    file."""
    ref = (REPO / "hnsw_slim_tpu" / rel).read_bytes()
    assert (REPO / "hnsw_slim_tpu_torch" / rel).read_bytes() == ref
