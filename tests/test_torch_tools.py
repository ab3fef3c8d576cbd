"""prep_data / recall_knn CLI tools of the port (tools.py, a byte-equal
copy of the JAX package's), on ground truth from the port's
BruteForceIndex on the CPU, and scored against the JAX package's tools on
the same files."""

import numpy as np

from hnsw_slim_tpu import tools as jax_tools
from hnsw_slim_tpu_torch import tools
from hnsw_slim_tpu_torch.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu_torch.utils.data import clustered
from hnsw_slim_tpu_torch.utils.io import read_fvecs, write_fvecs, write_ivecs


def test_prep_data_slices(tmp_path):
    base, _ = clustered(500, 16, seed=1)
    src = tmp_path / "full.fvecs"
    dst = tmp_path / "small.fvecs"
    write_fvecs(src, base)
    tools.prep_data(["--src", str(src), "--dst", str(dst), "--num", "100"])
    out = read_fvecs(dst)
    np.testing.assert_array_equal(out, base[:100])
    assert dst.read_bytes() == src.read_bytes()[:dst.stat().st_size]


def test_recall_knn_scores(tmp_path):
    base, queries = clustered(800, 16, n_queries=10, seed=2)
    bf = BruteForceIndex(base, chunk=1024, device="cpu")
    _, gt = bf.search(queries, k=50)
    write_fvecs(tmp_path / "b.fvecs", base)
    write_fvecs(tmp_path / "q.fvecs", queries)
    write_ivecs(tmp_path / "gt.ivecs", gt)
    write_ivecs(tmp_path / "knn.ivecs", gt[:, :10])
    r = tools.recall_knn([
        "--base", str(tmp_path / "b.fvecs"),
        "--query", str(tmp_path / "q.fvecs"),
        "--gt", str(tmp_path / "gt.ivecs"),
        "--knn", str(tmp_path / "knn.ivecs"),
        "--k", "10",
    ])
    assert r == 1.0


def test_recall_knn_equals_the_jax_tool(tmp_path):
    """A knn file with a third of its ids wrong scores the same in both
    packages' recall_knn."""
    base, queries = clustered(800, 16, n_queries=12, seed=3)
    _, gt = BruteForceIndex(base, device="cpu").search(queries, k=50)
    knn = gt[:, :10].copy()
    knn[:, ::3] = np.random.default_rng(3).integers(0, 800, knn[:, ::3].shape)
    for name, arr in (("gt", gt), ("knn", knn)):
        write_ivecs(tmp_path / f"{name}.ivecs", arr)
    write_fvecs(tmp_path / "b.fvecs", base)
    write_fvecs(tmp_path / "q.fvecs", queries)
    argv = ["--base", str(tmp_path / "b.fvecs"),
            "--query", str(tmp_path / "q.fvecs"),
            "--gt", str(tmp_path / "gt.ivecs"),
            "--knn", str(tmp_path / "knn.ivecs"), "--k", "10"]
    r = tools.recall_knn(argv)
    assert r < 1.0 and r == jax_tools.recall_knn(argv)
