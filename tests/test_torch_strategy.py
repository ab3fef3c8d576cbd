"""The port's benchmark CLI (strategy.py) on the CPU: the JAX package's
test_strategy.py cases with ``--device cpu``, then one case per strategy
that runs the JAX CLI and the port's CLI on the same fvecs files (made with
numpy from a seed): ground-truth ivecs equal, near-ties aside (exact
float64 distances within 1e-5 * (1 + d)); every other strategy's port
recall@10 not below the JAX run's by more than 0.01; each port run under
``--profile_dir`` writes a Chrome trace."""

import json
import shutil

import numpy as np
import pytest
import torch

from hnsw_slim_tpu import strategy as jax_strategy
from hnsw_slim_tpu_torch import strategy
from hnsw_slim_tpu_torch.utils.data import clustered
from hnsw_slim_tpu_torch.utils.io import read_ivecs, write_fvecs

torch.set_num_threads(1)
KNOBS = ["--m", "16", "--ef_construction", "100", "--ef_search", "100",
         "--k", "10"]


def _cli(root, *extra):
    return ["--dataset", "toy", "--data_dir", str(root), *extra]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two data dirs with the same toy fvecs (one a copy of the other): the
    port's ground truth in the first, the JAX CLI's in the second."""
    root = tmp_path_factory.mktemp("data")
    d = root / "toy"
    d.mkdir()
    base, queries = clustered(n=2500, dim=24, n_queries=30, seed=71)
    write_fvecs(d / "toy_base.fvecs", base)
    write_fvecs(d / "toy_query.fvecs", queries)
    jroot = tmp_path_factory.mktemp("data_jax")
    shutil.copytree(d, jroot / "toy")
    strategy.main(_cli(root, "--solve_strategy", "bruteforce",
                       "--device", "cpu"))
    jax_strategy.main(_cli(jroot, "--solve_strategy", "bruteforce"))
    return root, jroot, base, queries


@pytest.mark.parametrize(
    "strat,min_recall",
    [
        ("hnsw", 0.9),
        ("hnsw_slim", 0.85),
        ("hnsw_slimzero", 0.85),
        ("hnsw_slimq", 0.8),
    ],
)
def test_strategies_on_cpu(dataset, strat, min_recall):
    r = strategy.main(_cli(dataset[0], "--solve_strategy", strat,
                           "--device", "cpu", *KNOBS))
    assert r >= min_recall, (strat, r)


def test_index_save_and_reload(dataset, tmp_path):
    argv = _cli(dataset[0], "--solve_strategy", "hnsw_slim", "--m", "16",
                "--ef_construction", "100", "--index_dir", str(tmp_path),
                "--device", "cpu")
    r1 = strategy.main(argv)
    r2 = strategy.main(argv)  # second run loads from disk
    assert abs(r1 - r2) < 1e-9
    saved = list((tmp_path / "toy").glob("*.npz"))
    assert [p.name for p in saved] == ["hnsw_slim_100_16_32_0_0.02_32.npz"]


def test_cli_needs_a_card_or_device_cpu(dataset, monkeypatch):
    """Without --device the indexes go to the CUDA card, and without one
    the CLI raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        strategy.main(_cli(dataset[0], "--solve_strategy", "hnsw"))


def _trace_ok(path) -> bool:
    with open(path) as fh:
        return len(json.load(fh)["traceEvents"]) > 0


@pytest.mark.parametrize("strat", ["bruteforce", "hnsw", "hnsw_slim",
                                   "hnsw_slimzero", "hnsw_slimq"])
def test_cli_matches_the_jax_cli(dataset, strat, tmp_path):
    root, jroot, base, queries = dataset
    prof = tmp_path / "prof"
    argv = ["--solve_strategy", strat, *KNOBS]
    if strat == "bruteforce":  # into a fresh dir: the fixture's GT stays
        shutil.copytree(root / "toy", tmp_path / "toy")
        strategy.main(_cli(tmp_path, *argv, "--device", "cpu",
                           "--profile_dir", str(prof)))
        gp = read_ivecs(tmp_path / "toy" / "toy_groundtruth.ivecs")
        gj = read_ivecs(jroot / "toy" / "toy_groundtruth.ivecs")
        assert gp.shape == gj.shape == (30, 100)
        q = queries.astype(np.float64)
        b = base.astype(np.float64)
        dp = ((b[gp] - q[:, None]) ** 2).sum(-1)
        dj = ((b[gj] - q[:, None]) ** 2).sum(-1)
        differ = gp != gj
        assert differ.mean() <= 0.01
        assert np.all(np.abs(dp - dj)[differ] <= 1e-5 * (1 + dj[differ]))
    else:
        rp = strategy.main(_cli(root, *argv, "--device", "cpu",
                                "--profile_dir", str(prof)))
        rj = jax_strategy.main(_cli(jroot, *argv))
        assert rp >= rj - 0.01, (strat, rp, rj)
    assert _trace_ok(prof / "trace.json")
