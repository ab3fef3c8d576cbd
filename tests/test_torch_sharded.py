"""ShardedSlimIndex (parallel/sharded.py) against the JAX package's on its
8-device CPU mesh (make_mesh(8, dp=2): 4 shards), on the same shard graphs
(tests/test_sharded.py's prebuilt-shards setup, built and saved by the JAX
package: torch_slice_util.jax_shard_dir); the .npz of either engine loaded
by the other; the padded short shard; the mesh == flat gate (the sharded
search equals the host merge of per-shard searches) and the union with
seed_width 0 equal to the sharded search; and the same search across 4
gloo ranks (dp 2 x 2 shard ranks) equal to the one-process result.

Tolerances: ids equal on every slot whose distance is not within 1e-4 *
(1 + |d|) of a neighbour's, distances within 1e-4 * (1 + |d|) (the fp32
expansion |q|^2 + |x|^2 - 2 q.x cancels terms up to 35 here, whose ulp is
4e-6, and the engines sum in another order), hops and distance
computations equal; index_size equal to the byte; across ranks and between
the port's own paths exactly equal."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hnsw_slim_tpu_torch.config import SearchConfig
from hnsw_slim_tpu_torch.parallel.flat_union import FlatUnionIndex
from hnsw_slim_tpu_torch.parallel.merge import merge_topk_plain
from hnsw_slim_tpu_torch.parallel.sharded import (Mesh, ShardedSlimIndex,
                                                  make_mesh)
from hnsw_slim_tpu_torch.persist.checkpoint import load_slim
from torch_slice_util import (SHARD_CFG, SHARD_EF, SHARD_K, SHARD_S,
                              jax_shard_dir, round_robin, shard_dataset,
                              short_dataset)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
SCFG = SearchConfig(ef=SHARD_EF)


@pytest.fixture(scope="module")
def jrun(tmp_path_factory):
    d = jax_shard_dir(tmp_path_factory)
    with np.load(d / "rec.npz") as z:
        return d, {k: z[k] for k in z.files}


def _shards(d):
    n = len(shard_dataset()[0])
    return [(load_slim(d / f"shard{si}.npz", device="cpu"),
             round_robin(n, SHARD_S, si)) for si in range(SHARD_S)]


def _assembly(d, dense: bool):
    sh = ShardedSlimIndex.from_indexes(make_mesh(SHARD_S), _shards(d),
                                       search_cfg=SCFG, device="cpu")
    if dense:
        assert sh.densify_level0() > 0
        sh.densify_upper()
    return sh


def assert_matches(idx, queries, rec, tag, tol=1e-4):
    """idx's search against the recorded one: ids equal except at slots
    tied within tol with a neighbour, distances within tol * (1 + |d|),
    hops and dcomp equal."""
    pd, pi = idx.search(queries, SHARD_K)
    jd, ji = rec[f"{tag}_d"], rec[f"{tag}_i"]
    fin = np.isfinite(jd)
    assert (np.isfinite(pd) == fin).all()
    assert np.all(np.abs(pd[fin] - jd[fin]) <= tol * (1 + np.abs(jd[fin])))
    gap = np.abs(np.diff(jd, axis=1)) <= tol * (1 + np.abs(jd[:, 1:]))
    pad = np.zeros_like(gap[:, :1])
    tie = np.concatenate([gap, pad], 1) | np.concatenate([pad, gap], 1)
    assert ((pi == ji) | tie).all(), np.argwhere((pi != ji) & ~tie)
    assert idx.last_stats["hops"] == int(rec[f"{tag}_hops"]), tag
    assert idx.last_stats["distance_computations"] == int(
        rec[f"{tag}_dcomp"]), tag
    return pd, pi


@pytest.mark.parametrize("dense", [False, True])
def test_sharded_matches_jax(jrun, dense):
    """from_indexes over the JAX-built shards, with and without the dense
    layouts: the JAX mesh search's results, hops and dcomp; index_size
    equal; no padded or missing id."""
    d, rec = jrun
    sh = _assembly(d, dense)
    assert sh.mesh.shape == {"dp": 1, "shard": SHARD_S}
    assert sh.index_size() == int(rec["index_size"])
    _, pi = assert_matches(sh, shard_dataset()[1], rec,
                           "dense" if dense else "chal")
    assert (pi >= 0).all() and (pi < len(shard_dataset()[0])).all()
    # an odd batch of 3 queries, k 2
    d3, i3 = sh.search(shard_dataset()[1][:3], 2)
    assert i3.shape == (3, 2) and np.isfinite(d3).all()


def test_save_load_across_engines(jrun, tmp_path):
    """JAX's file loads into the port and serves the JAX results; the
    port's file (saved in the fixture) holds JAX's array names and dtypes
    and serves, in the JAX engine, what the port serves; the port's own
    round trip is exact."""
    d, rec = jrun
    _, queries = shard_dataset()
    jl = ShardedSlimIndex.load(d / "sharded.npz", make_mesh(SHARD_S),
                               search_cfg=SCFG, device="cpu")
    assert jl.meta == {"max_level": jl.meta["max_level"],
                       "threshold_level": 0, "cap0": jl.meta["cap0"],
                       "cap": jl.meta["cap"]}
    assert_matches(jl, queries, rec, "chal")
    with np.load(d / "sharded.npz") as zj, np.load(d / "ported.npz") as zp:
        assert set(zp.files) == set(zj.files) | {"dense0", "rank_up",
                                                 "dense_up"}
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype, k
        for k in ("nbr", "off", "ent", "vecs", "gid", "lvl"):
            np.testing.assert_array_equal(zp[k], zj[k])
    port = _assembly(d, dense=True)
    assert_matches(port, queries, rec, "port_file")
    port.save(tmp_path / "rt.npz")
    back = ShardedSlimIndex.load(tmp_path / "rt.npz", make_mesh(SHARD_S),
                                 search_cfg=SCFG, device="cpu")
    assert set(back.arrays) == set(port.arrays)
    for k, v in port.arrays.items():
        assert torch.equal(back.arrays[k], v), k
    a, b = port.search(queries, SHARD_K), back.search(queries, SHARD_K)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def test_padded_short_shard_never_surfaces(jrun):
    """997 points over 4 shards: the JAX build's file served by the port
    gives the JAX results and no id >= 997 or -1; so does the port's own
    build, whose shards 1..3 (249 points each) carry one padded copy (gid
    -1) each."""
    d, rec = jrun
    base, queries = short_dataset()
    jl = ShardedSlimIndex.load(d / "sharded997.npz", make_mesh(SHARD_S),
                               search_cfg=SCFG, device="cpu")
    _, pi = assert_matches(jl, queries, rec, "short")
    assert (pi >= 0).all() and (pi < 997).all()
    own = ShardedSlimIndex(make_mesh(SHARD_S), search_cfg=SCFG,
                           device="cpu").build(base, hnsw_cfg=SHARD_CFG)
    gid = own.arrays["gid"].numpy()
    assert gid.shape == (SHARD_S, 250) and (gid == -1).sum() == 3
    assert (gid[1:, -1] == -1).all()
    _, oi = own.search(queries, SHARD_K)
    assert (oi >= 0).all() and (oi < 997).all()
    dt, it = own.search(base[:50], 1)
    assert (it[:, 0] == np.arange(50)).mean() >= 0.95
    assert own.index_size() == 24 * 1000 + 4 * int(
        (own.arrays["off"][:, :, -1] - own.arrays["off"][:, :, 0]).sum())


@pytest.mark.parametrize("dense", [False, True])
def test_sharded_equals_host_merge_and_union(jrun, dense):
    """The mesh == flat gate: the sharded search equals each shard's own
    search merged on the host (global ids, stable sort by distance), hops
    and dcomp the per-shard sums; the union with seed_width 0 over the same
    shards returns the same ids, distances and effort."""
    d, _ = jrun
    _, queries = shard_dataset()
    shards = _shards(d)
    sh = _assembly(d, dense)
    sd, si = sh.search(queries, SHARD_K)
    per_d, per_i, hops, dcomp = [], [], [], []
    for sub, _ in shards:
        sub.scfg = SCFG
        if dense:
            sub.densify_level0()
            sub.densify_upper()
        a, b, h, c = sub.search_async(queries, SHARD_K)
        per_d.append(a)
        per_i.append(b)
        hops.append(h)
        dcomp.append(c)
    gid = torch.as_tensor(np.stack([g for _, g in shards]))
    md, mi, mh, mc = merge_topk_plain(torch.stack(per_d),
                                      torch.stack(per_i), gid,
                                      torch.stack(hops), torch.stack(dcomp))
    np.testing.assert_array_equal(si, mi.numpy())
    np.testing.assert_array_equal(sd, md.numpy())
    assert sh.last_stats == {"hops": int(mh.sum()),
                             "distance_computations": int(mc.sum())}
    u = FlatUnionIndex.from_indexes(shards, search_cfg=SCFG, device="cpu")
    if dense:
        u.densify_level0()
        u.densify_upper()
    ud, ui = u.search(queries, SHARD_K)
    np.testing.assert_array_equal(ui, si)
    np.testing.assert_allclose(ud, sd, rtol=1e-6, atol=1e-6)
    assert u.last_stats == sh.last_stats


def test_make_mesh_layouts():
    """The (dp, shard) layout's rank arithmetic, and the refusals."""
    m = Mesh(dp=2, n_shards=4, ranks=4, rank=3)
    assert m.shard_ranks == 2 and m.dp_index == 1
    assert list(m.local_shards) == [2, 3]
    assert list(Mesh(dp=1, n_shards=4).local_shards) == [0, 1, 2, 3]
    assert make_mesh(3).shape == {"dp": 1, "shard": 3}
    with pytest.raises(ValueError):
        make_mesh(4, dp=2)  # one process: dp must divide 1 rank


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from hnsw_slim_tpu_torch.config import SearchConfig
from hnsw_slim_tpu_torch.parallel.sharded import ShardedSlimIndex, make_mesh

torch.set_num_threads(1)
port, rank, path, qpath, out = sys.argv[1:]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=int(rank))
try:
    mesh = make_mesh(4, dp=2)
    idx = ShardedSlimIndex.load(path, mesh, search_cfg=SearchConfig(ef=32),
                                device="cpu")
    q = np.load(qpath)
    d, i = idx.search(q, 5)
    np.savez(out, d=d, i=i, hops=idx.last_stats["hops"],
             dcomp=idx.last_stats["distance_computations"],
             size=idx.index_size(), local=np.array(list(mesh.local_shards)))
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_gloo_ranks_equal_one_process(jrun, tmp_path):
    """4 ranks (dp 2 x 2 shard ranks, 2 shards each) over gloo on the CPU:
    every rank returns the one-process result exactly (an odd batch of 63
    queries pads the dp split), with its hops, dcomp and index_size. The
    ranks run as child processes under a hard 180 s limit; on expiry they
    are killed and the test fails."""
    d, _ = jrun
    _, queries = shard_dataset()
    queries = queries[:63]
    ref = ShardedSlimIndex.load(d / "ported.npz", make_mesh(SHARD_S),
                                search_cfg=SCFG, device="cpu")
    rd, ri = ref.search(queries, SHARD_K)
    np.save(tmp_path / "q.npy", queries)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, port, str(r), str(d / "ported.npz"),
         str(tmp_path / "q.npy"), str(tmp_path / f"r{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(4)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            logs.append(out.decode(errors="replace")[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    for r in range(4):
        with np.load(tmp_path / f"r{r}.npz") as z:
            np.testing.assert_array_equal(z["i"], ri)
            np.testing.assert_array_equal(z["d"], rd)
            assert int(z["hops"]) == ref.last_stats["hops"]
            assert int(z["dcomp"]) == ref.last_stats["distance_computations"]
            assert int(z["size"]) == ref.index_size()
            assert list(z["local"]) == [2 * (r % 2), 2 * (r % 2) + 1]
