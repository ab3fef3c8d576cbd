"""The port's reference-graph import (graph/import_ref.py) against the JAX
package's, on the JAX-built Slim and HNSW graphs of torch_slice_util's
dataset written out in parity/ref_harness.cc's two dump formats: each dump
loads through both engines (and through the native and the Python parse)
into exactly equal graph arrays; the imported indexes search like the JAX
package's at the same ef (ids equal on >= 99% of slots, distances within
1e-4 * (1 + |d|), torch_slice_util.assert_ids_match) and exactly like the
port's own index loaded from the checkpoint the dump came from."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from hnsw_slim_tpu.graph import import_ref as jref
from hnsw_slim_tpu_torch.graph import import_ref as pref
from hnsw_slim_tpu_torch.utils import native
from torch_slice_util import (assert_ids_match, dataset, jax_graph_dir,
                              write_ref_hnsw_dump, write_ref_slim_dump)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """(slim dump, hnsw dump, slim.npz, hnsw.npz): the dumps written from
    the JAX-built checkpoints' arrays."""
    src = jax_graph_dir(tmp_path_factory)
    out = tmp_path_factory.mktemp("ref_dumps")
    with np.load(src / "slim.npz") as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        write_ref_slim_dump(
            out / "g.slimgraph", z["nbr"], z["lvl_off"], z["level"],
            entry=meta["entry"], max_level=meta["max_level"],
            threshold_level=meta["threshold_level"], cap=meta["cap"],
            cap0=meta["cap0"])
    with np.load(src / "hnsw.npz") as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        adjs = [z[f"adj{l}"] for l in range(meta["max_level"] + 1)]
        write_ref_hnsw_dump(
            out / "g.hnsw", adjs, z["level"], entry=meta["entry"],
            max_level=meta["max_level"], maxm=meta["cfg"]["M"],
            maxm0=adjs[0].shape[1])
    return out / "g.slimgraph", out / "g.hnsw", src / "slim.npz", \
        src / "hnsw.npz"


@pytest.fixture(params=["native", "python"])
def parse(request, monkeypatch):
    """Load through the native mmap parse, or with it switched off."""
    if request.param == "python":
        monkeypatch.setattr(native, "slim_graph_parse", lambda *a: None)
        monkeypatch.setattr(native, "hnsw_graph_parse", lambda *a: None)
    elif native._lib() is None:
        pytest.skip("native data plane library not built")
    return request.param


def test_slim_dump_loads_equal_in_both_engines(dumps, parse):
    jg, jh = jref.load_ref_slim_graph(str(dumps[0]), return_host=True)
    pg, ph = pref.load_ref_slim_graph(str(dumps[0]), return_host=True,
                                      device="cpu")
    for name in ("nbr", "lvl_off", "level"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
        np.testing.assert_array_equal(ph[name], jh[name])
    assert (pg.entry, pg.max_level, pg.threshold_level, pg.cap0, pg.cap) \
        == (int(jg.entry), jg.max_level, jg.threshold_level, jg.cap0, jg.cap)
    with np.load(dumps[2]) as z:  # and the checkpoint the dump came from
        np.testing.assert_array_equal(ph["lvl_off"], z["lvl_off"])
        np.testing.assert_array_equal(ph["level"], z["level"])
        total = int(z["lvl_off"][-1, -1])
        np.testing.assert_array_equal(ph["nbr"][:total], z["nbr"][:total])


def test_hnsw_dump_loads_equal_in_both_engines(dumps, parse):
    jg, ja = jref.load_ref_hnsw_graph(str(dumps[1]), return_host=True)
    pg, pa = pref.load_ref_hnsw_graph(str(dumps[1]), return_host=True,
                                      device="cpu")
    assert len(pg.adjs) == len(jg.adjs) == len(pa) == len(ja)
    for p_, j_, ph_, jh_ in zip(pg.adjs, jg.adjs, pa, ja):
        np.testing.assert_array_equal(p_.numpy(), np.asarray(j_))
        np.testing.assert_array_equal(ph_, jh_)
    np.testing.assert_array_equal(pg.level.numpy(), np.asarray(jg.level))
    assert (pg.entry, pg.max_level) == (int(jg.entry), jg.max_level)
    with np.load(dumps[3]) as z:
        for l, a in enumerate(pa):
            np.testing.assert_array_equal(a, z[f"adj{l}"])


def test_imported_slim_index_searches_like_jax_and_the_checkpoint(dumps):
    from hnsw_slim_tpu_torch.persist.checkpoint import load_slim

    base, queries = dataset()
    ji = jref.slim_index_from_ref(str(dumps[0]), base)
    pi = pref.slim_index_from_ref(str(dumps[0]), base, device="cpu")
    ck = load_slim(dumps[2], device="cpu")
    for idx in (ji, pi, ck):
        idx.scfg = dataclasses.replace(idx.scfg, ef=32, pop_width=8,
                                       seed_width=32)
    jd, jids = ji.search(queries, k=10)
    pd, pids = pi.search(queries, k=10)
    assert_ids_match(pids, pd, jids, jd)
    cd, cids = ck.search(queries, k=10)
    np.testing.assert_array_equal(pids, cids)
    np.testing.assert_array_equal(pd, cd)
    host = pref.slim_index_from_ref(str(dumps[0]), base, upload=False,
                                    device="cpu")
    assert host.vectors.device.type == "cpu"
    np.testing.assert_allclose(host.vn.numpy(), pi.vn.numpy(), rtol=1e-6)


def test_imported_hnsw_index_searches_like_jax_and_the_checkpoint(dumps):
    from hnsw_slim_tpu_torch.persist.checkpoint import load_hnsw

    base, queries = dataset()
    ji = jref.hnsw_index_from_ref(str(dumps[1]), base, M=8,
                                  ef_construction=64)
    pi = pref.hnsw_index_from_ref(str(dumps[1]), base, M=8,
                                  ef_construction=64, device="cpu")
    ck = load_hnsw(dumps[3], device="cpu")
    for idx in (ji, pi, ck):
        idx.set_ef(32)
    jd, jids = ji.search(queries, k=10)
    pd, pids = pi.search(queries, k=10)
    assert_ids_match(pids, pd, jids, jd)
    cd, cids = ck.search(queries, k=10)
    np.testing.assert_array_equal(pids, cids)
    np.testing.assert_array_equal(pd, cd)
    assert [a.tolist() for a in pi.host_adj()] == \
        [a.tolist() for a in ck.host_adj()]
