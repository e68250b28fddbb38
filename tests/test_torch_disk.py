"""The port's on-disk stores held to the JAX package on the CPU: the
DiskClusterStore file and its reads, DiskDocStore, the engine's DiskStore
and the paper's two on-disk retrievers (`ondisk_clusd_retrieve`, CluSD
over one block file, and `ondisk_rerank_retrieve`, S+Rerank with a read
per doc).

One JAX state at clusd_msmarco.smoke() widths, made from a seed, is
packed by both packages. Tolerances: the file's bytes, the blocks read
and the I/O counters (`IOStats.n_ops`, one op per run of adjacent
cluster ids, and `bytes`) are equal; retrieved ids are equal at every
rank more than 1e-5 from both neighbours' scores (`isolated_ranks`) and
scores allclose at rtol 1e-5, atol 1e-6 (dot products summed in other
orders).
"""

import threading

import _torch_parity as tp  # first: it caps torch at 2 threads
import numpy as np
import pytest
import torch
from _torch_parity import (as_tensor, assert_same_results, index_arrays,
                           torch_cfg)

from repro.core import disk as jdisk
from repro.data import synth_queries
from repro.engine import DiskStore as JaxDiskStore
from repro.engine import RetrievalEngine as JaxEngine
from repro_torch.convert import index_from_numpy
from repro_torch.core import disk as tdisk
from repro_torch.engine import DiskStore, RetrievalEngine

# runs, gaps, a lone id, a repeat, a descending pair and the last cluster
FETCH_IDS = ([0, 1, 2, 5, 20, 21, 22, 40, 63], [63, 62, 10], [7], [3, 3, 4],
             list(range(64)))


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    cfg, index, corpus = tp.jax_smoke_state(0)
    root = tmp_path_factory.mktemp("disk")
    emb = np.asarray(corpus.embeddings)
    jpath, tpath = str(root / "jax.bin"), str(root / "torch.bin")
    jstore = jdisk.DiskClusterStore.pack(jpath, emb, index.cluster_docs)
    tstore = tdisk.DiskClusterStore.pack(tpath, emb,
                                         np.asarray(index.cluster_docs))
    t_index = index_from_numpy(index_arrays(index), device="cpu")
    qs = synth_queries(9, corpus, 24)
    return cfg, index, corpus, t_index, qs, jstore, tstore


def test_pack_writes_the_jax_stores_bytes(state):
    _, index, corpus, _, _, jstore, tstore = state
    with open(jstore.path, "rb") as f:
        jbytes = f.read()
    with open(tstore.path, "rb") as f:
        tbytes = f.read()
    N, cap = np.asarray(index.cluster_docs).shape
    assert len(tbytes) == N * cap * corpus.embeddings.shape[1] * 4
    assert tbytes == jbytes
    assert (tstore.n_clusters, tstore.cap, tstore.dim, tstore.block_bytes) \
        == (jstore.n_clusters, jstore.cap, jstore.dim, jstore.block_bytes)
    # a tensor cluster table packs the same file
    other = tdisk.DiskClusterStore.pack(
        tstore.path + ".t", corpus.embeddings,
        torch.from_numpy(np.array(index.cluster_docs)))
    with open(other.path, "rb") as f:
        assert f.read() == jbytes


def test_open_checks_the_file_size(state, tmp_path):
    *_, jstore, tstore = state
    geo = (tstore.n_clusters, tstore.cap, tstore.dim)
    reopened = tdisk.DiskClusterStore.open(tstore.path, *geo)
    np.testing.assert_array_equal(reopened.fetch_clusters([4, 5]).numpy(),
                                  np.asarray(jstore.fetch_clusters([4, 5])))
    short = tmp_path / "short.bin"
    short.write_bytes(b"\0" * (tstore.block_bytes * 3))
    bad = (tstore.n_clusters, tstore.cap + 1, tstore.dim)
    for path, g in ((tstore.path, bad), (str(short), geo)):
        with pytest.raises(ValueError) as t_err:
            tdisk.DiskClusterStore.open(path, *g)
        with pytest.raises(ValueError) as j_err:
            jdisk.DiskClusterStore.open(path, *g)
        assert str(t_err.value) == str(j_err.value)
        assert "expected" in str(t_err.value)
    with pytest.raises(ValueError, match="n_clusters/cap/dim"):
        tdisk.DiskClusterStore(tstore.path)
    with pytest.raises(ValueError, match="float32"):
        tdisk.DiskClusterStore.open(tstore.path, *geo, dtype=np.float16)


def test_fetch_clusters_and_iostats_equal_jax(state):
    *_, jstore, tstore = state
    for ids in FETCH_IDS:
        ts, js = tdisk.IOStats(), jdisk.IOStats()
        got = tstore.fetch_clusters(ids, ts)
        want = np.asarray(jstore.fetch_clusters(ids, js))
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (ts.n_ops, ts.bytes) == (js.n_ops, js.bytes)
        assert ts.model_ms() == js.model_ms()
        assert tstore.fetch_clusters(ids).shape == got.shape  # stats optional


def test_disk_doc_store_equals_jax(state, tmp_path):
    _, _, corpus, _, _, _, _ = state
    emb = np.asarray(corpus.embeddings)
    jd = jdisk.DiskDocStore(str(tmp_path / "j.bin"), emb)
    td = tdisk.DiskDocStore(str(tmp_path / "t.bin"), emb)
    assert (tmp_path / "t.bin").read_bytes() \
        == (tmp_path / "j.bin").read_bytes()
    ids = np.random.default_rng(3).integers(0, len(emb), 37)
    ts, js = tdisk.IOStats(), jdisk.IOStats()
    got = td.fetch_docs(ids, ts)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jd.fetch_docs(ids, js)))
    assert (ts.n_ops, ts.bytes) == (js.n_ops, js.bytes) \
        == (37, 37 * td.doc_bytes)


def test_disk_store_fetch_blocks_equals_jax(state, tmp_path):
    _, index, corpus, _, _, jstore, tstore = state
    cd = np.asarray(index.cluster_docs)
    t = DiskStore(tstore, torch.from_numpy(np.array(cd)))
    j = JaxDiskStore(jstore, cd)
    assert t.is_host and not t.is_coded
    assert (t.cap, t.dim, t.block_bytes) == (j.cap, j.dim, j.block_bytes)
    assert t.cluster_docs.dtype == torch.int32
    for ids in FETCH_IDS + ([],):
        tv, td, tval = t.fetch_blocks(ids)
        jv, jd, jval = j.fetch_blocks(ids)
        assert tv.dtype == np.float32 and tv.shape == np.asarray(jv).shape
        np.testing.assert_array_equal(tv, np.asarray(jv))
        np.testing.assert_array_equal(td, np.asarray(jd))
        np.testing.assert_array_equal(tval, np.asarray(jval))
    assert (t.stats.n_ops, t.stats.bytes) == (j.stats.n_ops, j.stats.bytes)
    made = DiskStore.create(str(tmp_path / "c.bin"), corpus.embeddings, cd)
    assert (tmp_path / "c.bin").read_bytes() == open(jstore.path, "rb").read()
    np.testing.assert_array_equal(made.fetch_blocks([9])[0],
                                  t.fetch_blocks([9])[0])


def test_disk_store_stats_shared_by_two_threads(state):
    """Two threads fetch through one DiskStore at once (the engine's
    serving thread and its prefetcher): no count is lost."""
    *_, tstore = state
    store = DiskStore(tstore, np.asarray(state[1].cluster_docs))
    one = tdisk.IOStats()
    for ids in FETCH_IDS:
        tstore.fetch_clusters(ids, one)
    start = threading.Barrier(2)

    def work():
        start.wait()
        for _ in range(50):
            for ids in FETCH_IDS:
                store.fetch_blocks(ids)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert store.stats.n_ops == 100 * one.n_ops
    assert store.stats.bytes == 100 * one.bytes


def test_ondisk_clusd_retrieve_matches_jax(state):
    cfg, index, _, t_index, qs, jstore, tstore = state
    jids, jsc, jst = jdisk.ondisk_clusd_retrieve(
        cfg, index, jstore, qs.q_dense, qs.q_terms, qs.q_weights)
    with torch.no_grad():
        tids, tsc, tst = tdisk.ondisk_clusd_retrieve(
            torch_cfg(cfg), t_index, tstore, as_tensor(qs.q_dense),
            as_tensor(qs.q_terms), as_tensor(qs.q_weights))
    assert tids.shape == (24, cfg.k_final)
    assert_same_results((tids.numpy(), tsc.numpy()),
                        (np.asarray(jids), np.asarray(jsc)))
    assert (tst.n_ops, tst.bytes) == (jst.n_ops, jst.bytes) and tst.n_ops > 0


def test_ondisk_rerank_retrieve_matches_jax(state, tmp_path):
    cfg, index, corpus, t_index, qs, _, _ = state
    emb = np.asarray(corpus.embeddings)
    jd = jdisk.DiskDocStore(str(tmp_path / "j.bin"), emb)
    td = tdisk.DiskDocStore(str(tmp_path / "t.bin"), emb)
    jids, jsc, jst = jdisk.ondisk_rerank_retrieve(
        cfg, index, jd, qs.q_dense[:6], qs.q_terms[:6], qs.q_weights[:6],
        depth=100, k=40)
    with torch.no_grad():
        tids, tsc, tst = tdisk.ondisk_rerank_retrieve(
            torch_cfg(cfg), t_index, td, as_tensor(qs.q_dense[:6]),
            as_tensor(qs.q_terms[:6]), as_tensor(qs.q_weights[:6]),
            depth=100, k=40)
    assert tids.shape == (6, 40)
    assert_same_results((tids.numpy(), tsc.numpy()),
                        (np.asarray(jids), np.asarray(jsc)))
    assert (tst.n_ops, tst.bytes) == (jst.n_ops, jst.bytes) == (
        600, 600 * td.doc_bytes)


@pytest.mark.parametrize("cache_capacity", [0, 16])
def test_disk_store_engine_matches_jax(state, cache_capacity):
    """RetrievalEngine over a DiskStore, prefetch off: ids, and the same
    I/O counters and cache counts as the JAX engine; stats() has the JAX
    engine's keys (no decode_ms: a DiskStore decodes nothing)."""
    cfg, index, _, t_index, qs, jstore, tstore = state
    cd = np.asarray(index.cluster_docs)
    kw = dict(max_batch=8, prefetch=False, cache_capacity=cache_capacity)
    with JaxEngine(cfg, index, store=JaxDiskStore(jstore, cd), **kw) as je:
        j = [np.asarray(x) for x in je.retrieve(qs.q_dense, qs.q_terms,
                                                qs.q_weights)]
    with RetrievalEngine(torch_cfg(cfg), t_index,
                         store=DiskStore(tstore, t_index.cluster_docs),
                         device="cpu", **kw) as te:
        t = [x.numpy() for x in te.retrieve(qs.q_dense, qs.q_terms,
                                            qs.q_weights)]
    assert_same_results(t, j)
    ts, js = te.stats(), je.stats()
    assert sorted(ts) == sorted(js) and "decode_ms" not in ts
    assert ts["io"]["n_ops"] == js["io"]["n_ops"] > 0
    assert ts["io"]["bytes"] == js["io"]["bytes"]
    assert ("cache" in ts) == ("cache" in js) == bool(cache_capacity)
    if cache_capacity:
        for k in ("hits", "misses", "evictions", "size"):
            assert ts["cache"][k] == js["cache"][k], k
    te.reset_stats()
    assert te.stats()["io"]["n_ops"] == 0
