"""The v2 path end to end on the CPU: the JAX package builds a smoke-width
index and writes it as a v2 (PQ code shard) index; the port's writer
gives the same code shards byte for byte, the port opens JAX's shard
files with its own ShardedPQStore, and its RetrievalEngine(device="cpu")
serves 32 queries against the JAX RetrievalEngine over JAX's store.

Tolerances: result ids equal at every rank more than 1e-5 from both
neighbours' scores (the two engines sum ADC and sparse scores in other
orders); scores allclose at rtol 1e-5; code bytes, fetched blocks,
io.n_ops and the stats() keys exact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (as_tensor, index_arrays, isolated_ranks,
                           jax_smoke_state, torch_cfg)
from repro import index as jindex
from repro.core import quant as jquant
from repro.data import synth_queries as jax_synth_queries
from repro.engine.server import RetrievalEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import clusd as tcl
from repro_torch.core import quant as tquant
from repro_torch.engine import RetrievalEngine, ShardedPQStore
from repro_torch.engine import pipeline as tpipe
from repro_torch.index import IndexReader, shard_ranges, write_index

N_SHARDS = 3


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    cfg, index, corpus = jax_smoke_state(0)
    pq = jquant.train_pq(jax.random.key(1), corpus.embeddings, nsub=8)
    out = str(tmp_path_factory.mktemp("jax_v2") / "idx")
    jindex.write_index(out, cfg, index, np.asarray(corpus.embeddings),
                       n_shards=N_SHARDS, format_version=2, pq=pq)
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    qs = jax_synth_queries(9, corpus, 32)
    return cfg, index, corpus, pq, out, manifest, qs


def _torch_store(built):
    cfg, index, _, pq, out, manifest, _ = built
    shards = manifest["block_shards"]
    return ShardedPQStore(
        [os.path.join(out, s["file"]) for s in shards],
        [(s["cluster_lo"], s["cluster_hi"]) for s in shards],
        manifest["geometry"]["cap"],
        np.load(os.path.join(out, manifest["pq"]["arrays"]["codebooks"])),
        np.asarray(index.cluster_docs))


def test_code_shards_byte_identical_to_jax_writer(built, tmp_path):
    cfg, index, _, pq, out, manifest, _ = built
    cd = np.asarray(index.cluster_docs)
    assert shard_ranges(cd.shape[0], N_SHARDS) == [
        (s["cluster_lo"], s["cluster_hi"]) for s in manifest["block_shards"]]
    # PQ.codes stays int32 in both packages; the writer casts to uint8
    t_pq = convert.pq_from_numpy(pq.codebooks, pq.codes, None, pq.nsub,
                                 device="cpu")
    assert t_pq.codes.dtype == torch.int32
    t_index = convert.index_from_numpy(index_arrays(index), device="cpu")
    t_out = str(tmp_path / "idx")
    t_man = write_index(t_out, torch_cfg(cfg), t_index,
                        np.zeros((cd.max() + 1, cfg.dim), np.float32),
                        n_shards=N_SHARDS, format_version=2, pq=t_pq)
    assert t_man["block_shards"] == manifest["block_shards"]
    for shard in manifest["block_shards"]:
        with open(os.path.join(t_out, shard["file"]), "rb") as f, \
                open(os.path.join(out, shard["file"]), "rb") as g:
            assert f.read() == g.read(), shard["file"]


def test_store_fetches_like_jax_store(built):
    _, index, _, _, out, _, _ = built
    jstore = jindex.IndexReader.open(out).open_store(
        cluster_docs=index.cluster_docs)
    tstore = _torch_store(built)
    ids = np.asarray([0, 1, 2, 5, 20, 21, 22, 40, 63])   # runs + shard edges
    for fetch in ("fetch_code_blocks", "fetch_blocks"):
        jb, jd, jv = getattr(jstore, fetch)(ids)
        tb, td, tv = getattr(tstore, fetch)(ids)
        np.testing.assert_array_equal(tb, np.asarray(jb), err_msg=fetch)
        np.testing.assert_array_equal(td, np.asarray(jd))
        np.testing.assert_array_equal(tv, np.asarray(jv))
    assert tstore.stats.n_ops == jstore.stats.n_ops
    assert tstore.stats.bytes == jstore.stats.bytes
    with pytest.raises(IndexError):
        tstore.fetch_code_blocks([64])      # past the last cluster


def test_decode_code_blocks_matches_jax():
    rng = np.random.default_rng(0)
    books = rng.standard_normal((4, 256, 3)).astype(np.float32)
    codes = rng.integers(0, 256, (5, 7, 4)).astype(np.uint8)
    rot = np.linalg.qr(rng.standard_normal((12, 12)))[0].astype(np.float32)
    for r in (None, rot):
        np.testing.assert_array_equal(
            tquant.decode_code_blocks(books, codes, r),
            jquant.decode_code_blocks(books, codes, r))


def test_engine_matches_jax_engine_on_jax_written_index(built):
    cfg, index, _, _, out, _, qs = built
    jstore = jindex.IndexReader.open(out).open_store(
        cluster_docs=index.cluster_docs)
    t_index = convert.index_from_numpy(index_arrays(index), device="cpu")
    with JaxEngine(cfg, index, store=jstore, max_batch=16,
                   prefetch=False) as jeng:
        jids, jsc = jeng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
        jstats = jeng.stats()
    with RetrievalEngine(torch_cfg(cfg), t_index, _torch_store(built),
                         max_batch=16, prefetch=False, device="cpu") as teng:
        tids, tsc = teng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
        tstats = teng.stats()
    jids, jsc = np.asarray(jids), np.asarray(jsc)
    tids, tsc = tids.numpy(), tsc.numpy()
    assert tids.shape == jids.shape == (32, cfg.k_final)
    ok = isolated_ranks(jsc)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(tids[ok], jids[ok])
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-6)
    # same stats surface, same I/O
    assert sorted(tstats) == sorted(jstats)
    assert sorted(tstats["cache"]) == sorted(jstats["cache"])
    assert sorted(tstats["io"]) == sorted(jstats["io"])
    assert tstats["io"]["n_ops"] == jstats["io"]["n_ops"] > 0
    assert tstats["io"]["bytes"] == jstats["io"]["bytes"]
    for key in ("n_queries", "n_batches", "n_compile_batches",
                "compiled_buckets", "use_adc", "fusion"):
        assert tstats[key] == jstats[key], key


def test_fused_lists_have_no_duplicate_ids(built):
    """fuse_topk's premise: a doc gets at most one dense and one sparse
    addend, so the atomic scatter on CUDA is exact."""
    cfg, index, _, _, _, _, qs = built
    tcfg = torch_cfg(cfg)
    t_index = convert.index_from_numpy(index_arrays(index), device="cpu")
    qd, qt, qw = (as_tensor(x)
                  for x in (qs.q_dense, qs.q_terms, qs.q_weights))
    with torch.no_grad():
        sid, ss, cand, feats = tpipe.build_stage1_fn(tcfg, t_index)(qd, qt, qw)
        sel, mask, _ = tpipe.build_stage2_fn(tcfg, t_index)(cand, feats)
    docs = t_index.cluster_docs[sel.long()]
    valid = (docs >= 0) & mask[:, :, None]
    for b in range(sid.shape[0]):
        s = sid[b].numpy()
        assert len(np.unique(s)) == len(s)
        d = docs[b][valid[b]].numpy()
        assert len(np.unique(d)) == len(d)


def test_engine_rejects_a_float_store(built):
    """A float-block store serves the "dot" tail; demanding ADC over it
    raises, as in the JAX engine. A device store serves: with no store
    the engine builds an InMemoryStore from the index's embeddings, and
    demanding ADC over that raises as in the JAX engine too."""
    cfg, index, *_ = built
    t_index = convert.index_from_numpy(index_arrays(index), device="cpu")

    class FloatStore:
        is_host, is_coded = True, False
        cap, dim = 8, 32

    with pytest.raises(ValueError, match="code-backed"):
        RetrievalEngine(torch_cfg(cfg), t_index, FloatStore(), use_adc=True,
                        device="cpu")

    arrays = dict(index_arrays(index), embeddings=np.asarray(index.embeddings))
    t_index = convert.index_from_numpy(arrays, device="cpu")
    with RetrievalEngine(torch_cfg(cfg), t_index, device="cpu") as eng:
        assert type(eng.store).__name__ == "InMemoryStore"
        assert not eng.is_host and not eng.use_adc and eng.cache is None
    with pytest.raises(ValueError, match="code-backed"):
        JaxEngine(cfg, index, use_adc=True)
    with pytest.raises(ValueError, match="code-backed"):
        RetrievalEngine(torch_cfg(cfg), t_index, use_adc=True, device="cpu")


def test_retrieve_takes_the_engine_k_as_jax_does(built):
    """retrieve(k=) accepts None or the engine's own k and raises the JAX
    engine's ValueError for any other value."""
    cfg, index, _, _, _, _, qs = built
    arrays = dict(index_arrays(index), embeddings=np.asarray(index.embeddings))
    t_index = convert.index_from_numpy(arrays, device="cpu")
    q3 = (qs.q_dense[:4], qs.q_terms[:4], qs.q_weights[:4])
    with RetrievalEngine(torch_cfg(cfg), t_index, k=20, device="cpu") as eng, \
            JaxEngine(cfg, index, k=20) as jeng:
        ids, scores = eng.retrieve(*q3)
        ids_k, scores_k = eng.retrieve(*q3, k=20)
        assert ids.shape == (4, 20)
        assert torch.equal(ids, ids_k) and torch.equal(scores, scores_k)
        for bad in (10, 21):
            with pytest.raises(ValueError) as t_err:
                eng.retrieve(*q3, k=bad)
            with pytest.raises(ValueError) as j_err:
                jeng.retrieve(*q3, k=bad)
            assert str(t_err.value) == str(j_err.value)
            assert "construct the engine with the serving k" in \
                str(t_err.value)


def test_build_index_serves_end_to_end_on_cpu(tmp_path):
    """The port's own build side (k-means, cluster table, sparse index,
    PQ) written by its write_index and served through its IndexReader,
    as chip_smoke.py drives it."""
    from repro_torch.configs import clusd_msmarco
    from repro_torch.core.features import feature_dim
    from repro_torch.core.lstm import LSTMSelector
    from repro_torch.data import mrr_at, synth_corpus, synth_queries

    cfg = clusd_msmarco.smoke()
    corpus = synth_corpus(1, 2048, cfg.dim, cfg.vocab)
    g = torch.Generator().manual_seed(0)
    index = tcl.build_index(cfg, corpus.embeddings, corpus.doc_terms,
                            corpus.doc_weights, kmeans_iters=5, generator=g,
                            device="cpu")
    assert index.sparse_index.postings_docs.shape == (cfg.vocab,
                                                      cfg.max_postings)
    pq = tquant.train_pq(corpus.embeddings, 8, iters=4, sample_docs=1024,
                         generator=g, device="cpu")
    index.selector = LSTMSelector(feature_dim(cfg), cfg.lstm_hidden,
                                  generator=g)
    write_index(str(tmp_path / "v2"), cfg, index, corpus.embeddings,
                n_shards=4, format_version=2, pq=pq)
    qs = synth_queries(2, corpus, 24)
    with IndexReader.open(str(tmp_path / "v2"), verify="full").engine(
            max_batch=8, device="cpu") as eng:
        assert isinstance(eng.store, ShardedPQStore) and eng.use_adc
        ids, scores = eng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
        stats = eng.stats()
    assert ids.shape == (24, cfg.k_final) and torch.isfinite(scores).all()
    assert ((ids >= 0) & (ids < 2048)).all()
    assert all(len(set(row)) == cfg.k_final for row in ids.tolist())
    assert (scores[:, :-1] >= scores[:, 1:]).all()
    # the untrained selector still finds most queries' source doc
    assert mrr_at(ids.numpy(), qs.rel_doc) > 0.1
    assert stats["n_queries"] == 24 and stats["io"]["n_ops"] > 0
