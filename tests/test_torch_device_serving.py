"""The device-store path on the CPU against the JAX package: the engine
with no store (`RetrievalEngine(cfg, index)`, which serves an
InMemoryStore or a PQStore), `pipeline.retrieve`, `clusd.retrieve`,
`score_selected` and `full_dense_topk`; and the v2 bfloat16 host decode.

The two packages get the same index, selector, quantizer and queries as
numpy arrays (JAX builds them at smoke widths). Tolerances: ids equal at
every rank more than 1e-5 from both neighbours' scores; scores rtol
1e-5, atol 1e-6, because the two packages sum dot products, ADC terms
and sparse contributions in other orders (the port's ADC adds subspaces
in ascending order, XLA reduces them its own way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (as_tensor, assert_same_results, index_arrays,
                           isolated_ranks, jax_smoke_state, torch_cfg)

from repro.configs import get_config
from repro.core import clusd as jcl
from repro.core import quant as jquant
from repro.data import synth_corpus as jax_synth_corpus
from repro.data import synth_queries as jax_synth_queries
from repro.engine import pipeline as jpipe
from repro.engine.server import RetrievalEngine as JaxEngine
from repro.engine.stores import InMemoryStore as JaxInMemoryStore
from repro.engine.stores import PQStore as JaxPQStore
from repro_torch import convert
from repro_torch.core import clusd as tcl
from repro_torch.core import quant as tquant
from repro_torch.engine import InMemoryStore, PQStore, RetrievalEngine
from repro_torch.engine import pipeline as tpipe


def _pq_arrays(pq):
    return dict(codebooks=np.asarray(pq.codebooks), codes=np.asarray(pq.codes),
                rotation=None if pq.rotation is None
                else np.asarray(pq.rotation), nsub=pq.nsub)


def _t_index(index, quantizer=None):
    """The JAX index carried across with its embeddings (and PQ)."""
    arr = index_arrays(index)
    arr["embeddings"] = np.asarray(index.embeddings)
    if quantizer is not None:
        arr["quantizer"] = _pq_arrays(quantizer)
    return convert.index_from_numpy(arr, device="cpu")


@pytest.fixture(scope="module")
def smoke():
    cfg, index, corpus = jax_smoke_state(0)
    pq = jquant.train_pq(jax.random.key(1), corpus.embeddings, nsub=8,
                         iters=3)
    qs = jax_synth_queries(9, corpus, 32)
    return cfg, index, corpus, pq, qs


@pytest.fixture(scope="module")
def tiny():
    """256 docs, small enough for the exact identity PQ."""
    cfg, index, corpus = jax_smoke_state(
        0, n_docs=256, n_clusters=16, vocab=256, k_sparse=64,
        bins=(5, 15, 30, 64), n_candidates=8, max_selected=4,
        n_neighbors=8, u_bins=4, k_final=32)
    qs = jax_synth_queries(7, corpus, 12)
    return cfg, index, corpus, qs


def _serve_both(cfg, j_index, t_index, qs, **kw):
    with JaxEngine(cfg, j_index, max_batch=16, **kw) as jeng:
        jids, jsc = jeng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
        js = jeng.stats()
    with RetrievalEngine(torch_cfg(cfg), t_index, max_batch=16,
                         trace_sample_rate=1.0, device="cpu", **kw) as teng:
        tids, tsc = teng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
        ts = teng.stats()
        spans = {sp.name for tr in teng.tracer.traces for sp in tr.spans}
        store = teng.store
    return ((tids.numpy(), tsc.numpy(), ts), (np.asarray(jids),
                                             np.asarray(jsc), js),
            spans, store)


def _assert_device_stats(ts, js):
    assert sorted(ts) == sorted(js)
    assert "io" not in ts and "cache" not in ts and "use_adc" not in ts
    for key in ("n_queries", "n_batches", "n_compile_batches",
                "compiled_buckets", "fusion", "prefetch_enqueued"):
        assert ts[key] == js[key], key


def test_in_memory_engine_matches_jax_engine(smoke):
    cfg, index, _, _, qs = smoke
    t, j, spans, store = _serve_both(cfg, index, _t_index(index), qs)
    assert isinstance(store, InMemoryStore) and not store.is_host
    assert store.blocks.shape == (cfg.n_clusters, cfg.cluster_cap, cfg.dim)
    assert_same_results(t, j)
    _assert_device_stats(t[2], j[2])
    assert "device_pipeline" in spans and "cache_fetch" not in spans


@pytest.mark.parametrize("kind", ["trained", "identity"])
def test_pq_engine_matches_jax_engine(smoke, tiny, kind):
    if kind == "trained":
        cfg, index, _, pq, qs = smoke
    else:
        cfg, index, corpus, qs = tiny
        pq = jquant.identity_pq(corpus.embeddings, 8)
    j_index = dataclasses.replace(index, quantizer=pq)
    t, j, spans, store = _serve_both(cfg, j_index, _t_index(index, pq), qs)
    assert isinstance(store, PQStore)
    assert store.code_blocks.dtype == torch.uint8
    assert_same_results(t, j)
    _assert_device_stats(t[2], j[2])
    if kind == "identity":
        # lossless codes: ADC serving equals exact dense serving
        t_mem, _, _, _ = _serve_both(cfg, index, _t_index(index), qs)
        ok = isolated_ranks(t_mem[1])
        np.testing.assert_array_equal(t[0][ok], t_mem[0][ok])
        np.testing.assert_allclose(t[1], t_mem[1], rtol=1e-5, atol=1e-6)


def test_device_stores_fetch_and_score_docs_like_jax(tiny):
    """fetch_blocks / fetch_code_blocks / score_docs of both device stores
    against the JAX stores, over the port's own identity PQ."""
    cfg, index, corpus, _ = tiny
    jpq = jquant.identity_pq(corpus.embeddings, 8)
    tpq = tquant.identity_pq(corpus.embeddings, 8, device="cpu")
    np.testing.assert_array_equal(tpq.codebooks.numpy(),
                                  np.asarray(jpq.codebooks))
    np.testing.assert_array_equal(tpq.codes.numpy(), np.asarray(jpq.codes))
    t_index = _t_index(index)
    cd = t_index.cluster_docs
    pairs = ((JaxInMemoryStore(index.embeddings, index.cluster_docs),
              InMemoryStore(t_index.embeddings, cd)),
             (JaxPQStore(jpq, index.cluster_docs), PQStore(tpq, cd)))
    cids = np.asarray([[0, 3], [7, 3]])
    rng = np.random.default_rng(0)
    doc_ids = rng.integers(0, cfg.n_docs, (3, 10)).astype(np.int32)
    q = np.asarray(corpus.embeddings[:3]) * 2.0
    for jstore, tstore in pairs:
        for fetch in ("fetch_blocks", "fetch_code_blocks"):
            if not hasattr(jstore, fetch):
                continue
            got = getattr(tstore, fetch)(as_tensor(cids))
            want = getattr(jstore, fetch)(jnp.asarray(cids))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tstore.score_docs(as_tensor(q), as_tensor(doc_ids)).numpy(),
            np.asarray(jstore.score_docs(jnp.asarray(q),
                                         jnp.asarray(doc_ids))),
            rtol=1e-5, atol=1e-6)


def test_use_adc_over_an_in_memory_store_raises_as_in_jax(smoke):
    cfg, index, *_ = smoke
    with pytest.raises(ValueError, match="code-backed"):
        JaxEngine(cfg, index, use_adc=True)
    with pytest.raises(ValueError, match="code-backed"):
        RetrievalEngine(torch_cfg(cfg), _t_index(index), use_adc=True,
                        device="cpu")


def _assert_diag_equal(tdiag, jdiag):
    for key in ("sparse_ids", "cand", "sel_ids", "sel_mask", "n_selected"):
        np.testing.assert_array_equal(tdiag[key].numpy(),
                                      np.asarray(jdiag[key]), err_msg=key)
    for key in ("sparse_scores", "probs", "frac_docs_scanned"):
        np.testing.assert_allclose(tdiag[key].numpy(),
                                   np.asarray(jdiag[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("store", ["memory", "pq", "disk"])
def test_pipeline_retrieve_matches_jax(smoke, store, tmp_path):
    """Against a device store, and against a host store (v1 float
    shards), whose selection is deduplicated and fetched once."""
    cfg, index, corpus, pq, qs = smoke
    t_index = _t_index(index, pq)
    if store == "memory":
        jstore = JaxInMemoryStore(index.embeddings, index.cluster_docs)
        tstore = InMemoryStore(t_index.embeddings, t_index.cluster_docs)
    elif store == "pq":
        jstore = JaxPQStore(pq, index.cluster_docs)
        tstore = PQStore(t_index.quantizer, t_index.cluster_docs)
    else:
        from repro import index as jindex
        from repro_torch.index import IndexReader
        path = str(tmp_path / "v1")
        jindex.write_index(path, cfg, index, np.asarray(corpus.embeddings),
                           n_shards=2)
        jstore = jindex.IndexReader.open(path).open_store(
            cluster_docs=index.cluster_docs)
        tstore = IndexReader.open(path).open_store()
    jids, jsc, jdiag = jpipe.retrieve(cfg, index, jstore, qs.q_dense,
                                      qs.q_terms, qs.q_weights)
    with torch.no_grad():
        tids, tsc, tdiag = tpipe.retrieve(
            torch_cfg(cfg), t_index, tstore, as_tensor(qs.q_dense),
            as_tensor(qs.q_terms), as_tensor(qs.q_weights))
    assert_same_results((tids.numpy(), tsc.numpy()),
                        (np.asarray(jids), np.asarray(jsc)))
    _assert_diag_equal(tdiag, jdiag)


def test_clusd_retrieve_with_theta_and_selector_params_matches_jax(smoke):
    cfg, index, _, _, qs = smoke
    from repro.core.features import feature_dim
    from repro.core.lstm import lstm_init
    params = lstm_init(jax.random.key(5), feature_dim(cfg), cfg.lstm_hidden)
    j = jcl.retrieve(cfg, index, qs.q_dense, qs.q_terms, qs.q_weights,
                     theta=0.3, selector_params=params, k=40)
    t_index = _t_index(index)
    with torch.no_grad():
        t = tcl.retrieve(torch_cfg(cfg), t_index, as_tensor(qs.q_dense),
                         as_tensor(qs.q_terms), as_tensor(qs.q_weights),
                         theta=0.3, selector_params={
                             k: np.asarray(v) for k, v in params.items()},
                         k=40)
    assert t[0].shape == (32, 40)
    assert_same_results((t[0].numpy(), t[1].numpy()),
                        (np.asarray(j[0]), np.asarray(j[1])))
    _assert_diag_equal(t[2], j[2])
    # "rnn" over the index's LSTM weights: a TypeError in both packages
    # (JAX's scan meets a carry of the wrong shape); an unknown name is
    # the SELECTORS lookup's KeyError in both
    with pytest.raises(TypeError):
        jcl.retrieve(cfg, index, qs.q_dense, qs.q_terms, qs.q_weights,
                     selector="rnn")
    with pytest.raises(TypeError, match="rnn"):
        tcl.retrieve(torch_cfg(cfg), t_index, as_tensor(qs.q_dense),
                     as_tensor(qs.q_terms), as_tensor(qs.q_weights),
                     selector="rnn")
    for run in (lambda: jcl.retrieve(cfg, index, qs.q_dense, qs.q_terms,
                                     qs.q_weights, selector="gru"),
                lambda: tcl.retrieve(torch_cfg(cfg), t_index,
                                     as_tensor(qs.q_dense),
                                     as_tensor(qs.q_terms),
                                     as_tensor(qs.q_weights),
                                     selector="gru")):
        with pytest.raises(KeyError, match="gru"):
            run()


def test_clusd_retrieve_builds_its_device_store_once(smoke, monkeypatch):
    """clusd.retrieve and clusd.score_selected build the index's device
    store (a block table) at their first call and reuse it while the
    index keeps the same embeddings or quantizer; results do not change."""
    from repro_torch.engine import stores as tstores
    cfg, index, corpus, pq, qs = smoke
    built = []

    def counting(cls):
        class Counting(cls):
            def __init__(self, *a, **kw):
                built.append(cls.__name__)
                super().__init__(*a, **kw)
        return Counting

    for name in ("InMemoryStore", "PQStore"):
        monkeypatch.setattr(tstores, name, counting(getattr(tstores, name)))
    q = tuple(as_tensor(x) for x in (qs.q_dense, qs.q_terms, qs.q_weights))
    for quantizer, kind in ((None, "InMemoryStore"), (pq, "PQStore")):
        built.clear()
        t_index = _t_index(index, quantizer)
        with torch.no_grad():
            first = tcl.retrieve(torch_cfg(cfg), t_index, *q)
            second = tcl.retrieve(torch_cfg(cfg), t_index, *q)
        assert built == [kind]
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])
    sel = torch.zeros((2, 3), dtype=torch.int32)
    mask = torch.ones((2, 3), dtype=torch.bool)
    built.clear()
    for _ in range(2):
        tcl.score_selected(t_index, q[0][:2], sel, mask)
    assert built == ["InMemoryStore"]
    t_index.embeddings = t_index.embeddings.clone()    # new embeddings
    tcl.score_selected(t_index, q[0][:2], sel, mask)
    assert built == ["InMemoryStore"] * 2


def test_score_selected_and_full_dense_topk_match_jax(smoke):
    cfg, index, corpus, pq, qs = smoke
    t_index = _t_index(index, pq)
    rng = np.random.default_rng(2)
    sel = rng.integers(0, cfg.n_clusters, (8, 5)).astype(np.int32)
    mask = rng.random((8, 5)) > 0.3
    q = np.asarray(qs.q_dense[:8])
    for jfn, tfn in ((jcl.score_selected, tcl.score_selected),
                     (jquant.score_selected_pq, tquant.score_selected_pq)):
        jd, js, jv = jfn(index if jfn is jcl.score_selected else
                         dataclasses.replace(index, quantizer=pq),
                         jnp.asarray(q), jnp.asarray(sel), jnp.asarray(mask))
        td, ts, tv = tfn(t_index, as_tensor(q), as_tensor(sel),
                         as_tensor(mask))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-6)
    ji, js = jcl.full_dense_topk(corpus.embeddings, jnp.asarray(q), 50)
    ti, ts = tcl.full_dense_topk(as_tensor(corpus.embeddings), as_tensor(q),
                                 50)
    ok = isolated_ranks(np.asarray(js))
    np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)


def test_reload_selector_on_a_device_store(smoke, tmp_path):
    """A device-store engine with a reader adopts the reader's selector
    and config, keeps its store, and serves what JAX serves."""
    from repro import index as jindex
    from repro_torch.index import IndexReader

    cfg, index, corpus, _, qs = smoke
    path = str(tmp_path / "idx")
    jindex.write_index(path, cfg, index, np.asarray(corpus.embeddings),
                       n_shards=2)
    blank = dataclasses.replace(index, lstm_params=None)
    jeng = JaxEngine(cfg, blank, max_batch=16,
                     reader=jindex.IndexReader.open(path))
    teng = RetrievalEngine(torch_cfg(cfg), _t_index(blank), max_batch=16,
                           reader=IndexReader.open(path), device="cpu")
    with jeng, teng:
        store = teng.store
        for eng in (jeng, teng):
            eng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
            eng.reload_selector()
        assert teng.store is store and teng.index.selector is not None
        t = [x.numpy() for x in teng.retrieve(qs.q_dense, qs.q_terms,
                                              qs.q_weights)]
        j = [np.asarray(x) for x in jeng.retrieve(qs.q_dense, qs.q_terms,
                                                  qs.q_weights)]
        assert teng.stats()["selector_reloads"] == 1
    assert_same_results(t, j)


def test_v2_bfloat16_decode_matches_jax(tmp_path):
    """A v2 directory written with block_dtype="bfloat16": the JAX store
    decodes to bfloat16 blocks, the port's to the same values as
    float32, so use_adc=False serving scores what JAX scores."""
    from repro import index as jindex
    from repro.core import clusd as cl
    from repro_torch.index import IndexReader

    cfg = dataclasses.replace(get_config("clusd-msmarco", "smoke"),
                              n_docs=1024)
    corpus = jax_synth_corpus(4, cfg.n_docs, cfg.dim, cfg.vocab)
    index = cl.build_index(cfg, jax.random.key(4), corpus.embeddings,
                           corpus.doc_terms, corpus.doc_weights)
    pq = jquant.train_pq(jax.random.key(2), corpus.embeddings, nsub=8,
                         iters=3)
    path = str(tmp_path / "v2bf16")
    jindex.write_index(path, cfg, index, np.asarray(corpus.embeddings),
                       n_shards=2, format_version=2, pq=pq,
                       block_dtype="bfloat16")
    ids = np.arange(0, cfg.n_clusters, 5)
    jb = np.asarray(jindex.IndexReader.open(path).open_store(
        cluster_docs=index.cluster_docs).fetch_blocks(ids)[0])
    tb = IndexReader.open(path).open_store().fetch_blocks(ids)[0]
    assert jb.dtype.name == "bfloat16" and tb.dtype == np.float32
    np.testing.assert_array_equal(tb, jb.astype(np.float32))
    qs = jax_synth_queries(3, corpus, 16)
    with jindex.IndexReader.open(path).engine(max_batch=16, prefetch=False,
                                              use_adc=False) as jeng:
        j = [np.asarray(x) for x in jeng.retrieve(
            qs.q_dense, qs.q_terms, qs.q_weights)]
    with IndexReader.open(path).engine(max_batch=16, prefetch=False,
                                       use_adc=False, device="cpu") as teng:
        t = [x.numpy() for x in teng.retrieve(qs.q_dense, qs.q_terms,
                                              qs.q_weights)]
    assert_same_results(t, j)
