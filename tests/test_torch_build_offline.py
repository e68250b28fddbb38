"""The port's streaming build held to the JAX package on the CPU:
`lloyd_refine` (bitwise), `kmeans_shards` and `build_index_offline`
started from JAX's `jax.random.choice` rows, `RowSlice` views and
chunk-capped reads (no read over the chunk, the matrix never
materialized), `train_pq_stream` against `train_pq` on its sample, and
`write_index`'s new arguments (extra, chunk_docs, generation,
parent_generation, tracer, pq_nsub) against the JAX writer's files,
manifest and span names.

Tolerances: lloyd_refine, the cluster table, the postings and every
written file bitwise; centroids at rtol 1e-5 (the port's distances and
sums run through torch in another order than XLA), with equal
assignments on this data (no near-tie); the neighbor graph's ids at
ranks more than 1e-5 from both neighbours' sims, sims at rtol 1e-5, atol
1e-6. A PQ trained inside the writer is drawn from a torch generator
(JAX draws from jax.random.key(0)), so only its shapes and the manifest
around it are compared. At most 13 tests, as test_torch_serving_v1.py
says.
"""

import dataclasses
import json
import os

import _torch_parity as tp  # first: it caps torch at 2 threads
import jax
import numpy as np
import pytest
import torch
from test_index import CappedReads, _tiny_cfg

from repro import index as jindex
from repro.core import kmeans as jkm
from repro.data import synth_corpus
from repro.obs import Tracer as JTracer
from repro_torch.core import kmeans as tkm
from repro_torch.core import quant
from repro_torch.index import (IndexReader, RowSlice, build_index_offline,
                               embedding_shards, write_index)
from repro_torch.obs import Tracer

SHARD = 128


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    corpus = synth_corpus(11, cfg.n_docs, cfg.dim, cfg.vocab)
    return cfg, corpus


def jax_init(key, D, n):
    """The init rows JAX's kmeans_shards draws from `key`."""
    return np.sort(np.asarray(jax.random.choice(key, D, (n,), replace=False)))


@pytest.mark.parametrize("seed", [0, 1])
def test_lloyd_refine_is_bitwise(seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((300, 12)).astype(np.float32)
    C0 = X[rng.choice(300, 9, replace=False)] + 0.1
    C0[4] += 50.0                                    # one cluster goes empty
    jc, ja = jkm.lloyd_refine(X, C0, iters=4)
    tc, ta = tkm.lloyd_refine(X, C0, iters=4)
    assert tc.tobytes() == jc.tobytes() and ta.tobytes() == ja.tobytes()
    np.testing.assert_array_equal(tc[4], C0[4])


def test_kmeans_shards_with_jax_init_matches(tiny):
    cfg, corpus = tiny
    emb = np.asarray(corpus.embeddings)
    shards = embedding_shards(emb, SHARD)
    key = jax.random.key(4)
    jc, ja = jkm.kmeans_shards(key, [np.asarray(s) for s in shards],
                               cfg.n_clusters, iters=5)
    tc, ta = tkm.kmeans_shards(shards, cfg.n_clusters, 5,
                               init_idx=jax_init(key, cfg.n_docs,
                                                 cfg.n_clusters),
                               device="cpu")
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-7)
    assert tc.dtype == torch.float32 and ta.dtype == torch.int64
    # no init: N distinct rows from the generator, the same on every run
    a = tkm.kmeans_shards(shards, 8, 2, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    b = tkm.kmeans_shards(shards, 8, 2, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _same_index(t, j):
    np.testing.assert_array_equal(t.cluster_docs.numpy(),
                                  np.asarray(j.cluster_docs))
    np.testing.assert_array_equal(t.doc_cluster.numpy(),
                                  np.asarray(j.doc_cluster))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=1e-5, atol=1e-7)
    js = np.asarray(j.neighbor_sims)
    np.testing.assert_allclose(t.neighbor_sims.numpy(), js, rtol=1e-5,
                               atol=1e-6)
    ok = tp.isolated_ranks(js)
    np.testing.assert_array_equal(t.neighbor_ids.numpy()[ok],
                                  np.asarray(j.neighbor_ids)[ok])
    for name in ("postings_docs", "postings_weights"):
        np.testing.assert_array_equal(
            getattr(t.sparse_index, name).numpy(),
            np.asarray(getattr(j.sparse_index, name)))
    np.testing.assert_array_equal(t.bin_ids.numpy(), np.asarray(j.bin_ids))
    assert t.embeddings is None and t.n_docs == j.n_docs


def test_build_index_offline_matches_jax(tiny):
    cfg, corpus = tiny
    emb = np.asarray(corpus.embeddings)
    key = jax.random.key(1)
    j = jindex.build_index_offline(cfg, key, emb, corpus.doc_terms,
                                   corpus.doc_weights, shard_docs=SHARD,
                                   kmeans_iters=3)
    t = build_index_offline(tp.torch_cfg(cfg), emb, corpus.doc_terms,
                            corpus.doc_weights, shard_docs=SHARD,
                            kmeans_iters=3,
                            init_idx=jax_init(key, cfg.n_docs,
                                              cfg.n_clusters),
                            device="cpu")
    _same_index(t, j)


def test_row_slices_and_chunk_capped_reads(tiny, tmp_path):
    """build_index_offline and write_index (v1 and v2) over a source that
    fails on any read of more than the chunk, or on materializing the
    matrix, give what the unrestricted build and writes give."""
    cfg, corpus = tiny
    emb = np.asarray(corpus.embeddings)
    rs = RowSlice(emb, 100, 250)
    assert rs.shape == (150, cfg.dim) and len(rs) == 150
    np.testing.assert_array_equal(rs[2:7], emb[102:107])
    np.testing.assert_array_equal(rs[[0, 149]], emb[[100, 249]])
    np.testing.assert_array_equal(np.asarray(rs, np.float64), emb[100:250])
    assert [s.shape[0] for s in embedding_shards(emb, 200)] == [200, 200, 112]
    tcfg, chunk = tp.torch_cfg(cfg), 64
    kw = dict(shard_docs=chunk, kmeans_iters=3, device="cpu",
              init_idx=np.arange(0, cfg.n_docs, cfg.n_docs // cfg.n_clusters))
    capped = CappedReads(emb, chunk)
    index = build_index_offline(tcfg, capped, corpus.doc_terms,
                                corpus.doc_weights, **kw)
    ref = build_index_offline(tcfg, emb, corpus.doc_terms,
                              corpus.doc_weights, **kw)
    assert torch.equal(index.cluster_docs, ref.cluster_docs)
    assert torch.equal(index.centroids, ref.centroids)
    assert 0 < capped.peak <= chunk
    pq = quant.train_pq(emb, 4, iters=2, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for fv in (1, 2):
        a, b = str(tmp_path / f"capped{fv}"), str(tmp_path / f"ref{fv}")
        write_index(a, tcfg, index, capped, chunk_docs=chunk,
                    format_version=fv, pq=pq)
        write_index(b, tcfg, ref, emb, format_version=fv, pq=pq)
        for s in json.load(open(os.path.join(a, "manifest.json")))[
                "block_shards"]:
            with open(os.path.join(a, s["file"]), "rb") as f, \
                    open(os.path.join(b, s["file"]), "rb") as g:
                assert f.read() == g.read()
    # int8's global scale is read in chunks, too
    write_index(str(tmp_path / "i8"), tcfg, index, capped, chunk_docs=chunk,
                block_dtype="int8")
    assert capped.peak <= chunk


def test_train_pq_stream_matches_train_pq_on_its_sample(tiny):
    cfg, corpus = tiny
    emb = np.asarray(corpus.embeddings)
    capped = CappedReads(emb, 100)
    idx = np.random.default_rng(2).choice(cfg.n_docs, 300, replace=False)
    s = quant.train_pq_stream(capped, 4, iters=3, sample_idx=idx,
                              chunk_docs=100, device="cpu",
                              generator=torch.Generator().manual_seed(5))
    p = quant.train_pq(emb[np.sort(idx)], 4, iters=3, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    assert torch.equal(s.codebooks, p.codebooks) and s.rotation is None
    assert torch.equal(s.codes, quant.pq_encode(p.codebooks, emb))
    assert s.codes.shape == (cfg.n_docs, 4) and capped.peak <= 100
    # drawn sample: the generator decides it, the same on every run
    a = quant.train_pq_stream(emb, 4, iters=2, sample_docs=200,
                              device="cpu",
                              generator=torch.Generator().manual_seed(1))
    b = quant.train_pq_stream(emb, 4, iters=2, sample_docs=200,
                              device="cpu",
                              generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.codebooks, b.codebooks)
    assert torch.equal(a.codes, b.codes)


def _spans(tracer):
    return [(tr.name, [(sp.name, sp.depth, sorted(sp.annot))
                       for sp in tr.spans]) for tr in tracer.traces]


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m["stats"].pop("pack_wall_s")
    for rel in [r for r in m["files"] if r.endswith(".npz")]:
        m["files"][rel].pop("sha256")
    m.pop("total_bytes")
    return m


def test_write_index_new_arguments_match_jax(tiny, tmp_path):
    """extra, chunk_docs, generation, parent_generation and tracer, set on
    a v1 write: every file and the manifest equal the JAX writer's; the
    spans are JAX's."""
    cfg, corpus = tiny
    emb = np.asarray(corpus.embeddings)
    key = jax.random.key(1)
    j = jindex.build_index_offline(cfg, key, emb, corpus.doc_terms,
                                   corpus.doc_weights, shard_docs=SHARD,
                                   kmeans_iters=2)
    t = tp.index_arrays(j)
    from repro_torch.convert import index_from_numpy
    t = index_from_numpy(t, device="cpu")
    kw = dict(n_shards=3, extra={"corpus": {"kind": "synthetic", "seed": 11}},
              chunk_docs=100, generation=3, parent_generation=2)
    jt, tt = JTracer(sample_rate=1.0), Tracer(sample_rate=1.0)
    jindex.write_index(str(tmp_path / "j"), cfg, j, emb, tracer=jt, **kw)
    man = write_index(str(tmp_path / "t"), tp.torch_cfg(cfg), t, emb,
                      tracer=tt, **kw)
    assert man["generation"] == 3 and man["parent_generation"] == 2
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")
    for rel in _manifest(tmp_path / "t")["files"]:
        with open(tmp_path / "t" / rel, "rb") as f, \
                open(tmp_path / "j" / rel, "rb") as g:
            assert f.read() == g.read(), rel
    assert _spans(tt) == _spans(jt)
    assert tt.traces[0].spans[0].annot["total_bytes"] == \
        jt.traces[0].spans[0].annot["total_bytes"]


def test_write_index_trains_a_pq_when_v2_has_none(tiny, tmp_path):
    cfg, corpus = tiny
    emb = np.asarray(corpus.embeddings)
    key = jax.random.key(1)
    j = jindex.build_index_offline(cfg, key, emb, corpus.doc_terms,
                                   corpus.doc_weights, shard_docs=SHARD,
                                   kmeans_iters=2)
    from repro_torch.convert import index_from_numpy
    t = index_from_numpy(tp.index_arrays(j), device="cpu")
    kw = dict(format_version=2, pq_nsub=4, chunk_docs=128)
    jt, tt = JTracer(sample_rate=1.0), Tracer(sample_rate=1.0)
    jindex.write_index(str(tmp_path / "j"), cfg, j, emb, tracer=jt, **kw)
    write_index(str(tmp_path / "t"), tp.torch_cfg(cfg), t, emb, tracer=tt,
                **kw)
    jm, tm = _manifest(tmp_path / "j"), _manifest(tmp_path / "t")
    trained = [r for r in tm["files"] if r.startswith(("pq", "blocks"))]
    for m in (jm, tm):
        for rel in trained:
            m["files"][rel].pop("sha256")
    assert tm == jm and tm["geometry"]["nsub"] == 4
    assert _spans(tt) == _spans(jt)
    # the writer's PQ is train_pq_stream's with a generator seeded 0
    pq = quant.train_pq_stream(emb, 4, chunk_docs=128, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    r = IndexReader.open(str(tmp_path / "t"), verify="full")
    np.testing.assert_array_equal(r.quantizer(device="cpu").codes.numpy(),
                                  pq.codes.numpy())


def test_span_names_match_jax(tiny, tmp_path):
    """build_index_offline, write_index_delta and compact_index record
    the JAX package's traces: names, nesting and annotation keys."""
    cfg, corpus = tiny
    emb = np.asarray(corpus.embeddings)
    key = jax.random.key(2)
    jt, tt = JTracer(sample_rate=1.0), Tracer(sample_rate=1.0)
    j = jindex.build_index_offline(cfg, key, emb, corpus.doc_terms,
                                   corpus.doc_weights, shard_docs=SHARD,
                                   kmeans_iters=2, tracer=jt)
    build_index_offline(tp.torch_cfg(cfg), emb, corpus.doc_terms,
                        corpus.doc_weights, shard_docs=SHARD, kmeans_iters=2,
                        init_idx=jax_init(key, cfg.n_docs, cfg.n_clusters),
                        device="cpu", tracer=tt)
    assert _spans(tt) == _spans(jt)
    from repro_torch.index import update as tupdate
    src = str(tmp_path / "src")
    jindex.write_index(src, cfg, j, emb, n_shards=2)
    import shutil
    jd = str(shutil.copytree(src, tmp_path / "j"))
    td = str(shutil.copytree(src, tmp_path / "t"))
    delta = tp.jax_delta(j, cfg.dim, cfg.vocab, seed=1)
    jt, tt = JTracer(sample_rate=1.0), Tracer(sample_rate=1.0)
    jindex.write_index_delta(jd, delta, tracer=jt)
    jindex.compact_index(jd, tracer=jt)
    tupdate.write_index_delta(td, tupdate.IndexDelta(
        delta.upsert_ids, delta.upsert_embeddings, delta.upsert_terms,
        delta.upsert_weights, delta.delete_ids), tracer=tt, device="cpu")
    tupdate.compact_index(td, tracer=tt, device="cpu")
    assert [tr.name for tr in tt.traces] == [
        "write_index_delta", "write_index", "compact_index"]
    assert _spans(tt) == _spans(jt)
    for a, b in zip(tt.traces, jt.traces):
        assert {k: v for k, v in a.spans[0].annot.items()} == \
            dict(b.spans[0].annot)
    assert tt.span_totals().keys() == jt.span_totals().keys()
