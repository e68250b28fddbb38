"""The port's selector labels against the JAX package's, on the CPU, on
tests/test_train.py's tiny index written by the JAX writer (v1 float32
and v2 PQ shards), served to both packages by their own readers.

  * Within the port (one backend): streamed labels are bitwise the
    in-RAM ones (v1 against the corpus embeddings, v2 against the matrix
    its code shards decode to), at any chunk budget, every fetch at most
    `chunk_clusters` blocks.
  * Against JAX: the stage-1 candidates and features are held as the
    serving tests hold them (candidates equal, features rtol 1e-5, atol
    1e-6); the dense ids equal at isolated ranks (a score gap above 1e-5
    to both neighbours); the labels bitwise equal in every query whose
    dense ids are all equal. The number of queries left out is printed
    and asserted small, not chosen by seed.
  * The running merge's order is np.lexsort's: -0.0 and +0.0 tie, then
    the doc id decides; padded and tombstoned slots never enter it.
  * The label cache key equals the JAX package's, so an entry written by
    the JAX CLI is a hit in the port.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (CappedFetchStore, isolated_ranks, jax_train_dirs,
                           torch_cfg)
from repro import train as jtrain
from repro.index import IndexReader as JReader
from repro_torch import train as train_lib
from repro_torch.core import clusd as tclusd
from repro_torch.index import IndexReader
from repro_torch.obs import MetricsRegistry


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    return jax_train_dirs(tmp_path_factory.mktemp("labels"))


def _open(path):
    reader = IndexReader.open(path)
    cfg, index = reader.load_index(device="cpu")
    return reader, cfg, index, reader.open_store(
        cluster_docs=index.cluster_docs)


def _jopen(path):
    reader = JReader.open(path)
    cfg, index = reader.load_index()
    return reader, cfg, index, reader.open_store(
        cluster_docs=index.cluster_docs)


def _decoded(store, n_docs, dim):
    dec = np.zeros((n_docs, dim), np.float32)
    vecs, docs, valid = store.fetch_blocks(np.arange(store.n_clusters))
    dec[np.asarray(docs)[np.asarray(valid)]] = \
        np.asarray(vecs)[np.asarray(valid)]
    return dec


def _q3(qs):
    return qs.q_dense, qs.q_terms, qs.q_weights


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_streamed_labels_are_bitwise_the_in_ram_labels(state, fmt):
    _, corpus, _, dirs, qs = state
    _, cfg, index, store = _open(dirs[fmt])
    emb = np.asarray(corpus.embeddings) if fmt == "v1" else \
        _decoded(store, cfg.n_docs, cfg.dim)
    index.embeddings = torch.from_numpy(np.array(emb))
    cand, feats, labels = train_lib.make_labels(cfg, index, *_q3(qs))
    index.embeddings = None
    ls = train_lib.make_labels_streaming(
        cfg, index, store, *_q3(qs),
        label_cfg=train_lib.LabelConfig(chunk_clusters=5 if fmt == "v1"
                                        else 7), device="cpu")
    np.testing.assert_array_equal(cand.numpy(), ls.cand)
    np.testing.assert_array_equal(feats.numpy(), ls.feats)
    np.testing.assert_array_equal(labels.numpy(), ls.labels)
    ids, _ = tclusd.full_dense_topk(torch.tensor(emb),
                                    torch.tensor(qs.q_dense), 10)
    np.testing.assert_array_equal(ids.numpy(), ls.dense_ids)
    assert ls.stats.n_fetches == -(-cfg.n_clusters // (5 if fmt == "v1"
                                                       else 7))


@pytest.mark.parametrize("chunk", [1, 4, 13, 32])
def test_streaming_topk_is_exact_and_bounded_at_any_chunk(state, chunk):
    _, corpus, _, dirs, qs = state
    _, _, _, store = _open(dirs["v1"])
    capped = CappedFetchStore(store, chunk)
    ids, scores = train_lib.streaming_full_dense_topk(
        capped, qs.q_dense, 10, chunk_clusters=chunk, device="cpu")
    ref_ids, ref_scores = tclusd.full_dense_topk(
        torch.tensor(np.asarray(corpus.embeddings)),
        torch.tensor(qs.q_dense), 10)
    np.testing.assert_array_equal(ref_ids.numpy(), ids)
    np.testing.assert_array_equal(ref_scores.numpy(), scores)
    assert 0 < capped.peak <= chunk
    # the cluster_score kernel's route (its plain version on the CPU)
    kids, _ = train_lib.streaming_full_dense_topk(
        store, qs.q_dense, 10, chunk_clusters=chunk, use_kernel=True,
        device="cpu")
    ok = isolated_ranks(ref_scores.numpy())
    np.testing.assert_array_equal(kids[ok], ids[ok])


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_labels_match_jax_at_isolated_ranks(state, fmt, capsys):
    _, _, _, dirs, qs = state
    _, cfg, index, store = _open(dirs[fmt])
    _, jcfg, jindex, jstore = _jopen(dirs[fmt])
    lc = train_lib.LabelConfig(chunk_clusters=6)
    ls = train_lib.make_labels_streaming(cfg, index, store, *_q3(qs),
                                         label_cfg=lc, device="cpu")
    jls = jtrain.make_labels_streaming(
        jcfg, jindex, jstore, *_q3(qs),
        label_cfg=jtrain.LabelConfig(chunk_clusters=6))
    np.testing.assert_array_equal(ls.cand, jls.cand)
    np.testing.assert_allclose(ls.feats, jls.feats, rtol=1e-5, atol=1e-6)
    _, jscores = jtrain.streaming_full_dense_topk(jstore, qs.q_dense, 10,
                                                  chunk_clusters=6)
    ok = isolated_ranks(jscores)
    np.testing.assert_array_equal(ls.dense_ids[ok], jls.dense_ids[ok])
    same = (ls.dense_ids == jls.dense_ids).all(axis=1)
    np.testing.assert_array_equal(ls.labels[same], jls.labels[same])
    n_out = int((~same).sum())
    print(f"{fmt}: {n_out} of {len(same)} queries left out of the label "
          f"comparison; {int((~ok[:, :-1]).sum())} ranks not isolated")
    assert n_out <= len(same) // 4


class _FakeStore:
    """Two clusters of four slots, scores set through unit queries:
    -0.0 and +0.0 dot products, exact ties across chunks, a padded slot
    and a tombstoned slot (valid False) carrying a high score."""

    is_host = True
    block_bytes = 64

    def __init__(self):
        v = np.zeros((2, 4, 2), np.float32)
        v[0, :, 0] = [0.5, -0.0, 0.0, 9.0]       # slot 3 tombstoned
        v[1, :, 0] = [0.5, 0.0, -0.0, 7.0]       # slot 3 padded
        self.vecs = v
        self.docs = np.array([[5, 4, 1, 8], [3, 2, 0, -1]], np.int32)
        self.valid = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], bool)
        self.cluster_docs = np.where(self.valid, self.docs, -1)

    def fetch_blocks(self, ids):
        ids = np.asarray(ids)
        return self.vecs[ids], self.docs[ids], self.valid[ids]


def test_merge_ties_signed_zeros_and_masks_dead_slots_as_jax():
    store = _FakeStore()
    q = np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)
    for chunk in (1, 2):
        ids, sc = train_lib.streaming_full_dense_topk(
            store, q, 6, chunk_clusters=chunk, device="cpu")
        jids, jsc = jtrain.streaming_full_dense_topk(store, q, 6,
                                                     chunk_clusters=chunk)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(sc.view(np.int32),
                                      np.asarray(jsc).view(np.int32))
    # query 0: 0.5 (docs 3, 5), then the four zeros by doc id
    np.testing.assert_array_equal(ids[0], [3, 5, 0, 1, 2, 4])
    with pytest.raises(ValueError, match="fewer than k=7 live"):
        train_lib.streaming_full_dense_topk(store, q, 7, device="cpu")


def test_label_cache_key_equals_jax_and_a_jax_entry_is_a_hit(state,
                                                            tmp_path):
    _, _, _, dirs, qs = state
    reader, cfg, index, store = _open(dirs["v1"])
    jreader, jcfg, jindex, jstore = _jopen(dirs["v1"])
    lc = train_lib.LabelConfig(chunk_clusters=5)
    fp = train_lib.query_fingerprint(*_q3(qs))
    assert fp == jtrain.query_fingerprint(*_q3(qs))
    key = train_lib.label_cache_key(reader.manifest, cfg, lc, fp)
    assert key == jtrain.label_cache_key(
        jreader.manifest, jcfg, jtrain.LabelConfig(chunk_clusters=5), fp)
    assert key != train_lib.label_cache_key(
        reader.manifest, cfg, train_lib.LabelConfig(chunk_clusters=5,
                                                    top_dense=20), fp)
    # the JAX package writes the entry, the port reads it back
    jcache = jtrain.LabelCache(str(tmp_path / "labels"))
    jls, hit = jcache.get_or_build(key, lambda: jtrain.make_labels_streaming(
        jcfg, jindex, jstore, *_q3(qs),
        label_cfg=jtrain.LabelConfig(chunk_clusters=5)))
    assert not hit
    reg = MetricsRegistry()
    ls, hit = train_lib.LabelCache(str(tmp_path / "labels")).get_or_build(
        key, lambda: pytest.fail("the JAX entry must be a hit"),
        metrics=reg)
    assert hit and reg.snapshot()["counters"]["labels.cache_hits"] == 1
    for a in ("cand", "feats", "labels", "dense_ids"):
        np.testing.assert_array_equal(getattr(ls, a), getattr(jls, a))
    # and the reverse: a port entry the JAX cache loads
    cache = train_lib.LabelCache(str(tmp_path / "port"))
    built, hit = cache.get_or_build(
        key, lambda: train_lib.make_labels_streaming(
            cfg, index, store, *_q3(qs), label_cfg=lc, metrics=reg,
            device="cpu"),
        metrics=reg)
    assert not hit
    back = jtrain.LabelCache(str(tmp_path / "port")).load(key)
    np.testing.assert_array_equal(back.dense_ids, built.dense_ids)
    snap = reg.snapshot()
    assert snap["counters"]["labels.passes"] == 1
    assert snap["counters"]["labels.blocks_read"] == cfg.n_clusters
    assert snap["counters"]["labels.cache_misses"] == 1


def test_relabel_and_stage1_for_queries_match_jax(state):
    import dataclasses
    _, _, _, dirs, qs = state
    _, cfg, index, store = _open(dirs["v1"])
    _, jcfg, jindex, _ = _jopen(dirs["v1"])
    ls = train_lib.make_labels_streaming(cfg, index, store, *_q3(qs),
                                         device="cpu")
    for depth in (0, 1):
        c = dataclasses.replace(cfg, expand_depth=depth)
        jc = dataclasses.replace(jcfg, expand_depth=depth)
        cand, feats = train_lib.stage1_for_queries(c, index, *_q3(qs))
        jcand, jfeats = jtrain.stage1_for_queries(jc, jindex, *_q3(qs))
        np.testing.assert_array_equal(cand, jcand)
        np.testing.assert_allclose(feats, jfeats, rtol=1e-5, atol=1e-6)
        rl = train_lib.relabel_for_config(c, index, *_q3(qs), ls.dense_ids)
        jrl = jtrain.relabel_for_config(jc, jindex, *_q3(qs), ls.dense_ids)
        np.testing.assert_array_equal(rl.cand, jrl.cand)
        np.testing.assert_array_equal(rl.labels, jrl.labels)
        if depth == 0:
            np.testing.assert_array_equal(rl.labels, ls.labels)
    assert torch_cfg(jcfg) == cfg
