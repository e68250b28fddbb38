"""The port serves the BENCH_serve state as the JAX engine does, on the
CPU.

The JAX package builds the state of `benchmarks/serve_engine.py` once
per module: 20000 synthetic docs at `benchmarks.common.bench_cfg()`
widths (dim 48, 256 clusters, cap 128), the selector trained through
`core/train_lstm` (512 training queries, 25 epochs), the PQ of
`train_pq(key 3, nsub 12, rotate=True)`, and 256 test queries from seed
9. The JAX engine serves them in the bench's 32/24/12 request cycle
(buckets of up to 32) through six backends, and the port's engine on the
CPU through the same six:

  memory    RetrievalEngine(cfg, index): the device InMemoryStore
  disk      a DiskStore over a DiskClusterStore file, cache_capacity
            n_clusters (the bench's "on-disk (engine)" row)
  v2        the v2 pq-sharded directory through reader.engine()
  bf16      the v1 bfloat16 directory through reader.engine()
  int8      the v1 int8 directory through reader.engine()
  v1_pq     a v1 float32 directory written with the PQ, served through
            RetrievalEngine(*reader.load_index()): the device PQStore

Prefetch is off throughout, so the I/O counters are not racy (ids do
not depend on it). Tolerances: ids equal at every rank more than 1e-5
from both neighbours' scores (`isolated_ranks`), scores allclose at
rtol 1e-5, atol 1e-6; MRR@10 equal; the DiskStore engine's `io.n_ops`
and `io.bytes` equal. The JAX MRR@10 values are printed beside
BENCH_serve.json's (0.6874, 0.6841), which another JAX build recorded;
they are not asserted.
"""

import dataclasses
import os

import _torch_parity as tp  # first: it caps torch at 2 threads
import jax
import numpy as np
import pytest
import torch

from benchmarks import common as bench
from repro import index as jindex
from repro.core import clusd as jcl
from repro.core import disk as jdisk
from repro.core import quant as jquant
from repro.core import train_lstm as jtrain
from repro.data import mrr_at as jax_mrr_at
from repro.data import synth_corpus, synth_queries
from repro.engine import DiskStore as JaxDiskStore
from repro.engine import RetrievalEngine as JaxEngine
from repro_torch.convert import index_from_numpy
from repro_torch.core import disk as tdisk
from repro_torch.data import mrr_at
from repro_torch.engine import DiskStore, InMemoryStore, PQStore
from repro_torch.engine import RetrievalEngine
from repro_torch.index import IndexReader, ShardedDiskStore, ShardedPQStore

N_DOCS, N_QUERIES, MAX_BATCH = 20_000, 256, 32
BATCH_CYCLE = (32, 24, 12)
BACKENDS = ("memory", "disk", "v2", "bf16", "int8", "v1_pq")
STORES = {"memory": InMemoryStore, "disk": DiskStore, "v2": ShardedPQStore,
          "bf16": ShardedDiskStore, "int8": ShardedDiskStore,
          "v1_pq": PQStore}


def serve(engine, qs):
    """The bench's request cycle: (ids, scores) of all queries as numpy."""
    ids, scores, i, n = [], [], 0, 0
    while i < N_QUERIES:
        b = min(BATCH_CYCLE[n % len(BATCH_CYCLE)], N_QUERIES - i)
        out = engine.retrieve(qs.q_dense[i:i + b], qs.q_terms[i:i + b],
                              qs.q_weights[i:i + b])
        ids.append(np.asarray(out[0]))
        scores.append(np.asarray(out[1]))
        i, n = i + b, n + 1
    return np.concatenate(ids), np.concatenate(scores)


def _engine(name, st, port):
    """The port's engine on the CPU (`port`) or the JAX engine of one
    backend, unserved."""
    cfg, index, dirs = st["cfg"], st["index"], st["dirs"]
    kw = dict(max_batch=MAX_BATCH, prefetch=False)
    if port:
        kw["device"] = "cpu"
    if name in ("disk", "v2", "bf16", "int8"):
        kw["cache_capacity"] = cfg.n_clusters
    if name == "memory":
        return RetrievalEngine(st["t_cfg"], st["t_index_emb"], **kw) if port \
            else JaxEngine(cfg, index, **kw)
    if name == "disk":
        cd = np.asarray(index.cluster_docs)
        if port:
            return RetrievalEngine(st["t_cfg"], st["t_index"],
                                   store=DiskStore(st["tblocks"], cd), **kw)
        return JaxEngine(cfg, index, store=JaxDiskStore(st["jblocks"], cd),
                         **kw)
    reader = (IndexReader if port else jindex.IndexReader).open(
        dirs[name], verify="size")
    if name == "v1_pq":
        loaded = reader.load_index(device="cpu") if port \
            else reader.load_index()
        return (RetrievalEngine if port else JaxEngine)(*loaded, **kw)
    return reader.engine(**kw)


@pytest.fixture(scope="module")
def st(tmp_path_factory):
    """The BENCH_serve state, its files, and the JAX engine's results and
    stats() for every backend."""
    cfg = dataclasses.replace(bench.bench_cfg(), n_docs=N_DOCS,
                              train_queries=512, epochs=25)
    corpus = synth_corpus(0, cfg.n_docs, cfg.dim, cfg.vocab, topic_noise=0.5)
    index = jcl.build_index(cfg, jax.random.key(0), corpus.embeddings,
                            corpus.doc_terms, corpus.doc_weights)
    tq = synth_queries(1, corpus, cfg.train_queries)
    _, feats, labels = jtrain.make_labels(cfg, index, tq.q_dense, tq.q_terms,
                                          tq.q_weights)
    index.lstm_params, _ = jtrain.train_selector(
        cfg, jax.random.key(2), np.asarray(feats), np.asarray(labels))
    qs = synth_queries(9, corpus, N_QUERIES, dense_noise=0.30,
                       term_noise_frac=0.4)
    emb = np.asarray(corpus.embeddings)
    root = tmp_path_factory.mktemp("bench_serve")
    out = {"cfg": cfg, "index": index, "qs": qs, "t_cfg": tp.torch_cfg(cfg)}
    out["jblocks"] = jdisk.DiskClusterStore(str(root / "jax_blocks.bin"), emb,
                                            index.cluster_docs)
    out["tblocks"] = tdisk.DiskClusterStore.pack(
        str(root / "torch_blocks.bin"), emb, np.asarray(index.cluster_docs))
    pq = jquant.train_pq(jax.random.key(3), corpus.embeddings, 12,
                         rotate=True)
    dirs = {k: str(root / k) for k in ("v2", "bf16", "int8", "v1_pq")}
    index.quantizer = pq
    jindex.write_index(dirs["v2"], cfg, index, emb, n_shards=8,
                       format_version=jindex.FORMAT_VERSION_PQ)
    jindex.write_index(dirs["v1_pq"], cfg, index, emb, n_shards=8)
    index.quantizer = None
    for name, dt in (("bf16", "bfloat16"), ("int8", "int8")):
        jindex.write_index(dirs[name], cfg, index, emb, n_shards=8,
                           block_dtype=dt)
    arrays = tp.index_arrays(index)
    out.update(dirs=dirs,
               t_index=index_from_numpy(arrays, device="cpu"),
               t_index_emb=index_from_numpy({**arrays, "embeddings": emb},
                                            device="cpu"))
    out["jax"] = {}
    for name in BACKENDS:
        with _engine(name, out, port=False) as jeng:
            ids, scores = serve(jeng, qs)
        out["jax"][name] = (ids, scores, jeng.stats())
    return out


@pytest.mark.parametrize("name", BACKENDS)
def test_backend_serves_as_the_jax_engine(st, name):
    jids, jsc, jstats = st["jax"][name]
    teng = _engine(name, st, port=True)
    assert isinstance(teng.store, STORES[name])
    with teng, torch.no_grad():
        tids, tsc = serve(teng, st["qs"])
    ts = teng.stats()
    tp.assert_same_results((tids, tsc), (jids, jsc))
    rel = st["qs"].rel_doc
    assert mrr_at(tids, rel) == jax_mrr_at(jids, rel)
    print(f"{name}: MRR@10 port {mrr_at(tids, rel):.4f} JAX "
          f"{jax_mrr_at(jids, rel):.4f}")
    for key in ("n_queries", "n_batches", "n_compile_batches",
                "compiled_buckets"):
        assert ts[key] == jstats[key], key
    assert ("io" in ts) == ("io" in jstats) == (name not in ("memory",
                                                             "v1_pq"))
    if "io" in ts:
        assert ts["io"]["n_ops"] == jstats["io"]["n_ops"] > 0
        assert ts["io"]["bytes"] == jstats["io"]["bytes"]
        for k in ("hits", "misses", "evictions"):
            assert ts["cache"][k] == jstats["cache"][k], k


def test_jax_mrr_beside_the_bench_record(st):
    """The JAX engine's MRR@10 on this build, beside BENCH_serve.json's
    recorded rows (printed, not asserted: another JAX build recorded
    them). The float32 DiskStore serves the in-memory ids, and the v1
    directory's PQStore the v2 directory's (one PQ, ADC on both)."""
    import json
    rel = st["qs"].rel_doc
    mrr = {k: jax_mrr_at(v[0], rel) for k, v in st["jax"].items()}
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "BENCH_serve.json")) as f:
        recorded = {r["backend"]: r["MRR@10"]
                    for r in json.load(f)["rows"] if "MRR@10" in r}
    print(f"JAX MRR@10 here {mrr}; BENCH_serve.json {recorded}")
    assert mrr["disk"] == mrr["memory"]
    assert mrr["v1_pq"] == mrr["v2"]
