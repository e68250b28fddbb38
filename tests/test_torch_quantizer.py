"""The port's reader of an index's quantizer held to the JAX package on
the CPU: `IndexReader.quantizer()` over a v1 directory (pq/ codebooks,
codes and OPQ rotation) and over a v2 directory with one JAX delta
generation (per-doc codes rebuilt from the code shards, tombstoned
slots skipped), `load_index(load_quantizer=)` and its defaults, and the
device PQStore that `RetrievalEngine(*reader.load_index())` serves a v1
directory from.

One JAX state at clusd_msmarco.smoke() widths, made from a seed, with a
PQ of nsub 8 and an OPQ rotation (jax.random key 3); the JAX package
writes the directories. Tolerances: the quantizer's arrays are equal;
served ids are equal at every rank more than 1e-5 from both neighbours'
scores (`isolated_ranks`) and scores allclose at rtol 1e-5, atol 1e-6.
"""

import shutil

import _torch_parity as tp  # first: it caps torch at 2 threads
import jax
import numpy as np
import pytest
import torch
from _torch_parity import assert_same_results, jax_delta, queries3

from repro import index as jindex
from repro.core import quant as jquant
from repro.data import synth_queries
from repro.engine import RetrievalEngine as JaxEngine
from repro_torch.engine import PQStore, RetrievalEngine
from repro_torch.index import IndexReader


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """{"v1": float32 blocks + pq/, "v2": code shards, "v2_delta": v2 with
    one delta generation (deletes and replacements)}."""
    cfg, index, corpus = tp.jax_smoke_state(0)
    pq = jquant.train_pq(jax.random.key(3), corpus.embeddings, nsub=8,
                         iters=3, rotate=True)
    root = tmp_path_factory.mktemp("quantizer")
    emb = np.asarray(corpus.embeddings)
    dirs = {"v1": str(root / "v1"), "v2": str(root / "v2")}
    index.quantizer = pq
    jindex.write_index(dirs["v1"], cfg, index, emb, n_shards=3)
    index.quantizer = None
    # 16 shards: the delta rewrites only the shards its upserts land in,
    # so deleted and replaced docs elsewhere leave tombstoned slots
    jindex.write_index(dirs["v2"], cfg, index, emb, n_shards=16,
                       format_version=2, pq=pq)
    dirs["v2_delta"] = str(shutil.copytree(dirs["v2"], root / "v2_delta"))
    jindex.write_index_delta(dirs["v2_delta"], jax_delta(
        index, cfg.dim, cfg.vocab, seed=11, n_del=5, n_rep=6, n_app=3))
    return cfg, index, corpus, dirs, synth_queries(9, corpus, 20)


def _same_pq(t, j):
    assert t.nsub == j.nsub
    assert t.codebooks.device.type == "cpu"
    np.testing.assert_array_equal(t.codebooks.numpy(),
                                  np.asarray(j.codebooks))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    assert (t.rotation is None) == (j.rotation is None)
    if t.rotation is not None:
        np.testing.assert_array_equal(t.rotation.numpy(),
                                      np.asarray(j.rotation))


@pytest.mark.parametrize("kind", ["v1", "v2", "v2_delta"])
def test_quantizer_equals_jax(state, kind):
    path = state[3][kind]
    t, j = IndexReader.open(path), jindex.IndexReader.open(path)
    tq, jq = t.quantizer(device="cpu"), j.quantizer()
    _same_pq(tq, jq)
    assert tq.codes.dtype == torch.int32 and tq.rotation is not None
    assert tq.codes.shape == (t.geometry["n_docs"], 8)
    if kind == "v2_delta":
        # the delta left tombstoned slots (deleted and replaced docs'
        # stale copies): the per-doc view must skip them
        tomb = t.tombstones()
        assert tomb is not None and tomb.sum() == 5
        np.testing.assert_array_equal(tomb, j.tombstones())


def test_v2_codes_skip_tombstoned_slots(state):
    """Reading the code shards without the tombstones would hand a
    replaced doc its stale code; the port's per-doc view equals a
    rebuild from the live slots only."""
    path = state[3]["v2_delta"]
    reader = IndexReader.open(path)
    codes = reader.quantizer(device="cpu").codes.numpy()
    g = reader.geometry
    cd = np.asarray(reader.array("cluster_docs"))
    live = reader.masked_cluster_docs()
    blocks = np.concatenate([np.fromfile(
        f"{path}/{s['file']}", np.uint8).reshape(-1, g["cap"], g["nsub"])
        for s in reader.manifest["block_shards"]])
    want = np.zeros_like(codes)
    want[live[live >= 0]] = blocks[live >= 0]
    np.testing.assert_array_equal(codes, want)
    stale = np.zeros_like(codes)
    stale[cd[cd >= 0]] = blocks[cd >= 0]
    assert (stale != codes).any(axis=1).sum() == 3


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_load_index_defaults_and_overrides(state, kind):
    path = state[3][kind]
    t, j = IndexReader.open(path), jindex.IndexReader.open(path)
    for flag in (None, True, False):
        kw = {} if flag is None else {"load_quantizer": flag}
        _, ti = t.load_index(device="cpu", **kw)
        _, ji = j.load_index(**kw)
        assert (ti.quantizer is None) == (ji.quantizer is None)
        want = flag if flag is not None else kind == "v1"
        assert (ti.quantizer is not None) == want
        if ti.quantizer is not None:
            _same_pq(ti.quantizer, ji.quantizer)
        assert ti.embeddings is None


@pytest.mark.parametrize("kind", ["v1", "v2_delta"])
def test_engine_over_load_index_matches_jax(state, kind):
    """`RetrievalEngine(*reader.load_index())` serves from the device
    PQStore of the directory's quantizer (v1 by default; the v2 delta
    directory with load_quantizer=True), as the JAX engine does."""
    path, qs = state[3][kind], state[4]
    kw = {} if kind == "v1" else {"load_quantizer": True}
    jeng = JaxEngine(*jindex.IndexReader.open(path).load_index(**kw),
                     max_batch=8)
    teng = RetrievalEngine(*IndexReader.open(path).load_index(device="cpu",
                                                              **kw),
                           max_batch=8, device="cpu")
    assert isinstance(teng.store, PQStore) and not teng.is_host
    assert type(jeng.store).__name__ == "PQStore"
    j = [np.asarray(x) for x in jeng.retrieve(*queries3(qs))]
    with teng:
        t = [x.numpy() for x in teng.retrieve(*queries3(qs))]
    assert_same_results(t, j)
    st = teng.stats()
    assert "io" not in st and st["n_queries"] == 20
