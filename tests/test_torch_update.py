"""The port's delta writer (`repro_torch.index.update`) held to the JAX
package on the CPU: `IndexDelta`'s errors, `_update_postings`,
`apply_delta_to_index`, and `write_index_delta` over JAX-written twins
of one directory (f32, bf16, v2 from one state at clusd_msmarco.smoke()
widths, and a packed random index that re-clusters a shard).

Tolerance: none — every staged file and the manifest equal JAX's, but
for the manifest's wall times and, after a re-cluster, the neighbor
graph: the port's `centroids @ centroids.T` sums in another order than
XLA's, so `neighbor_sims` is held at rtol 1e-5, atol 1e-6,
`neighbor_ids` at ranks more than 1e-5 from both neighbours' sims, and
the two files' sha256 entries in the manifest may differ. An int8 v1
index is refused by the port; the JAX bytes it would write are pinned
beside the refusal. At most 13 tests, as test_torch_serving_v1.py says.
"""

import dataclasses
import json
import os
import shutil

import _torch_parity as tp  # first: it caps torch at 2 threads
import numpy as np
import pytest
import torch
from test_index_properties import _random_index

from repro import index as jindex
from repro.index import update as jupdate
from repro_torch import convert
from repro_torch.index import IndexReader
from repro_torch.index import format as tfmt
from repro_torch.index import update as tupdate

WALL = (("update_stats", "wall_s"), ("stats", "pack_wall_s"))


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    return tp.jax_dirs_state(tmp_path_factory)


def port_delta(d):
    """The port's IndexDelta with a JAX delta's arrays."""
    return tupdate.IndexDelta(d.upsert_ids, d.upsert_embeddings,
                              d.upsert_terms, d.upsert_weights, d.delete_ids,
                              d.format_version)


def twins(src, tmp_path):
    """(JAX copy, port copy) of the directory `src`."""
    return (str(shutil.copytree(src, tmp_path / "j")),
            str(shutil.copytree(src, tmp_path / "t")))


def manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    for sec, key in WALL:
        m.get(sec, {}).pop(key, None)
    return m


def same_bytes(a, b, rel):
    with open(os.path.join(a, rel), "rb") as f, \
            open(os.path.join(b, rel), "rb") as g:
        return f.read() == g.read()


def assert_same_generation(jdir, tdir, sims_tol=False):
    """Manifests equal but for wall times; each file new in this
    generation byte-equal, or, with `sims_tol`, the neighbor graph at the
    module's tolerance (and its sha256 entries left out)."""
    jm, tm = manifest(jdir), manifest(tdir)
    loose = ()
    if sims_tol:
        loose = (jm["arrays"]["neighbor_ids"], jm["arrays"]["neighbor_sims"])
        ji = np.load(os.path.join(jdir, loose[0]))
        ti = np.load(os.path.join(tdir, loose[0]))
        js = np.load(os.path.join(jdir, loose[1]))
        ts = np.load(os.path.join(tdir, loose[1]))
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
        ok = tp.isolated_ranks(js)
        np.testing.assert_array_equal(ti[ok], ji[ok])
        for m in (jm, tm):
            for rel in loose:
                m["files"][rel].pop("sha256")
    assert tm == jm
    g = tm["generation"]
    new = [rel for rel in tm["files"] if f".g{g}" in rel]
    assert new
    for rel in new:
        if rel not in loose:
            assert same_bytes(jdir, tdir, rel), rel


def test_index_delta_errors_match_jax():
    z = np.zeros((2, 4), np.float32)
    cases = [
        dict(upsert_ids=[1, 2], upsert_embeddings=np.zeros((3, 4)),
             upsert_terms=np.zeros((2, 2)), upsert_weights=np.zeros((2, 2)),
             delete_ids=[]),
        dict(upsert_ids=[1, 2], upsert_embeddings=z,
             upsert_terms=np.zeros((2, 2)), upsert_weights=np.zeros((2, 3)),
             delete_ids=[]),
        dict(upsert_ids=[1, 2], upsert_embeddings=z,
             upsert_terms=np.zeros((3, 2)), upsert_weights=np.zeros((3, 2)),
             delete_ids=[]),
        dict(upsert_ids=[5, 5], upsert_embeddings=z,
             upsert_terms=np.zeros((2, 2)), upsert_weights=np.zeros((2, 2)),
             delete_ids=[]),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as je:
            jindex.IndexDelta(**kw)
        with pytest.raises(ValueError) as te:
            tupdate.IndexDelta(**kw)
        assert str(te.value) == str(je.value)
    ok = tupdate.IndexDelta([3, 1], z, np.zeros((2, 2)), np.ones((2, 2)),
                            [7])
    assert (ok.n_upserts, ok.n_deletes) == (2, 1)
    assert ok.upsert_ids.dtype == np.int64 and ok.upsert_terms.dtype == \
        np.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_update_postings_is_bitwise(seed):
    rng = np.random.default_rng(seed)
    V, P, D = 40, 6, 60
    pd = np.full((V, P), -1, np.int32)
    pw = np.zeros((V, P), np.float32)
    for t in range(V):
        n = P if t < 4 else int(rng.integers(0, P + 1))   # 0-3 full
        pd[t, :n] = rng.choice(D, n, replace=False)
        pw[t, :n] = np.sort(rng.random(n).astype(np.float32))[::-1]
    pw[3, :2] = pw[3, 2] = 0.5                     # equal weights: doc desc
    drops = rng.choice(D, 8, replace=False)
    up = np.concatenate([drops[:3], [D, D + 1]])
    terms = rng.integers(-1, 8, (len(up), 5)).astype(np.int32)
    weights = rng.lognormal(0, 0.5, terms.shape).astype(np.float32)
    weights[0, 0] = 0.0
    j = jupdate._update_postings(pd, pw, drops, up, terms, weights)
    t = tupdate._update_postings(pd, pw, drops, up, terms, weights)
    for a, b in zip(t[:2], j[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert t[2] == j[2] > 0


def test_apply_delta_to_index_matches_jax(state):
    cfg, index, corpus, pq, _ = state
    delta = tp.jax_delta(index, cfg.dim, cfg.vocab, seed=5, n_del=6, n_rep=4,
                         n_app=5)
    jindex_q = dataclasses.replace(index, quantizer=pq)
    j_idx, j_emb, j_rep = jindex.apply_delta_to_index(
        cfg, jindex_q, corpus.embeddings, delta, n_shards=3)
    t_in = convert.index_from_numpy(tp.index_arrays(index), device="cpu")
    t_in.quantizer = convert.pq_from_numpy(pq.codebooks, pq.codes,
                                           pq.rotation, pq.nsub, device="cpu")
    t_idx, t_emb, t_rep = tupdate.apply_delta_to_index(
        tp.torch_cfg(cfg), t_in, corpus.embeddings, port_delta(delta),
        n_shards=3)
    assert t_rep == j_rep
    np.testing.assert_array_equal(t_emb, j_emb)
    for name in ("centroids", "cluster_docs", "doc_cluster", "neighbor_ids",
                 "neighbor_sims"):
        np.testing.assert_array_equal(getattr(t_idx, name).numpy(),
                                      np.asarray(getattr(j_idx, name)), name)
    for name in ("postings_docs", "postings_weights"):
        np.testing.assert_array_equal(
            getattr(t_idx.sparse_index, name).numpy(),
            np.asarray(getattr(j_idx.sparse_index, name)), name)
    assert t_idx.sparse_index.truncated_postings == \
        j_idx.sparse_index.truncated_postings
    np.testing.assert_array_equal(t_idx.quantizer.codes.numpy(),
                                  np.asarray(j_idx.quantizer.codes))
    assert t_idx.selector is t_in.selector and t_idx.n_docs == j_idx.n_docs


@pytest.mark.parametrize("kind", ["f32", "bf16", "v2"])
def test_write_index_delta_matches_jax(state, kind, tmp_path):
    cfg, index, *_, dirs = state
    jdir, tdir = twins(dirs[kind], tmp_path)
    for seed in (1, 2):                 # two generations: tombstones carry
        delta = tp.jax_delta(index, cfg.dim, cfg.vocab, seed=seed)
        j = jindex.write_index_delta(jdir, delta)
        t = tupdate.write_index_delta(tdir, port_delta(delta), device="cpu")
        for r in (j, t):
            r.pop("wall_s")
        assert t == j
        assert_same_generation(jdir, tdir)
    # the archive of generation 1 is the same file, too
    for g in (0, 1):
        assert tfmt.load_manifest(tdir, generation=g) == \
            jindex.load_manifest(tdir, generation=g)
        rel = os.path.join("manifests", f"manifest.g{g}.json")
        assert os.path.exists(os.path.join(jdir, rel))


def test_wrong_format_delta_is_refused(state, tmp_path):
    cfg, index, *_, dirs = state
    for kind, fv in (("f32", 2), ("v2", 1)):
        out = str(shutil.copytree(dirs[kind], tmp_path / kind))
        delta = port_delta(tp.jax_delta(index, cfg.dim, cfg.vocab, seed=1))
        delta.format_version = fv
        with pytest.raises(tfmt.IndexFormatError, match="format"):
            tupdate.write_index_delta(out, delta, device="cpu")
        reader = IndexReader.open(out, verify="full")
        assert reader.generation == 0
        assert not [n for n in os.listdir(out) if n.startswith(".stage")]


def test_delete_only_delta_rewrites_zero_bytes(state, tmp_path):
    cfg, index, *_, dirs = state
    jdir, tdir = twins(dirs["v2"], tmp_path)
    delta = tp.jax_delta(index, cfg.dim, cfg.vocab, seed=3, n_rep=0, n_app=0,
                         n_del=7)
    j = jindex.write_index_delta(jdir, delta)
    t = tupdate.write_index_delta(tdir, port_delta(delta), device="cpu")
    assert t["bytes_rewritten"] == j["bytes_rewritten"] == 0
    assert t["shards_rewritten"] == []
    assert_same_generation(jdir, tdir)
    reader = IndexReader.open(tdir, verify="full")
    assert int(reader.tombstones().sum()) == 7
    _, lindex = reader.load_index(device="cpu")
    dele = delta.delete_ids
    assert not np.isin(lindex.cluster_docs.numpy(), dele).any()
    assert not np.isin(lindex.sparse_index.postings_docs.numpy(), dele).any()
    assert (lindex.doc_cluster.numpy()[dele] == -1).all()


def test_int8_is_refused_and_the_jax_bytes_pinned(state, tmp_path):
    """The reference fault: JAX's delta packs upserted rows of an int8 v1
    index with no block_scale (every such record all zeros), and its
    compaction re-reads the int8 records as floats under a scale of 1.0.
    The port refuses both before writing a byte."""
    cfg, index, *_, dirs = state
    jdir, tdir = twins(dirs["int8"], tmp_path)
    delta = tp.jax_delta(index, cfg.dim, cfg.vocab, seed=1)
    delta.upsert_embeddings /= np.linalg.norm(delta.upsert_embeddings,
                                              axis=1, keepdims=True)
    scale = jindex.load_manifest(jdir)["geometry"]["block_scale"]
    jindex.write_index_delta(jdir, delta)
    jr = jindex.IndexReader.open(jdir)
    cd = jr.masked_cluster_docs()
    rows = []
    for d in delta.upsert_ids:
        c, slot = np.argwhere(cd == d)[0]
        s = next(s for s in jr.manifest["block_shards"]
                 if s["cluster_lo"] <= c < s["cluster_hi"])
        mm = np.memmap(os.path.join(jdir, s["file"]), np.int8, "r").reshape(
            -1, cd.shape[1], cfg.dim)
        rows.append(np.array(mm[c - s["cluster_lo"], slot]))
    assert len(rows) == 4 and not np.any(rows)  # JAX: upserts all zeros
    jindex.compact_index(jdir)
    assert jindex.load_manifest(jdir)["geometry"]["block_scale"] == 1.0 \
        != scale
    before = sorted(os.listdir(tdir))
    for call in (lambda: tupdate.write_index_delta(tdir, port_delta(delta),
                                                   device="cpu"),
                 lambda: tupdate.compact_index(tdir, device="cpu")):
        with pytest.raises(tfmt.IndexFormatError, match="block_scale"):
            call()
    assert sorted(os.listdir(tdir)) == before
    assert not os.path.exists(tdir + ".compact-g1")
    assert IndexReader.open(tdir, verify="full").generation == 0


@pytest.mark.parametrize("fv", [1, 2])
def test_reclustering_delta_matches_jax(fv, tmp_path):
    """A packed index whose upserts overflow: the target shard
    re-clusters (lloyd_refine, build_cluster_table, the neighbor graph)
    in both packages alike."""
    import jax

    from repro.core import quant as jquant

    cfg, index, emb = _random_index(17)
    cfg = dataclasses.replace(cfg, max_postings=int(
        np.asarray(index.sparse_index.postings_docs).shape[1]))
    pq = None
    if fv == 2:
        pq = jquant.train_pq(jax.random.key(3), emb, 4, iters=2)
    src = str(tmp_path / "src")
    jindex.write_index(src, cfg, index, emb, n_shards=2, format_version=fv,
                       pq=pq)
    jdir, tdir = twins(src, tmp_path)
    rng = np.random.default_rng(0)
    live = np.flatnonzero(np.asarray(index.doc_cluster) >= 0)
    n_free = int(np.asarray(index.cluster_docs).size) - len(live)
    dele = rng.choice(live, 4, replace=False)
    n_app = min(6, n_free + len(dele))
    D = len(live)
    delta = jindex.IndexDelta(
        upsert_ids=np.arange(D, D + n_app),
        upsert_embeddings=rng.standard_normal((n_app, emb.shape[1])).astype(
            np.float32),
        upsert_terms=rng.integers(0, cfg.vocab, (n_app, 4)).astype(np.int32),
        upsert_weights=rng.lognormal(0, 0.5, (n_app, 4)).astype(np.float32),
        delete_ids=dele)
    kw = dict(recluster_overflow=0.0, recluster_min_overflow=0,
              lloyd_iters=2)
    j = jindex.write_index_delta(jdir, delta, **kw)
    t = tupdate.write_index_delta(tdir, port_delta(delta), device="cpu", **kw)
    assert t["reclustered_shards"] == j["reclustered_shards"] != []
    for r in (j, t):
        r.pop("wall_s")
    assert t == j
    assert_same_generation(jdir, tdir, sims_tol=True)


def test_v1_delta_drops_the_pq_side_artifacts(state, tmp_path):
    """A v1 directory written with its quantizer (pq/) loses it in a
    delta generation, so load_index() has no quantizer, as in JAX."""
    cfg, index, corpus, pq, _ = state
    src = str(tmp_path / "src")
    jindex.write_index(src, cfg, dataclasses.replace(index, quantizer=pq),
                       np.asarray(corpus.embeddings), n_shards=3)
    jdir, tdir = twins(src, tmp_path)
    _, lindex = IndexReader.open(tdir).load_index(device="cpu")
    assert lindex.quantizer is not None
    delta = tp.jax_delta(index, cfg.dim, cfg.vocab, seed=4)
    jindex.write_index_delta(jdir, delta)
    tupdate.write_index_delta(tdir, port_delta(delta), device="cpu")
    assert_same_generation(jdir, tdir)
    assert manifest(tdir)["pq"] is None
    _, lindex = IndexReader.open(tdir).load_index(device="cpu")
    _, jl = jindex.IndexReader.open(jdir).load_index()
    assert lindex.quantizer is None and jl.quantizer is None
    assert isinstance(lindex.centroids, torch.Tensor)
