"""The port's compaction and generations held to the JAX package on the
CPU: a sequence of port deltas followed by `compact_index` gives the
files of `write_index(apply_delta_to_index(...))` (three fixed seeds of
a random index, v1 and v2); JAX's `compact_index` of the port's
generations equals the port's; each package's reader opens the other's
generations; the manifest archive and `IndexReader.refresh()`; and an
engine's `reload_index()` across a port commit serves as a fresh
engine does.

Tolerance: none (files byte-equal, ids and scores bitwise against a
fresh port engine); manifests are compared without their wall times and
without the sha256 of `.npz` checkpoint members, whose zip headers carry
their write time. At most 13 tests, as test_torch_serving_v1.py says.
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
from repro_torch import convert
from repro_torch.core import quant
from repro_torch.index import IndexReader, write_index
from repro_torch.index import format as tfmt
from repro_torch.index import update as tupdate


def _random_delta(rng, doc_cluster, n_slots, dim, vocab, dmax=3):
    """A feasible random port delta against the current state: up to
    `dmax` each of deletes, replacements and appends (appends bounded by
    free capacity)."""
    doc_cluster = np.asarray(doc_cluster)
    D = len(doc_cluster)
    live = np.flatnonzero(doc_cluster >= 0)
    n_del = int(rng.integers(0, min(dmax, len(live)) + 1))
    dele = rng.choice(live, n_del, replace=False) if n_del else \
        np.zeros(0, np.int64)
    rest = np.setdiff1d(live, dele)
    n_rep = int(rng.integers(0, min(dmax, len(rest)) + 1))
    reps = rng.choice(rest, n_rep, replace=False) if n_rep else \
        np.zeros(0, np.int64)
    free = n_slots - (len(live) - n_del - n_rep)
    n_app = int(rng.integers(0, max(0, min(dmax, free - n_rep)) + 1))
    ids = np.concatenate([reps, np.arange(D, D + n_app)]).astype(np.int64)
    U, T = len(ids), 4
    terms = rng.integers(0, vocab, (U, T)).astype(np.int32)
    terms[rng.random((U, T)) < 0.25] = -1
    return tupdate.IndexDelta(
        upsert_ids=ids,
        upsert_embeddings=rng.standard_normal((U, dim)).astype(np.float32),
        upsert_terms=terms,
        upsert_weights=rng.lognormal(0.0, 0.5, (U, T)).astype(np.float32),
        delete_ids=dele)


def _port_random_index(seed):
    """A JAX random index (test_index_properties) carried to the port."""
    cfg, index, emb = _random_index(seed)
    cfg = dataclasses.replace(cfg, max_postings=int(
        np.asarray(index.sparse_index.postings_docs).shape[1]))
    return tp.torch_cfg(cfg), convert.index_from_numpy(
        tp.index_arrays(index), device="cpu"), emb


def _files(root):
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, n), root)
                for n in names]
    return sorted(out)


def _man(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m.get("stats", {}).pop("pack_wall_s", None)
    m.get("update_stats", {}).pop("wall_s", None)
    for rel in [r for r in m["files"] if r.endswith(".npz")]:
        m["files"][rel].pop("sha256")
    m.pop("total_bytes")
    return m


def _assert_same_index_files(a, b, arrays_only=False):
    """Every array and block shard of two index directories byte-equal
    (`arrays_only`: compared by logical name, as the JAX property test
    does); else every file but .npz members and manifest.json, and the
    manifests."""
    ma, mb = _man(a), _man(b)
    if arrays_only:
        assert set(ma["arrays"]) == set(mb["arrays"])
        pairs = [(ma["arrays"][k], mb["arrays"][k]) for k in ma["arrays"]]
        pairs += [(x["file"], y["file"]) for x, y in
                  zip(ma["block_shards"], mb["block_shards"])]
    else:
        assert ma == mb
        assert _files(a) == _files(b)
        pairs = [(r, r) for r in _files(a)
                 if r != "manifest.json" and not r.endswith(".npz")]
    for ra, rb in pairs:
        with open(os.path.join(a, ra), "rb") as f, \
                open(os.path.join(b, rb), "rb") as g:
            assert f.read() == g.read(), (ra, rb)


def _policy_vectors(index, delta):
    """What a re-cluster on disk sees: for v2 the PQ-decoded vectors of
    the stored docs and the delta's own rows (v1: None, the floats)."""
    q = index.quantizer
    if q is None:
        return None
    pv = quant.decode_code_blocks(q.codebooks.numpy(), q.codes.numpy(), None)
    n_new = int((delta.upsert_ids >= len(pv)).sum())
    pv = np.concatenate([pv, np.zeros((n_new, pv.shape[1]), np.float32)])
    pv[delta.upsert_ids] = delta.upsert_embeddings
    return pv


def _run_delta_sequence(root, seed, fv, n_deltas=2):
    """Random index -> port write -> port delta sequence -> port compact;
    against the same deltas applied in memory -> port write_index.
    Returns (live dir, its pre-compaction copy, n_shards)."""
    cfg, index, emb = _port_random_index(seed)
    n_shards = 1 + seed % 3
    if fv == 2:
        nsub = 4 if emb.shape[1] % 4 == 0 else 8
        index.quantizer = quant.train_pq(
            emb, nsub, iters=2, generator=torch.Generator().manual_seed(seed),
            device="cpu")
    out = str(root / "live")
    write_index(out, cfg, index, emb, n_shards=n_shards, format_version=fv)
    rng = np.random.default_rng(seed + 1)
    ref_index, ref_emb, ref_cfg = index, emb, cfg
    for _ in range(n_deltas):
        delta = _random_delta(rng, ref_index.doc_cluster.numpy(),
                              int(ref_index.cluster_docs.numel()),
                              emb.shape[1], cfg.vocab)
        report = tupdate.write_index_delta(out, delta, device="cpu")
        assert report["bytes_rewritten"] <= report["shard_bytes_total"]
        if delta.n_upserts == 0:
            assert report["bytes_rewritten"] == 0
        ref_index, ref_emb, _ = tupdate.apply_delta_to_index(
            ref_cfg, ref_index, ref_emb, delta, n_shards=n_shards,
            policy_vectors=_policy_vectors(ref_index, delta))
        ref_cfg = dataclasses.replace(ref_cfg, n_docs=ref_index.n_docs)
    before = str(shutil.copytree(out, root / "before"))
    tupdate.compact_index(out, device="cpu")
    ref_out = str(root / "ref")
    write_index(ref_out, ref_cfg, ref_index, ref_emb, n_shards=n_shards,
                format_version=fv)
    _assert_same_index_files(out, ref_out, arrays_only=True)
    IndexReader.open(out, verify="full")
    return out, before, n_shards


@pytest.mark.parametrize("fv", [1, 2])
@pytest.mark.parametrize("seed", [2, 7, 13])
def test_delta_sequence_then_compaction_equals_rebuild(tmp_path, seed, fv):
    _run_delta_sequence(tmp_path, seed, fv)


@pytest.mark.parametrize("fv", [1, 2])
def test_jax_compaction_of_port_generations_equals_ports(tmp_path, fv):
    out, before, _ = _run_delta_sequence(tmp_path, 11, fv)
    jdir = str(shutil.copytree(before, tmp_path / "jax_compacted"))
    jindex.compact_index(jdir)
    _assert_same_index_files(out, jdir)


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    return tp.jax_dirs_state(tmp_path_factory)


def _port_delta(d):
    return tupdate.IndexDelta(d.upsert_ids, d.upsert_embeddings,
                              d.upsert_terms, d.upsert_weights, d.delete_ids)


def test_each_reader_opens_the_others_generations(state, tmp_path):
    cfg, index, *_, dirs = state
    t_dir = str(shutil.copytree(dirs["v2"], tmp_path / "t"))
    j_dir = str(shutil.copytree(dirs["v2"], tmp_path / "j"))
    for seed in (1, 2):
        delta = tp.jax_delta(index, cfg.dim, cfg.vocab, seed=seed)
        tupdate.write_index_delta(t_dir, _port_delta(delta), device="cpu")
        jindex.write_index_delta(j_dir, delta)
    for path in (t_dir, j_dir):
        for g in (0, 1, 2):
            jm = jindex.load_manifest(path, generation=g)
            tm = tfmt.load_manifest(path, generation=g)
            assert jm == tm and tm["generation"] == g
            jindex.verify_files(path, jm, level="full")
            tfmt.verify_files(path, tm, level="full")
        jr = jindex.IndexReader.open(path, verify="full")
        tr = IndexReader.open(path, verify="full")
        assert jr.generation == tr.generation == 2
        np.testing.assert_array_equal(jr.masked_cluster_docs(),
                                      tr.masked_cluster_docs())
        np.testing.assert_array_equal(np.asarray(jr.quantizer().codes),
                                      tr.quantizer(device="cpu").codes.numpy())


def test_generation_archive_and_refresh(state, tmp_path):
    cfg, index, *_, dirs = state
    out = str(shutil.copytree(dirs["f32"], tmp_path / "idx"))
    reader = IndexReader.open(out)
    assert reader.generation == 0 and reader.refresh() is False
    for seed in (1, 2):
        rep = tupdate.write_index_delta(
            out, _port_delta(tp.jax_delta(index, cfg.dim, cfg.vocab,
                                          seed=seed)), device="cpu")
        assert rep["generation"] == seed and rep["parent_generation"] == \
            seed - 1
    assert reader.generation == 0
    assert reader.refresh() is True and reader.generation == 2
    assert reader.refresh() is False
    assert sorted(os.listdir(os.path.join(out, "manifests"))) == [
        "manifest.g0.json", "manifest.g1.json"]
    for g in (0, 1):
        man = tfmt.load_manifest(out, generation=g)
        assert tfmt.manifest_generation(man) == g
        tfmt.verify_files(out, man, level="full")
    with pytest.raises(tfmt.IndexFormatError, match="generation"):
        tfmt.load_manifest(out, generation=7)
    man = tupdate.compact_index(out, device="cpu")
    assert man["generation"] == 3 and man["parent_generation"] == 2
    assert not os.path.exists(os.path.join(out, "manifests"))
    assert not [n for n in os.listdir(out) if ".compact-g" in n]
    IndexReader.open(out, verify="full")
    jindex.IndexReader.open(out, verify="full")


def test_reload_index_across_a_port_commit_equals_a_fresh_engine(state,
                                                                 tmp_path):
    from repro.data import synth_queries

    cfg, index, corpus, _, dirs = state
    out = str(shutil.copytree(dirs["f32"], tmp_path / "live"))
    qs = synth_queries(9, corpus, tp.SERVE_BATCH)
    delta = tp.jax_delta(index, cfg.dim, cfg.vocab, seed=6, n_del=8)
    with IndexReader.open(out).engine(max_batch=tp.SERVE_BATCH,
                                      prefetch=False, device="cpu") as eng:
        before = tp.retrieve_np(eng, qs)
        tupdate.write_index_delta(out, _port_delta(delta), device="cpu")
        np.testing.assert_array_equal(tp.retrieve_np(eng, qs)[0], before[0])
        assert eng.reload_index() == 1
        after = tp.retrieve_np(eng, qs)
        st = eng.stats()
    assert st["generation"] == 1 and st["reloads"] == 1
    assert not np.isin(after[0], delta.delete_ids).any()
    assert not (after[0] == before[0]).all()
    fresh = tp.serve_torch(out, qs)
    np.testing.assert_array_equal(after[0], fresh[0])
    np.testing.assert_array_equal(after[1], fresh[1])
    # and the JAX engine over the port's generation serves the same ids
    tp.assert_same_results(after, tp.serve_jax(out, qs))
