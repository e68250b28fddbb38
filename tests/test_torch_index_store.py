"""The port's `IndexReader` and `ShardedDiskStore` held to the JAX
package on the CPU, over v1 (float32, bfloat16, int8) and v2
directories and one delta generation that the JAX package writes for
one state at clusd_msmarco.smoke() widths from a seed.

Tolerance: none; arrays, fetched blocks and IOStats are compared
exactly (bitwise). At most 13 tests, as test_torch_serving_v1.py says.
"""

import dataclasses
import os

import _torch_parity as tp  # first: it caps torch at 2 threads
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import index as jindex
from repro_torch.index import (IndexFormatError, IndexReader,
                               ShardedDiskStore, load_manifest)
from repro_torch.index import format as tfmt

KINDS = ("f32", "bf16", "int8", "v2")
V1_KINDS = ("f32", "bf16", "int8")


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    # v1 and v2 directories and a generation with deletes, replacements
    # and appends, all written by the JAX package
    return tp.jax_dirs_state(tmp_path_factory, delta_seed=5)


@pytest.mark.parametrize("kind", KINDS + ("delta",))
def test_reader_arrays_bitwise_equal_jax(state, kind):
    path = state[4][kind]
    t, j = IndexReader.open(path), jindex.IndexReader.open(path)
    assert (t.format_version, t.is_pq, t.generation, t.n_block_shards()) \
        == (j.format_version, j.is_pq, j.generation, j.n_block_shards())
    for name in j.manifest["arrays"]:
        a, b = t.array(name), j.array(name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.masked_cluster_docs(),
                                  j.masked_cluster_docs())
    tt, jt = t.tombstones(), j.tombstones()
    assert (tt is None) == (jt is None) == (kind != "delta")
    if tt is not None:
        assert tt.sum() > 0
        np.testing.assert_array_equal(tt, jt)
    assert dataclasses.asdict(t.config()) == dataclasses.asdict(j.config())
    assert t.selector_meta() == j.selector_meta()
    cfg, ti = t.load_index(device="cpu")
    _, ji = j.load_index(load_quantizer=False)
    assert ti.device == torch.device("cpu")
    for name in ("centroids", "cluster_docs", "doc_cluster", "neighbor_ids",
                 "neighbor_sims", "bin_ids"):
        np.testing.assert_array_equal(getattr(ti, name).numpy(),
                                      np.asarray(getattr(ji, name)))
    # v2's CSR postings re-padded to the JAX reader's width
    np.testing.assert_array_equal(ti.sparse_index.postings_docs.numpy(),
                                  np.asarray(ji.sparse_index.postings_docs))
    np.testing.assert_array_equal(
        ti.sparse_index.postings_weights.numpy(),
        np.asarray(ji.sparse_index.postings_weights))
    assert ti.n_docs == ji.n_docs == t.geometry["n_docs"]
    for k, p in ti.selector.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(ji.lstm_params[k]))


# runs across shard edges, a lone id, and a repeated run
FETCH_IDS = ([0, 1, 2, 5, 20, 21, 22, 40, 63], [63, 62, 10], [7],
             list(range(64)))


@pytest.mark.parametrize("kind", V1_KINDS + ("delta",))
def test_disk_store_fetch_bitwise_and_n_ops(state, kind):
    path = state[4][kind]
    t, j = IndexReader.open(path), jindex.IndexReader.open(path)
    ts, js = t.open_store(), j.open_store()
    assert isinstance(ts, ShardedDiskStore) and not ts.is_coded
    assert (ts.cap, ts.dim, ts.block_bytes) == (js.cap, js.dim,
                                                js.block_bytes)
    for ids in FETCH_IDS:
        tb, td, tv = ts.fetch_blocks(ids)
        jb, jd, jv = js.fetch_blocks(ids)
        assert tb.dtype == np.float32 and np.asarray(jb).dtype == np.float32
        np.testing.assert_array_equal(tb, np.asarray(jb))
        np.testing.assert_array_equal(td, np.asarray(jd))
        np.testing.assert_array_equal(tv, np.asarray(jv))
        assert ts.stats.n_ops == js.stats.n_ops
        assert ts.stats.bytes == js.stats.bytes
    np.testing.assert_array_equal(
        ts.fetch_clusters([3, 4, 9]).numpy(),
        np.asarray(js.fetch_clusters([3, 4, 9])))
    assert ts.stats.n_ops == js.stats.n_ops
    np.testing.assert_array_equal(ts.cluster_docs_np, js.cluster_docs_np)


def test_store_shard_subset_like_jax(state):
    path = state[4]["f32"]
    ts = IndexReader.open(path).open_store(shards=[2, 0])
    js = jindex.IndexReader.open(path).open_store(shards=[2, 0])
    assert ts.owned_ranges == js.owned_ranges == [(0, 22), (43, 64)]
    lo, hi = ts.owned_ranges[1]
    np.testing.assert_array_equal(ts.fetch_blocks([0, lo, hi - 1])[0],
                                  np.asarray(js.fetch_blocks(
                                      [0, lo, hi - 1])[0]))
    with pytest.raises(KeyError, match="not owned"):
        ts.fetch_blocks([ts.owned_ranges[0][1]])      # shard 1's first
    with pytest.raises(ValueError, match="out of range"):
        IndexReader.open(path).open_store(shards=[3])


def test_int8_store_needs_its_scale(state):
    man = load_manifest(state[4]["int8"])
    s = man["block_shards"][0]
    with pytest.raises(ValueError, match="block_scale"):
        ShardedDiskStore([os.path.join(state[4]["int8"], s["file"])],
                         [(s["cluster_lo"], s["cluster_hi"])],
                         man["geometry"]["cap"], man["geometry"]["dim"],
                         np.zeros((s["cluster_hi"], man["geometry"]["cap"]),
                                  np.int32), dtype="int8")
    with pytest.raises(IndexFormatError, match="unsupported"):
        tfmt.resolve_block_dtype("float16")


def test_bf16_bits_match_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10,
        np.array([0.0, -0.0, np.inf, -np.inf, 3.4028235e38, 1e-40,
                  -1e-45, 1.00390625, 1.01171875], np.float32),
        # exact halfway cases round to even
        (np.arange(64, dtype=np.uint32) << 16 | 0x8000).view(np.float32)])
    ref = x.astype(ml_dtypes.bfloat16)
    bits = tfmt.f32_to_bf16_bits(x)
    np.testing.assert_array_equal(bits, ref.view(np.uint16))
    np.testing.assert_array_equal(tfmt.bf16_bits_to_f32(bits),
                                  ref.astype(np.float32))
    nan = tfmt.f32_to_bf16_bits(np.array([np.nan, -np.nan], np.float32))
    assert np.isnan(tfmt.bf16_bits_to_f32(nan)).all()
    assert tfmt.record_dtype("bfloat16") == np.uint16
    assert tfmt.resolve_block_dtype(np.dtype(ml_dtypes.bfloat16)) == \
        "bfloat16"
    assert tfmt.resolve_block_dtype(np.float32) == "float32"
