"""The port's index format and checkpoint layer held to the JAX package
on the CPU: the JAX package builds one state at clusd_msmarco.smoke()
widths from a seed and writes it as v1 (float32, bfloat16, int8) and v2
directories and one delta generation; the port loads and verifies their
manifests, reads archived generations and the LSTM checkpoint, and
writes checkpoints in the same layout. The reader and stores are in
test_torch_index_store.py, the writer in test_torch_index_writer.py.

Tolerance: none; manifests and checkpoint leaves are compared exactly.
The npz checkpoint members are compared by their .npy bytes: a zip
header carries its write time. At most 13 tests, as
test_torch_serving_v1.py says.
"""

import os
import shutil
import zipfile

import _torch_parity as tp  # first: it caps torch at 2 threads
import jax
import numpy as np
import pytest

from repro import index as jindex
from repro.checkpoint import restore_checkpoint
from repro.core.lstm import lstm_init
from repro_torch.checkpoint import leaf_key, read_checkpoint, save_checkpoint
from repro_torch.index import (IndexChecksumError, IndexFormatError,
                               IndexReader, load_manifest, verify_files)
from repro_torch.index import format as tfmt

KINDS = ("f32", "bf16", "int8", "v2")


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    # v1 and v2 directories and a generation with deletes, replacements
    # and appends, all written by the JAX package
    return tp.jax_dirs_state(tmp_path_factory, delta_seed=5)


@pytest.mark.parametrize("kind", KINDS + ("delta",))
def test_manifest_and_verify_match_jax(state, kind):
    path = state[4][kind]
    man = load_manifest(path)
    assert man == jindex.load_manifest(path)
    for level in ("none", "size", "full"):
        verify_files(path, man, level=level)
    with pytest.raises(ValueError):
        verify_files(path, man, level="fast")


def test_v1_only_reader_rejects_v2(state):
    dirs = state[4]
    with pytest.raises(IndexFormatError, match="unsupported"):
        load_manifest(dirs["v2"], supported=(1,))
    with pytest.raises(IndexFormatError, match="unsupported"):
        IndexReader.open(dirs["v2"], supported=(1,))
    assert IndexReader.open(dirs["f32"], supported=(1,)).format_version == 1
    with pytest.raises(jindex.IndexFormatError):
        jindex.load_manifest(dirs["v2"], supported=(1,))


def test_full_verify_catches_one_bit_flip(state, tmp_path):
    work = str(shutil.copytree(state[4]["f32"], tmp_path / "flip"))
    man = load_manifest(work)
    shard = os.path.join(work, man["block_shards"][1]["file"])
    with open(shard, "r+b") as f:
        f.seek(1000)
        byte = f.read(1)
        f.seek(1000)
        f.write(bytes([byte[0] ^ 0x10]))
    verify_files(work, man, level="size")           # same size: passes
    with pytest.raises(IndexChecksumError, match="sha256"):
        verify_files(work, man, level="full")
    with pytest.raises(IndexChecksumError):
        IndexReader.open(work, verify="full")
    with pytest.raises(jindex.IndexChecksumError):
        jindex.IndexReader.open(work, verify="full")
    os.truncate(shard, os.path.getsize(shard) - 4)
    with pytest.raises(IndexChecksumError, match="truncated"):
        IndexReader.open(work, verify="size")


def test_generation_reads_archived_manifest(state):
    path = state[4]["delta"]
    cur = load_manifest(path)
    assert tfmt.manifest_generation(cur) == 1
    assert load_manifest(path, generation=1) == cur
    g0 = load_manifest(path, generation=0)
    assert g0 == jindex.load_manifest(path, generation=0)
    assert g0 == load_manifest(state[4]["f32"])
    with pytest.raises(IndexFormatError, match="generation 7"):
        load_manifest(path, generation=7)
    assert IndexReader.open(path).generation == 1


def test_commit_manifest_replaces_the_manifest(state, tmp_path):
    work = str(shutil.copytree(state[4]["f32"], tmp_path / "commit"))
    man = load_manifest(work)
    man.update(generation=3, parent_generation=0)
    tfmt.commit_manifest(work, man)
    assert sorted(os.listdir(work)) == sorted(os.listdir(state[4]["f32"]))
    assert jindex.load_manifest(work) == man
    assert IndexReader.open(work, verify="full").generation == 3


def test_lstm_leaves_bitwise_equal_jax_restore(state):
    dirs = state[4]
    meta = load_manifest(dirs["f32"])["lstm"]
    ckpt = os.path.join(dirs["f32"], meta["dir"])
    leaves, extra = read_checkpoint(ckpt, meta["step"])
    target = lstm_init(jax.random.key(0), meta["feat_dim"], meta["hidden"])
    params, jextra = restore_checkpoint(ckpt, meta["step"], target)
    assert extra == jextra
    assert sorted(leaves) == sorted(leaf_key(k) for k in params)
    for k, v in params.items():
        np.testing.assert_array_equal(leaves[leaf_key(k)], np.asarray(v))
    got = IndexReader.open(dirs["f32"]).lstm_params()
    for k, v in params.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(v))


def test_checkpoint_writer_matches_jax_layout(tmp_path):
    from repro.checkpoint import save_checkpoint as jsave
    rng = np.random.default_rng(0)
    arrays = {"wx": rng.standard_normal((5, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32),
              "step": np.arange(3, dtype=np.int64)}
    save_checkpoint(str(tmp_path / "t"), 4, arrays, extra={"a": 1})
    jsave(str(tmp_path / "j"), 4, arrays, extra={"a": 1})
    t, j = tmp_path / "t" / "step_4", tmp_path / "j" / "step_4"
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    assert (t / "manifest.json").read_bytes() == \
        (j / "manifest.json").read_bytes()
    _assert_same_npz(t / "shard_0.npz", j / "shard_0.npz")


def _assert_same_npz(a, b):
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name
