"""The port's `write_index` held to the JAX package's on the CPU: for
one state at clusd_msmarco.smoke() widths from a seed, each written
file is byte-identical to the JAX writer's except manifest.json, whose
parsed JSON is equal apart from wall-time fields; each package's reader
opens the other's directory.

Tolerance: none. The npz checkpoint members are compared by their .npy
bytes: a zip header carries its write time. At most 13 tests, as
test_torch_serving_v1.py says.
"""

import json
import os
import zipfile

import _torch_parity as tp  # first: it caps torch at 2 threads
import numpy as np
import pytest

from repro import index as jindex
from repro_torch import convert
from repro_torch.index import IndexReader, write_index

KINDS = ("f32", "bf16", "int8", "v2")


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    return tp.jax_dirs_state(tmp_path_factory)


def _torch_index(index, pq=None):
    t = convert.index_from_numpy(tp.index_arrays(index), device="cpu")
    if pq is not None:
        t.quantizer = convert.pq_from_numpy(pq.codebooks, pq.codes,
                                            pq.rotation, pq.nsub,
                                            device="cpu")
    return t


def _assert_same_npz(a, b):
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name


def _files(root):
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, n), root)
                for n in names]
    return sorted(out)


@pytest.mark.parametrize("kind", KINDS)
def test_writer_matches_jax_writer(state, kind, tmp_path):
    cfg, index, corpus, pq, dirs = state
    jdir = dirs[kind]
    tcfg = tp.torch_cfg(cfg)
    tindex = _torch_index(index)
    dtype = {"f32": "float32", "bf16": "bfloat16", "int8": "int8",
             "v2": "float32"}[kind]
    out = str(tmp_path / "t")
    kw = dict(format_version=2, pq=_torch_index(index, pq).quantizer) \
        if kind == "v2" else {}
    man = write_index(out, tcfg, tindex, np.asarray(corpus.embeddings),
                      n_shards=3, block_dtype=dtype, **kw)
    assert not os.path.exists(out + ".tmp")
    assert _files(out) == _files(jdir)
    for rel in _files(out):
        if rel == "manifest.json":
            continue
        if rel.endswith(".npz"):
            _assert_same_npz(os.path.join(out, rel), os.path.join(jdir, rel))
            continue
        with open(os.path.join(out, rel), "rb") as f, \
                open(os.path.join(jdir, rel), "rb") as g:
            assert f.read() == g.read(), rel
    with open(os.path.join(jdir, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == json.loads(json.dumps(man))
    man = json.loads(json.dumps(man))
    for m in (man, jman):           # wall time, and the npz write times
        del m["stats"]["pack_wall_s"]
        for rel in [r for r in m["files"] if r.endswith(".npz")]:
            del m["files"][rel]["sha256"]
        m.pop("total_bytes")
    assert man == jman
    # each package's reader opens the other's directory
    j = jindex.IndexReader.open(out, verify="full")
    t = IndexReader.open(jdir, verify="full")
    np.testing.assert_array_equal(np.asarray(j.array("cluster_docs")),
                                  t.array("cluster_docs"))
    if kind != "v2":
        ids = [0, 1, 30, 63]
        np.testing.assert_array_equal(
            np.asarray(j.open_store().fetch_blocks(ids)[0]),
            IndexReader.open(out).open_store().fetch_blocks(ids)[0])


def test_writer_refuses_v2_without_a_pq(state, tmp_path):
    """A v2 write refuses a PQ that does not cover the index (codes of
    another doc count, or outside uint8) and an unknown format. With no
    PQ at all it now trains one, as the JAX writer does
    (tests/test_torch_build_offline.py holds that write to JAX's)."""
    cfg, index, corpus, pq, _ = state
    codes = np.asarray(pq.codes)
    for bad, msg in ((codes[:-1], "PQ codes cover"),
                     (codes + 256, "out of uint8 range")):
        with pytest.raises(ValueError, match=msg):
            write_index(str(tmp_path / "x"), tp.torch_cfg(cfg),
                        _torch_index(index), np.asarray(corpus.embeddings),
                        format_version=2, pq=convert.pq_from_numpy(
                            pq.codebooks, bad, pq.rotation, pq.nsub,
                            device="cpu"))
    with pytest.raises(ValueError, match="format_version"):
        write_index(str(tmp_path / "x"), tp.torch_cfg(cfg),
                    _torch_index(index), np.asarray(corpus.embeddings),
                    format_version=3)
    assert not os.path.exists(tmp_path / "x")
