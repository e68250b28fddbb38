"""The port's calibration and selector publishing against the JAX
package's, on the CPU.

  * select_at, recall_at_budget, calibration_table and
    choose_operating_point give JAX's rows and picks on the same
    probabilities (exactly: numpy on the same inputs); the port's
    selector_probs is JAX's within rtol 1e-5, atol 1e-6;
    expansion_sweep's stage-1 ceilings and rows equal JAX's on the same
    params; select_at is the port engine's stage2_select.
  * publish_selector on two copies of one JAX-written directory: the
    manifests are equal (with the zip member time pinned, so the lstm
    checkpoint files hash alike), and the file trees are byte for byte.
  * the JAX reader opens a port-published generation and serves the
    same ids as the port's engine (isolated ranks, as the serving
    tests hold them).
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (SERVE_BATCH, assert_same_results,
                           frozen_zip_time, jax_train_dirs, serve_jax,
                           serve_torch)
from repro import train as jtrain
from repro.core.lstm import lstm_init
from repro.index import IndexReader as JReader
from repro_torch import train as train_lib
from repro_torch.core import clusd as tclusd
from repro_torch.index import IndexReader


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    jcfg, corpus, jindex, dirs, qs = jax_train_dirs(
        tmp_path_factory.mktemp("calib"))
    reader = IndexReader.open(dirs["v1"])
    cfg, index = reader.load_index(device="cpu")
    store = reader.open_store(cluster_docs=index.cluster_docs)
    ls = train_lib.make_labels_streaming(cfg, index, store, qs.q_dense,
                                         qs.q_terms, qs.q_weights,
                                         device="cpu")
    params, _ = train_lib.train_selector(
        cfg, torch.Generator().manual_seed(2), ls.feats, ls.labels,
        epochs=3, batch_size=8, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, index=index, store=store, dirs=dirs,
                qs=qs, ls=ls, params=params)


def _jls(ls):
    return jtrain.LabelSet(cand=ls.cand, feats=ls.feats, labels=ls.labels,
                           dense_ids=ls.dense_ids)


def _jparams(params):
    return {k: jax.numpy.asarray(v.numpy()) for k, v in params.items()}


def test_selector_probs_and_select_at_match_jax(state):
    ls, params = state["ls"], state["params"]
    probs = train_lib.selector_probs(params, ls.feats, batch=7,
                                     device="cpu")
    jprobs = np.asarray(jtrain.selector_probs(_jparams(params), ls.feats,
                                              batch=7))
    np.testing.assert_allclose(probs, jprobs, rtol=1e-5, atol=1e-6)
    for theta, budget in ((0.0, 3), (0.2, 4), (0.5, 99)):
        for a, b in zip(train_lib.select_at(ls.cand, probs, theta, budget),
                        jtrain.select_at(ls.cand, probs, theta, budget)):
            np.testing.assert_array_equal(a, b)
    # select_at is the engine's stage2_select on the same probabilities
    cfg = dataclasses.replace(state["cfg"], max_selected=4)
    with torch.no_grad():
        s2 = tclusd.stage2_select(
            cfg, state["index"], torch.from_numpy(ls.cand),
            torch.from_numpy(ls.feats), theta=0.2,
            selector_params={k: v.numpy() for k, v in params.items()})
    sel_ids, sel_mask = train_lib.select_at(
        ls.cand, s2["probs"].numpy(), 0.2, 4)
    np.testing.assert_array_equal(s2["sel_mask"].numpy(), sel_mask)
    np.testing.assert_array_equal(
        np.where(sel_mask, s2["sel_ids"].numpy(), -1),
        np.where(sel_mask, sel_ids, -1))


def test_calibration_table_and_operating_point_equal_jax(state):
    ls, index, store = state["ls"], state["index"], state["store"]
    probs = train_lib.selector_probs(state["params"], ls.feats,
                                     device="cpu")
    kw = dict(thetas=[0.02, 0.2, 0.5, 0.05], budgets=[2, 8, 4],
              block_bytes=store.block_bytes)
    table = train_lib.calibration_table(ls, probs, index.doc_cluster, **kw)
    jtable = jtrain.calibration_table(_jls(ls), probs,
                                      index.doc_cluster.numpy(), **kw)
    assert table == jtable and len(table) == 12
    best = max(r["recall"] for r in table)
    for kw2 in ({"target_recall": best}, {"target_recall": 1.1},
                {"target_recall": 0.3}, {"target_budget": 4},
                {"target_budget": 1}):
        assert train_lib.choose_operating_point(table, **kw2) == \
            jtrain.choose_operating_point(jtable, **kw2)
    with pytest.raises(ValueError):
        train_lib.choose_operating_point(table)
    with pytest.raises(ValueError):
        train_lib.choose_operating_point([], target_budget=4)
    q = train_lib.selection_quality(probs, ls.labels, 0.2)
    jq = jtrain.selection_quality(probs, ls.labels, 0.2)
    for k in q:
        np.testing.assert_allclose(float(q[k]), float(jq[k]), rtol=1e-6)


def test_expansion_sweep_equals_jax(state):
    qs, ls, params = state["qs"], state["ls"], state["params"]
    _, jindex = JReader.open(state["dirs"]["v1"]).load_index()
    kw = dict(depths=[2, 0], thetas=[0.02, 0.2], budgets=[2, 4],
              block_bytes=state["store"].block_bytes)
    got = train_lib.expansion_sweep(state["cfg"], state["index"], params,
                                    qs.q_dense, qs.q_terms, qs.q_weights,
                                    ls.dense_ids, **kw)
    want = jtrain.expansion_sweep(state["jcfg"], jindex, _jparams(params),
                                  qs.q_dense, qs.q_terms, qs.q_weights,
                                  ls.dense_ids, **kw)
    assert [d["depth"] for d in got] == [0, 2]
    assert got == want


def _publish(pkg, work, params, calibration):
    return pkg.publish_selector(
        work, params, theta=0.11, budget=4, calibration=calibration,
        label_config={"top_dense": 10, "chunk_clusters": 8},
        train_meta={"epochs": 3, "final_loss": 0.5}, expand_depth=1,
        fusion="rrf")


def _tree_bytes(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_publish_manifest_equals_jax_on_two_copies(state, tmp_path,
                                                   monkeypatch):
    frozen_zip_time(monkeypatch)
    src = state["dirs"]["v1"]
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    shutil.copytree(src, tdir)
    shutil.copytree(src, jdir)
    params = state["params"]
    cal = [{"theta": 0.11, "budget": 4, "recall": 0.5, "avg_selected": 3.0,
            "est_read_bytes": 0}]
    rep = _publish(train_lib, tdir, params, cal)
    jrep = _publish(jtrain, jdir, _jparams(params), cal)
    for k in ("generation", "parent_generation", "lstm_dir", "theta",
              "budget", "n_files_added", "bytes_added"):
        assert rep[k] == jrep[k], k
    tm = json.load(open(os.path.join(tdir, "manifest.json")))
    jm = json.load(open(os.path.join(jdir, "manifest.json")))
    assert tm == jm
    assert tm["generation"] == 1 and tm["lstm"]["dir"] == "lstm.g1"
    assert tm["config"]["expand_depth"] == 1 and tm["config"]["fusion"] == "rrf"
    assert _tree_bytes(tdir) == _tree_bytes(jdir)
    with pytest.raises(ValueError):
        train_lib.publish_selector(tdir, {"w1": np.zeros((3, 3))},
                                   selector="mlp")
    with pytest.raises(ValueError, match="head_w"):
        train_lib.publish_selector(tdir, {"wx": np.zeros((3, 12)),
                                          "wh": np.zeros((3, 12)),
                                          "b": np.zeros(12)})


def test_jax_reader_serves_a_port_published_generation(state, tmp_path):
    work = str(tmp_path / "pub")
    shutil.copytree(state["dirs"]["v2"], work)
    cfg, qs = state["jcfg"], state["qs"]
    params = {k: np.asarray(v) for k, v in
              lstm_init(jax.random.key(8), state["ls"].feats.shape[-1],
                        cfg.lstm_hidden).items()}
    with IndexReader.open(work).engine(max_batch=SERVE_BATCH,
                                       prefetch=False, device="cpu") as eng:
        before = eng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
        rep = train_lib.publish_selector(work, params, theta=0.3, budget=3,
                                         verify="full")
        assert eng.reload_selector() == rep["generation"] == 1
        hot = eng.retrieve(qs.q_dense, qs.q_terms, qs.q_weights)
        assert eng.stats()["selector_reloads"] == 1
    assert before[0].shape == hot[0].shape
    jreader = JReader.open(work, verify="full")
    assert jreader.generation == 1 and jreader.config().theta == 0.3
    for k, v in jreader.lstm_params().items():
        np.testing.assert_array_equal(np.asarray(v), params[k])
    t = serve_torch(work, qs)
    j = serve_jax(work, qs)
    assert_same_results(t, j)
    np.testing.assert_array_equal(t[0], hot[0].numpy())
