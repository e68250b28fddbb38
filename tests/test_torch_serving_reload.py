"""The port's hot reloads held to the JAX package on the CPU: over
JAX-written index directories (one state at clusd_msmarco.smoke()
widths from a seed), the port's engine reloads to a JAX delta
generation (`reload_index`) and to a JAX-published selector
(`reload_selector`) and then serves as the reloaded JAX engine and a
fresh port engine do, with its lifetime counters carried; also under
concurrent serving, and with a pinned prefetch depth and k below
k_final.

Tolerances: ids equal at every rank more than 1e-5 from both
neighbours' scores (`isolated_ranks`), scores allclose at rtol 1e-5,
atol 1e-6 against the JAX engine; bitwise against a fresh port engine.
At most 13 tests, as test_torch_serving_v1.py says.
"""

import shutil
import sys
import threading

import _torch_parity as tp  # first: it caps torch at 2 threads
import jax
import numpy as np
import pytest
from _torch_parity import (SERVE_BATCH, assert_same_results,
                           assert_same_stats_surface, live_engines,
                           retrieve_np, serve_jax, serve_torch)

from repro import index as jindex
from repro import train as jtrain
from repro.data import synth_queries
from repro_torch.engine import RetrievalEngine
from repro_torch.index import IndexReader, ShardedDiskStore

N_Q = 16


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    cfg, index, corpus, _, dirs = tp.jax_dirs_state(tmp_path_factory)
    return cfg, index, corpus, dirs, synth_queries(9, corpus, N_Q)


@pytest.mark.parametrize("kind", ["f32", "v2"])
def test_reload_index_to_a_jax_delta_generation(state, kind, tmp_path):
    cfg, index, _, dirs, qs = state
    work = str(shutil.copytree(dirs[kind], tmp_path / "live"))
    jeng, teng = live_engines(work)
    before = retrieve_np(teng, qs)
    assert_same_results(before, retrieve_np(jeng, qs))
    st0 = teng.stats()
    jindex.write_index_delta(work, tp.jax_delta(index, cfg.dim, cfg.vocab,
                                                seed=11))
    assert jeng.reload_index() == teng.reload_index() == 1
    after = retrieve_np(teng, qs)
    assert_same_results(after, retrieve_np(jeng, qs))
    with IndexReader.open(work).engine(max_batch=SERVE_BATCH, prefetch=False,
                                       device="cpu") as fresh:
        np.testing.assert_array_equal(after[0], retrieve_np(fresh, qs)[0])
        np.testing.assert_array_equal(after[1], retrieve_np(fresh, qs)[1])
    ts, js = teng.stats(), jeng.stats()
    assert_same_stats_surface(ts, js)
    assert ts["reloads"] == 1 and ts["generation"] == 1
    assert ts["cache"]["clears"] == st0["cache"]["clears"] + 1
    # lifetime counters carried across the swap
    assert ts["io"]["n_ops"] > st0["io"]["n_ops"] > 0
    assert ts["n_queries"] == 2 * N_Q
    assert not (after[0] == before[0]).all()       # the corpus moved
    teng.reset_stats()
    jeng.reset_stats()
    ts, js = teng.stats(), jeng.stats()
    assert ts["n_queries"] == ts["io"]["n_ops"] == ts["cache"]["clears"] == 0
    assert sorted(ts) == sorted(js)
    teng.close()
    jeng.close()


def test_reload_index_under_concurrent_serving(state, tmp_path):
    """reload_index from this thread while four serving threads wait on
    the engine, with a short switch interval: no batch fails, each one
    serves one whole generation, and the reloaded engine equals a fresh
    one. (Few threads: this file runs beside timing-sensitive tests.)"""
    cfg, index, _, dirs, qs = state
    work = str(shutil.copytree(dirs["f32"], tmp_path / "live"))
    eng = IndexReader.open(work).engine(max_batch=8, device="cpu")
    jindex.write_index_delta(work, tp.jax_delta(index, cfg.dim, cfg.vocab,
                                                seed=12))
    errors, served = [], []

    def serve():
        try:
            served.append(retrieve_np(eng, qs))
        except Exception as e:           # recorded, asserted below
            errors.append(e)

    threads = [threading.Thread(target=serve) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        assert eng.reload_index() == 1
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors and len(served) == len(threads)
    after = retrieve_np(eng, qs)
    st = eng.stats()
    eng.close()
    with IndexReader.open(work).engine(max_batch=8, prefetch=False,
                                       device="cpu") as fresh:
        np.testing.assert_array_equal(after[0], retrieve_np(fresh, qs)[0])
    with IndexReader.open(dirs["f32"]).engine(max_batch=8, prefetch=False,
                                              device="cpu") as old:
        old_ids = retrieve_np(old, qs)[0]
    # each chunk of max_batch queries served on one generation
    for ids, _ in served:
        for lo in range(0, N_Q, 8):
            chunk = ids[lo:lo + 8]
            assert (chunk == old_ids[lo:lo + 8]).all() \
                or (chunk == after[0][lo:lo + 8]).all()
    assert st["reloads"] == 1 and st["prefetch_errors"] == 0
    assert st["cache"]["clears"] == 1
    assert st["n_queries"] == (len(threads) + 1) * N_Q


def _publish(path, index, cfg, seed, **kw):
    from repro.core.features import feature_dim
    from repro.core.lstm import lstm_init
    params = lstm_init(jax.random.key(seed), feature_dim(cfg),
                       cfg.lstm_hidden)
    return jtrain.publish_selector(path, params, **kw)


def test_reload_selector_to_a_jax_publish(state, tmp_path):
    cfg, index, _, dirs, qs = state
    work = str(shutil.copytree(dirs["f32"], tmp_path / "live"))
    jeng, teng = live_engines(work)
    retrieve_np(teng, qs)
    retrieve_np(jeng, qs)
    cache0 = teng.stats()["cache"]
    _publish(work, index, cfg, 7, theta=0.3, budget=5)
    assert jeng.reload_selector() == teng.reload_selector() == 1
    assert teng.cfg.theta == 0.3 and teng.cfg.max_selected == 5
    got = retrieve_np(teng, qs)
    assert_same_results(got, retrieve_np(jeng, qs))
    with IndexReader.open(work).engine(max_batch=SERVE_BATCH, prefetch=False,
                                       device="cpu") as fresh:
        np.testing.assert_array_equal(got[0], retrieve_np(fresh, qs)[0])
    st = teng.stats()
    assert st["selector_reloads"] == 1 and st["reloads"] == 0
    assert st["cache"]["clears"] == cache0["clears"]    # cache kept
    assert st["cache"]["hits"] > cache0["hits"]
    assert_same_stats_surface(st, jeng.stats())
    # the corpus moves too: reload_selector falls back to reload_index
    jindex.write_index_delta(work, tp.jax_delta(index, cfg.dim, cfg.vocab,
                                                seed=13))
    assert teng.reload_selector() == jeng.reload_selector() == 2
    st = teng.stats()
    assert st["reloads"] == 1 and st["selector_reloads"] == 1
    assert_same_results(retrieve_np(teng, qs), retrieve_np(jeng, qs))
    teng.close()
    jeng.close()


def test_reload_selector_retunes_stage1(state, tmp_path):
    cfg, index, _, dirs, qs = state
    work = str(shutil.copytree(dirs["f32"], tmp_path / "live"))
    jeng, teng = live_engines(work)
    retrieve_np(teng, qs)
    _publish(work, index, cfg, 8, expand_depth=1, fusion="rrf")
    jeng.reload_selector()
    teng.reload_selector()
    assert teng.cfg.expand_depth == 1 and teng.cfg.fusion == "rrf"
    assert not any(k[0] == "stage1" for k in teng._fns)
    assert_same_results(retrieve_np(teng, qs), retrieve_np(jeng, qs),
                         "rrf")
    teng.close()
    jeng.close()


def test_k_and_pinned_prefetch_depth_match_jax(state, tmp_path):
    """k below k_final serves the JAX engine's k columns; a pinned
    prefetch_depth survives reload_selector and reload_index, while the
    default follows the published budget, as in the JAX engine."""
    cfg, index, _, dirs, qs = state
    k = cfg.k_final // 2
    t = serve_torch(dirs["f32"], qs, k=k)
    assert t[0].shape == t[1].shape == (N_Q, k)
    assert_same_results(t, serve_jax(dirs["f32"], qs, k=k))
    work = str(shutil.copytree(dirs["f32"], tmp_path / "live"))
    pinned, default = live_engines(work, prefetch_depth=3), \
        live_engines(work)
    _publish(work, index, cfg, 7, budget=5)
    for eng in (*pinned, *default):
        eng.reload_selector()
    jindex.write_index_delta(work, tp.jax_delta(index, cfg.dim, cfg.vocab,
                                                seed=14))
    for eng in (*pinned, *default):
        assert eng.reload_index() == 2
    assert [e.prefetch_depth for e in pinned] == [3, 3]
    assert [e.prefetch_depth for e in default] == [7, 7]   # budget 5 + 5//2
    for jeng, teng in (pinned, default):
        assert_same_results(retrieve_np(teng, qs), retrieve_np(jeng, qs))
        jeng.close()
        teng.close()


def test_reloads_need_a_reader(state):
    path = state[3]["f32"]
    r = IndexReader.open(path)
    cfg, idx = r.load_index(device="cpu")
    with RetrievalEngine(cfg, idx, r.open_store(), device="cpu") as eng:
        with pytest.raises(ValueError, match="IndexReader"):
            eng.reload_index()
        with pytest.raises(ValueError, match="IndexReader"):
            eng.reload_selector()
        assert "generation" not in eng.stats()
        assert isinstance(eng.store, ShardedDiskStore)
