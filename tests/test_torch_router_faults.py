"""The port's router under faults, generation hops and observation, on the
CPU over JAX-written directories (one state at clusd_msmarco.smoke()
widths, 3 shards).

  * failover: killing a host mid-stream with R 2 fails nothing and stays
    bitwise the single-host engine; killing a shard's only replica
    completes degraded, bitwise a placement without that shard; every
    host dead still completes (sparse side only) while a direct submit
    raises HostDown
  * a stalled host times out, the router backs off (an injected sleep
    that also releases the stall) and retries; the late response is
    never merged and the batch is exact, whatever the machine's load
  * rolling reload_index to a port-committed delta while a second thread
    serves (0 failed batches, one generation per batch, ids equal a
    fresh engine's); reload_selector to a published selector, as a no-op
    without a new generation, and falling back to reload_index when the
    arrays moved
  * traces (router spans, host spans grafted under scatter, per-host
    Chrome lanes), per-host gauges, /healthz flips through the port's
    MetricsExporter, and explain records with host_contrib, each against
    the JAX router's

At most 13 tests.
"""

import json
import shutil
import threading
import urllib.error
import urllib.request

import _torch_parity as tp  # first: it caps torch at 2 threads
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro import index as jindex
from repro.data import synth_queries
from repro_torch.engine import (HostDown, HostRequest, ShardPlacement,
                                ShardRouter)
from repro_torch.index import IndexReader, write_index_delta
from repro_torch.launch.update_index import synth_delta
from repro_torch.obs import ExplainLogger, MetricsExporter
from repro_torch.train import publish_selector

BATCH = 8


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    cfg, index, corpus, _, dirs = tp.jax_dirs_state(tmp_path_factory)
    return {"v1": dirs["f32"], "v2": dirs["v2"]}, \
        synth_queries(7, corpus, 24)


def _q3(qs, lo=0, hi=None):
    return qs.q_dense[lo:hi], qs.q_terms[lo:hi], qs.q_weights[lo:hi]


def _router(path, n_hosts, replication=1, **kw):
    return ShardRouter.local(IndexReader.open(path), n_hosts, replication,
                             max_batch=BATCH, device="cpu", **kw)


def _engine_out(path, qs):
    with IndexReader.open(path).engine(max_batch=BATCH, prefetch=False,
                                       device="cpu") as eng:
        ids, sc = eng.retrieve(*_q3(qs))
    return ids.numpy(), sc.numpy()


def _bitwise(a, b):
    for x, y in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        y = y.numpy() if isinstance(y, torch.Tensor) else y
        assert x.tobytes() == y.tobytes()


def test_kill_one_host_replica_serves_exactly(state):
    dirs, qs = state
    ref = _engine_out(dirs["v2"], qs)
    with _router(dirs["v2"], 3, 2) as router:
        a = router.retrieve(*_q3(qs, 0, 8))
        router.hosts[0].kill()
        b = router.retrieve(*_q3(qs, 8))
        st = router.stats()
    _bitwise((torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]])), ref)
    assert st["failed_requests"] == 0 and st["failovers"] > 0
    assert not st["degraded"] and st["missing_shards"] == []
    assert st["per_host"][0]["alive"] is False


def test_kill_all_replicas_degrades_exactly(state):
    dirs, qs = state
    with _router(dirs["v2"], 3, 1) as router:
        router.hosts[1].kill()
        got = router.retrieve(*_q3(qs))
        st = router.stats()
        metas = list(router.last_batches)
    assert st["failed_requests"] == 0
    assert st["degraded"] and st["missing_shards"] == [1]
    assert st["degraded_requests"] == len(metas) > 0
    assert all(m["degraded"] and m["missing_shards"] == [1] for m in metas)
    pl = ShardPlacement(3, 2, replication=1,
                        replicas={0: [0], 1: [], 2: [1]})
    with ShardRouter.local(IndexReader.open(dirs["v2"]), 2, placement=pl,
                           max_batch=BATCH, device="cpu") as ref:
        want = ref.retrieve(*_q3(qs))
        assert ref.stats()["degraded"]
    _bitwise(got, want)
    with jengine.ShardRouter.local(jindex.IndexReader.open(dirs["v2"]),
                                   n_hosts=3, max_batch=BATCH) as jr:
        jr.hosts[1].kill()
        tp.assert_same_results([x.numpy() for x in got],
                               [np.asarray(x) for x in
                                jr.retrieve(*_q3(qs))])


def test_all_hosts_dead_completes_degraded(state):
    dirs, qs = state
    with _router(dirs["v1"], 2, 2) as router:
        for h in router.hosts:
            h.kill()
        req = HostRequest(generation=0, mode="dot",
                          q_or_lut=np.zeros((1, 32), np.float32),
                          sel_ids=np.zeros((1, 1), np.int64),
                          mine=np.zeros((1, 1), bool),
                          uniq=np.zeros((0,), np.int64))
        with pytest.raises(HostDown):
            router.hosts[0].submit(req).result()
        ids, _ = router.retrieve(*_q3(qs, 0, 4))
        st = router.stats()
    assert st["degraded"] and st["missing_shards"] == [0, 1, 2]
    assert st["failed_requests"] == 0 and st["degraded_requests"] == 1
    assert tuple(ids.shape) == (4, router.k)


def test_stalled_host_times_out_backs_off_and_retries_exactly(state):
    """Host 2 stalls on an Event that the router's injected backoff sleep
    sets: the first attempt times out (2 s), the retry is served after
    the stall ends, and only the retry's response is merged."""
    dirs, qs = state
    ref = _engine_out(dirs["v1"], qs)
    release = threading.Event()
    sleeps = []

    def backoff(s):
        sleeps.append(s)
        release.set()

    with _router(dirs["v1"], 3, 1, host_timeout=2.0, max_retries=4,
                 backoff_ms=20.0, sleep=backoff) as router:
        router.retrieve(*_q3(qs, 0, 8))
        stalled = router.hosts[2]
        stalled._sleep = lambda s: release.wait(timeout=60)
        served_before = stalled.served
        stalled.inject_delay(1.0, times=1)
        ids, _ = router.retrieve(*_q3(qs, 0, 8))
        st = router.stats()
        meta = router.last_batches[-1]
        router.hosts[2].close()         # drain the late response's thread
        assert stalled.served - served_before == 2
    np.testing.assert_array_equal(ids.numpy(), ref[0][:8])
    assert release.is_set()
    assert sleeps == [pytest.approx(0.02)]
    assert st["retries"] == 1 and meta["retries"] == 1
    assert st["failed_requests"] == 0 and not st["degraded"]
    assert sorted(meta["hosts"]) == [0, 1, 2]     # host 2 merged once


def test_rolling_reload_under_concurrent_queries(state, tmp_path):
    dirs, qs = state
    out = str(shutil.copytree(dirs["v2"], tmp_path / "live"))
    with _router(out, 3, 2) as router:
        router.retrieve(*_q3(qs, 0, 8))
        errors, stop = [], threading.Event()

        def serve_loop():
            while not stop.is_set():
                try:
                    router.retrieve(*_q3(qs, 0, 4))
                except Exception as e:          # pragma: no cover
                    errors.append(e)
                    return

        t = threading.Thread(target=serve_loop)
        t.start()
        try:
            delta, _ = synth_delta(router.reader, 12, 8, seed=3)
            write_index_delta(out, delta, device="cpu")
            gen = router.reload_index()
            router.retrieve(*_q3(qs, 0, 4))
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive() and not errors and gen == 1
        got = router.retrieve(*_q3(qs))
        st = router.stats()
        metas = list(router.last_batches)
        assert all(h.generations() == [1] for h in router.hosts)
    assert st["failed_requests"] == 0 and st["degraded_requests"] == 0
    assert st["reloads"] == 1 and st["generation"] == 1
    assert {m["generation"] for m in metas} <= {0, 1}
    assert metas[-1]["generation"] == 1
    _bitwise(got, _engine_out(out, qs))


def test_reload_selector_publish_noop_and_fallback(state, tmp_path):
    dirs, qs = state
    out = str(shutil.copytree(dirs["v1"], tmp_path / "live"))
    with _router(out, 2) as router:
        router.retrieve(*_q3(qs, 0, 4))
        assert router.reload_selector() == 0
        assert router.reload_index() == 0
        assert router.stats()["reloads"] == 0
        params = {k: v * 1.5 for k, v in router.reader.lstm_params().items()}
        publish_selector(out, params, theta=0.3, budget=4)
        assert router.reload_selector() == 1
        st = router.stats()
        assert (st["selector_reloads"], st["reloads"]) == (1, 0)
        _bitwise(router.retrieve(*_q3(qs)), _engine_out(out, qs))
        # the retire went through each host's queue before that batch
        assert all(h.generations() == [1] for h in router.hosts)
        # the corpus moved too: a full reload instead
        delta, _ = synth_delta(router.reader, 6, 4, seed=1)
        write_index_delta(out, delta, device="cpu")
        assert router.reload_selector() == 2
        assert router.stats()["reloads"] == 1
        _bitwise(router.retrieve(*_q3(qs)), _engine_out(out, qs))


def test_traces_graft_host_spans_on_their_own_lanes(state, tmp_path):
    dirs, qs = state
    with _router(dirs["v2"], 3, 2, trace_sample_rate=1.0) as router:
        router.retrieve(*_q3(qs, 0, 8))
        totals = router.tracer.span_totals("batch")
        traces = [t for t in router.tracer.traces if t.name == "batch"]
        path = str(tmp_path / "r.json")
        from repro_torch.obs import write_trace
        write_trace(router.tracer, path)
    with jengine.ShardRouter.local(jindex.IndexReader.open(dirs["v2"]),
                                   n_hosts=3, replication=2, max_batch=BATCH,
                                   trace_sample_rate=1.0) as jr:
        jr.retrieve(*_q3(qs, 0, 8))
        jtotals = jr.tracer.span_totals("batch")
    assert sorted(totals) == sorted(jtotals)
    for span in ("stage1", "lut_build", "stage2_select", "scatter", "gather",
                 "merge", "fuse", "host_serve", "block_fetch", "compact",
                 "score", "partial_topk"):
        assert span in totals, span
    hosts = set()
    for tr in traces:
        for sp in tr.spans:
            if sp.name == "host_serve":
                parent = tr.spans[sp.parent]
                assert parent.name == "scatter"
                assert sp.t0_ms + 0.1 >= parent.t0_ms
                assert sp.t0_ms + sp.dur_ms <= \
                    parent.t0_ms + parent.dur_ms + 0.1
                hosts.add(sp.annot["host"])
            if sp.name in ("score", "partial_topk", "compact"):
                assert tr.spans[sp.parent].name == "host_serve"
    assert hosts == {0, 1, 2}
    doc = json.load(open(path))
    lanes = {ev["tid"] for ev in doc["traceEvents"]
             if (ev.get("args") or {}).get("host") is not None}
    assert len(lanes) >= 3 and all(".host" in str(t) for t in lanes)


def test_gauges_mirror_every_host_like_jax(state):
    dirs, qs = state
    with _router(dirs["v2"], 3, 1) as router:
        router.retrieve(*_q3(qs, 0, 8))
        router.hosts[2].kill()
        st = router.stats()
        g = router.metrics.snapshot()["gauges"]
        prom = router.metrics.to_prometheus()
    with jengine.ShardRouter.local(jindex.IndexReader.open(dirs["v2"]),
                                   n_hosts=3, max_batch=BATCH) as jr:
        jr.retrieve(*_q3(qs, 0, 8))
        jr.hosts[2].kill()
        jr.stats()
        jg = jr.metrics.snapshot()["gauges"]
    assert sorted(g) == sorted(jg)
    for key in g:
        if ".cache." not in key:        # prefetch-free, but timing-free too
            assert g[key] == jg[key], key
    assert g["router.hosts_alive"] == 2
    assert g["router.missing_shards"] == len(st["missing_shards"]) > 0
    for i, h in enumerate(st["per_host"]):
        assert g[f"host{i}.served"] == h["served"]
        assert g[f"host{i}.io.bytes"] == h["io"]["bytes"]
    assert "host0_served" in prom


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_healthz_flips_on_replica_loss_and_recovers(state):
    dirs, qs = state
    with _router(dirs["v2"], 3, 1) as router:
        router.retrieve(*_q3(qs, 0, 8))
        with MetricsExporter(router, port=0) as exp:
            code, body = _get(exp.port, "/healthz")
            assert code == 200 and json.loads(body)["ok"] is True
            code, text = _get(exp.port, "/metrics")
            assert code == 200 and "router_hosts_alive 3" in text
            router.hosts[1].kill()
            code, body = _get(exp.port, "/healthz")
            assert code == 503
            assert any("shards_without_replicas" in r
                       for r in json.loads(body)["reasons"])
            router.retrieve(*_q3(qs, 0, 4))
            code, text = _get(exp.port, "/metrics")
            assert code == 200 and "router_hosts_alive 2" in text
            router.hosts[1].revive()
            code, body = _get(exp.port, "/healthz")
            assert code == 200 and json.loads(body)["ok"] is True


def test_explain_records_carry_host_contrib_like_jax(state):
    dirs, qs = state
    recs = {}
    for pkg in ("torch", "jax"):
        ex = ExplainLogger(sample_rate=1.0) if pkg == "torch" else \
            __import__("repro.obs", fromlist=["ExplainLogger"]) \
            .ExplainLogger(sample_rate=1.0)
        make = (lambda: _router(dirs["v2"], 3, 1, explain=ex)) \
            if pkg == "torch" else \
            (lambda: jengine.ShardRouter.local(
                jindex.IndexReader.open(dirs["v2"]), n_hosts=3,
                max_batch=BATCH, explain=ex))
        with make() as router:
            router.retrieve(*_q3(qs, 0, 8))
            router.hosts[1].kill()
            router.retrieve(*_q3(qs, 8, 12))
        recs[pkg] = ex.recent()
    got, want = recs["torch"], recs["jax"]
    assert len(got) == len(want) == 12
    assert [r["qid"] for r in got] == list(range(12))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("cand", "selected", "degraded", "provenance", "budget",
                    "host_contrib", "fusion_contrib"):
            assert g[key] == w[key], key
    assert all(r["host_contrib"].get("1", 0) == 0 for r in got[8:])
