"""The port's live observability (repro_torch.obs.slo, .exporter) against
the JAX package's on the same registry snapshots.

  * SLOMonitor: the same objectives over two registries driven through
    the same metric sequence, on one injected clock, give the same
    evaluate() results, states, events, status and verdict — latency,
    error-rate and gauge objectives, the default set and a JSON config
  * MetricsExporter: every route's payload and status code equal the
    JAX exporter's over equal registries, /healthz flips to 503 on an SLO
    page and on a shard without replicas and recovers, a failing stats()
    never breaks a scrape, a route error answers 500
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from repro import obs as jobs
from repro_torch import obs as tobs


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Target:
    """A serving target of one package: its registry, stats() and
    missing_shards()."""

    def __init__(self, pkg):
        self.metrics = pkg.MetricsRegistry()
        self.lost = []
        self.fail_stats = False

    def stats(self):
        if self.fail_stats:
            raise RuntimeError("mid-reload")
        self.metrics.gauge("target.synced").inc()
        return {}

    def missing_shards(self):
        return list(self.lost)


def _drive(reg, step):
    """One step of a metric sequence: latencies, requests, errors, drift."""
    h = reg.histogram("serve.batch_ms", ring=64)
    for v in (10.0 + 40.0 * (step % 5), 5.0, 900.0 if step in (6, 7) else 1):
        h.observe(v)
    reg.counter("soak.requests").inc(10)
    if step in (3, 4, 9):
        reg.counter("soak.failed_requests").inc(step % 3 + 1)
    reg.gauge("soak.recall_drift").set(0.01 * (step % 7))


def _pair(objectives_fn, **kw):
    out = []
    for pkg in (tobs, jobs):
        reg, clock = pkg.MetricsRegistry(), _Clock()
        out.append((pkg, reg, clock,
                    pkg.SLOMonitor(reg, objectives_fn(pkg), clock=clock,
                                   **kw)))
    return out


@pytest.mark.parametrize("objectives", ["default", "custom"])
def test_slo_monitor_matches_jax_over_a_metric_sequence(objectives):
    def objs(pkg):
        if objectives == "default":
            return pkg.default_objectives(p99_gate_ms=200.0,
                                          failure_budget=0.05)
        return [pkg.SLOObjective("lat", "latency", "serve.batch_ms", 100.0,
                                 fast_window_s=5, slow_window_s=20,
                                 warn_burn=0.5, page_burn=1.5),
                pkg.SLOObjective("err", "error_rate", "soak.failed_requests",
                                 0.0, total="soak.requests",
                                 fast_window_s=5, slow_window_s=20),
                pkg.SLOObjective("drift", "gauge", "soak.recall_drift",
                                 0.04, fast_window_s=5, slow_window_s=20)]
    pair = _pair(objs, event_capacity=8, max_samples=16)
    for step in range(24):
        got = []
        for pkg, reg, clock, mon in pair:
            _drive(reg, step)
            clock.t += 3.0
            got.append(mon.evaluate())
        assert got[0] == got[1], step
    (_, _, _, t), (_, _, _, j) = pair
    assert t.state == j.state
    assert t.status() == j.status()
    assert t.verdict() == j.verdict()
    assert list(t.events) == list(j.events) and len(t.events) > 0


def test_slo_objectives_validate_and_load_like_jax(tmp_path):
    bad = [dict(name="x", kind="nope", metric="m", threshold=1.0),
           dict(name="x", kind="error_rate", metric="m", threshold=1.0),
           dict(name="x", kind="gauge", metric="m", threshold=-1.0),
           dict(name="x", kind="gauge", metric="m", threshold=1.0,
                fast_window_s=10, slow_window_s=5)]
    for d in bad:
        for pkg in (tobs, jobs):
            with pytest.raises(ValueError):
                pkg.SLOObjective(**d)
    cfg = {"objectives": [dict(name="lat", kind="latency",
                               metric="serve.batch_ms", threshold=50.0)]}
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(cfg))
    t = tobs.SLOMonitor.from_config(tobs.MetricsRegistry(), str(path))
    j = jobs.SLOMonitor.from_config(jobs.MetricsRegistry(), str(path))
    assert t.objectives[0] == tobs.SLOObjective(**cfg["objectives"][0])
    assert t.evaluate()["objectives"] == j.evaluate()["objectives"]
    with pytest.raises(ValueError):
        tobs.SLOObjective.from_dict({"name": "x", "bogus": 1})
    with pytest.raises(ValueError):
        tobs.SLOMonitor(tobs.MetricsRegistry(), [])


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _exporters(slo_threshold=None):
    out = []
    for pkg in (tobs, jobs):
        target = _Target(pkg)
        target.metrics.counter("serve.queries").inc(7)
        target.metrics.histogram("serve.batch_ms").observe(3.0)
        slo = None
        if slo_threshold is not None:
            slo = pkg.SLOMonitor(target.metrics, [pkg.SLOObjective(
                "lat", "latency", "serve.batch_ms", slo_threshold,
                fast_window_s=0.0, slow_window_s=0.0)], clock=_Clock())
        out.append((target, pkg.MetricsExporter(target, port=0,
                                                slo=slo).start()))
    return out


def test_exporter_routes_match_jax():
    pair = _exporters(slo_threshold=100.0)
    try:
        for path in ("/metrics", "/metrics.json", "/slo", "/healthz",
                     "/nope"):
            (tc, tb), (jc, jb) = [_get(e.port, path) for _, e in pair]
            assert tc == jc, path
            if path in ("/metrics.json", "/slo", "/healthz", "/nope"):
                assert json.loads(tb) == json.loads(jb), path
            else:
                assert tb == jb
        code, body = _get(pair[0][1].port, "/metrics")
        assert code == 200 and "serve_queries 7" in body
        assert "target_synced" in body          # stats() ran first
    finally:
        for _, e in pair:
            e.stop()


def test_healthz_flips_on_page_and_shard_loss_like_jax():
    pair = _exporters(slo_threshold=1.0)        # 3 ms > 1 ms: pages
    try:
        for target, exp in pair:
            code, body = _get(exp.port, "/healthz")
            assert code == 503 and "slo_page" in json.loads(body)["reasons"]
        pair2 = _exporters()
        for (target, exp) in pair2:
            assert _get(exp.port, "/healthz")[0] == 200
            target.lost = [2, 0]
            code, body = _get(exp.port, "/healthz")
            assert code == 503
            assert json.loads(body)["reasons"] == \
                ["shards_without_replicas:[0, 2]"]
            target.lost = []
            assert _get(exp.port, "/healthz")[0] == 200
            target.fail_stats = True            # a scrape never raises
            assert _get(exp.port, "/metrics")[0] == 200
            exp.stop()
    finally:
        for _, e in pair:
            e.stop()


def test_concurrent_scrapes_during_mutation():
    target = _Target(tobs)
    stop = threading.Event()

    def mutate():
        c = target.metrics.counter("serve.queries")
        while not stop.is_set():
            c.inc()
            target.metrics.histogram("serve.batch_ms").observe(1.0)

    t = threading.Thread(target=mutate)
    t.start()
    try:
        with tobs.MetricsExporter(target, port=0) as exp:
            codes = []

            def scrape():
                for _ in range(10):
                    codes.append(_get(exp.port, "/metrics.json")[0])
            threads = [threading.Thread(target=scrape) for _ in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
    finally:
        stop.set()
        t.join(timeout=30)
    assert codes == [200] * 40


def test_route_error_answers_500():
    target = _Target(tobs)
    with tobs.MetricsExporter(target, port=0) as exp:
        target.metrics = None               # every render now fails
        code, body = _get(exp.port, "/metrics")
        assert code == 500 and "error" in json.loads(body)
        assert _get(exp.port, "/healthz")[0] == 200
