"""The port's serve CLI (repro_torch.launch.serve) on `--device cpu`
against the JAX CLI (repro.launch.serve) on the same JAX-written
directories (the tiny train index: v1 and v2, 3 shards, the synthetic
corpus recipe under `extra`).

  * --help carries every flag of the JAX CLI, and --device
  * the same exit code and printed MRR@10 on the single-host path (v1
    exact parity, v2 the PQ MRR bound), the --hosts path with a killed
    replica (R 2: parity OK, 0 failed), a killed only replica (R 1:
    degraded, parity fails, exit 1) and an updated directory (parity
    unavailable, exit 1)
  * --trace-out / --metrics-out / --explain-out carry the JAX CLI's span,
    metric and record names; --metrics-port serves /healthz and /metrics
    mid-run under --serve-seconds
  * the build-and-serve path (no --index-dir) with --ondisk
"""

import contextlib
import io
import json
import re
import shutil
import sys
import threading
import time
import urllib.request

import _torch_parity as tp  # first: it caps torch at 2 threads
import pytest

from repro.launch import serve as jserve
from repro_torch.index import write_index_delta
from repro_torch.index import IndexReader
from repro_torch.launch import serve as tserve
from repro_torch.launch.update_index import synth_delta

BASE = ["--queries", "24", "--batch", "8"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return tp.jax_train_dirs(tmp_path_factory.mktemp("serve_cli"))[3]


def _run_jax(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    rc = jserve.main()
    return rc, capsys.readouterr().out


def _run_torch(argv, capsys):
    rc = tserve.main(argv + ["--device", "cpu"])
    return rc, capsys.readouterr().out


def _mrr(out):
    return re.findall(r"MRR@10=([0-9.]+)", out)


def _both(argv, capsys, monkeypatch):
    j = _run_jax(argv, capsys, monkeypatch)
    t = _run_torch(argv, capsys)
    assert t[0] == j[0], (t[1], j[1])
    assert _mrr(t[1]) == _mrr(j[1]) and _mrr(t[1])
    return t, j


def test_help_carries_the_jax_flags(capsys, monkeypatch):
    flags = {}
    for name, main in (("jax", jserve.main), ("torch", tserve.main)):
        monkeypatch.setattr(sys, "argv", ["serve", "--help"])
        with pytest.raises(SystemExit) as e:
            main() if name == "jax" else main(["--help"])
        assert e.value.code == 0
        out = capsys.readouterr().out
        flags[name] = set(re.findall(r"^  (--[a-z][a-z-]+)", out, re.M))
        assert "Usage:" in out                  # the docstring epilog
    assert flags["jax"] <= flags["torch"] and len(flags["jax"]) > 20
    assert "--device" in flags["torch"]


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_single_host_check_parity_like_jax(dirs, fmt, capsys, monkeypatch):
    (rc, out), _ = _both(["--index-dir", dirs[fmt], *BASE,
                          "--check-parity"], capsys, monkeypatch)
    assert rc == 0 and "parity OK" in out


def test_hosts_with_a_killed_replica_like_jax(dirs, capsys, monkeypatch):
    (rc, out), (_, jout) = _both(
        ["--index-dir", dirs["v2"], *BASE, "--hosts", "3", "--replication",
         "2", "--kill-host", "1", "--check-parity"], capsys, monkeypatch)
    assert rc == 0 and "parity OK: 3-host" in out
    line = [ln for ln in out.splitlines() if ln.startswith("served")]
    assert line == [ln for ln in jout.splitlines()
                    if ln.startswith("served")]
    assert "failed=0" in line[0] and "failovers=0" not in line[0]


def test_killed_only_replica_fails_parity_like_jax(dirs, capsys,
                                                   monkeypatch):
    (rc, out), _ = _both(
        ["--index-dir", dirs["v1"], *BASE, "--hosts", "3", "--kill-host",
         "1", "--check-parity"], capsys, monkeypatch)
    assert rc == 1 and "PARITY FAIL" in out and "degraded=2" in out


def test_updated_directory_has_no_parity_like_jax(dirs, tmp_path, capsys,
                                                  monkeypatch):
    path = str(shutil.copytree(dirs["v1"], tmp_path / "upd"))
    delta, _ = synth_delta(IndexReader.open(path), 8, 4, seed=0)
    write_index_delta(path, delta, device="cpu")
    (rc, out), _ = _both(["--index-dir", path, *BASE, "--check-parity"],
                         capsys, monkeypatch)
    assert rc == 1 and "PARITY UNAVAILABLE" in out


def _names(path):
    if path.endswith(".jsonl"):
        return {json.loads(ln)["name"] for ln in open(path)}
    return {ev["name"] for ev in json.load(open(path))["traceEvents"]}


def test_trace_metrics_and_explain_files_like_jax(dirs, tmp_path, capsys,
                                                  monkeypatch):
    files = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        argv = ["--index-dir", dirs["v2"], *BASE, "--hosts", "2",
                "--trace-out", str(d / "t.json"),
                "--metrics-out", str(d / "m.json"),
                "--explain-out", str(d / "e.jsonl")]
        rc, _ = _run_jax(argv, capsys, monkeypatch) if pkg == "jax" \
            else _run_torch(argv, capsys)
        assert rc == 0
        files[pkg] = d
    assert _names(str(files["torch"] / "t.json")) == \
        _names(str(files["jax"] / "t.json"))
    tm, jm = (json.load(open(files[p] / "m.json")) for p in ("torch", "jax"))
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(tm[kind]) == sorted(jm[kind]), kind
    tr, jr = ([json.loads(ln) for ln in open(files[p] / "e.jsonl")]
              for p in ("torch", "jax"))
    assert len(tr) == len(jr) == 24
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    assert [r["host_contrib"] for r in tr] == [r["host_contrib"] for r in jr]


def test_metrics_port_serves_mid_run(dirs, tmp_path):
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"objectives": [
        {"name": "lat", "kind": "latency", "metric": "serve.batch_ms",
         "threshold": 1e6}]}))
    buf = io.StringIO()
    result = {}

    def run():
        with contextlib.redirect_stdout(buf):
            result["rc"] = tserve.main(
                ["--index-dir", dirs["v2"], *BASE, "--hosts", "3",
                 "--replication", "2", "--kill-host", "1",
                 "--metrics-port", "0", "--slo-config", str(slo),
                 "--serve-seconds", "4", "--device", "cpu"])

    t = threading.Thread(target=run)
    t.start()
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            m = re.search(r"127\.0\.0\.1:(\d+)/metrics", buf.getvalue())
            port = m and int(m.group(1))
            time.sleep(0.05)
        assert port, buf.getvalue()
        seen = ""
        while "router_hosts_alive 2" not in seen and \
                time.monotonic() < deadline:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=5) as r:
                assert r.status == 200
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=5) as r:
                seen = r.read().decode()
            time.sleep(0.1)
        assert "router_hosts_alive 2" in seen
    finally:
        t.join(timeout=120)
    assert not t.is_alive() and result["rc"] == 0
    out = buf.getvalue()
    assert "SLO state: OK" in out and "sustained serving" in out


def test_build_and_serve_path_with_ondisk(capsys):
    rc, out = _run_torch(["--docs", "1500", "--dim", "16", "--clusters",
                          "32", "--queries", "32", "--batch", "16",
                          "--epochs", "2", "--ondisk"], capsys)
    assert rc == 0
    for head in ("LSTM trained", "CluSD   MRR@10=", "oracle-dense MRR@10=",
                 "on-disk engine:"):
        assert head in out, out
