"""The port's update CLI (`python -m repro_torch.launch.update_index`)
held to the JAX package's on the CPU: `--help` names every JAX flag;
`synth_delta` gives JAX's delta for one directory and seed (its float64
screen decides the nearest-centroid test as JAX's float32 expression
does, near-ties included); the CLI with `--check-parity` and `--compact`
returns 0 on a small port-built directory; `--trace-out` (.jsonl span
lines, Chrome JSON) and `--metrics-out` (.prom, JSON) hold the JAX CLI's
records: the same keys, span names and metric names, only the times
differ. The serve batches' traces are compared without two spans: the
port's `h2d` (its host-to-device copy of the fetched blocks, which the
JAX engine does not make) and `disk_fetch`, which either engine records
only when its prefetch thread has not yet filled the block cache.

Tolerance: none on the delta (arrays equal). At most 13 tests, as
test_torch_serving_v1.py says.
"""

import contextlib
import io
import json
import os
import shutil

import _torch_parity as tp  # first: it caps torch at 2 threads
import numpy as np
import pytest
import torch

from repro import index as jindex
from repro.launch import update_index as jcli
from repro_torch.index import IndexReader
from repro_torch.launch import update_index as tcli

JAX_FLAGS = ("--index-dir", "--upserts", "--deletes", "--append-frac",
             "--target-shards", "--seed", "--verify", "--serve-queries",
             "--batch", "--check-parity", "--compact",
             "--recluster-overflow", "--recluster-min-overflow",
             "--lloyd-iters", "--trace-out", "--metrics-out")


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_help_documents_every_flag():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    text = out.getvalue()
    for flag in JAX_FLAGS + ("--device",):
        assert flag in text, flag
    assert "shard-localized" in text and "repro_torch.launch.update_index" \
        in text


@pytest.fixture(scope="module")
def jstate(tmp_path_factory):
    return tp.jax_dirs_state(tmp_path_factory)


@pytest.mark.parametrize("kind,n_up,n_del,seed", [
    ("f32", 120, 40, 0), ("v2", 300, 10, 3), ("f32", 30, 500, 7)])
def test_synth_delta_matches_jax(jstate, kind, n_up, n_del, seed):
    *_, dirs = jstate
    jr = jindex.IndexReader.open(dirs[kind])
    tr = IndexReader.open(dirs[kind])
    jd, ji = jcli.synth_delta(jr, n_up, n_del, seed=seed, append_frac=0.4)
    td, ti = tcli.synth_delta(tr, n_up, n_del, seed=seed, append_frac=0.4)
    assert ti == ji
    for name in ("upsert_ids", "upsert_embeddings", "upsert_terms",
                 "upsert_weights", "delete_ids"):
        a, b = getattr(td, name), getattr(jd, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert td.n_upserts > 0


def test_nearest_in_range_screen_equals_the_float32_test():
    """The screen's decision against `argmin(((C - v) ** 2).sum(1)) < hi`
    on random candidates and on candidates built equidistant from an
    in-range and an out-of-range centroid (the screen falls back)."""
    rng = np.random.default_rng(0)
    C = rng.standard_normal((300, 48)).astype(np.float32)
    C /= np.linalg.norm(C, axis=1, keepdims=True) * 1.3
    c64 = C.astype(np.float64)
    c2 = (c64 * c64).sum(1)
    vs = [rng.standard_normal(48).astype(np.float32) for _ in range(200)]
    for _ in range(200):
        a, b = rng.integers(0, 100), rng.integers(100, 300)
        vs.append(C[a] + C[b] + 1e-7 * rng.standard_normal(48).astype(
            np.float32))
    hi = 100
    n_close = 0
    for v in vs:
        v = (v / np.linalg.norm(v)).astype(np.float32)
        want = int(np.argmin(((C - v) ** 2).sum(axis=1))) < hi
        assert tcli._nearest_in_range(C, c64, c2, v, hi) == want
        d2 = c2 - 2.0 * (c64 @ v.astype(np.float64))
        n_close += abs(d2[:hi].min() - d2[hi:].min()) <= tcli._SCREEN_MARGIN
    assert n_close > 50
    assert tcli._nearest_in_range(C, c64, c2, vs[0], len(C))


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """A small index built and written by the port on the CPU, with the
    synthetic-corpus recipe under extra (as the CLI needs)."""
    import dataclasses

    from repro_torch.configs import clusd_msmarco
    from repro_torch.core.clusd import build_index
    from repro_torch.data import synth_corpus
    from repro_torch.index import write_index

    cfg = dataclasses.replace(clusd_msmarco.smoke(), n_docs=2048)
    corpus = synth_corpus(3, cfg.n_docs, cfg.dim, cfg.vocab)
    index = build_index(cfg, corpus.embeddings, corpus.doc_terms,
                        corpus.doc_weights, kmeans_iters=4, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    out = str(tmp_path_factory.mktemp("cli") / "idx")
    write_index(out, cfg, index, corpus.embeddings, n_shards=4, extra={
        "corpus": {"kind": "synthetic", "seed": 3, "n_docs": cfg.n_docs,
                   "dim": cfg.dim, "vocab": cfg.vocab}})
    return out


def test_cli_check_parity_and_compact_return_0(port_dir, tmp_path):
    d = str(shutil.copytree(port_dir, tmp_path / "idx"))
    rc, out = _run(tcli.main, [
        "--index-dir", d, "--upserts", "60", "--deletes", "30",
        "--serve-queries", "16", "--batch", "8", "--check-parity",
        "--compact", "--device", "cpu"])
    assert rc == 0, out
    assert "committed generation 1" in out and "parity OK" in out
    assert "hot-reloaded to generation 1" in out
    assert "compacted -> generation 2" in out
    r = IndexReader.open(d, verify="full")
    assert r.generation == 2 and r.tombstones() is None
    assert r.geometry["n_docs"] == 2048 + 18
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp")]


UNMATCHED = ("h2d", "disk_fetch")


def _trace_records(path):
    if path.endswith(".jsonl"):
        with open(path) as f:
            recs = [json.loads(ln) for ln in f]
        return [(r["trace_name"], r["span"], r["depth"], sorted(r))
                for r in recs if r["span"] not in UNMATCHED]
    with open(path) as f:
        doc = json.load(f)
    assert sorted(doc) == ["displayTimeUnit", "traceEvents"]
    return [(e["cat"], e["name"], sorted(e), sorted(e["args"]))
            for e in doc["traceEvents"] if e["name"] not in UNMATCHED]


def _metric_names(path):
    with open(path) as f:
        text = f.read()
    if path.endswith(".prom"):
        return [ln.split()[0] if not ln.startswith("#") else ln
                for ln in text.splitlines()]
    snap = json.loads(text)
    return {sec: {k: sorted(v) if isinstance(v, dict) else None
                  for k, v in snap[sec].items()} for sec in snap}


@pytest.mark.parametrize("trace,metrics", [("t.jsonl", "m.prom"),
                                           ("t.json", "m.json")])
def test_trace_and_metrics_files_follow_jax(port_dir, tmp_path, trace,
                                            metrics):
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        d = str(shutil.copytree(port_dir, tmp_path / name))
        t, m = str(tmp_path / f"{name}_{trace}"), \
            str(tmp_path / f"{name}_{metrics}")
        rc, out = _run(main, [
            "--index-dir", d, "--upserts", "40", "--deletes", "10",
            "--serve-queries", "8", "--batch", "8", "--compact",
            "--trace-out", t, "--metrics-out", m] + extra)
        assert rc == 0, out
        outs[name] = (_trace_records(t), _metric_names(m))
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1] == outs["jax"][1]
    names = {r[1] for r in outs["port"][0]}
    assert {"write_index_delta", "apply_delta", "stage_blocks", "commit",
            "compact_index", "rewrite", "batch"} <= names


def test_registry_and_tracer_exports_equal_jax(tmp_path):
    """A registry holding the same values gives JAX's snapshot, JSON and
    Prometheus text; a tracer holding the same spans gives its records,
    span totals and Chrome events but for the times."""
    from repro.obs import registry as jreg
    from repro.obs import trace as jtrace
    from repro_torch.obs import registry as treg
    from repro_torch.obs import trace as ttrace

    texts = []
    for reg_mod, tr_mod in ((jreg, jtrace), (treg, ttrace)):
        reg = reg_mod.MetricsRegistry()
        reg.counter("serve.queries").inc(3)
        reg.counter("serve.adc_ms").inc(1.23456)
        reg.gauge("index.generation").set(2)
        h = reg.histogram("serve.batch_ms", ring=4)
        for v in (0.2, 3.0, 7.5, 120.0, 9000.0):
            h.observe(v)
        assert h.values() == [3.0, 7.5, 120.0, 9000.0]
        assert h.percentile(50) == 63.75 and h.mean() == 2282.625
        reg_mod.write_metrics(reg, str(tmp_path / "m.prom"))
        reg_mod.write_metrics(reg, str(tmp_path / "m.json"))
        tracer = tr_mod.Tracer(sample_rate=1.0)
        tr = tracer.trace("write_index_delta", n_upserts=2)
        sp = tr.span("load_state")
        sp.annotate(bytes=7).end()
        with tr.span("commit"):
            pass
        tr.finish(generation=1)
        tr_mod.write_trace(tracer, str(tmp_path / "t.jsonl"))
        tr_mod.write_trace(tracer, str(tmp_path / "t.json"))
        with open(tmp_path / "t.jsonl") as f:
            recs = [json.loads(ln) for ln in f]
        with open(tmp_path / "t.json") as f:
            events = json.load(f)["traceEvents"]
        for r in recs + events:
            for k in ("t0_ms", "dur_ms", "ts", "dur"):
                r.pop(k, None)
        totals = {k: v["count"] for k, v in tracer.span_totals().items()}
        texts.append((reg.snapshot(), reg.to_prometheus(),
                      open(tmp_path / "m.prom").read(),
                      open(tmp_path / "m.json").read(), recs, events,
                      totals))
    assert texts[1] == texts[0]
