"""The port's train_selector and build_index CLIs on `--device cpu`.

The CLIs draw their initial params (and build_index its k-means seed
rows and PQ sample) from torch.Generators, not jax.random, so a CLI run
is held to the port's own library calls with the same generators, and
its directory to being read and served by the JAX package's reader:

  * `--help`: every JAX flag of each CLI, plus `--device`, and the
    module docstring as the epilog;
  * train_selector `--publish --serve-check`: the published weights are
    bitwise those of `make_labels_streaming` + `SelectorTrainer.fit` +
    calibration run by hand; the generation serves in the JAX reader;
    `--resume` hits the label cache and has no steps left;
    `--trace-out` / `--metrics-out` hold the JAX CLI's span and metric
    names (only the times differ); `--expand-depths` retrains;
  * build_index (v1 with a trained selector, and v2 from an np.memmap):
    the port's reader and the JAX reader open it and serve the same ids
    (isolated ranks).
"""

import contextlib
import io
import json
import os
import re
import shutil

import _torch_parity as tp  # first: it caps torch at 2 threads
import numpy as np
import pytest
import torch

from repro.launch import build_index as jbuild
from repro.launch import train_selector as jtrain_cli
from repro_torch import train as train_lib
from repro_torch.data import synth_corpus, synth_queries
from repro_torch.index import IndexReader
from repro_torch.launch import build_index as tbuild
from repro_torch.launch import train_selector as ttrain_cli


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _help(main):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    return out.getvalue()


def _flags(text):
    return set(re.findall(r"(--[a-z][a-z-]+)", text.split("\n\n", 2)[2]
                          .split("Selector training CLI")[0]
                          .split("Offline index build CLI")[0]))


@pytest.mark.parametrize("pair", ["train_selector", "build_index"])
def test_help_carries_every_jax_flag_and_the_docstring(pair):
    t, j = {"train_selector": (ttrain_cli, jtrain_cli),
            "build_index": (tbuild, jbuild)}[pair]
    tflags, jflags = _flags(_help(t.main)), _flags(_help(j.main))
    assert jflags and tflags == jflags | {"--device"}
    assert t.__doc__.strip().splitlines()[0] in _help(t.main)
    assert f"repro_torch.launch.{pair}" in _help(t.main)


@pytest.fixture(scope="module")
def jdirs(tmp_path_factory):
    return tp.jax_train_dirs(tmp_path_factory.mktemp("cli"))


TRAIN_ARGS = ["--train-queries", "32", "--holdout-queries", "16",
              "--epochs", "3", "--batch-size", "8", "--chunk-clusters", "8",
              "--ckpt-every", "4", "--target-recall", "0.8",
              "--thetas", "0.02,0.1,0.3", "--budgets", "2,4,8"]


def _library_run(path, seed=0):
    """What the CLI computes, by the library's own calls on a copy of the
    directory at generation 0."""
    reader = IndexReader.open(path)
    cfg, index = reader.load_index(device="cpu")
    store = reader.open_store(cluster_docs=index.cluster_docs)
    meta = reader.manifest["extra"]["corpus"]
    corpus = synth_corpus(meta["seed"], meta["n_docs"], meta["dim"],
                          meta["vocab"])
    tq = synth_queries(seed + 21, corpus, 32)
    hq = synth_queries(seed + 22, corpus, 16)
    lc = train_lib.LabelConfig(chunk_clusters=8)
    ls = [train_lib.make_labels_streaming(cfg, index, store, q.q_dense,
                                          q.q_terms, q.q_weights,
                                          label_cfg=lc, device="cpu")
          for q in (tq, hq)]
    tr = train_lib.SelectorTrainer(cfg, train_lib.SelectorTrainConfig(
        epochs=3, batch_size=8, seed=seed), device="cpu")
    params, _ = tr.fit(torch.Generator().manual_seed(seed + 2),
                       ls[0].feats, ls[0].labels)
    probs = train_lib.selector_probs(params, ls[1].feats, device="cpu")
    table = train_lib.calibration_table(
        ls[1], probs, index.doc_cluster,
        thetas=sorted({0.02, 0.1, 0.3, cfg.theta}), budgets=[2, 4, 8],
        block_bytes=store.block_bytes)
    op = train_lib.choose_operating_point(table, target_recall=0.8)
    return params, table, op


def test_train_selector_cli_equals_the_library_and_serves_in_jax(jdirs,
                                                                 tmp_path):
    from repro.index import IndexReader as JReader
    *_, dirs, _ = jdirs
    work = str(tmp_path / "idx")
    shutil.copytree(dirs["v1"], work)
    rc, out = _run(ttrain_cli.main, ["--index-dir", work, *TRAIN_ARGS,
                                     "--publish", "--serve-check", "8",
                                     "--verify", "full", "--device", "cpu"])
    assert rc == 0, out
    assert "serve check OK: 8 queries" in out and "device cpu" in out
    params, table, op = _library_run(dirs["v1"])
    reader = IndexReader.open(work, verify="full")
    assert reader.generation == 1
    got = reader.lstm_params()
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    meta = reader.selector_meta()
    assert meta["calibration"] == table
    assert (meta["theta"], meta["budget"]) == (op["theta"], op["budget"])
    assert json.loads(out.strip().splitlines()[-1])["operating_point"] == op
    jreader = JReader.open(work, verify="full")
    assert jreader.generation == 1 and jreader.config().theta == op["theta"]
    qs = synth_queries(5, synth_corpus(0, 512, 16, 256), 24)
    tp.assert_same_results(tp.serve_torch(work, qs), tp.serve_jax(work, qs))

    # --resume: both label sets from the cache, no steps left
    rc, out = _run(ttrain_cli.main, ["--index-dir", work, *TRAIN_ARGS,
                                     "--resume", "--device", "cpu"])
    assert rc == 0, out
    assert out.count("(cache hit)") == 2
    assert "no steps left (resumed a finished run)" in out


def _spans(path):
    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    return sorted({(r["trace_name"], r["span"]) for r in recs
                   if r["trace_name"] == "train_selector"})


def _metric_names(path):
    return sorted(ln.split("{")[0].split(" ")[0] for ln in open(path)
                  if ln and not ln.startswith("#"))


def test_trace_metrics_and_expand_depths_hold_the_jax_cli(jdirs, tmp_path):
    *_, dirs, _ = jdirs
    names = {}
    for who, main in (("port", ttrain_cli.main), ("jax", jtrain_cli.main)):
        work = str(tmp_path / who)
        shutil.copytree(dirs["v2"], work)
        argv = ["--index-dir", work, *TRAIN_ARGS, "--use-kernel", "0",
                "--expand-depths", "0,1", "--publish",
                "--trace-out", str(tmp_path / f"{who}.jsonl"),
                "--metrics-out", str(tmp_path / f"{who}.prom")]
        if who == "port":
            argv += ["--device", "cpu"]
        rc, out = _run(main, argv)
        assert rc == 0, out
        last = json.loads(out.strip().splitlines()[-1])
        assert last["hybrid"]["depth"] in (0, 1)
        assert [d["depth"] for d in last["hybrid"]["sweep"]] == [0, 1]
        names[who] = (_spans(str(tmp_path / f"{who}.jsonl")),
                      _metric_names(str(tmp_path / f"{who}.prom")))
        assert IndexReader.open(work).manifest["config"]["expand_depth"] \
            == last["hybrid"]["depth"]
    assert names["port"] == names["jax"]
    assert ("train_selector", "hybrid") in names["port"][0]
    assert any(n.startswith("train_steps") for n in names["port"][1])


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_build_index_cli_directory_serves_in_both_readers(tmp_path, fmt):
    out_dir = str(tmp_path / fmt)
    argv = ["--out", out_dir, "--docs", "1024", "--dim", "16", "--clusters",
            "32", "--vocab", "256", "--shards", "2", "--epochs", "2",
            "--kmeans-iters", "4", "--device", "cpu"]
    argv += ["--train-queries", "32"] if fmt == "v1" else \
        ["--train-queries", "0", "--format-version", "2", "--memmap",
         "--chunk-docs", "256", "--pq-nsub", "4"]
    rc, out = _run(tbuild.main, argv)
    assert rc == 0, out
    reader = IndexReader.open(out_dir, verify="full")
    assert reader.format_version == (1 if fmt == "v1" else 2)
    assert reader.manifest["extra"]["corpus"]["n_docs"] == 1024
    assert (reader.manifest["lstm"] is not None) == (fmt == "v1")
    if fmt == "v1":
        assert "loss" in out
    qs = synth_queries(4, synth_corpus(0, 1024, 16, 256), 16)
    tp.assert_same_results(tp.serve_torch(out_dir, qs),
                           tp.serve_jax(out_dir, qs))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
