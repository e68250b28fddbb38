"""Package hygiene of repro_torch: it imports neither jax nor the JAX
package, and its entry points refuse to fall back to the CPU when no
card is present and the caller did not ask for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.join(os.path.dirname(__file__), "..")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "repro" or k.startswith("repro."))
missing = sorted({"repro_torch.index.update", "repro_torch.launch",
                  "repro_torch.launch.update_index", "repro_torch.train",
                  "repro_torch.train.labels", "repro_torch.train.trainer",
                  "repro_torch.train.calibrate", "repro_torch.train.publish",
                  "repro_torch.train.data", "repro_torch.optim",
                  "repro_torch.optim.adam", "repro_torch.common.tree",
                  "repro_torch.checkpoint.ckpt",
                  "repro_torch.core.train_lstm",
                  "repro_torch.launch.train_selector",
                  "repro_torch.launch.build_index",
                  "repro_torch.engine.router", "repro_torch.core.distributed",
                  "repro_torch.obs.slo", "repro_torch.obs.exporter",
                  "repro_torch.launch.serve"} - set(names))
from repro_torch.core.fusion import fuse_topk_merge  # noqa: F401
print(len(names), bad + missing)
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30 and bad == "[]", out.stdout


def test_chip_smoke_imports_nothing_of_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1].split(".")[0]
            assert mod not in ("jax", "jaxlib", "repro"), line


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_with_default_device_raise_without_a_card(no_card):
    from repro_torch.configs import clusd_msmarco
    from repro_torch.core import clusd, kmeans, quant
    from repro_torch.core.sparse import SparseIndex
    from repro_torch.device import resolve_device
    from repro_torch.engine import RetrievalEngine
    from repro_torch.index import (build_index_offline, compact_index,
                                   update, write_index_delta)
    from repro_torch.core.distributed import ServeMesh, ServeRunner
    from repro_torch.engine import EngineHost, ShardRouter
    from repro_torch.launch import (build_index, serve, train_selector,
                                    update_index)
    from repro_torch.train import (SelectorTrainer, make_labels_streaming,
                                   selector_probs,
                                   streaming_full_dense_topk)
    from repro_torch.train import train_selector as train_one_shot

    X = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    delta = update.IndexDelta(np.zeros(0), np.zeros((0, 8)), np.zeros((0, 2)),
                              np.zeros((0, 2)), [1])
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: kmeans.kmeans(X, 4, 2),
        lambda: quant.train_pq(X, 2, iters=1),
        lambda: SparseIndex.build(np.zeros((4, 2), np.int32),
                                  np.ones((4, 2), np.float32), 8, 4),
        lambda: clusd.build_index(clusd_msmarco.smoke(), X,
                                  np.zeros((64, 2), np.int32),
                                  np.ones((64, 2), np.float32)),
        lambda: kmeans.kmeans_shards([X[:32], X[32:]], 4, 2),
        lambda: quant.train_pq_stream(X, 2, iters=1),
        lambda: build_index_offline(clusd_msmarco.smoke(), X,
                                    np.zeros((64, 2), np.int32),
                                    np.ones((64, 2), np.float32)),
        lambda: write_index_delta("no-such-index", delta),
        lambda: compact_index("no-such-index"),
        lambda: update_index.main(["--index-dir", "no-such-index"]),
        lambda: SelectorTrainer(clusd_msmarco.smoke()).fit(
            None, np.zeros((2, 4, 9), np.float32), np.zeros((2, 4))),
        lambda: train_one_shot(clusd_msmarco.smoke(), None,
                               np.zeros((2, 4, 9), np.float32),
                               np.zeros((2, 4))),
        lambda: make_labels_streaming(clusd_msmarco.smoke(), None, None,
                                      X[:2], np.zeros((2, 2), np.int32),
                                      np.ones((2, 2), np.float32)),
        lambda: streaming_full_dense_topk(None, X[:2], 4),
        lambda: selector_probs({}, np.zeros((2, 4, 9), np.float32)),
        lambda: train_selector.main(["--index-dir", "no-such-index"]),
        lambda: build_index.main(["--out", "no-such-index"]),
        lambda: EngineHost(0, None, [0]),
        lambda: ShardRouter.local(None, 2),
        lambda: ServeRunner(clusd_msmarco.smoke(), ServeMesh(1, 1),
                            np.zeros((64, 4, 8), np.float32),
                            np.zeros((8, 1, 8), np.int32),
                            np.zeros((8, 1, 8), np.float32), X, X[:, :2],
                            X[:, :2], None),
        lambda: serve.main(["--index-dir", "no-such-index"]),
        lambda: serve.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

    class Store:
        is_host = is_coded = True
        cap, dim = 8, 8

    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalEngine(clusd_msmarco.smoke(), None, Store())
    assert resolve_device("cpu") == torch.device("cpu")
