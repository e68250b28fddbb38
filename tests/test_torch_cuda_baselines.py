"""The baselines on the card against the same functions on the CPU (the
kernels' plain versions), on a port-built smoke index.

Marked `cuda`: the `card` fixture skips them where no GPU is present. On
the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_baselines.py

Tolerances: ids equal at isolated ranks (1e-5), scores within rtol 1e-5,
atol 1e-6 (cluster_score's FMA chain and cuBLAS against the CPU's sums);
the CDFS mass bitwise; the kNN rows equal where the neighbour scores are
isolated.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state(card):
    from repro_torch.configs import clusd_msmarco
    from repro_torch.core.clusd import build_index
    from repro_torch.data import synth_corpus, synth_queries

    cfg = dataclasses.replace(clusd_msmarco.smoke(), n_docs=8192)
    corpus = synth_corpus(0, cfg.n_docs, cfg.dim, cfg.vocab)
    cpu = build_index(cfg, corpus.embeddings, corpus.doc_terms,
                      corpus.doc_weights,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    cpu.embeddings = torch.from_numpy(corpus.embeddings)
    qs = synth_queries(1, corpus, 32)
    return cfg, cpu, cpu.to(card), (qs.q_dense, qs.q_terms, qs.q_weights)


def _isolated(s, tol=1e-5):
    gap = np.abs(s[:, :-1] - s[:, 1:])
    ok = np.zeros(s.shape, bool)
    ok[:, :-1] = gap > tol
    ok[:, 1:-1] &= gap[:, :-1] > tol
    return ok


def assert_same(g, c):
    gi, gs = (x.cpu().numpy() for x in g[:2])
    ci, cs = (x.numpy() for x in c[:2])
    fin = np.isfinite(cs)
    assert (np.isfinite(gs) == fin).all()
    np.testing.assert_allclose(gs[fin], cs[fin], rtol=1e-5, atol=1e-6)
    ok = _isolated(np.where(fin, cs, -1e30)) & fin
    assert ok.any() and (gi[ok] == ci[ok]).all()


@pytest.mark.parametrize("name", ["ivf", "ivf_unfused", "rerank", "cdfs",
                                  "ladr"])
def test_baseline_on_the_card_matches_the_cpu(state, name):
    from repro_torch.core import baselines as bl

    cfg, cpu, gpu, q3 = state

    def run(index, knn):
        if name.startswith("ivf"):
            return bl.ivf_retrieve(cfg, index, *q3, 6,
                                   fuse_sparse=name == "ivf")
        if name == "rerank":
            return bl.rerank_retrieve(cfg, index, *q3)
        if name == "cdfs":
            return bl.cdfs_retrieve(cfg, index, *q3)
        return bl.ladr_retrieve(cfg, index, knn, *q3, n_seeds=16, depth=2,
                                budget=64)

    knn = bl.build_doc_knn(cpu, 8, 3) if name == "ladr" else None
    kernels.reset_launches()
    g = run(gpu, knn)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk"] > 0
    if name in ("ivf", "cdfs"):
        assert kernels.LAUNCHES["cluster_score"] > 0
    assert_same(g, run(cpu, knn))


def test_cdfs_mass_on_the_card_is_bitwise_the_cpu(state):
    from repro_torch.core import baselines as bl
    from repro_torch.core.sparse import sparse_retrieve_topk

    cfg, cpu, gpu, (_, qt, qw) = state
    sid, _ = sparse_retrieve_topk(cpu.sparse_index, torch.from_numpy(qt),
                                  torch.from_numpy(qw), cfg.k_sparse)
    got = bl.cdfs_mass(gpu, sid.to(gpu.device)).cpu()
    want = bl.cdfs_mass(cpu, sid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_doc_knn_on_the_card_matches_the_cpu(state):
    from repro_torch.core import baselines as bl

    cfg, cpu, gpu, _ = state
    kernels.reset_launches()
    got = bl.build_doc_knn(gpu, 8, 3, chunk=1000)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cluster_score"] == -(-cfg.n_docs // 1000)
    want = bl.build_doc_knn(cpu, 8, 3, chunk=1000).numpy()
    got = got.cpu().numpy()
    emb = cpu.embeddings.double().numpy()
    s = np.einsum("dnk,dk->dn", emb[want], emb)
    ok = _isolated(s)
    assert ok.mean() > 0.8 and (got[ok] == want[ok]).all()
