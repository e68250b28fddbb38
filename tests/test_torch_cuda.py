"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: adc_tables, adc_score_blocks, topk (values and ids) and
bin_overlap (P and Q) bitwise; lstm_sequence atol 1e-5;
cluster_score rtol 1e-5, atol 1e-5 on dot products of unit scale (FMA
in lane order and a shuffle tree against the einsum's order); the v1
engine on the card against the CPU: ids at isolated ranks, scores rtol
1e-5, atol 1e-6, and so are the device-store engines.
"""

import pytest
import torch
from _torch_parity import isolated_ranks

from repro_torch import kernels
from repro_torch.kernels.cluster_score import cluster_score, cluster_score_ref
from repro_torch.kernels.adc import (adc_score_blocks, adc_score_blocks_ref,
                                     adc_tables, adc_tables_ref)
from repro_torch.kernels.bin_overlap import bin_overlap, bin_overlap_ref
from repro_torch.kernels.lstm import lstm_sequence, lstm_sequence_ref
from repro_torch.kernels.topk import topk, topk_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen():
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,nsub,dsub,K", [(3, 8, 4, 256), (2, 5, 3, 17),
                                           (64, 96, 8, 256),
                                           (256, 96, 8, 256),
                                           (33, 3, 24, 17), (40, 4, 1, 5),
                                           (7, 2, 16, 300)])
def test_adc_tables_kernel_vs_plain(card, B, nsub, dsub, K):
    """Bitwise: K below 32, dsub above the 16 kept in registers, a batch
    that is no multiple of the query tile, and exact zeros in q (a -0.0
    product must stay -0.0 at dsub 1)."""
    g = _gen()
    q = torch.randn(B, nsub * dsub, device=card, generator=g)
    q[:, ::5] = 0.0
    books = torch.randn(nsub, K, dsub, device=card, generator=g)
    before = kernels.LAUNCHES["adc_tables"]
    out = adc_tables(q, books)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["adc_tables"] == before + 1
    assert torch.equal(out.view(torch.int32),
                       adc_tables_ref(q, books).view(torch.int32))


@pytest.mark.parametrize("B,nsub,U,cap,S", [(3, 8, 6, 16, 4),
                                            (2, 5, 3, 7, 5),
                                            (16, 96, 64, 256, 32)])
def test_adc_score_blocks_kernel_bitwise(card, B, nsub, U, cap, S):
    g = _gen()
    lut = torch.randn(B, nsub, 256, device=card, generator=g)
    codes = torch.randint(0, 256, (U, cap, nsub), device=card, generator=g,
                          dtype=torch.uint8)
    sel = torch.randint(0, U, (B, S), device=card, generator=g,
                        dtype=torch.int32)
    out = adc_score_blocks(lut, codes, sel)
    torch.cuda.synchronize()
    assert torch.equal(out, adc_score_blocks_ref(lut, codes, sel))


def test_adc_score_blocks_rejects_bad_inputs(card):
    lut = torch.randn(2, 4, 256, device=card)
    codes = torch.zeros(3, 8, 4, dtype=torch.uint8, device=card)
    with pytest.raises(TypeError):
        adc_score_blocks(lut, codes, torch.zeros(2, 2, dtype=torch.int64,
                                                 device=card))
    with pytest.raises(ValueError):
        adc_score_blocks(lut, codes, torch.zeros(2, 2, dtype=torch.int32))


@pytest.mark.parametrize("B,n,F,H", [(256, 32, 21, 32), (5, 7, 13, 16)])
def test_lstm_sequence_kernel_vs_plain(card, B, n, F, H):
    g = _gen()
    x = torch.randn(B, n, F, device=card, generator=g)
    wx = torch.randn(F, 4 * H, device=card, generator=g) / F ** 0.5
    wh = torch.randn(H, 4 * H, device=card, generator=g) / H ** 0.5
    b = 0.1 * torch.randn(4 * H, device=card, generator=g)
    out = lstm_sequence(x, wx, wh, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, lstm_sequence_ref(x, wx, wh, b),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,dim,U,cap,S", [(3, 13, 5, 7, 4), (4, 32, 9, 16, 3),
                                           (64, 768, 300, 256, 32)])
def test_cluster_score_kernel_vs_plain(card, B, dim, U, cap, S):
    g = _gen()
    # unit-scale dot products, as between L2-normalised embeddings
    q = torch.randn(B, dim, device=card, generator=g) / dim ** 0.25
    blocks = torch.randn(U, cap, dim, device=card, generator=g) / dim ** 0.25
    sel = torch.randint(0, U, (B, S), device=card, generator=g,
                        dtype=torch.int32)
    before = kernels.LAUNCHES["cluster_score"]
    out = cluster_score(q, blocks, sel)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cluster_score"] == before + 1
    torch.testing.assert_close(out, cluster_score_ref(q, blocks, sel),
                               rtol=1e-5, atol=1e-5)


def test_cluster_score_empty_selection_and_bad_inputs(card):
    q = torch.randn(3, 16, device=card)
    before = kernels.LAUNCHES["cluster_score"]
    out = cluster_score(q, torch.zeros(1, 8, 16, device=card),
                        torch.zeros(3, 0, dtype=torch.int32, device=card))
    assert out.shape == (3, 0, 8)
    assert kernels.LAUNCHES["cluster_score"] == before   # no empty launch
    out = cluster_score(q, torch.zeros(1, 8, 16, device=card),
                        torch.zeros(3, 2, dtype=torch.int32, device=card))
    torch.cuda.synchronize()
    assert out.shape == (3, 2, 8) and not out.any()
    with pytest.raises(TypeError):
        cluster_score(q, torch.zeros(2, 8, 16, device=card),
                      torch.zeros(3, 2, dtype=torch.int64, device=card))
    with pytest.raises(ValueError):
        cluster_score(q, torch.zeros(2, 8, 16, device=card),
                      torch.zeros(3, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        cluster_score(q, torch.zeros(2, 8, 15, device=card),
                      torch.zeros(3, 2, dtype=torch.int32, device=card))


def test_v1_engine_on_the_card_matches_the_cpu(card, tmp_path):
    """The port's own build and writer at smoke widths, then the same v1
    directory served through IndexReader.engine on the card and on the
    CPU; the card's engine launches cluster_score and lstm_sequence."""
    import numpy as np

    from repro_torch.configs import clusd_msmarco
    from repro_torch.core import clusd
    from repro_torch.core.features import feature_dim
    from repro_torch.core.lstm import LSTMSelector
    from repro_torch.data import synth_corpus, synth_queries
    from repro_torch.index import IndexReader, write_index

    cfg = clusd_msmarco.smoke()
    corpus = synth_corpus(1, cfg.n_docs, cfg.dim, cfg.vocab)
    g = torch.Generator().manual_seed(0)
    index = clusd.build_index(cfg, corpus.embeddings, corpus.doc_terms,
                              corpus.doc_weights, kmeans_iters=5,
                              generator=g, device="cpu")
    index.selector = LSTMSelector(feature_dim(cfg), cfg.lstm_hidden,
                                  generator=g)
    write_index(str(tmp_path / "v1"), cfg, index, corpus.embeddings)
    qs = synth_queries(2, corpus, 32)
    q3 = (qs.q_dense, qs.q_terms, qs.q_weights)
    kernels.reset_launches()
    with IndexReader.open(str(tmp_path / "v1")).engine(max_batch=16) as eng:
        g_ids, g_sc = (t.cpu().numpy() for t in eng.retrieve(*q3))
    assert kernels.LAUNCHES["cluster_score"] == 2
    assert kernels.LAUNCHES["lstm_sequence"] == 2
    with IndexReader.open(str(tmp_path / "v1")).engine(
            max_batch=16, device="cpu") as eng:
        c_ids, c_sc = (t.numpy() for t in eng.retrieve(*q3))
    ok = isolated_ranks(c_sc)
    np.testing.assert_array_equal(g_ids[ok], c_ids[ok])
    np.testing.assert_allclose(g_sc, c_sc, rtol=1e-5, atol=1e-6)


def _topk_rows(case, g):
    """(x, k) on the card: the shapes the main path gives topk."""
    dev = "cuda"
    if case == "fused":           # (256, 2^20) view, ~9000 valid entries
        buf = torch.zeros(256, (1 << 20) + 1, device=dev)
        at = torch.randint(0, 1 << 20, (256, 9000), device=dev, generator=g)
        buf.scatter_(1, at, torch.rand(256, 9000, device=dev, generator=g))
        buf[:, -1] = 7.0                                # the dump column
        return buf[:, :1 << 20], 1000
    if case == "sparse_few":      # fewer than k nonzero: zeros fill in
        x = torch.zeros(64, 1 << 20, device=dev)
        at = torch.randint(0, 1 << 20, (64, 300), device=dev, generator=g)
        x.scatter_(1, at, torch.rand(64, 300, device=dev, generator=g))
        return x, 1000
    if case == "stage2":          # the budget mask, k == D
        x = torch.rand(256, 32, device=dev, generator=g)
        x[x < 0.5] = -torch.inf
        x[3] = -torch.inf
        return x, 32
    if case == "sort_by_dist":
        return torch.randn(256, 8192, device=dev, generator=g), 32
    if case == "neighbors":
        x = torch.randn(8192, 8192, device=dev, generator=g)
        return x - 2e9 * torch.eye(8192, device=dev), 128
    if case == "ties":            # few distinct values, signed zeros
        vals = torch.tensor([0.0, -0.0, 1.0, -1.0, 0.5], device=dev)
        pick = torch.randint(0, 5, (16, 20000), device=dev, generator=g)
        return vals[pick], 2048
    raise ValueError(case)


@pytest.mark.parametrize("case", ["fused", "sparse_few", "stage2",
                                  "sort_by_dist", "neighbors", "ties"])
def test_topk_kernel_bitwise_vs_plain(card, case):
    x, k = _topk_rows(case, _gen())
    before = kernels.LAUNCHES["topk"]
    v, i = topk(x, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk"] == before + 1
    rv, ri = topk_ref(x, k)
    assert torch.equal(i, ri)
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32))


def test_topk_rejects_bad_inputs(card):
    x = torch.randn(4, 3000, device=card)
    with pytest.raises(ValueError, match="over the"):
        topk(x, 2049)
    with pytest.raises(TypeError):
        topk(x.double(), 5)
    with pytest.raises(ValueError, match="contiguous rows"):
        topk(x.T, 2)
    with pytest.raises(ValueError, match="2-D"):
        topk(x[0], 2)
    v, i = topk(x, 0)
    assert v.shape == i.shape == (4, 0)


@pytest.mark.parametrize("per_query_bins", [False, True])
def test_bin_overlap_kernel_bitwise_vs_plain(card, per_query_bins):
    g = _gen()
    B, k, N, v = 256, 1000, 8192, 7
    c_of = torch.randint(0, N, (B, k), device=card, generator=g,
                         dtype=torch.int32)
    c_of[:, 500:] = c_of[:, :500]             # runs of equal clusters
    bins = torch.bucketize(torch.arange(k, device=card), torch.tensor(
        [10, 25, 50, 100, 200, 500, 1000], device=card), right=True).int()
    if per_query_bins:
        bins = bins.expand(B, k).contiguous()
    scores = torch.rand(B, k, device=card, generator=g)
    before = kernels.LAUNCHES["bin_overlap"]
    P, Q = bin_overlap(c_of, bins, scores, n_clusters=N, v=v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bin_overlap"] == before + 1
    # the plain version on the card adds with atomics: hold the kernel to
    # its sequential order on the CPU
    rP, rQ = bin_overlap_ref(c_of.cpu(), bins.cpu(), scores.cpu(),
                             n_clusters=N, v=v)
    assert (P > 1).any()
    assert torch.equal(P.cpu(), rP)
    assert torch.equal(Q.cpu().view(torch.int32), rQ.view(torch.int32))


def test_bin_overlap_rejects_bad_inputs(card):
    c = torch.zeros(2, 8, dtype=torch.int32, device=card)
    s = torch.zeros(2, 8, device=card)
    b = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        bin_overlap(c.long(), b, s, n_clusters=4, v=2)
    with pytest.raises(ValueError):
        bin_overlap(c, torch.zeros(7, dtype=torch.int32, device=card), s,
                    n_clusters=4, v=2)
    with pytest.raises(ValueError):
        bin_overlap(c, b.cpu(), s, n_clusters=4, v=2)


def test_device_store_engines_on_the_card_match_the_cpu(card):
    """RetrievalEngine(cfg, index) with no store on the port's own build:
    an InMemoryStore, then a PQStore; each launches its kernels, topk
    and bin_overlap on the card, and agrees with the CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import clusd_msmarco
    from repro_torch.core import clusd
    from repro_torch.core.features import feature_dim
    from repro_torch.core.lstm import LSTMSelector
    from repro_torch.core.quant import train_pq
    from repro_torch.data import synth_corpus, synth_queries
    from repro_torch.engine import RetrievalEngine

    cfg = clusd_msmarco.smoke()
    corpus = synth_corpus(1, cfg.n_docs, cfg.dim, cfg.vocab)
    g = torch.Generator().manual_seed(0)
    index = clusd.build_index(cfg, corpus.embeddings, corpus.doc_terms,
                              corpus.doc_weights, kmeans_iters=5,
                              generator=g, device="cpu")
    index.selector = LSTMSelector(feature_dim(cfg), cfg.lstm_hidden,
                                  generator=g)
    index.embeddings = torch.from_numpy(corpus.embeddings)
    pq = train_pq(corpus.embeddings, 8, iters=4, generator=g, device="cpu")
    qs = synth_queries(2, corpus, 32)
    q3 = (qs.q_dense, qs.q_terms, qs.q_weights)
    for name, idx, kern in (
            ("memory", index, ("cluster_score",)),
            ("pq", dataclasses.replace(index, quantizer=pq),
             ("adc_tables", "adc_score_blocks"))):
        kernels.reset_launches()
        with RetrievalEngine(cfg, idx, max_batch=16) as eng:
            assert not eng.is_host
            g_ids, g_sc = (t.cpu().numpy() for t in eng.retrieve(*q3))
        for k in kern + ("lstm_sequence", "bin_overlap"):
            assert kernels.LAUNCHES[k] == 2, (name, k)
        # the sparse top-k, the Stage-II budget and the fuse: 3 a batch
        assert kernels.LAUNCHES["topk"] == 6, name
        with RetrievalEngine(cfg, idx, max_batch=16, device="cpu") as eng:
            c_ids, c_sc = (t.numpy() for t in eng.retrieve(*q3))
        ok = isolated_ranks(c_sc)
        np.testing.assert_array_equal(g_ids[ok], c_ids[ok], err_msg=name)
        np.testing.assert_allclose(g_sc, c_sc, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_sparse_scores_on_the_card_are_bitwise_the_cpu(card):
    """Docs reached by many query terms, some twice by one term (a doc
    holding a term twice sits twice in its posting list): the card adds
    each doc's contributions in the CPU's index order, with no two adds
    to one doc in a scatter layer, so the scores are equal bit for bit."""
    import numpy as np

    from repro_torch.core.sparse import SparseIndex, sparse_retrieve

    rng = np.random.default_rng(11)
    D, vocab = 20000, 64
    doc_terms = rng.integers(0, vocab, (D, 24)).astype(np.int32)
    doc_weights = rng.lognormal(0.0, 1.0, (D, 24)).astype(np.float32)
    q_terms = torch.from_numpy(rng.integers(0, vocab, (64, 16)).astype(
        np.int32))
    q_weights = torch.from_numpy(rng.lognormal(0.0, 1.0, (64, 16)).astype(
        np.float32))
    c_index = SparseIndex.build(doc_terms, doc_weights, vocab, 10000,
                                device="cpu")
    g_index = c_index.to(card)
    assert g_index.occurrence_ranks()[1] > 1
    _, _, c = sparse_retrieve(c_index, q_terms, q_weights, 100)
    _, _, g = sparse_retrieve(g_index, q_terms.to(card), q_weights.to(card),
                              100)
    # how many terms of its query reach each doc
    hits = (torch.from_numpy(doc_terms)[None, :, :, None]
            == q_terms[:, None, None, :]).any(2).sum(-1)
    assert (hits >= 3).sum() > 1000
    assert torch.equal(g.cpu().view(torch.int32), c.view(torch.int32))
