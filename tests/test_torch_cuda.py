"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: adc_score_blocks bitwise (one fp32 accumulator, ascending
subspaces, no FMA); adc_tables rtol/atol 1e-5; lstm_sequence atol 1e-5;
cluster_score rtol 1e-5, atol 1e-5 on dot products of unit scale (FMA
in lane order and a shuffle tree against the einsum's order); the v1
engine on the card against the CPU: ids at isolated ranks, scores rtol
1e-5, atol 1e-6.
"""

import pytest
import torch
from _torch_parity import isolated_ranks

from repro_torch import kernels
from repro_torch.kernels.cluster_score import cluster_score, cluster_score_ref
from repro_torch.kernels.adc import (adc_score_blocks, adc_score_blocks_ref,
                                     adc_tables, adc_tables_ref)
from repro_torch.kernels.lstm import lstm_sequence, lstm_sequence_ref

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
                                           (64, 96, 8, 256)])
def test_adc_tables_kernel_vs_plain(card, B, nsub, dsub, K):
    g = _gen()
    q = torch.randn(B, nsub * dsub, device=card, generator=g)
    books = torch.randn(nsub, K, dsub, device=card, generator=g)
    before = kernels.LAUNCHES["adc_tables"]
    out = adc_tables(q, books)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["adc_tables"] == before + 1
    torch.testing.assert_close(out, adc_tables_ref(q, books), rtol=1e-5,
                               atol=1e-5)


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
