"""Selector and recsys training on the card against the plain versions
and the CPU.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Tolerances: the lstm_sequence autograd Function's gradients for a given
output gradient are bitwise autograd through the plain version (its
backward IS that VJP, recomputed on the same inputs); through the whole
selector loss, where the kernel's forward differs from the plain one in
the last bits, rtol 1e-4, atol 1e-6; one trainer step card against CPU
rtol 1e-4, atol 1e-6 (cuBLAS sums in another order, fed through log and
sigmoid), and the params after its Adam step rtol 1e-5, atol 1e-5 but
2 lr where |grad| < 1e-6 (Adam's first step is about lr whatever the
gradient's size); resume on the card bitwise; the embedding_bag
backward (an index_add_ with atomics) against autograd through the
plain version rtol 1e-5, atol 1e-5 (a row's gradient sums up to a few
hundred float32 terms of size 1 in another order); cluster_score at the
label chunk shape rtol 1e-5, atol 1e-6; topk over (B, 2^20) rows
bitwise; streamed labels card against CPU at isolated ranks.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import clusd_msmarco, get_config
from repro_torch.kernels.cluster_score import cluster_score, cluster_score_ref
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
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


def _lstm_inputs(B, n, F, H, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, n, F, generator=g)
    wx = torch.randn(F, 4 * H, generator=g) / F ** 0.5
    wh = torch.randn(H, 4 * H, generator=g) / H ** 0.5
    b = torch.randn(4 * H, generator=g) * 0.1
    gout = torch.randn(B, n, H, generator=g)
    return [t.to(dev) for t in (x, wx, wh, b, gout)]


@pytest.mark.parametrize("shape", [(256, 4, 21, 32), (256, 32, 21, 32),
                                   (7, 9, 5, 16), (3, 5, 21, 64)])
def test_lstm_function_backward_is_autograd_through_ref(card, shape):
    x, wx, wh, b, gout = _lstm_inputs(*shape, card)
    ins = [t.clone().requires_grad_() for t in (x, wx, wh, b)]
    kernels.reset_launches()
    h = lstm_sequence(*ins)
    assert kernels.LAUNCHES["lstm_sequence"] == 1
    got = torch.autograd.grad(h, ins, gout)
    assert kernels.LAUNCHES["lstm_sequence"] == 1      # none in backward
    refs = [t.clone().requires_grad_() for t in (x, wx, wh, b)]
    want = torch.autograd.grad(lstm_sequence_ref(*refs), refs, gout)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (h.detach() - lstm_sequence_ref(x, wx, wh, b)).abs().max() <= 1e-5
    # only some inputs wanting a gradient
    wx2 = wx.clone().requires_grad_()
    (gw,) = torch.autograd.grad(lstm_sequence(x, wx2, wh, b), [wx2], gout)
    assert torch.equal(gw, want[1])


def test_selector_loss_grads_and_trainer_step_card_vs_cpu(card):
    from repro_torch import train as train_lib
    cfg = clusd_msmarco.smoke()
    rng = np.random.default_rng(1)
    f = rng.standard_normal((64, 16, 9)).astype(np.float32)
    y = (rng.random((64, 16)) < 0.2).astype(np.float32)
    w = np.ones(64, np.float32)
    params = train_lib.trainer.init_selector_params(
        "lstm", 9, cfg.lstm_hidden, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev, use_kernel in (("cpu", False), (card, True), (card, False)):
        tr = train_lib.SelectorTrainer(cfg, train_lib.SelectorTrainConfig(
            use_kernel=use_kernel), device=dev)
        kernels.reset_launches()
        out[(str(dev), use_kernel)] = tr.loss_and_grads(
            {k: v.to(dev) for k, v in params.items()},
            *(torch.from_numpy(a).to(dev) for a in (f, y, w)),
            torch.tensor(4.0, device=dev))
        assert kernels.LAUNCHES["lstm_sequence"] == int(use_kernel)
    base_loss, base = out[("cpu", False)]
    for key in ((str(card), True), (str(card), False)):
        loss, grads = out[key]
        np.testing.assert_allclose(float(loss), float(base_loss), rtol=1e-5)
        for k in base:
            np.testing.assert_allclose(grads[k].cpu().numpy(),
                                       base[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{key} {k}")


def test_trainer_resume_is_bitwise_on_the_card(card, tmp_path):
    from repro_torch import train as train_lib
    cfg = clusd_msmarco.smoke()
    rng = np.random.default_rng(2)
    f = rng.standard_normal((40, 16, 9)).astype(np.float32)
    y = (rng.random((40, 16)) < 0.2).astype(np.float32)
    f[:20, 3:, 5:] = 0.0          # half the queries live in 3 steps:
    y[:20, 3:] = 0.0              # buckets 4 and 16
    kw = dict(epochs=3, batch_size=8, seed=5)
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    full = train_lib.SelectorTrainer(cfg, train_lib.SelectorTrainConfig(
        **kw), device=card)
    assert full.use_kernel
    p_full, _ = full.fit(g(), f, y)
    per_epoch = train_lib.n_batches_per_epoch(
        train_lib.bucket_lengths(cfg, f, y), 8)
    assert len(full._steps) >= 2
    k = per_epoch + 2
    train_lib.SelectorTrainer(cfg, train_lib.SelectorTrainConfig(
        ckpt_dir=str(tmp_path), max_steps=k, **kw), device=card).fit(g(), f, y)
    p_res, _ = train_lib.SelectorTrainer(cfg, train_lib.SelectorTrainConfig(
        ckpt_dir=str(tmp_path), **kw), device=card).fit(g(), f, y,
                                                        resume=True)
    for key in p_full:
        assert torch.equal(p_full[key], p_res[key]), key


def test_embedding_bag_backward_on_the_card(card):
    rng = np.random.default_rng(3)
    for V, d, B, hot in ((1000, 32, 512, 40), (64, 8, 33, 3), (50, 1, 7, 9)):
        table = torch.from_numpy(rng.standard_normal((V, d)).astype(
            np.float32))
        idx = torch.from_numpy(rng.integers(0, V // 2, (B, hot)).astype(
            np.int32))
        gout = torch.from_numpy(rng.standard_normal((B, d)).astype(
            np.float32))
        grads = {}
        for dev, fn in (("card", embedding_bag), ("ref", embedding_bag_ref)):
            t = table.to(card).requires_grad_()
            out = fn(t, idx.to(card))
            (grads[dev],) = torch.autograd.grad(out, t, gout.to(card))
        tc = table.clone().requires_grad_()
        (gcpu,) = torch.autograd.grad(embedding_bag(tc, idx), tc, gout)
        np.testing.assert_allclose(grads["card"].cpu().numpy(),
                                   grads["ref"].cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(grads["card"].cpu().numpy(), gcpu.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert torch.all(grads["card"][V // 2:] == 0)


def test_label_chunk_kernels_on_their_shapes(card):
    """cluster_score at the label pass's chunk (B 512 x 64 blocks of 256
    x 768) and topk at the in-RAM full-dense rows (B x 2^20, k 10)."""
    g = torch.Generator(device=card).manual_seed(4)
    q = torch.randn(512, 768, device=card, generator=g)
    q /= q.norm(dim=1, keepdim=True)
    blocks = torch.randn(64, 256, 768, device=card, generator=g)
    blocks /= blocks.norm(dim=2, keepdim=True)
    sel = torch.arange(64, dtype=torch.int32, device=card)[None].expand(
        512, 64).contiguous()
    got = cluster_score(q, blocks, sel)
    want = cluster_score_ref(q, blocks, sel)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    flat = q @ blocks.reshape(-1, 768).T
    torch.testing.assert_close(got.reshape(512, -1), flat, rtol=1e-5,
                               atol=1e-6)
    x = torch.randn(128, 1 << 20, device=card, generator=g)
    v, i = topk(x, 10)
    rv, ri = topk_ref(x, 10)
    assert torch.equal(i, ri) and torch.equal(v, rv)


def test_streamed_labels_on_the_card_match_the_cpu(card, tmp_path):
    from _torch_parity import isolated_ranks

    from repro_torch import train as train_lib
    from repro_torch.core.clusd import build_index
    from repro_torch.data import synth_corpus, synth_queries
    from repro_torch.index import IndexReader, write_index
    cfg = clusd_msmarco.smoke()
    corpus = synth_corpus(0, cfg.n_docs, cfg.dim, cfg.vocab)
    index = build_index(cfg, corpus.embeddings, corpus.doc_terms,
                        corpus.doc_weights,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    write_index(str(tmp_path / "idx"), cfg, index, corpus.embeddings,
                n_shards=3)
    qs = synth_queries(1, corpus, 48)
    out = {}
    for dev in ("cpu", card):
        reader = IndexReader.open(str(tmp_path / "idx"))
        lcfg, lindex = reader.load_index(device=dev)
        store = reader.open_store(cluster_docs=lindex.cluster_docs)
        for use_kernel in (False, True):
            out[(str(dev), use_kernel)] = train_lib.make_labels_streaming(
                lcfg, lindex, store, qs.q_dense, qs.q_terms, qs.q_weights,
                label_cfg=train_lib.LabelConfig(chunk_clusters=7,
                                                use_kernel=use_kernel),
                device=dev)
    _, scores = train_lib.streaming_full_dense_topk(
        IndexReader.open(str(tmp_path / "idx")).open_store(), qs.q_dense, 10,
        device="cpu")
    ok = isolated_ranks(scores)
    base = out[("cpu", False)]
    for key, ls in out.items():
        np.testing.assert_array_equal(ls.cand, base.cand, err_msg=str(key))
        np.testing.assert_array_equal(ls.dense_ids[ok], base.dense_ids[ok])
        same = (ls.dense_ids == base.dense_ids).all(axis=1)
        np.testing.assert_array_equal(ls.labels[same], base.labels[same])


def test_recsys_train_step_card_vs_cpu(card):
    from repro_torch.configs import TrainConfig
    from repro_torch.data import RecsysStream
    from repro_torch.models import recsys as rs
    from repro_torch.optim import adamw_init
    cfg = get_config("wide-deep", "smoke")
    params = rs.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = RecsysStream(cfg, seed=1).batch(64)
    step = rs.make_train_step(cfg)
    res = {}
    for dev in ("cpu", card):
        p = {k: v.moved(dev) if isinstance(v, rs.FusedTable) else v.to(dev)
             for k, v in params.items()}
        loss, grads = rs.train_loss_and_grads(cfg, p, rs.as_batch(batch, dev))
        p2, _, st = step(p, adamw_init(rs.train_tree(p)),
                         rs.as_batch(batch, dev))
        res[str(dev)] = (loss, grads, rs.train_tree(p2), st)
    c, g = res["cpu"], res[str(card)]
    np.testing.assert_allclose(float(g[0]), float(c[0]), rtol=1e-5)
    lr = TrainConfig().lr
    for k in c[1]:
        gc = c[1][k].numpy()
        np.testing.assert_allclose(g[1][k].cpu().numpy(), gc,
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        # Adam's first step is about lr whatever the gradient's size, so
        # where |grad| < 1e-6 the devices may step opposite ways
        small = np.abs(gc) < 1e-6
        got, want = g[2][k].cpu().numpy(), c[2][k].numpy()
        np.testing.assert_allclose(got[~small], want[~small], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        assert np.all(np.abs(got[small] - want[small]) <= 2 * lr + 1e-6), k
