"""The port's selector trainer against the JAX package's, on the CPU, on
one label set (the JAX package's streamed labels of tests/test_train.py's
tiny index) and JAX's initial params.

Tolerances:
  * probabilities: rtol 1e-5, atol 1e-6 (the LSTM scan's matmuls summed
    in another order);
  * one step's gradients against JAX's value_and_grad, for JAX's scan
    and for its Pallas kernel path in interpret mode (the custom VJP):
    rtol 1e-5, atol 1e-6;
  * params after two epochs of the bucketed trainer, and after three of
    the one-shot trainer, from JAX's init (and JAX's permutations): rtol
    1e-5, atol 1e-6 (measured: at most 6e-8 apart);
  * resume within the port: bitwise; across the packages: the same
    tolerance as two epochs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_train_dirs, torch_cfg
from repro import train as jtrain
from repro.core.lstm import SELECTORS as JSELECTORS
from repro.index import IndexReader as JReader
from repro_torch import train as train_lib
from repro_torch.obs import MetricsRegistry

TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = TOL


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    cfg, corpus, index, dirs, qs = jax_train_dirs(
        tmp_path_factory.mktemp("trainer"))
    reader = JReader.open(dirs["v1"])
    lcfg, lindex = reader.load_index()
    store = reader.open_store(cluster_docs=lindex.cluster_docs)
    ls = jtrain.make_labels_streaming(
        lcfg, lindex, store, qs.q_dense, qs.q_terms, qs.q_weights,
        label_cfg=jtrain.LabelConfig(chunk_clusters=8))
    return cfg, torch_cfg(cfg), ls


def _jinit(selector, seed, F, H):
    return {k: np.asarray(v) for k, v in
            JSELECTORS[selector][0](jax.random.key(seed), F, H).items()}


def _t(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _close(got, want, **tol):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **tol, err_msg=k)


@pytest.mark.parametrize("selector", ["lstm", "rnn", "mlp"])
def test_selector_apply_matches_jax(state, selector):
    jcfg, _, ls = state
    p = _jinit(selector, 3, ls.feats.shape[-1], jcfg.lstm_hidden)
    want = np.asarray(jtrain.selector_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(ls.feats),
        selector=selector))
    for use_kernel in (False, True):
        got = train_lib.selector_apply(_t(p), torch.tensor(ls.feats),
                                       selector=selector,
                                       use_kernel=use_kernel)
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _batch(ls, n=6):
    rng = np.random.default_rng(0)
    w = np.ones(n, np.float32)
    w[-1] = 0.0                                    # a padding row
    return ls.feats[:n], ls.labels[:n], w, rng


def test_one_step_grads_match_jax_value_and_grad(state):
    """The trainer step's loss_fn and value_and_grad: JAX's scan and its
    Pallas-kernel custom VJP (interpret mode, as tests/test_train.py runs
    it), against the port's plain path and its lstm_sequence op path."""
    jcfg, tcfg, ls = state
    f, y, w, _ = _batch(ls)
    p = _jinit("lstm", 7, f.shape[-1], jcfg.lstm_hidden)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def jloss(params, use_kernel):
        probs = jtrain.selector_apply(params, jnp.asarray(f),
                                      use_kernel=use_kernel)
        probs = jnp.clip(probs, 1e-6, 1 - 1e-6)
        bce = -(4.0 * y * jnp.log(probs) + (1 - y) * jnp.log(1 - probs))
        per_row = jnp.mean(bce, axis=1)
        return jnp.sum(per_row * w) / jnp.maximum(jnp.sum(w), 1.0)

    for jk in (False, True):
        jl, jg = jax.value_and_grad(lambda q: jloss(q, jk))(jp)
        for tk in (False, True):
            tr = train_lib.SelectorTrainer(
                tcfg, train_lib.SelectorTrainConfig(use_kernel=tk),
                device="cpu")
            loss, grads = tr.loss_and_grads(
                _t(p), torch.from_numpy(f), torch.from_numpy(y),
                torch.from_numpy(w), torch.tensor(4.0))
            np.testing.assert_allclose(float(loss), float(jl), **TOL)
            _close({k: v.numpy() for k, v in grads.items()}, jg, **TOL)


def test_clip_gradient_at_an_exact_bound_differs_from_jnp_clip():
    """Pinned rather than hidden: at a probability exactly on a
    clip bound, torch.clamp passes the whole gradient and jnp.clip (via
    lax.max / lax.min at a tie) half of it. Nowhere else do they differ."""
    x = np.array([1e-6, 0.3, 1 - 1e-6], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    (tg,) = torch.autograd.grad(torch.clamp(t, 1e-6, 1 - 1e-6).sum(), t)
    jg = jax.grad(lambda v: jnp.clip(v, 1e-6, 1 - 1e-6).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(tg.numpy(), [1.0, 1.0, 1.0])
    np.testing.assert_array_equal(np.asarray(jg), [0.5, 1.0, 0.5])


def test_bucketed_batch_stream_equals_jax(state):
    jcfg, tcfg, ls = state
    for min_len in (2, 4):
        tb = train_lib.bucket_lengths(tcfg, ls.feats, ls.labels,
                                      min_len=min_len)
        jb = jtrain.bucket_lengths(jcfg, ls.feats, ls.labels, min_len=min_len)
        np.testing.assert_array_equal(tb, jb)
        assert train_lib.n_batches_per_epoch(tb, 5) == \
            jtrain.n_batches_per_epoch(jb, 5)
        for epoch in (0, 3):
            got = list(train_lib.bucketed_batches(
                ls.feats, ls.labels, tb, batch_size=5, seed=2, epoch=epoch))
            want = list(jtrain.bucketed_batches(
                ls.feats, ls.labels, jb, batch_size=5, seed=2, epoch=epoch))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert (a.length, a.index) == (b.length, b.index)
                for f in ("feats", "labels", "weights"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f))


def test_two_epochs_from_jax_init_match_jax(state):
    jcfg, tcfg, ls = state
    kw = dict(epochs=2, batch_size=5, seed=3, use_kernel=False)
    jt = jtrain.SelectorTrainer(jcfg, jtrain.SelectorTrainConfig(**kw))
    jp, jh = jt.fit(jax.random.key(9), ls.feats, ls.labels)
    init = _jinit("lstm", 9, ls.feats.shape[-1], jcfg.lstm_hidden)
    for use_kernel in (False, True):
        tt = train_lib.SelectorTrainer(
            tcfg, train_lib.SelectorTrainConfig(
                **dict(kw, use_kernel=use_kernel)), device="cpu")
        tp, th = tt.fit(None, ls.feats, ls.labels, init=init)
        np.testing.assert_allclose(th, jh, rtol=1e-5)
        _close({k: v.numpy() for k, v in tp.items()}, jp, **FIT_TOL)
        assert sorted(tp) == sorted(jp)


def test_one_shot_train_selector_with_jax_draws_matches_jax(state):
    jcfg, tcfg, ls = state
    rng = jax.random.key(11)
    epochs, nq = 3, ls.feats.shape[0]
    jp, jh = jtrain.train_selector(jcfg, rng, ls.feats, ls.labels,
                                   epochs=epochs, batch_size=8)
    # the JAX trainer's draws: init from rng, perms from fold_in(rng, 1)
    init = _jinit("lstm", 11, ls.feats.shape[-1], jcfg.lstm_hidden)
    rngs = jax.random.split(jax.random.fold_in(rng, 1), epochs)
    perms = [np.asarray(jax.random.permutation(rngs[e], nq))
             for e in range(epochs)]
    tp, th = train_lib.train_selector(tcfg, None, ls.feats, ls.labels,
                                      epochs=epochs, batch_size=8,
                                      init=init, perms=perms, device="cpu")
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    _close({k: v.numpy() for k, v in tp.items()}, jp, **FIT_TOL)
    # fewer queries than a batch: JAX steps twice an epoch on all of them
    jp2, jh2 = jtrain.train_selector(jcfg, rng, ls.feats[:6],
                                     ls.labels[:6], epochs=1, batch_size=8)
    perms2 = [np.asarray(jax.random.permutation(rngs[0], 6))]
    tp2, th2 = train_lib.train_selector(tcfg, None, ls.feats[:6],
                                        ls.labels[:6], epochs=1,
                                        batch_size=8, init=init,
                                        perms=perms2, device="cpu")
    np.testing.assert_allclose(th2, jh2, rtol=1e-5)
    _close({k: v.numpy() for k, v in tp2.items()}, jp2, **FIT_TOL)


def test_resume_is_bitwise_and_metrics_are_recorded(state, tmp_path):
    """train N steps == train k, resume, train N-k (bitwise params), with
    the port's own draws; the train.* metrics as JAX names them."""
    _, tcfg, ls = state
    kw = dict(epochs=3, batch_size=5, seed=7, use_kernel=True)
    g = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    reg = MetricsRegistry()
    full = train_lib.SelectorTrainer(tcfg, train_lib.SelectorTrainConfig(
        **kw), device="cpu")
    p_full, _ = full.fit(g(), ls.feats, ls.labels, metrics=reg)
    per_epoch = train_lib.n_batches_per_epoch(
        train_lib.bucket_lengths(tcfg, ls.feats, ls.labels), 5)
    snap = reg.snapshot()
    assert snap["counters"]["train.steps"] == 3 * per_epoch
    assert snap["counters"]["train.epochs"] == 3
    assert snap["histograms"]["train.step_ms"]["count"] == 3 * per_epoch
    assert {"train.steps_per_s", "train.last_loss"} <= set(snap["gauges"])
    k = per_epoch + max(1, per_epoch // 2)
    part = train_lib.SelectorTrainer(tcfg, train_lib.SelectorTrainConfig(
        ckpt_dir=str(tmp_path / "ck"), max_steps=k, **kw), device="cpu")
    part.fit(g(), ls.feats, ls.labels)
    resumed = train_lib.SelectorTrainer(tcfg, train_lib.SelectorTrainConfig(
        ckpt_dir=str(tmp_path / "ck"), **kw), device="cpu")
    p_res, _ = resumed.fit(g(), ls.feats, ls.labels, resume=True)
    for key in p_full:
        assert torch.equal(p_full[key], p_res[key]), key


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_run_resumes_across_the_packages(state, tmp_path, first):
    """k steps in one package, checkpointed; the other resumes from the
    same directory and finishes: its params equal the first package's
    uninterrupted run."""
    jcfg, tcfg, ls = state
    kw = dict(epochs=2, batch_size=5, seed=4, use_kernel=False)
    init = _jinit("lstm", 5, ls.feats.shape[-1], jcfg.lstm_hidden)
    per_epoch = jtrain.n_batches_per_epoch(
        jtrain.bucket_lengths(jcfg, ls.feats, ls.labels), 5)
    k = max(1, per_epoch // 2) + 1
    ck = str(tmp_path / "ck")
    jfull, _ = jtrain.SelectorTrainer(
        jcfg, jtrain.SelectorTrainConfig(**kw)).fit(
        jax.random.key(5), ls.feats, ls.labels)
    if first == "jax":
        jtrain.SelectorTrainer(jcfg, jtrain.SelectorTrainConfig(
            ckpt_dir=ck, max_steps=k, **kw)).fit(
            jax.random.key(5), ls.feats, ls.labels)
        got, _ = train_lib.SelectorTrainer(
            tcfg, train_lib.SelectorTrainConfig(ckpt_dir=ck, **kw),
            device="cpu").fit(None, ls.feats, ls.labels, init=init,
                              resume=True)
        got = {k_: v.numpy() for k_, v in got.items()}
    else:
        train_lib.SelectorTrainer(tcfg, train_lib.SelectorTrainConfig(
            ckpt_dir=ck, max_steps=k, **kw), device="cpu").fit(
            None, ls.feats, ls.labels, init=init)
        got, _ = jtrain.SelectorTrainer(
            jcfg, jtrain.SelectorTrainConfig(ckpt_dir=ck, **kw)).fit(
            jax.random.key(99), ls.feats, ls.labels, resume=True)
    _close(got, jfull, **FIT_TOL)


def test_pos_weight_is_config_driven_as_in_jax(state):
    jcfg, tcfg, ls = state
    labels = ls.labels
    assert train_lib.resolve_pos_weight(tcfg, labels) == 4.0
    assert train_lib.resolve_pos_weight(tcfg, labels, 7.5) == 7.5
    none_cfg = dataclasses.replace(tcfg, pos_weight=None)
    assert train_lib.resolve_pos_weight(none_cfg, labels) == \
        jtrain.resolve_pos_weight(dataclasses.replace(jcfg, pos_weight=None),
                                  labels)
    tr = train_lib.SelectorTrainer(none_cfg, train_lib.SelectorTrainConfig(
        epochs=1, batch_size=8), device="cpu")
    tr.fit(None, ls.feats, ls.labels)
    assert tr.pos_weight == pytest.approx(
        train_lib.derive_pos_weight(labels))
    assert train_lib.derive_pos_weight(np.zeros((4, 8))) == 100.0
