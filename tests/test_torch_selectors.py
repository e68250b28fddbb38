"""The port's Stage-II selectors held to the JAX package on the CPU: the
"rnn" and "mlp" ablation selectors (and "lstm" beside them) against
`repro.core.lstm.SELECTORS`, `convert.selector_from_numpy(selector=)`,
and `stage2_select` / `retrieve` with each selector's params.

Inputs are made from numpy seeds; parameters come from the JAX package's
own init functions (jax.random keys) and are handed over as numpy.
Tolerances: probabilities allclose at atol 1e-6 (matmuls summed in other
orders; the recurrences run step by step in both); selections equal away
from |p - theta| < 1e-5; retrieved ids equal at every rank more than
1e-5 from both neighbours' scores, scores at rtol 1e-5, atol 1e-6.
"""

import dataclasses

import _torch_parity as tp  # first: it caps torch at 2 threads
import jax
import numpy as np
import pytest
import torch
from _torch_parity import as_tensor, assert_same_results, torch_cfg

from repro.core import clusd as jcl
from repro.core import lstm as jlstm
from repro.core import sparse as jsparse
from repro.core.features import feature_dim
from repro.data import synth_queries
from repro_torch.convert import index_from_numpy, selector_from_numpy
from repro_torch.core import clusd as tcl
from repro_torch.core import lstm as tlstm

EPS = 1e-5


def _params(name, F, H, seed=1):
    init, _ = jlstm.SELECTORS[name]
    return {k: np.asarray(v) for k, v in init(jax.random.key(seed), F,
                                               H).items()}


@pytest.fixture(scope="module")
def smoke():
    cfg, index, corpus = tp.jax_smoke_state(0)
    t_index = index_from_numpy(tp.index_arrays(index), device="cpu")
    return cfg, index, t_index, synth_queries(9, corpus, 24)


def test_selector_names_match_jax():
    assert sorted(tlstm.SELECTORS) == sorted(jlstm.SELECTORS)


@pytest.mark.parametrize("name", ["rnn", "mlp", "lstm"])
def test_probs_match_jax(name):
    """(B, n, F, H): the paper's n 32, F 21, H 32, a smoke shape and one
    step of one candidate."""
    _, apply = jlstm.SELECTORS[name]
    for B, n, F, H in ((5, 32, 21, 32), (3, 7, 13, 16), (1, 1, 4, 8)):
        rng = np.random.default_rng(B * 100 + n)
        feats = rng.standard_normal((B, n, F)).astype(np.float32) * 2.0
        params = _params(name, F, H)
        want = np.asarray(apply(params, feats))
        mod = selector_from_numpy(params, selector=name, device="cpu")
        assert isinstance(mod, tlstm.SELECTORS[name])
        with torch.no_grad():
            got = mod(torch.from_numpy(feats)).numpy()
        assert got.shape == (B, n) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_selector_from_numpy_checks_kind_and_shapes():
    rnn, lstm, mlp = (_params(k, 21, 32) for k in ("rnn", "lstm", "mlp"))
    # rnn and lstm share their key names: the kind is the caller's word
    assert isinstance(selector_from_numpy(rnn, selector="rnn",
                                          device="cpu"), tlstm.RNNSelector)
    assert isinstance(selector_from_numpy(lstm, device="cpu"),
                      tlstm.LSTMSelector)
    with pytest.raises(ValueError, match="wx"):
        selector_from_numpy(rnn, selector="lstm", device="cpu")
    with pytest.raises(ValueError, match="wx"):
        selector_from_numpy(lstm, selector="rnn", device="cpu")
    with pytest.raises(KeyError, match="w1"):
        selector_from_numpy(rnn, selector="mlp", device="cpu")
    with pytest.raises(KeyError, match="gru"):
        selector_from_numpy(mlp, selector="gru", device="cpu")
    mod = selector_from_numpy(mlp, selector="mlp", device="cpu")
    for k, p in mod.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), mlp[k])


@pytest.mark.parametrize("name", ["rnn", "mlp"])
def test_stage2_select_matches_jax(smoke, name):
    """Selections over the smoke index's Stage-I candidates, given each
    selector's params, equal JAX's wherever no probability sits within
    EPS of theta; the index's own selector of that kind selects the
    same."""
    cfg, index, t_index, qs = smoke
    params = _params(name, feature_dim(cfg), cfg.lstm_hidden, seed=4)
    sid, ss = jsparse.sparse_retrieve_topk(index.sparse_index, qs.q_terms,
                                           qs.q_weights, cfg.k_sparse)
    s1 = jcl.stage1_candidates(cfg, index, qs.q_dense, sid, ss)
    probs = np.asarray(jlstm.SELECTORS[name][1](params, s1["feats"]))
    theta = float(np.median(probs))        # a theta that splits them
    j = jcl.stage2_select(cfg, index, s1["cand"], s1["feats"],
                          selector=name, theta=theta,
                          selector_params=params)
    tc = torch_cfg(cfg)
    cand, feats = as_tensor(s1["cand"]), as_tensor(s1["feats"])
    with torch.no_grad():
        t = tcl.stage2_select(tc, t_index, cand, feats, selector=name,
                              theta=theta, selector_params=params)
        own_index = dataclasses.replace(
            t_index, selector=selector_from_numpy(params, selector=name,
                                                  device="cpu"))
        own = tcl.stage2_select(tc, own_index, cand, feats, selector=name,
                                theta=theta)
    np.testing.assert_allclose(t["probs"].numpy(), probs, atol=1e-6)
    clear = (np.abs(probs - theta) >= EPS).all(axis=1)
    assert clear.mean() > 0.5
    for key in ("sel_ids", "sel_mask"):
        np.testing.assert_array_equal(t[key].numpy()[clear],
                                      np.asarray(j[key])[clear])
        np.testing.assert_array_equal(own[key].numpy(), t[key].numpy())


@pytest.mark.parametrize("name", ["rnn", "mlp"])
def test_retrieve_with_selector_params_matches_jax(smoke, name):
    cfg, index, t_index, qs = smoke
    params = _params(name, feature_dim(cfg), cfg.lstm_hidden, seed=6)
    jids, jsc, _ = jcl.retrieve(cfg, index, qs.q_dense, qs.q_terms,
                                qs.q_weights, selector=name, theta=0.5,
                                selector_params=params, k=40)
    arrays = {**tp.index_arrays(index),
              "embeddings": np.asarray(index.embeddings)}
    emb_index = index_from_numpy(arrays, device="cpu")
    with torch.no_grad():
        tids, tsc, diag = tcl.retrieve(torch_cfg(cfg), emb_index,
                                       as_tensor(qs.q_dense),
                                       as_tensor(qs.q_terms),
                                       as_tensor(qs.q_weights),
                                       selector=name, theta=0.5,
                                       selector_params=params, k=40)
    assert tids.shape == (24, 40)
    # theta 0.5 splits the candidates: some clusters selected, not all
    n_sel = diag["n_selected"].float().mean().item()
    assert 0 < n_sel < cfg.max_selected
    assert_same_results((tids.numpy(), tsc.numpy()),
                        (np.asarray(jids), np.asarray(jsc)))
