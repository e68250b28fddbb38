"""The port's serving of index directories held to the JAX package on the
CPU: the JAX package builds one state at clusd_msmarco.smoke() widths
from a seed and writes v1 (float32, bfloat16, int8) and v2 directories;
the port's `IndexReader.engine(device="cpu")` serves them against the
JAX `IndexReader.engine()`, through the "dot" tail (kernel
cluster_score, its plain version on the CPU) for v1 and ADC for v2, and
emits the same explain records. Hot reloads are in
test_torch_serving_reload.py.

Tolerances: ids equal at every rank more than 1e-5 from both
neighbours' scores (`isolated_ranks`; the engines sum dense, ADC and
sparse scores in other orders); scores allclose at rtol 1e-5, atol 1e-6;
cluster_score's plain version allclose to the JAX kernel (interpret
mode) and to its jnp reference at rtol 1e-5, atol 1e-5 (one einsum
against another, summed in other orders); explain probs at atol 1e-4
(they are rounded to 4 places), every other explain field exact.

The port's parity tests keep 13 tests or fewer per file: `--dist
loadfile` starts the largest files first, so these start after the
first round, which holds the load-sensitive router tests.
"""

import _torch_parity as tp  # first: it caps torch at 2 threads
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (SERVE_BATCH, assert_same_results,
                           assert_same_stats_surface, queries3, serve_jax,
                           serve_torch)

from repro import index as jindex
from repro.data import synth_queries
from repro.kernels.cluster_score import cluster_score as jax_cluster_score
from repro.kernels.cluster_score import cluster_score_ref as jax_cs_ref
from repro.obs import ExplainLogger as JaxExplain
from repro_torch import kernels
from repro_torch.engine import pipeline as tpipe
from repro_torch.index import IndexReader
from repro_torch.kernels.cluster_score import cluster_score, cluster_score_ref
from repro_torch.obs import ExplainLogger

N_Q = 16


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    cfg, index, corpus, _, dirs = tp.jax_dirs_state(tmp_path_factory)
    return cfg, index, corpus, dirs, synth_queries(9, corpus, N_Q)


# -- cluster_score ----------------------------------------------------------

@pytest.mark.parametrize("B,dim,U,cap,S", [(3, 13, 5, 7, 4), (2, 32, 9, 16, 3),
                                           (4, 8, 1, 5, 6)])
def test_cluster_score_plain_matches_jax_kernel(B, dim, U, cap, S):
    rng = np.random.default_rng(B * 100 + dim)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    blocks = rng.standard_normal((U, cap, dim)).astype(np.float32)
    sel = rng.integers(0, U, (B, S)).astype(np.int32)
    got = cluster_score(torch.from_numpy(q), torch.from_numpy(blocks),
                        torch.from_numpy(sel)).numpy()
    assert got.shape == (B, S, cap) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, cluster_score_ref(torch.from_numpy(q), torch.from_numpy(blocks),
                               torch.from_numpy(sel)).numpy())
    jk = np.asarray(jax_cluster_score(jnp.asarray(q), jnp.asarray(blocks),
                                      jnp.asarray(sel), use_kernel=True))
    np.testing.assert_allclose(got, jk, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_cs_ref(q, blocks, sel)),
                               rtol=1e-5, atol=1e-5)


def test_cluster_score_empty_selection():
    q = torch.ones(3, 8)
    # the engine's all-masked batch: one zero placeholder block, every
    # slot at position 0
    out = cluster_score(q, torch.zeros(1, 4, 8),
                        torch.zeros(3, 2, dtype=torch.int32))
    assert out.shape == (3, 2, 4) and not out.any()
    for blocks, sel in ((torch.zeros(1, 4, 8),
                         torch.zeros(3, 0, dtype=torch.int32)),
                        (torch.zeros(0, 4, 8),
                         torch.zeros(3, 2, dtype=torch.int32))):
        assert cluster_score(q, blocks, sel).shape == (3, sel.shape[1], 4)
    before = dict(kernels.LAUNCHES)
    cluster_score(q, torch.ones(2, 4, 8), torch.ones(3, 2, dtype=torch.int32))
    assert kernels.LAUNCHES == before        # the CPU path launches nothing


# -- the "dot" tail ----------------------------------------------------------

def test_fused_dot_tail_matches_jax(state):
    """fetch_unique_blocks + build_fused_scorer(mode="dot") on one batch,
    against the JAX engine's own stage functions."""
    from repro.engine import pipeline as jpipe

    cfg, _, _, dirs, qs = state
    jr, tr = jindex.IndexReader.open(dirs["f32"]), IndexReader.open(
        dirs["f32"])
    jcfg, jidx = jr.load_index()
    tcfg, tidx = tr.load_index(device="cpu")
    qd, qt, qw = (jnp.asarray(x) for x in queries3(qs))
    sid, ss, cand, feats = jpipe.build_stage1_fn(jcfg, jidx)(qd, qt, qw)
    sel, mask, _ = jpipe.build_stage2_fn(jcfg, jidx)(cand, feats)
    uniq, pos = jpipe.dedup_selected(np.asarray(sel), np.asarray(mask))
    jstore, tstore = jr.open_store(), tr.open_store()
    jb = jpipe.fetch_unique_blocks(jstore, uniq)
    tb = tpipe.fetch_unique_blocks(tstore, uniq)
    np.testing.assert_array_equal(tb, jb)
    jids, jsc = jpipe.build_fused_scorer(jcfg, jidx, jstore, k=jcfg.k_final,
                                         mode="dot")(
        qd, sid, ss, sel, mask, jnp.asarray(jb), jnp.asarray(pos))
    T = tp.as_tensor
    tids, tsc = tpipe.build_fused_scorer(tcfg, tidx, k=tcfg.k_final,
                                         mode="dot")(
        T(qd), T(sid), T(ss), T(sel), T(mask), torch.from_numpy(tb),
        torch.from_numpy(pos))
    assert_same_results((tids.numpy(), tsc.numpy()),
                         (np.asarray(jids), np.asarray(jsc)))
    with pytest.raises(ValueError, match="mode"):
        tpipe.build_fused_scorer(tcfg, tidx, k=8, mode="decode")


# -- the engine over reader-opened directories -------------------------------

@pytest.mark.parametrize("kind,fusion,use_adc", [
    ("f32", None, None), ("f32", "rrf", None), ("bf16", None, None),
    ("int8", None, None), ("v2", None, None),
    ("v2", None, False)])            # v2 decoded on the host, "dot" tail
def test_engine_matches_jax_engine(state, kind, fusion, use_adc):
    path = state[3][kind]
    t = serve_torch(path, state[4], fusion=fusion, use_adc=use_adc)
    j = serve_jax(path, state[4], fusion=fusion, use_adc=use_adc)
    assert_same_results(t, j, fusion or "interp")
    assert_same_stats_surface(t[2], j[2])
    assert t[2]["use_adc"] == (kind == "v2" and use_adc is None)
    assert t[2]["fusion"] == (fusion or "interp")
    assert t[2]["generation"] == 0


def test_engine_rejects_bad_options(state):
    path = state[3]["f32"]
    with pytest.raises(ValueError, match="fusion"):
        IndexReader.open(path).engine(device="cpu", fusion="borda")
    with pytest.raises(ValueError, match="code-backed"):
        IndexReader.open(path).engine(device="cpu", use_adc=True)


# -- explain records ---------------------------------------------------------

def test_explain_records_match_jax(state):
    cfg, _, _, dirs, qs = state
    path = dirs["f32"]
    jlog, tlog = JaxExplain(sample_rate=1.0), ExplainLogger(sample_rate=1.0)
    with jindex.IndexReader.open(path).engine(
            max_batch=SERVE_BATCH, prefetch=False, explain=jlog,
            fusion="interp") as jeng:
        jeng.retrieve(*queries3(qs))
    with IndexReader.open(path).engine(max_batch=SERVE_BATCH, prefetch=False,
                                       explain=tlog, device="cpu") as teng:
        teng.retrieve(*queries3(qs))
    jr, tr = jlog.recent(), tlog.recent()
    assert len(tr) == len(jr) == N_Q
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.pop("probs"), b.pop("probs"),
                                   atol=1e-4)
        assert a == b
    assert tlog.stats() == jlog.stats()
    tlog, jlog = ExplainLogger(sample_rate=0.3), JaxExplain(sample_rate=0.3)
    assert [tlog.sample() for _ in range(9)] == \
        [jlog.sample() for _ in range(9)]
    assert tlog.stats() == jlog.stats()
