"""The port's scatter-gather tier (repro_torch.engine.router) and its
sort-merge fusion held to the JAX package on the CPU.

  * merge_partial_topk bitwise JAX's on drawn partitions with exact ties,
    signed zeros, pads and ragged widths; underfull merges pad with
    (MERGE_SENTINEL, -inf) and duplicates keep their multiplicity
  * fuse_topk_merge bitwise JAX's at id multiplicity 1-5 (interp and
    rrf), and bitwise the port's fuse_topk where no id has more than two
    addends
  * the port's router over JAX-written v1 and v2 directories (3 shards;
    (v1, 3, 1), (v1, 3, 2), (v2, 3, 2), (v2, 2, 1)) against the JAX
    router, and bitwise the port's single-host engine; also with
    --expand-depth 1
  * a host's response (column compaction, searchsorted positions, the
    partial top-k over S * cap with kp truncation) against JAX's
    EngineHost._serve on the same HostRequest

Tolerances: ids equal at ranks more than 1e-5 from both neighbours'
scores, scores allclose at rtol 1e-5, atol 1e-6 against JAX; bitwise
against the port's engine. At most 13 tests.
"""

import dataclasses

import _torch_parity as tp  # first: it caps torch at 2 threads
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                      # fall back to deterministic sweeps
    from _hypothesis_stub import given, settings
    from _hypothesis_stub import strategies as st

from _torch_parity import assert_same_results, isolated_ranks

from repro import engine as jengine
from repro import index as jindex
from repro.core import fusion as jfusion
from repro.data import synth_queries
from repro_torch.core import fusion as tfusion
from repro_torch.engine import (MERGE_SENTINEL, EngineHost, HostRequest,
                                ShardRouter, merge_partial_topk)
from repro_torch.index import IndexReader

N_Q = 24
BATCH = 8
ROUTER_CASES = [("v1", 3, 1), ("v1", 3, 2), ("v2", 3, 2), ("v2", 2, 1)]


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    cfg, index, corpus, _, dirs = tp.jax_dirs_state(tmp_path_factory)
    dirs = {"v1": dirs["f32"], "v2": dirs["v2"]}
    return cfg, dirs, synth_queries(7, corpus, N_Q)


def _q3(qs):
    return qs.q_dense, qs.q_terms, qs.q_weights


def _np(pair):
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in pair)


def _engine(path, cfg=None):
    with IndexReader.open(path).engine(cfg=cfg, max_batch=BATCH,
                                       prefetch=False, device="cpu") as eng:
        return eng


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10**9))
def test_merge_is_bitwise_jax_on_drawn_partitions(seed):
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 4))
    k = int(rng.integers(1, 24))
    pool = np.asarray([0.0, -0.0, 0.25, 1.0, 2.0, np.inf, np.nan],
                      np.float32)
    parts = []
    for _ in range(int(rng.integers(1, 5))):
        w = int(rng.integers(1, 16))
        ids = rng.integers(-2, 30, (B, w)).astype(np.int64)
        ids[rng.random((B, w)) < 0.1] = MERGE_SENTINEL + 3
        ss = pool[rng.integers(0, len(pool), (B, w))]
        parts.append((ids, ss))
    got = merge_partial_topk(parts, k)
    want = jengine.merge_partial_topk(parts, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_merge_underfull_and_duplicates():
    ids = np.array([[3, 3, 7]], np.int64)
    ss = np.array([[1.0, 1.0, 2.0]], np.float32)
    got_ids, got_ss = merge_partial_topk([(ids, ss)], 6)
    np.testing.assert_array_equal(
        got_ids[0], [7, 3, 3] + [MERGE_SENTINEL] * 3)
    np.testing.assert_array_equal(got_ss[0], [2.0, 1.0, 1.0] + [-np.inf] * 3)
    with pytest.raises(ValueError):
        merge_partial_topk([], 3)


# ---------------------------------------------------------------------------
# fuse_topk_merge
# ---------------------------------------------------------------------------

def _fusion_inputs(rng, mult, B=3, Ks=20, Kd=40, n=30):
    sid = rng.integers(0, n, (B, Ks)).astype(np.int32)
    ss = rng.choice(np.asarray([0.0, -0.0, 0.5, 1.0, 2.0], np.float32),
                    (B, Ks))
    did = np.repeat(rng.integers(0, n, (B, -(-Kd // mult))), mult,
                    axis=1)[:, :Kd].astype(np.int32)
    ds = rng.standard_normal((B, Kd)).astype(np.float32)
    dm = rng.random((B, Kd)) < 0.8
    sm = rng.random((B, Ks)) < 0.9
    return sid, ss, did, ds, dm, sm


@pytest.mark.parametrize("method", ["interp", "rrf"])
def test_fuse_topk_merge_is_bitwise_jax_at_multiplicity_1_to_5(method):
    rng = np.random.default_rng(5)
    for mult in range(1, 6):
        for k in (1, 10, 60):
            sid, ss, did, ds, dm, sm = _fusion_inputs(rng, mult)
            want = jfusion.fuse_topk_merge(sid, ss, did, ds, dm, 0.3, k, 31,
                                           sparse_mask=sm, method=method)
            got = tfusion.fuse_topk_merge(
                *map(torch.from_numpy, (sid, ss, did, ds, dm)), 0.3, k, 31,
                sparse_mask=torch.from_numpy(sm), method=method)
            for g, w in zip(_np(got), _np(want)):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), \
                    (mult, k)


def test_fuse_topk_merge_is_fuse_topk_at_two_addends():
    """Each doc at most once a side: the ranked docs of fuse_topk_merge
    are fuse_topk's wherever fuse_topk's top-k holds only docs that some
    side reached (fuse_topk also ranks unreached docs at 0.0)."""
    rng = np.random.default_rng(11)
    n = 400
    for _ in range(6):
        B, Ks, Kd = 4, 50, 80
        sid = np.stack([rng.permutation(n)[:Ks] for _ in range(B)]
                       ).astype(np.int32)
        did = np.stack([rng.permutation(n)[:Kd] for _ in range(B)]
                       ).astype(np.int32)
        ss = rng.random((B, Ks)).astype(np.float32)
        ds = rng.standard_normal((B, Kd)).astype(np.float32)
        dm = rng.random((B, Kd)) < 0.9
        args = [torch.from_numpy(a) for a in (sid, ss, did, ds, dm)]
        m_ids, m_sc = tfusion.fuse_topk_merge(*args, 0.5, 20, n + 1)
        f_ids, f_sc = tfusion.fuse_topk(*args, n, 0.5, 20)
        assert bool((f_sc > 0).all())
        np.testing.assert_array_equal(m_ids.numpy(), f_ids.numpy())
        assert m_sc.numpy().tobytes() == f_sc.numpy().tobytes()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,n_hosts,replication", ROUTER_CASES)
def test_router_matches_jax_router_and_is_bitwise_the_engine(
        state, fmt, n_hosts, replication):
    _, dirs, qs = state
    path = dirs[fmt]
    eng = _engine(path)
    ref = _np(eng.retrieve(*_q3(qs)))
    with ShardRouter.local(IndexReader.open(path), n_hosts, replication,
                           max_batch=BATCH, device="cpu") as router:
        got = _np(router.retrieve(*_q3(qs)))
        stt = router.stats()
    with jengine.ShardRouter.local(jindex.IndexReader.open(path),
                                   n_hosts=n_hosts, replication=replication,
                                   max_batch=BATCH) as jr:
        want = _np(jr.retrieve(*_q3(qs)))
        sjt = jr.stats()
    for g, r in zip(got, ref):
        assert g.tobytes() == r.tobytes()
    assert_same_results(got, want)
    assert sorted(stt) == sorted(sjt)
    for key in ("n_queries", "n_batches", "n_compile_batches", "hosts",
                "replication", "n_shards", "failed_requests", "failovers",
                "degraded", "use_adc", "fusion"):
        assert stt[key] == sjt[key], key
    assert [h["served"] for h in stt["per_host"]] == \
        [h["served"] for h in sjt["per_host"]]
    assert all(h["served"] > 0 for h in stt["per_host"])


def test_router_with_expand_depth_is_bitwise_the_engine(state):
    cfg, dirs, qs = state
    path = dirs["v2"]
    tcfg = dataclasses.replace(IndexReader.open(path).config(),
                               expand_depth=1)
    ref = _np(_engine(path, cfg=tcfg).retrieve(*_q3(qs)))
    with ShardRouter.local(IndexReader.open(path), 3, 2, cfg=tcfg,
                           max_batch=BATCH, device="cpu") as router:
        got = _np(router.retrieve(*_q3(qs)))
    for g, r in zip(got, ref):
        assert g.tobytes() == r.tobytes()
    jcfg = dataclasses.replace(jindex.IndexReader.open(path).config(),
                               expand_depth=1)
    with jengine.ShardRouter.local(jindex.IndexReader.open(path), n_hosts=3,
                                   replication=2, cfg=jcfg,
                                   max_batch=BATCH) as jr:
        assert_same_results(got, _np(jr.retrieve(*_q3(qs))))


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_host_response_matches_jax_engine_host(state, fmt):
    """The JAX router's own HostRequests of one batch, served by a port
    EngineHost and a JAX EngineHost over the same shard subset."""
    _, dirs, qs = state
    path = dirs[fmt]
    seen = []
    with jengine.ShardRouter.local(jindex.IndexReader.open(path), n_hosts=3,
                                   max_batch=BATCH) as jr:
        for h in jr.hosts:
            real = h.submit
            h.submit = (lambda req, real=real, h=h:
                        seen.append((h.host_id, req)) or real(req))
        jr.retrieve(*_q3(qs))
        jhosts = {h.host_id: h for h in jr.hosts}
        treader = IndexReader.open(path)
        assert len(seen) >= 3
        for hid, req in seen:
            req = dataclasses.replace(req, trace=True)
            want = jhosts[hid]._serve(req)
            th = EngineHost(hid, treader, jhosts[hid].shard_ids,
                            device="cpu")
            got = th._serve(req)
            th.close()
            assert got.generation == want.generation
            assert got.ids.dtype == want.ids.dtype
            assert got.ids.shape == want.ids.shape
            ok = isolated_ranks(np.where(np.isfinite(want.scores),
                                         want.scores, -1e9))
            np.testing.assert_array_equal(got.ids[ok], want.ids[ok])
            if fmt == "v2":           # ADC sums in one order everywhere
                np.testing.assert_array_equal(got.ids, want.ids)
                assert got.scores.tobytes() == want.scores.tobytes()
            np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                                       atol=1e-6)
            assert [s["name"] for s in got.spans] == \
                [s["name"] for s in want.spans]


def test_host_request_columns_compact_to_a_power_of_two(state):
    """A host scores only its own columns: S shrinks to the next power of
    two of the widest row's owned slots, and an all-masked request pads
    one entry, as in JAX."""
    _, dirs, _ = state
    reader = IndexReader.open(dirs["v1"])
    host = EngineHost(0, reader, [0], device="cpu")
    jhost = jengine.EngineHost(0, jindex.IndexReader.open(dirs["v1"]), [0])
    dim = reader.geometry["dim"]
    rng = np.random.default_rng(2)
    sel = rng.integers(0, 20, (4, 8)).astype(np.int64)
    mine = (sel < 10) & (rng.random((4, 8)) < 0.7)
    for m in (mine, np.zeros_like(mine)):
        req = HostRequest(generation=0, mode="dot",
                          q_or_lut=rng.standard_normal((4, dim)).astype(
                              np.float32),
                          sel_ids=sel, mine=m,
                          uniq=np.unique(sel[m]) if m.any()
                          else np.zeros((0,), np.int64), trace=True)
        got, want = host._serve(req), jhost._serve(req)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                                   atol=1e-6)
        n_slots = [s["annot"]["n_slots"] for s in got.spans
                   if s["name"] == "compact"]
        assert n_slots == [s["annot"]["n_slots"] for s in want.spans
                           if s["name"] == "compact"]
    host.close()
    jhost.close()
