"""The port's distributed serving (repro_torch.core.distributed over
torch.distributed) against the JAX package's (repro.core.distributed
over a device mesh).

  * the blocked layout and the postings by owner are byte for byte
    JAX's, on divisible and non-divisible cluster counts
  * make_serve_step across 4 gloo ranks (torch.multiprocessing, a
    FileStore) on 1 x 4 and 2 x 2 meshes against JAX's make_serve_step
    on (1, 4) and (2, 2) meshes of host devices (a subprocess with
    --xla_force_host_platform_device_count): ids equal at isolated
    ranks, scores allclose; a model group serving the whole batch gives
    each data rank's rows bit for bit
  * the shard-local guide top-k equals the global one under a process
    group and raises without one
  * the wide top-k (k over the topk kernel's limit, taken in rounds)
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from _torch_parity import (dist_worker, index_arrays, isolated_ranks,
                           jax_smoke_state, torch_cfg)
from repro.core import distributed as jdd
from repro_torch.convert import index_from_numpy
from repro_torch.core import distributed as tdd
from repro_torch.core import retrieval as tret
from repro_torch.kernels.topk.ref import topk_ref

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_QUERIES = 16


@pytest.fixture(scope="module")
def state():
    """JAX smoke state (N 64), its blocked index, the port's, queries."""
    from repro.data import synth_queries
    cfg, index, corpus = jax_smoke_state(0)
    jb = jdd.build_blocked_index(cfg, index)
    tindex = index_from_numpy(index_arrays(index), device="cpu")
    tb = tdd.build_blocked_index(torch_cfg(cfg), tindex,
                                 np.asarray(corpus.embeddings))
    qs = synth_queries(7, corpus, N_QUERIES)
    return cfg, index, corpus, jb, tb, qs


def _tiny_blocked():
    """N 9 clusters: no split over 2 or 4 shards is even."""
    _, index, corpus = jax_smoke_state(0, with_selector=False, n_docs=300,
                                       dim=16, n_clusters=9, vocab=128,
                                       max_postings=64, k_sparse=32,
                                       bins=(3, 6, 9), n_candidates=6,
                                       max_selected=3, n_neighbors=4,
                                       u_bins=3, k_final=16)
    return index, corpus


def test_blocked_layout_is_byte_for_byte_jax(state):
    _, _, _, jb, tb, _ = state
    for f in ("blocks", "valid", "centroids", "neighbor_ids",
              "neighbor_sims", "postings_docs", "postings_weights",
              "old_to_new"):
        j, t = np.asarray(getattr(jb, f)), getattr(tb, f)
        assert t.dtype == j.dtype and t.shape == j.shape, f
        assert t.tobytes() == j.tobytes(), f
    assert (tb.n_clusters, tb.cap) == (jb.n_clusters, jb.cap)


@pytest.mark.parametrize("which", ["smoke", "tiny"])
def test_postings_by_owner_and_ranges_are_jax(state, which):
    if which == "smoke":
        jb, tb = state[3], state[4]
    else:
        index, corpus = _tiny_blocked()
        jb = jdd.build_blocked_index(None, index)
        tb = tdd.build_blocked_index(
            None, index_from_numpy(index_arrays(index), device="cpu"),
            np.asarray(corpus.embeddings))
    N = jb.blocks.shape[0]
    for n_shards in (1, 2, 3, 4):
        if n_shards > N:
            continue
        jd, jw = jdd.shard_postings_by_owner(jb, n_shards)
        td, tw = tdd.shard_postings_by_owner(tb, n_shards)
        assert td.dtype == jd.dtype and td.tobytes() == jd.tobytes()
        assert tw.dtype == jw.dtype and tw.tobytes() == jw.tobytes()
        assert tdd.shard_ranges(N, n_shards) == jdd.shard_ranges(N, n_shards)
        ids = np.arange(N)
        ranges = jdd.shard_ranges(N, n_shards)
        np.testing.assert_array_equal(tdd.owner_of(ids, ranges),
                                      jdd.owner_of(ids, ranges))
    with pytest.raises(ValueError):
        tdd.owner_of([N], tdd.shard_ranges(N, 2))
    with pytest.raises(ValueError):
        tdd.shard_ranges(2, 3)


def test_blocked_blocks_read_a_slice_of_a_memmap(state, tmp_path):
    _, index, corpus, jb, _, _ = state
    emb = np.asarray(corpus.embeddings)
    path = tmp_path / "emb.f32"
    emb.tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=emb.shape)
    cd = np.asarray(index.cluster_docs)
    got = tdd.blocked_blocks(mm, cd, 16, 32)
    assert got.tobytes() == np.asarray(jb.blocks)[16:32].tobytes()


_JAX_SERVE = """
import json, numpy as np, jax, jax.numpy as jnp, dataclasses
from repro.configs import get_config
from repro.core import distributed as dist
job = dict(np.load({job!r}))
d = json.loads(str(job["cfg_json"]))
cfg = dataclasses.replace(get_config("clusd-msmarco", "smoke"),
                          **{{**d, "bins": tuple(d["bins"])}})
mesh = jax.make_mesh(({nd}, {nm}), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
params = {{k[4:]: jnp.asarray(v) for k, v in job.items()
          if k.startswith("sel_")}}
N, cap, dim = job["blocks"].shape
serve = dist.make_serve_step(cfg, mesh, (N, cap, dim, cfg.vocab,
    job["pd"].shape[2], job["nb_ids"].shape[1]), 0)
ids, scores = jax.jit(serve)(
    jnp.asarray(job["blocks"]), jnp.asarray(job["pd"]),
    jnp.asarray(job["pw"]), jnp.asarray(job["centroids"]),
    jnp.asarray(job["nb_ids"]), jnp.asarray(job["nb_sims"]), params,
    jnp.asarray(job["q_dense"]), jnp.asarray(job["q_terms"]),
    jnp.asarray(job["q_weights"]))
np.savez({out!r}, ids=np.asarray(ids), scores=np.asarray(scores))
"""


def _job(state, tmp_path, nm):
    cfg, index, _, jb, _, qs = state
    pd, pw = jdd.shard_postings_by_owner(jb, nm)
    guide = np.random.default_rng(3).choice(
        np.asarray([0.0, -0.0, 0.5, 1.0, 2.0], np.float32), 4096)
    path = str(tmp_path / f"job{nm}.npz")
    np.savez(path, cfg_json=json.dumps(dataclasses.asdict(cfg)),
             blocks=jb.blocks, pd=pd, pw=pw, centroids=jb.centroids,
             nb_ids=jb.neighbor_ids, nb_sims=jb.neighbor_sims,
             q_dense=np.asarray(qs.q_dense), q_terms=np.asarray(qs.q_terms),
             q_weights=np.asarray(qs.q_weights), guide=guide, k_guide=100,
             **{f"sel_{k}": np.asarray(v)
                for k, v in index.lstm_params.items()})
    return path


def _jax_serve(job, tmp_path, nd, nm):
    out = str(tmp_path / f"jax{nd}x{nm}.npz")
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _JAX_SERVE.format(job=job, out=out, nd=nd, nm=nm))],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    return dict(np.load(out))


def _torch_serve(job, tmp_path, nd, world=4):
    out_dir = tmp_path / f"torch{nd}"
    out_dir.mkdir()
    tmp.spawn(dist_worker, args=(world, str(tmp_path / f"store{nd}"), nd,
                                 job, str(out_dir)), nprocs=world)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("nd,nm", [(1, 4), (2, 2)])
def test_serve_step_over_gloo_ranks_matches_jax_mesh(state, tmp_path, nd,
                                                     nm):
    job = _job(state, tmp_path, nm)
    want = _jax_serve(job, tmp_path, nd, nm)
    ranks = _torch_serve(job, tmp_path, nd)
    rows = N_QUERIES // nd
    ids = np.zeros_like(want["ids"])
    scores = np.zeros_like(want["scores"])
    for r in ranks:
        d = int(r["data"])
        if int(r["model"]) == 0:
            ids[d * rows:(d + 1) * rows] = r["ids"]
            scores[d * rows:(d + 1) * rows] = r["scores"]
        # every model rank of a data rank returns the same rows
        lead = ranks[d * nm]
        np.testing.assert_array_equal(r["ids"], lead["ids"])
        np.testing.assert_array_equal(r["scores"], lead["scores"])
        # the shard-local guide top-k is the global one
        np.testing.assert_array_equal(r["local_i"], r["global_i"])
        assert r["local_v"].tobytes() == r["global_v"].tobytes()
    ok = isolated_ranks(want["scores"])
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(ids[ok], want["ids"][ok])
    np.testing.assert_allclose(scores, want["scores"], rtol=1e-5, atol=1e-6)
    # the outputs do not depend on how the queries split over 'data':
    # each model group serving the whole batch gives the same rows
    for r in ranks:
        np.testing.assert_array_equal(r["whole_ids"], ids)
        assert r["whole_scores"].tobytes() == scores.tobytes()


def test_local_guide_topk_raises_without_a_process_group():
    g = torch.randn(64)
    spec = tret.CandidateIndexSpec(n_candidates=64, k_guide=8,
                                   local_topk=True)
    with pytest.raises(RuntimeError, match="process group"):
        tret._guide_topk(g, spec)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        tdd.make_mesh(1, 4)


@pytest.mark.parametrize("width", [3, 8, 64])
def test_topk_wide_takes_rounds_of_the_kernel_width(width):
    x = torch.from_numpy(np.random.default_rng(width).choice(
        np.asarray([0.0, -0.0, 1.0, 2.0, -1.0], np.float32), (4, 100)))
    x[:, 90:] = -torch.inf
    v, i = tdd.topk_wide(x, 60, width=width)
    rv, ri = topk_ref(x, 60)
    assert v.numpy().tobytes() == rv.numpy().tobytes()
    fin = torch.isfinite(rv)
    np.testing.assert_array_equal(i[fin].numpy(), ri[fin].numpy())
