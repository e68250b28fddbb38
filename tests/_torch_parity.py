"""Shared helpers of the port's parity tests: build state with the JAX
package at smoke widths and carry it across to repro_torch as numpy."""

import numpy as np
import torch

# The suite runs test files in parallel worker processes: a small torch
# intra-op pool keeps these CPU tests from oversubscribing the cores that
# timing-sensitive tests in the other workers share.
torch.set_num_threads(2)


def as_tensor(x):
    """A torch tensor over a writable copy of x (numpy or jax array)."""
    return torch.from_numpy(np.array(x))


def jax_smoke_state(seed=0, *, with_selector=True, **cfg_overrides):
    """(jax cfg, jax CluSDIndex, corpus) at clusd_msmarco.smoke() widths,
    with lstm_init params when `with_selector`."""
    import dataclasses

    import jax

    from repro.configs import get_config
    from repro.core import clusd as cl
    from repro.core.features import feature_dim
    from repro.core.lstm import lstm_init
    from repro.data import synth_corpus

    cfg = get_config("clusd-msmarco", "smoke")
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    corpus = synth_corpus(seed, cfg.n_docs, cfg.dim, cfg.vocab)
    index = cl.build_index(cfg, jax.random.key(seed), corpus.embeddings,
                           corpus.doc_terms, corpus.doc_weights)
    if with_selector:
        index.lstm_params = lstm_init(jax.random.key(seed + 1),
                                      feature_dim(cfg), cfg.lstm_hidden)
    return cfg, index, corpus


def index_arrays(index):
    """A JAX CluSDIndex's fields as numpy, in repro_torch.convert's keys."""
    out = {k: np.asarray(getattr(index, k))
           for k in ("centroids", "cluster_docs", "doc_cluster",
                     "neighbor_ids", "neighbor_sims", "bin_ids")}
    out["sparse_postings_docs"] = np.asarray(index.sparse_index.postings_docs)
    out["sparse_postings_weights"] = np.asarray(
        index.sparse_index.postings_weights)
    out["n_docs"] = index.sparse_index.n_docs
    if index.lstm_params is not None:
        out["lstm_params"] = {k: np.asarray(v)
                              for k, v in index.lstm_params.items()}
    return out


def torch_cfg(jax_cfg):
    """The port's CluSDConfig with the same field values."""
    import dataclasses

    from repro_torch.configs import CluSDConfig
    return CluSDConfig(**dataclasses.asdict(jax_cfg))


def isolated_ranks(scores, tol=1e-5):
    """(B, k) bool: ranks whose score is more than `tol` from both
    neighbours' (the last rank has an unseen neighbour and is left out).
    Ids at these ranks must agree across implementations."""
    s = np.asarray(scores, np.float64)
    gap_next = np.abs(s[:, :-1] - s[:, 1:])
    ok = np.zeros(s.shape, bool)
    ok[:, :-1] = gap_next > tol
    ok[:, 1:-1] &= gap_next[:, :-1] > tol
    return ok


def write_jax_dirs(root, cfg, index, corpus, pq, *, n_shards=3):
    """JAX-written index directories of one state under `root`:
    {"f32", "bf16", "int8"} (format 1) and "v2" (format 2, PQ codes)."""
    import os

    from repro import index as jindex

    emb = np.asarray(corpus.embeddings)
    out = {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16"),
                        ("int8", "int8")):
        out[name] = os.path.join(str(root), name)
        jindex.write_index(out[name], cfg, index, emb, n_shards=n_shards,
                           block_dtype=dtype)
    out["v2"] = os.path.join(str(root), "v2")
    jindex.write_index(out["v2"], cfg, index, emb, n_shards=n_shards,
                       format_version=2, pq=pq)
    return out


def jax_delta(index, dim, vocab, seed, *, n_del=3, n_rep=2, n_app=2):
    """A JAX IndexDelta against `index`: deletes, replacements and
    appends, made from a seed with numpy."""
    from repro import index as jindex

    rng = np.random.default_rng(seed)
    dc = np.asarray(index.doc_cluster)
    live = np.flatnonzero(dc >= 0)
    dele = rng.choice(live, n_del, replace=False)
    reps = rng.choice(np.setdiff1d(live, dele), n_rep, replace=False)
    ids = np.concatenate([reps, np.arange(len(dc), len(dc) + n_app)])
    terms = rng.integers(0, vocab, (len(ids), 4)).astype(np.int32)
    return jindex.IndexDelta(
        upsert_ids=ids,
        upsert_embeddings=rng.standard_normal((len(ids), dim)).astype(
            np.float32),
        upsert_terms=terms,
        upsert_weights=rng.lognormal(0.0, 0.5, terms.shape).astype(
            np.float32),
        delete_ids=dele)



def jax_dirs_state(tmp_path_factory, *, delta_seed=None):
    """`jax_smoke_state(0)`, its PQ (nsub 8) and the JAX-written
    directories of `write_jax_dirs`; given `delta_seed`, also "delta": a
    copy of "f32" with one JAX delta generation. Returns (cfg, index,
    corpus, pq, dirs)."""
    import shutil

    import jax

    from repro import index as jindex
    from repro.core import quant as jquant

    cfg, index, corpus = jax_smoke_state(0)
    pq = jquant.train_pq(jax.random.key(1), corpus.embeddings, nsub=8,
                         iters=3)
    root = tmp_path_factory.mktemp("jax_dirs")
    dirs = write_jax_dirs(root, cfg, index, corpus, pq)
    if delta_seed is not None:
        dirs["delta"] = str(shutil.copytree(dirs["f32"], root / "delta"))
        jindex.write_index_delta(dirs["delta"], jax_delta(
            index, cfg.dim, cfg.vocab, seed=delta_seed))
    return cfg, index, corpus, pq, dirs


# -- serving both packages' engines on one directory -------------------------

SERVE_BATCH = 16


def queries3(qs):
    return qs.q_dense, qs.q_terms, qs.q_weights


def serve_jax(path, qs, **kw):
    """ids, scores, stats() of a fresh JAX engine over `path`."""
    from repro import index as jindex

    with jindex.IndexReader.open(path).engine(max_batch=SERVE_BATCH,
                                              prefetch=False, **kw) as eng:
        ids, sc = eng.retrieve(*queries3(qs))
        return np.asarray(ids), np.asarray(sc), eng.stats()


def serve_torch(path, qs, **kw):
    """ids, scores, stats() of a fresh port engine on the CPU."""
    from repro_torch.index import IndexReader

    with IndexReader.open(path).engine(max_batch=SERVE_BATCH,
                                       prefetch=False, device="cpu",
                                       **kw) as eng:
        ids, sc = eng.retrieve(*queries3(qs))
        return ids.numpy(), sc.numpy(), eng.stats()


def live_engines(path, **kw):
    """(JAX engine, port engine on the CPU) over `path`, left open."""
    from repro import index as jindex
    from repro_torch.index import IndexReader

    jeng = jindex.IndexReader.open(path).engine(max_batch=SERVE_BATCH,
                                                prefetch=False, **kw)
    teng = IndexReader.open(path).engine(max_batch=SERVE_BATCH,
                                         prefetch=False, device="cpu", **kw)
    return jeng, teng


def retrieve_np(eng, qs):
    ids, sc = eng.retrieve(*queries3(qs))
    if isinstance(ids, torch.Tensor):
        return ids.numpy(), sc.numpy()
    return np.asarray(ids), np.asarray(sc)


def assert_same_results(t, j, fusion="interp"):
    """Ids equal at the isolated ranks of the JAX scores, scores allclose
    at rtol 1e-5, atol 1e-6."""
    tids, tsc = t[:2]
    jids, jsc = j[:2]
    assert tids.shape == jids.shape
    ok = isolated_ranks(jsc)
    # rrf scores are rank reciprocals: docs at one rank of one list tie
    # exactly, so fewer ranks are isolated than under interp
    assert ok.mean() > (0.9 if fusion == "interp" else 0.3)
    np.testing.assert_array_equal(tids[ok], jids[ok])
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-6)


def assert_same_stats_surface(ts, js):
    """The engines' stats(): same keys, same counts and I/O."""
    assert sorted(ts) == sorted(js)
    for k in ("cache", "io"):
        assert sorted(ts[k]) == sorted(js[k]), k
    for key in ("n_queries", "n_batches", "n_compile_batches",
                "compiled_buckets", "use_adc", "fusion", "reloads",
                "selector_reloads"):
        assert ts[key] == js[key], key
    assert ts["io"]["n_ops"] == js["io"]["n_ops"] > 0
    assert ts["io"]["bytes"] == js["io"]["bytes"]
    for k in ("hits", "misses", "evictions", "clears", "size"):
        assert ts["cache"][k] == js["cache"][k], k


# -- selector training ---------------------------------------------------------

def tiny_train_cfg():
    """tests/test_train.py's tiny CluSD config (512 docs, 32 clusters,
    n 8), as a JAX config."""
    import dataclasses

    from repro.configs import get_config
    return dataclasses.replace(
        get_config("clusd-msmarco", "smoke"),
        n_docs=512, dim=16, n_clusters=32, vocab=256, max_postings=128,
        k_sparse=64, bins=(5, 15, 30, 64), n_candidates=8, max_selected=4,
        n_neighbors=8, u_bins=4, k_final=32, train_queries=24, epochs=2)


def jax_train_dirs(root, *, seed=0, n_queries=24):
    """The tiny corpus of tests/test_train.py built by the JAX package and
    written by its writer as v1 (3 float32 shards) and v2 (3 PQ code
    shards, nsub 4), each with the synthetic-corpus recipe under `extra`
    (so the train CLIs regenerate its queries). Returns (jax cfg, corpus,
    jax index, {"v1", "v2"}, queries)."""
    import os

    import jax

    from repro import index as jindex
    from repro.core import clusd as cl
    from repro.data import synth_corpus, synth_queries

    cfg = tiny_train_cfg()
    corpus = synth_corpus(seed, cfg.n_docs, cfg.dim, cfg.vocab)
    index = cl.build_index(cfg, jax.random.key(seed), corpus.embeddings,
                           corpus.doc_terms, corpus.doc_weights)
    emb = np.asarray(corpus.embeddings)
    extra = {"corpus": {"kind": "synthetic", "seed": seed,
                        "n_docs": cfg.n_docs, "dim": cfg.dim,
                        "vocab": cfg.vocab}}
    dirs = {"v1": os.path.join(str(root), "v1"),
            "v2": os.path.join(str(root), "v2")}
    jindex.write_index(dirs["v1"], cfg, index, emb, n_shards=3, extra=extra)
    jindex.write_index(dirs["v2"], cfg, index, emb, n_shards=3,
                       format_version=2, pq_nsub=4, extra=extra)
    qs = synth_queries(seed + 3, corpus, n_queries)
    return cfg, corpus, index, dirs, qs


class CappedFetchStore:
    """A ClusterStore wrapper that fails if one fetch asks for more than
    `max_blocks` cluster blocks (the bounded-read contract of streaming
    label generation); `peak` is the largest fetch seen."""

    is_host = True

    def __init__(self, store, max_blocks):
        self._store = store
        self.max_blocks = int(max_blocks)
        self.peak = 0

    @property
    def cluster_docs(self):
        return self._store.cluster_docs

    @property
    def block_bytes(self):
        return self._store.block_bytes

    def fetch_blocks(self, cluster_ids):
        n = len(np.asarray(cluster_ids).reshape(-1))
        self.peak = max(self.peak, n)
        assert n <= self.max_blocks, \
            f"fetched {n} blocks in one read (cap {self.max_blocks})"
        return self._store.fetch_blocks(cluster_ids)


def frozen_zip_time(monkeypatch):
    """Pin the time np.savez stamps into zip member headers, so two
    writes of the same arrays give the same file bytes."""
    import time as time_mod
    import zipfile

    class _T:
        @staticmethod
        def time():
            return 1_700_000_000.0

        localtime = staticmethod(time_mod.localtime)

    monkeypatch.setattr(zipfile, "time", _T)


# -- torch.distributed ranks ---------------------------------------------------

def dist_worker(rank, world, store_path, n_data, job_path, out_dir):
    """One gloo rank of a `torch.multiprocessing.spawn` (a FileStore at
    `store_path`): serves the job's queries through the port's
    ServeRunner on an (n_data, world // n_data) mesh on the CPU (its data
    slice, and again the whole batch on each model group), takes the
    job's guide top-k with local_topk and without, and saves both to
    `out_dir`/rank<r>.npz. The job (an .npz) holds the config as JSON,
    the blocked index, the postings by owner, the selector's params
    (keys "sel_*"), the queries and a guide score vector."""
    import dataclasses
    import json
    import os

    import torch.distributed as tdist

    from repro_torch.configs import CluSDConfig
    from repro_torch.convert import selector_from_numpy
    from repro_torch.core import distributed as tdd
    from repro_torch.core import retrieval as tret

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store_path, world),
                             rank=rank, world_size=world)
    try:
        job = dict(np.load(job_path))
        d = json.loads(str(job["cfg_json"]))
        cfg = CluSDConfig(**{**d, "bins": tuple(d["bins"])})
        mesh = tdd.make_mesh(n_data, world // n_data)
        n_local = job["blocks"].shape[0] // mesh.n_model
        lo = mesh.model * n_local
        params = {k[4:]: v for k, v in job.items() if k.startswith("sel_")}
        runner = tdd.ServeRunner(
            cfg, mesh, job["blocks"][lo:lo + n_local], job["pd"], job["pw"],
            job["centroids"], job["nb_ids"], job["nb_sims"],
            selector_from_numpy(params, device="cpu"), device="cpu")
        q3 = (job["q_dense"], job["q_terms"], job["q_weights"])
        ids, scores = runner(*q3)
        whole_ids, whole_scores = runner.serve(*q3)
        g = torch.from_numpy(job["guide"])
        spec = tret.CandidateIndexSpec(n_candidates=len(g),
                                       k_guide=int(job["k_guide"]),
                                       local_topk=True)
        lv, li = tret._guide_topk(g, spec)
        gv, gi = tret._guide_topk(g, dataclasses.replace(spec,
                                                         local_topk=False))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), ids=ids.numpy(),
                 scores=scores.numpy(), whole_ids=whole_ids.numpy(),
                 whole_scores=whole_scores.numpy(), data=mesh.data,
                 model=mesh.model,
                 local_v=lv.numpy(), local_i=li.numpy(), global_v=gv.numpy(),
                 global_i=gi.numpy())
    finally:
        tdist.destroy_process_group()


def compression_worker(rank, world, store_path, job_path, out_dir):
    """One gloo rank of a `torch.multiprocessing.spawn` (a FileStore at
    `store_path`): runs the port's compressed_psum twice (the second
    from the first's carry) on its slice [rank] of every "g_*" and
    "e_*" array of the job (an .npz), and saves the sums and carries to
    `out_dir`/rank<r>.npz."""
    import os

    import torch.distributed as tdist

    from repro_torch.optim.compression import compressed_psum

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store_path, world),
                             rank=rank, world_size=world)
    try:
        job = dict(np.load(job_path))
        names = sorted(k[2:] for k in job if k.startswith("g_"))
        g = {n: torch.from_numpy(job["g_" + n][rank]) for n in names}
        e = {n: torch.from_numpy(job["e_" + n][rank]) for n in names}
        out = {}
        for step in (0, 1):
            s, e = compressed_psum(g, e, None, world)
            out.update({f"s{step}_{n}": s[n].numpy() for n in names})
            out.update({f"e{step}_{n}": e[n].numpy() for n in names})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tdist.destroy_process_group()
