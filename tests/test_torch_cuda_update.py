"""The update path and the streaming build on the card against the CPU.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_update.py

Tolerances: a delta written on the card equals its CPU twin file for
file, but for upsert code rows (v2) whose `pq_encode` argmin is a
near-tie (relative gap of the two codes' squared distances under 1e-5;
each one is counted) and, after a re-cluster, the neighbor graph (ids at
ranks more than 1e-5 from both neighbours' sims, sims rtol 1e-5, atol
1e-6); `build_index_offline` at 65536 docs x dim 768, N 256, on data
with no near-tie: assignments and the cluster table equal, centroids rtol
1e-5; the topk kernel at the neighbor graph's (8192, 8192), k 128,
bitwise its plain version.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from _torch_parity import isolated_ranks

from repro_torch import kernels
from repro_torch.core import kmeans as km
from repro_torch.core import quant
from repro_torch.index import IndexReader, build_index_offline, write_index
from repro_torch.index import update as upd
from repro_torch.kernels.topk import topk, topk_ref
from repro_torch.launch.update_index import synth_delta

pytestmark = pytest.mark.cuda

NEAR_TIE = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _clustered(n_docs, dim, n_clusters, noise, seed):
    """Unit rows around n_clusters random unit centres, cluster c's rows
    at [c * n, (c + 1) * n): every row far nearer its own centre."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    X = np.repeat(centres, n_docs // n_clusters, axis=0)
    X += noise * rng.standard_normal(X.shape).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    terms = rng.integers(0, 512, (n_docs, 8)).astype(np.int32)
    weights = rng.lognormal(0, 0.5, terms.shape).astype(np.float32)
    return X, terms, weights


def _index_dir(root, fv, *, n_docs=8192, dim=64, n_clusters=64):
    """A v1 or v2 directory written by the port from a CPU build."""
    import dataclasses

    from repro_torch.configs import clusd_msmarco

    cfg = dataclasses.replace(clusd_msmarco.smoke(), n_docs=n_docs, dim=dim,
                              n_clusters=n_clusters, vocab=512)
    X, terms, weights = _clustered(n_docs, dim, 16, 0.8, seed=fv)
    index = build_index_offline(cfg, X, terms, weights, shard_docs=2048,
                                kmeans_iters=3, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    out = str(root / f"v{fv}")
    write_index(out, cfg, index, X, n_shards=4, format_version=fv,
                pq_nsub=8)
    return out


def _code_near_ties(card_dir, cpu_dir, delta):
    """Compare the staged code shards of one delta written twice: every
    differing (slot, subspace) must hold an upserted doc whose two codes
    are a near-tie. Returns the number of such codes."""
    man = json.load(open(os.path.join(cpu_dir, "manifest.json")))
    r = IndexReader.open(cpu_dir)
    books = r._pq_array("codebooks").astype(np.float64)
    cd = np.asarray(r.array("cluster_docs"))
    nsub, cap = books.shape[0], cd.shape[1]
    row_of = {int(d): i for i, d in enumerate(delta.upsert_ids)}
    n = 0
    for s in man["block_shards"]:
        a = np.fromfile(os.path.join(card_dir, s["file"]), np.uint8)
        b = np.fromfile(os.path.join(cpu_dir, s["file"]), np.uint8)
        a, b = a.reshape(-1, cap, nsub), b.reshape(-1, cap, nsub)
        for c, slot, sub in np.argwhere(a != b):
            d = int(cd[s["cluster_lo"] + c, slot])
            x = delta.upsert_embeddings[row_of[d]].astype(np.float64)
            xs = x.reshape(nsub, -1)[sub]
            da = ((xs - books[sub, a[c, slot, sub]]) ** 2).sum()
            db = ((xs - books[sub, b[c, slot, sub]]) ** 2).sum()
            assert abs(da - db) <= NEAR_TIE * max(da, db), (d, sub)
            n += 1
    return n


def _same_generation(card_dir, cpu_dir, delta, reclustered):
    """Card vs CPU twin: the manifests (but for wall times and the sha256
    of the files allowed to differ), every staged file, the codes under
    the near-tie rule, the neighbor graph at its tolerance."""
    mans = []
    for d in (card_dir, cpu_dir):
        with open(os.path.join(d, "manifest.json")) as f:
            mans.append(json.load(f))
    g = mans[1]["generation"]
    loose = {s["file"] for s in mans[1]["block_shards"]
             if s["file"].endswith(f".g{g}.codes.bin")}
    if reclustered:
        ids = mans[1]["arrays"]["neighbor_ids"]
        sims = mans[1]["arrays"]["neighbor_sims"]
        loose |= {ids, sims}
        cs, ts = (np.load(os.path.join(d, sims)) for d in (card_dir, cpu_dir))
        np.testing.assert_allclose(cs, ts, rtol=1e-5, atol=1e-6)
        ok = isolated_ranks(ts)
        ci, ti = (np.load(os.path.join(d, ids)) for d in (card_dir, cpu_dir))
        np.testing.assert_array_equal(ci[ok], ti[ok])
    for m in mans:
        m["update_stats"].pop("wall_s")
        for rel in loose:
            m["files"][rel].pop("sha256")
    assert mans[0] == mans[1]
    for rel in mans[1]["files"]:
        if f".g{g}" in rel and rel not in loose:
            with open(os.path.join(card_dir, rel), "rb") as f, \
                    open(os.path.join(cpu_dir, rel), "rb") as h:
                assert f.read() == h.read(), rel
    return _code_near_ties(card_dir, cpu_dir, delta) \
        if any(r.endswith(".codes.bin") for r in loose) else 0


@pytest.mark.parametrize("fv", [1, 2])
def test_write_index_delta_on_the_card_matches_a_cpu_twin(card, fv,
                                                          tmp_path):
    """A synthetic delta (v2: upserts encoded on the card), then for v1 a
    re-clustering delta (neighbor graph on the card), and a compaction."""
    src = _index_dir(tmp_path, fv)
    gpu = str(shutil.copytree(src, tmp_path / "gpu"))
    cpu = str(shutil.copytree(src, tmp_path / "cpu"))
    delta, _ = synth_delta(IndexReader.open(cpu), 400, 100, seed=1)
    before = kernels.LAUNCHES["topk"]
    r_gpu = upd.write_index_delta(gpu, delta, device=card)
    r_cpu = upd.write_index_delta(cpu, delta, device="cpu")
    for r in (r_gpu, r_cpu):
        r.pop("wall_s")
    assert r_gpu == r_cpu and r_gpu["shards_rewritten"]
    n_ties = _same_generation(gpu, cpu, delta, r_cpu["reclustered_shards"])
    print(f"v{fv}: {n_ties} near-tie codes")
    if fv == 1:
        delta, _ = synth_delta(IndexReader.open(cpu), 400, 100, seed=2)
        kw = dict(recluster_overflow=0.0, recluster_min_overflow=0)
        r_gpu = upd.write_index_delta(gpu, delta, device=card, **kw)
        r_cpu = upd.write_index_delta(cpu, delta, device="cpu", **kw)
        assert r_gpu["reclustered_shards"] == r_cpu["reclustered_shards"] \
            != []
        assert kernels.LAUNCHES["topk"] > before     # neighbor_graph
        _same_generation(gpu, cpu, delta, True)
    m_gpu = upd.compact_index(gpu, device=card)
    m_cpu = upd.compact_index(cpu, device="cpu")
    assert m_gpu["generation"] == m_cpu["generation"]
    IndexReader.open(gpu, verify="full")


def test_build_index_offline_on_the_card_matches_the_cpu(card):
    import dataclasses

    from repro_torch.configs import clusd_msmarco

    n_docs, dim, N = 65536, 768, 256
    cfg = dataclasses.replace(clusd_msmarco.full(), n_docs=n_docs,
                              n_clusters=N, n_neighbors=32)
    X, terms, weights = _clustered(n_docs, dim, N, 0.05, seed=3)
    init = np.arange(0, n_docs, n_docs // N) + 7        # one row a cluster
    kw = dict(shard_docs=16384, kmeans_iters=3, init_idx=init)
    g = build_index_offline(cfg, X, terms, weights, device=card, **kw)
    c = build_index_offline(cfg, X, terms, weights, device="cpu", **kw)
    np.testing.assert_array_equal(g.doc_cluster.cpu().numpy(),
                                  c.doc_cluster.numpy())
    np.testing.assert_array_equal(g.cluster_docs.cpu().numpy(),
                                  c.cluster_docs.numpy())
    np.testing.assert_allclose(g.centroids.cpu().numpy(),
                               c.centroids.numpy(), rtol=1e-5, atol=1e-7)
    cs = c.neighbor_sims.numpy()
    np.testing.assert_allclose(g.neighbor_sims.cpu().numpy(), cs, rtol=1e-5,
                               atol=1e-6)
    ok = isolated_ranks(cs)
    np.testing.assert_array_equal(g.neighbor_ids.cpu().numpy()[ok],
                                  c.neighbor_ids.numpy()[ok])
    assert g.centroids.device.type == "cuda"
    # the streamed PQ: codebooks trained on the card, codes of every row
    pq = quant.train_pq_stream(X, 96, iters=2, sample_docs=8192,
                               chunk_docs=8192, device=card,
                               generator=torch.Generator().manual_seed(0))
    assert pq.codes.shape == (n_docs, 96) and pq.codes.device.type == "cuda"


def test_topk_on_the_neighbor_graph_shape(card):
    """The (8192, 8192) centroid similarities with the self term pushed
    down, k 128: the kernel bitwise its plain version, and
    `neighbor_graph` on the card against the CPU's."""
    g = torch.Generator(device="cuda").manual_seed(0)
    C = torch.randn(8192, 768, device=card, generator=g)
    C = C / C.norm(dim=1, keepdim=True)
    sims = C @ C.T - 2e9 * torch.eye(8192, device=card)
    before = kernels.LAUNCHES["topk"]
    v, i = topk(sims, 128)
    rv, ri = topk_ref(sims, 128)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk"] == before + 1
    assert torch.equal(i, ri)
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32))
    ids, nsims = km.neighbor_graph(C, 128)
    cids, csims = km.neighbor_graph(C.cpu(), 128)
    np.testing.assert_allclose(nsims.cpu().numpy(), csims.numpy(), rtol=1e-5,
                               atol=1e-6)
    ok = isolated_ranks(csims.numpy())
    np.testing.assert_array_equal(ids.cpu().numpy()[ok], cids.numpy()[ok])
    assert (ids != torch.arange(8192, device=card)[:, None]).all()
