"""The router, the distributed serve step and the sort-merge fusion on the
card against the CPU (plain versions).

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_router.py

  * the router over port-written v1 and v2 directories (4 shards) on the
    card: bitwise the port's single-host engine on the card, and equal to
    the CPU router at isolated ranks (scores rtol 1e-5; atol 0 for v2's
    ADC, 1e-6 for v1's dot products)
  * a host's response on the card against the same host on the CPU, on
    the router's own requests (the partial top-k on the host, np.lexsort)
  * two hosts' threads on their own streams: one raises its own error on
    every other request, the other's responses stay bitwise
  * fuse_topk_merge at id multiplicity 1-5 bitwise the CPU's
  * the distributed ServeRunner (1 x 1) on the card against the CPU, the
    wide top-k over the topk kernel's k limit, and the shard-local guide
    top-k through a one-rank gloo group (CUDA tensors staged via host)
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import isolated_ranks

from repro_torch.core import distributed as tdd
from repro_torch.core import fusion as tfusion
from repro_torch.core import retrieval as tret
from repro_torch.engine import EngineHost, ShardRouter
from repro_torch.index import IndexReader
from repro_torch.kernels.topk import topk_ref
from repro_torch.launch import build_index

pytestmark = pytest.mark.cuda

BATCH = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cuda_router")
    out = {}
    for fmt, extra in (("v1", []), ("v2", ["--format-version", "2",
                                           "--pq-nsub", "8"])):
        out[fmt] = str(root / fmt)
        build_index.main(["--out", out[fmt], "--docs", "4096", "--dim", "32",
                          "--clusters", "64", "--shards", "4",
                          "--train-queries", "128", "--epochs", "4",
                          "--device", "cpu", *extra])
    return out


def _queries(path, n=48):
    from repro_torch.data import synth_corpus, synth_queries
    meta = IndexReader.open(path).manifest["extra"]["corpus"]
    corpus = synth_corpus(meta["seed"], meta["n_docs"], meta["dim"],
                          meta["vocab"])
    qs = synth_queries(9, corpus, n)
    return qs.q_dense, qs.q_terms, qs.q_weights


def _serve(make, q3):
    with make() as x:
        ids, sc = x.retrieve(*q3)
        return ids.cpu().numpy(), sc.cpu().numpy()


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_router_on_the_card_is_bitwise_the_engine(card, dirs, fmt):
    path = dirs[fmt]
    q3 = _queries(path)
    ref = _serve(lambda: IndexReader.open(path).engine(
        max_batch=BATCH, prefetch=False, device=card), q3)
    for hosts, repl in ((4, 1), (4, 2), (3, 2)):
        got = _serve(lambda: ShardRouter.local(
            IndexReader.open(path), hosts, repl, max_batch=BATCH,
            device=card), q3)
        for g, r in zip(got, ref):
            assert g.tobytes() == r.tobytes(), (hosts, repl)
    cpu = _serve(lambda: ShardRouter.local(IndexReader.open(path), 4, 2,
                                           max_batch=BATCH, device="cpu"), q3)
    ok = isolated_ranks(cpu[1])
    np.testing.assert_array_equal(got[0][ok], cpu[0][ok])
    np.testing.assert_allclose(got[1], cpu[1], rtol=1e-5,
                               atol=0.0 if fmt == "v2" else 1e-6)


def _requests(path, card):
    seen = []
    with ShardRouter.local(IndexReader.open(path), 4, max_batch=BATCH,
                           device=card) as router:
        for h in router.hosts:
            real = h.submit
            h.submit = (lambda req, real=real, h=h:
                        seen.append((h.host_id, h.shard_ids, req))
                        or real(req))
        router.retrieve(*_queries(path, BATCH))
    return seen


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_host_response_on_the_card_matches_the_cpu(card, dirs, fmt):
    path = dirs[fmt]
    reader = IndexReader.open(path)
    for hid, shards, req in _requests(path, card):
        g_host = EngineHost(hid, reader, shards, device=card)
        c_host = EngineHost(hid, reader, shards, device="cpu")
        got, want = g_host._serve(req), c_host._serve(req)
        g_host.close()
        c_host.close()
        assert got.ids.shape == want.ids.shape
        ok = isolated_ranks(np.where(np.isfinite(want.scores), want.scores,
                                     -1e9))
        np.testing.assert_array_equal(got.ids[ok], want.ids[ok])
        if fmt == "v2":
            np.testing.assert_array_equal(got.ids, want.ids)
            assert got.scores.tobytes() == want.scores.tobytes()
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                                   atol=1e-6)


def test_two_host_threads_keep_their_own_errors(card, dirs):
    """Host A's every other request is malformed (a LUT of the wrong
    width, refused by the adc_score_blocks wrapper in A's thread); host
    B serves beside it the whole time. Only A's bad requests raise, and
    B's responses stay bitwise its first."""
    path = dirs["v2"]
    reader = IndexReader.open(path)
    reqs = {hid: req for hid, _, req in _requests(path, card)}
    a_id, b_id = sorted(reqs)[:2]
    a = EngineHost(a_id, reader, [a_id], device=card)
    b = EngineHost(b_id, reader, [b_id], device=card)
    bad = dataclasses.replace(reqs[a_id],
                              q_or_lut=reqs[a_id].q_or_lut[:, :-1])
    first = b.submit(reqs[b_id]).result()
    futs = [(i, a.submit(bad if i % 2 else reqs[a_id]),
             b.submit(reqs[b_id])) for i in range(40)]
    for i, fa, fb in futs:
        if i % 2:
            with pytest.raises(ValueError, match="shape mismatch"):
                fa.result(timeout=60)
        else:
            fa.result(timeout=60)
        got = fb.result(timeout=60)
        np.testing.assert_array_equal(got.ids, first.ids)
        assert got.scores.tobytes() == first.scores.tobytes()
    a.close()
    b.close()


def test_fuse_topk_merge_on_the_card_is_the_cpu(card):
    rng = np.random.default_rng(1)
    for mult in range(1, 6):
        B, Ks, Kd, n = 8, 300, 900, 500
        sid = rng.integers(0, n, (B, Ks)).astype(np.int32)
        ss = rng.choice(np.asarray([0.0, -0.0, 0.5, 1.0, 2.0], np.float32),
                        (B, Ks))
        did = np.repeat(rng.integers(0, n, (B, -(-Kd // mult))), mult,
                        axis=1)[:, :Kd].astype(np.int32)
        ds = rng.standard_normal((B, Kd)).astype(np.float32)
        dm = rng.random((B, Kd)) < 0.8
        for method in ("interp", "rrf"):
            args = [torch.from_numpy(a) for a in (sid, ss, did, ds, dm)]
            want = tfusion.fuse_topk_merge(*args, 0.3, 100, n + 1,
                                           method=method)
            got = tfusion.fuse_topk_merge(*[a.to(card) for a in args], 0.3,
                                          100, n + 1, method=method)
            for g, w in zip(got, want):
                assert g.cpu().numpy().tobytes() == w.numpy().tobytes()


def test_serve_runner_on_the_card_matches_the_cpu(card, dirs):
    path = dirs["v1"]
    reader = IndexReader.open(path)
    cfg, index = reader.load_index(device="cpu")
    meta = reader.manifest["extra"]["corpus"]
    from repro_torch.data import synth_corpus
    emb = synth_corpus(meta["seed"], meta["n_docs"], meta["dim"],
                       meta["vocab"]).embeddings
    bidx = tdd.build_blocked_index(cfg, index, emb)
    q3 = _queries(path, 32)
    out = {}
    for dev in (card, "cpu"):
        run = tdd.ServeRunner.from_blocked(cfg, tdd.ServeMesh(1, 1), bidx,
                                           device=dev)
        out[str(dev)] = [t.cpu().numpy() for t in run(*q3)]
    (g_ids, g_sc), (c_ids, c_sc) = out[str(card)], out["cpu"]
    ok = isolated_ranks(c_sc)
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(g_ids[ok], c_ids[ok])
    np.testing.assert_allclose(g_sc, c_sc, rtol=1e-5, atol=1e-6)


def test_wide_topk_and_local_guide_topk_on_the_card(card, tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).choice(
        np.asarray([0.0, -0.0, 1.0, 2.0, -1.0, 3.5], np.float32),
        (16, 8192)))
    x[:, 7000:] = -torch.inf
    v, i = tdd.topk_wide(x.to(card), 4000)
    rv, ri = topk_ref(x, 4000)
    assert v.cpu().numpy().tobytes() == rv.numpy().tobytes()
    np.testing.assert_array_equal(i.cpu().numpy(), ri.numpy())
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        g = torch.from_numpy(np.random.default_rng(1).choice(
            np.asarray([0.0, -0.0, 0.5, 1.0], np.float32), 1 << 16))
        spec = tret.CandidateIndexSpec(n_candidates=1 << 16, k_guide=1024,
                                       local_topk=True)
        lv, li = tret._guide_topk(g.to(card), spec)
        gv, gi = tret._guide_topk(g, dataclasses.replace(spec,
                                                         local_topk=False))
        assert lv.device.type == "cuda"
        np.testing.assert_array_equal(li.cpu().numpy(), gi.numpy())
        assert lv.cpu().numpy().tobytes() == gv.numpy().tobytes()
    finally:
        dist.destroy_process_group()
