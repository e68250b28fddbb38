"""The recsys slice on the card: the embedding_bag kernel against its plain
version, and the recsys models and CluSD candidate retrieval on the card
against the CPU.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_recsys.py

Tolerances: the kernel bitwise against the plain version (float32, and
bfloat16: both add in float32 in ascending h and round once on store),
bfloat16 within 3e-2 of the float32 bag; recsys towers bitwise card
against CPU (the kernel's order is the plain version's), forward logits
rtol 1e-5 and atol 1e-5 (matmuls summed in another order); retrieval ids
equal at isolated ranks, scores rtol 1e-5 and atol 1e-6.
"""

import numpy as np
import pytest
import torch
from _torch_parity import isolated_ranks

from repro_torch import kernels
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref

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


def test_embedding_bag_kernel_bitwise_vs_plain(card):
    """d in {1, 10, 32, 128} x hot in {1, 2, 40}, and B = 0 (the cases
    are looped, not parametrised: this file's few items keep the driver's
    file-by-test-count schedule as it was)."""
    g = _gen()
    V, B = 5000, 3000
    for d in (1, 10, 32, 128):
        for hot in (1, 2, 40):
            table = torch.randn(V, d, device=card, generator=g)
            # heavy-tailed ids, as the recsys traffic draws them
            idx = (torch.rand(B, hot, device=card, generator=g) ** 4
                   * V).int()
            before = kernels.LAUNCHES["embedding_bag"]
            out = embedding_bag(table, idx)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["embedding_bag"] == before + 1
            ref = embedding_bag_ref(table, idx)
            assert out.shape == (B, d) and out.dtype == torch.float32
            assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
            # a table that starts 4 bytes into its storage: no float4
            # path, the same bits
            odd = table.view(-1)[1:1 + (V - 1) * d].view(V - 1, d)
            out = embedding_bag(odd, idx.clamp(max=V - 2))
            assert torch.equal(out, embedding_bag_ref(odd,
                                                      idx.clamp(max=V - 2)))
            assert embedding_bag(table, idx[:0]).shape == (0, d)


def test_embedding_bag_kernel_bfloat16(card):
    g = _gen()
    for d, hot in ((1, 40), (10, 2), (32, 20), (128, 3)):
        table = torch.randn(2000, d, device=card, generator=g)
        idx = torch.randint(0, 2000, (777, hot), device=card, generator=g,
                            dtype=torch.int32)
        out = embedding_bag(table.bfloat16(), idx)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, embedding_bag_ref(table.bfloat16(), idx))
        torch.testing.assert_close(out.float(), embedding_bag_ref(table, idx),
                                   rtol=3e-2, atol=3e-2 * 4)


def test_embedding_bag_rejects_bad_inputs(card):
    table = torch.randn(100, 8, device=card)
    idx = torch.zeros(4, 3, dtype=torch.int32, device=card)
    for bad in (-1, 100):
        with pytest.raises(IndexError, match="outside the table"):
            embedding_bag(table, torch.full_like(idx, bad))
    with pytest.raises(TypeError):
        embedding_bag(table, idx.long())
    with pytest.raises(TypeError):
        embedding_bag(table.double(), idx)
    with pytest.raises(ValueError):
        embedding_bag(table, idx.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table[:, ::2], idx)


@pytest.mark.parametrize("arch", ["wide-deep", "deepfm", "dlrm-mlperf",
                                  "din"])
def test_recsys_model_on_the_card_matches_the_cpu(card, arch):
    from repro_torch.configs import get_config
    from repro_torch.data import RecsysStream
    from repro_torch.models import recsys as rs

    cfg = get_config(arch, "smoke")
    params = rs.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cpu = rs.RecsysModel(cfg, params, device="cpu")
    gpu = rs.RecsysModel(cfg, params)
    assert gpu.device.type == "cuda"
    batch = {k: v for k, v in RecsysStream(cfg, seed=1).batch(64).items()
             if k != "label"}
    cb, gb = rs.as_batch(batch, "cpu"), rs.as_batch(batch, gpu.device)
    kernels.reset_launches()
    with torch.no_grad():
        logits = gpu(gb)
        u = gpu.user_tower(gb)
        v = gpu.candidate_tower(gb["sparse"][:, :2])
    torch.testing.assert_close(logits.cpu(), cpu(cb), rtol=1e-5, atol=1e-5)
    if arch != "dlrm-mlperf":     # dlrm's user tower is an MLP
        assert torch.equal(u.cpu(), cpu.user_tower(cb))
    assert torch.equal(v.cpu(), cpu.candidate_tower(cb["sparse"][:, :2]))
    # the wide branch (wide-deep, deepfm) and the towers run the kernel
    n_bags = {"wide-deep": 3, "deepfm": 3, "dlrm-mlperf": 1, "din": 2}[arch]
    assert kernels.LAUNCHES["embedding_bag"] == n_bags


def test_clusd_candidate_retrieval_on_the_card_matches_the_cpu(card):
    """The port's own candidate index (kmeans, cluster table, neighbour
    graph) at wide-deep smoke widths; each query on the card launches
    embedding_bag, topk, bin_overlap and lstm_sequence."""
    from repro_torch.configs import get_config
    from repro_torch.core import kmeans as km
    from repro_torch.core import retrieval as ret
    from repro_torch.core.lstm import LSTMSelector
    from repro_torch.data import RecsysStream
    from repro_torch.models import recsys as rs

    cfg = get_config("wide-deep", "smoke")
    g = torch.Generator().manual_seed(0)
    params = rs.init_params(cfg, g, device="cpu")
    N, cap, n_cand = 64, 256, 15000
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(np.stack([rng.integers(0, cfg.table_sizes[i],
                                                  n_cand)
                                     for i in range(2)], 1).astype(np.int32))
    model = {"cpu": rs.RecsysModel(cfg, params, device="cpu"),
             "cuda": rs.RecsysModel(cfg, params)}
    vecs = model["cpu"].candidate_tower(raw)
    cents, assign = km.kmeans(vecs, N, 8, generator=g, device="cpu")
    table, _ = km.build_cluster_table(assign.numpy(), N, cap, vecs.numpy(),
                                      cents.numpy())
    table = torch.from_numpy(table)
    valid = table >= 0
    blocks = torch.zeros(N, cap, vecs.shape[1])
    blocks[valid] = vecs[table[valid].long()]
    cand = torch.zeros(N * cap, 2, dtype=torch.int32)
    cand[valid.reshape(-1)] = raw[table[valid].long()]
    nb_ids, nb_sims = km.neighbor_graph(cents, N - 1)
    spec = ret.CandidateIndexSpec(n_candidates=n_cand, n_clusters=N, cap=cap,
                                  max_selected=12, theta=0.47, alpha=0.3)
    sel = LSTMSelector(1 + spec.u_bins + 2 * spec.v_bins, 32, generator=g)
    users = {k: v for k, v in RecsysStream(cfg, seed=3).batch(4).items()
             if k != "label"}
    out = {}
    for dev in ("cpu", "cuda"):
        moved = [t.to(dev) for t in (cand, blocks, cents, nb_ids, nb_sims,
                                     valid.reshape(-1))]
        s = sel.to(dev)
        kernels.reset_launches()
        res = []
        with torch.no_grad():
            for q in range(4):
                b = rs.as_batch({k: v[q:q + 1] for k, v in users.items()},
                                model[dev].device)
                ids, sc, _ = ret.clusd_candidate_retrieval(
                    cfg, spec, model[dev], b, moved[0], moved[1], moved[2],
                    s, moved[3], moved[4], slot_valid=moved[5])
                res.append((ids.cpu().numpy(), sc.cpu().numpy()))
        out[dev] = res
        if dev == "cuda":
            # a query: user tower + guide bags, guide/budget/fuse top-ks
            assert kernels.LAUNCHES["embedding_bag"] == 8
            assert kernels.LAUNCHES["topk"] == 12
            assert kernels.LAUNCHES["bin_overlap"] == 4
            assert kernels.LAUNCHES["lstm_sequence"] == 4
    for (g_ids, g_sc), (c_ids, c_sc) in zip(out["cuda"], out["cpu"]):
        ok = isolated_ranks(c_sc[None])[0]
        np.testing.assert_array_equal(g_ids[ok], c_ids[ok])
        np.testing.assert_allclose(g_sc, c_sc, rtol=1e-5, atol=1e-6)
