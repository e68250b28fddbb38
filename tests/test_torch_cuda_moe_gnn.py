"""The MoE router, the MoE LM and NequIP on the card against the plain
versions and the CPU (repro_torch.models.{moe,transformer,nequip}), and
compressed_psum on a CUDA tensor.

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe_gnn.py

Tolerances: the topk kernel at the router's shapes bitwise its plain
version (indices and values); moe_ffn card against CPU (float32, TF32
off, cuBLAS sums in another order) outputs rtol 1e-5, atol 1e-6,
gradients rtol 1e-4, atol 1e-6, the expert ids equal; the mixtral smoke
LM hidden states rtol 1e-4, atol 1e-5 and gradients rtol 1e-3, atol
1e-6; NequIP energies rtol 1e-5, atol 1e-6 and gradients rtol 1e-4,
atol 1e-7 (the scatters add in another order on the card);
compressed_psum bitwise (its sum is exact in int32).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.kernels.topk import topk, topk_ref
from repro_torch.models import moe, nequip

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(128, 8), (1024, 8), (8, 128),
                                   (1024, 128)])
def test_topk_at_the_router_shapes_is_bitwise_the_plain_version(card, shape):
    g = torch.Generator().manual_seed(shape[0] + shape[1])
    probs = torch.softmax(torch.randn(shape, generator=g), -1)
    probs[::3, 1] = probs[::3, 0]              # exact ties
    probs[::5, -1] = probs[::5].max(-1).values
    x = probs.to(card)
    kernels.reset_launches()
    v, i = topk(x, 2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk"] == 1
    rv, ri = topk_ref(probs, 2)
    assert torch.equal(i.cpu(), ri)
    assert torch.equal(v.cpu().view(torch.int32), rv.view(torch.int32))


def _moe_inputs(T=256, d=64, f=32, E=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, d, generator=g) * 0.5
    x[1::2] = x[0]                              # half the tokens alike
    return [x, torch.randn(d, E, generator=g) * 0.3,
            torch.randn(E, d, f, generator=g) * 0.2,
            torch.randn(E, d, f, generator=g) * 0.2,
            torch.randn(E, f, d, generator=g) * 0.2]


def test_moe_ffn_on_the_card_matches_the_cpu_with_drops(card):
    cpu = _moe_inputs()
    gout = torch.randn(cpu[0].shape, generator=torch.Generator()
                       .manual_seed(1))
    _, _, eidx = moe.route(cpu[0], cpu[1], 2)
    C = moe.capacity(256, 8, 2)
    load = torch.bincount(eidx.reshape(-1), minlength=8)
    assert int((load - C).clamp(min=0).sum()) > 0
    outs = {}
    for dev in ("cpu", card):
        ts = [t.to(dev).requires_grad_() for t in cpu]
        kernels.reset_launches()
        out, aux = moe.moe_ffn(*ts, top_k=2)
        grads = torch.autograd.grad((out * gout.to(dev)).sum() + aux, ts)
        outs[str(dev)] = (out, aux, grads, moe.route(ts[0], ts[1], 2)[2])
        if dev == card:
            assert kernels.LAUNCHES["topk"] == 2
    (oc, ac, gc, ec), (og, ag, gg, eg) = outs["cpu"], outs[str(card)]
    assert torch.equal(eg.cpu(), ec)
    torch.testing.assert_close(og.cpu(), oc, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ag.cpu(), ac, rtol=1e-6, atol=0)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)


def test_mixtral_smoke_forward_and_gradients_card_vs_cpu(card):
    from repro_torch.models import transformer as tt

    cfg = get_config("mixtral-8x7b", "smoke")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    g = torch.Generator().manual_seed(2)
    t = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    batch = {"tokens": t[:, :-1].int(), "labels": t[:, 1:].int()}
    (tc_, lc, ac), gc = tt.value_and_grad(cfg, params, batch)
    gp = tree_map(lambda x: x.to(card), params)
    (tg, lg, ag), gg = tt.value_and_grad(
        cfg, gp, {k: v.to(card) for k, v in batch.items()})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
    torch.testing.assert_close(ag.cpu(), ac, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-6)
    with torch.no_grad():
        hg = tt.forward(cfg, gp, batch["tokens"].to(card))[0]
        hc = tt.forward(cfg, params, batch["tokens"])[0]
    torch.testing.assert_close(hg.cpu(), hc, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["molecules", "padded"])
def test_nequip_forward_and_gradient_card_vs_cpu(card, kind):
    from repro_torch.data.graphs import synth_molecules
    from repro_torch.data.sampler import CSRGraph, padded_batch

    cfg = get_config("nequip", "smoke")
    if kind == "molecules":
        d_feat = 0
        b = synth_molecules(3, 16, 12, 32, n_species=cfg.n_species)
    else:
        d_feat = 6
        rng = np.random.default_rng(0)
        src = rng.integers(0, 400, 3000).astype(np.int32)
        dst = rng.integers(0, 400, 3000).astype(np.int32)
        b = padded_batch(CSRGraph.from_edges(src, dst, 400),
                         rng.standard_normal((400, 6)).astype(np.float32),
                         np.arange(16), (5, 3), np.random.default_rng(1),
                         max_nodes=320, max_edges=400)
        b["positions"] = (3.0 * rng.standard_normal((320, 3))) \
            .astype(np.float32)
    params = nequip.init_params(cfg, torch.Generator().manual_seed(0),
                                d_feat, device="cpu")
    cb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    gb = {k: v.to(card) for k, v in cb.items()}
    gp = tree_map(lambda x: x.to(card), params)
    with torch.no_grad():
        torch.testing.assert_close(nequip.forward(cfg, gp, gb).cpu(),
                                   nequip.forward(cfg, params, cb),
                                   rtol=1e-5, atol=1e-6)
    lc, gc = nequip.value_and_grad(cfg, params, cb)
    lg, gg = nequip.value_and_grad(cfg, gp, gb)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-6)
    for a, c in zip(tree_leaves(gg), tree_leaves(gc)):
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-7)


def test_compressed_psum_on_the_card_is_bitwise_the_cpu(card, tmp_path):
    import torch.distributed as dist

    from repro_torch.optim.compression import compressed_psum, ef_init

    g = {"w": torch.randn(4096, 33, generator=torch.Generator()
                          .manual_seed(5))}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        sc, ec = compressed_psum(g, ef_init(g))
        gd = {"w": g["w"].to(card)}
        sg, eg = compressed_psum(gd, ef_init(gd))
    finally:
        dist.destroy_process_group()
    assert sg["w"].is_cuda
    assert torch.equal(sg["w"].cpu().view(torch.int32),
                       sc["w"].view(torch.int32))
    assert torch.equal(eg["w"].cpu().view(torch.int32),
                       ec["w"].view(torch.int32))
