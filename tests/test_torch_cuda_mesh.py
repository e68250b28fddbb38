"""The sharded MoE dispatches and the router's top-k on the card
(repro_torch.models.moe under a launch.mesh.Mesh).

Marked `cuda`: the `card` fixture skips them where no GPU is present (it
decides inside the fixture, never at import). On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py

  * 2 gloo ranks on the one card (1 x 2): moe_ffn_ep_shardmap and
    moe_ffn_tp_shardmap against the single-card moe_ffn where nothing
    drops (float32, TF32 off: outputs within 1e-5 absolute, the aux
    within 1e-6), and their gradients against autograd through moe_ffn
    (rtol 1e-4, atol 1e-6)
  * the topk kernel at the router's per-shard shapes (the 2 x 2 mixtral
    and 1 x 4 arctic steps' (T_local, E) and their decode batches),
    bitwise its plain version
  * a sharded LM step on a mesh of 4 ranks and no process group raises
  * a rank that holds no rows of a microbatch (the mesh train step's
    uneven split): the router's topk on a (0, E) CUDA tensor returns
    empty outputs with no launch and no plain version, and
    moe_ffn_sort_mesh on (0, d) tokens runs its dispatch plan, scatters
    and expert bmms on the card, with its gradients
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_mesh import spawn

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_ep_and_tp_on_two_ranks_match_the_single_card_moe(card, tmp_path):
    from repro_torch.models import moe

    T, D, F, E = 128, 64, 32, 8
    rng = np.random.default_rng(0)
    job = dict(x=(rng.standard_normal((T, D)) * 0.5).astype(np.float32),
               rw=(rng.standard_normal((D, E)) * 0.3).astype(np.float32),
               wg=(rng.standard_normal((E, D, F)) * 0.2).astype(np.float32),
               wu=(rng.standard_normal((E, D, F)) * 0.2).astype(np.float32),
               wd=(rng.standard_normal((E, F, D)) * 0.2).astype(np.float32),
               ct=rng.standard_normal((T, D)).astype(np.float32),
               c_aux=0.3, device="cuda")
    job["cases"] = [{"mode": m, "mesh": [1, 2]} for m in ("ep", "tp")]
    got = spawn("task_moe", job, tmp_path, world=2)
    t = {k: torch.from_numpy(job[k]).to(card).requires_grad_()
         for k in ("x", "rw", "wg", "wu", "wd")}
    y, aux = moe.moe_ffn(t["x"], t["rw"], t["wg"], t["wu"], t["wd"], top_k=2)
    _, _, eidx = moe.route(t["x"].detach(), t["rw"].detach(), 2)
    C = moe.capacity(T, E, 2)
    assert bool(moe.dispatch_plan(eidx, E, C)[2].all())      # no drops
    loss = (y * torch.from_numpy(job["ct"]).to(card)).sum() + 0.3 * aux
    want = [g.cpu().numpy() for g in torch.autograd.grad(
        loss, [t[k] for k in ("x", "rw", "wg", "wu", "wd")])]
    for i, mode in enumerate(("ep", "tp")):
        for r in range(2):
            o = got[r][i]
            np.testing.assert_allclose(o["y"], y.detach().cpu().numpy(),
                                       rtol=0, atol=1e-5)
            assert abs(o["aux"] - float(aux)) < 1e-6
            np.testing.assert_allclose(o["grads"][0], want[0], rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(o["grads"][1], want[1], rtol=1e-4,
                                       atol=1e-6)
        for j in (2, 3, 4):
            axis = 0 if mode == "ep" else (2 if j < 4 else 1)
            w = np.concatenate([got[r][i]["grads"][j] for r in range(2)],
                               axis)
            np.testing.assert_allclose(w, want[j], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(512, 8), (4, 8), (1024, 128), (8, 128),
                                   (2048, 16)])
def test_topk_at_the_per_shard_router_shapes_is_bitwise(card, shape):
    from repro_torch import kernels
    from repro_torch.kernels.topk import topk, topk_ref

    g = torch.Generator().manual_seed(shape[0] * 7 + shape[1])
    probs = torch.softmax(torch.randn(shape, generator=g), -1)
    probs[::3, 1] = probs[::3, 0]              # exact ties
    kernels.reset_launches()
    v, i = topk(probs.to(card), 2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk"] == 1
    rv, ri = topk_ref(probs, 2)
    assert torch.equal(i.cpu(), ri)
    assert torch.equal(v.cpu().view(torch.int32), rv.view(torch.int32))


def test_a_sharded_step_raises_without_a_process_group(card):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config("mixtral-8x7b", "smoke"),
                              moe_impl="tp_shard_map")
    mesh = Mesh((2, 2), ("data", "model"))
    p = tf.init_params(cfg, device=card)
    tok = torch.zeros((4, 8), dtype=torch.int32, device=card)
    with sh.rules_ctx({}, mesh=mesh):
        pl = sh.shard_tree(p, tf.param_shardings(cfg, mesh))
        with pytest.raises(RuntimeError, match="process group"):
            tf.make_train_step(cfg)(pl, adamw_init(pl),
                                    {"tokens": tok, "labels": tok})


def test_topk_and_the_sort_moe_on_a_rank_with_no_tokens(card, monkeypatch):
    """A rank with no rows of a microbatch: topk on a (0, E) CUDA tensor
    gives (0, 2) values and int64 indices on the card without a launch
    or its plain version; moe_ffn_sort_mesh on a 1 x 1 mesh with (0, d)
    tokens of a global 64 gives a (0, d) output, no load (aux 0), no
    dropped pairs and zero gradients for every weight, with no topk
    launch."""
    from repro_torch import kernels
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe

    def plain(*args, **kw):
        raise AssertionError("topk's plain version ran on the card")
    monkeypatch.setattr(topk_ops, "topk_ref", plain)
    kernels.reset_launches()
    v, i = topk_ops.topk(torch.empty((0, 8), device=card), 2)
    assert v.shape == i.shape == (0, 2)
    assert v.is_cuda and i.is_cuda and i.dtype == torch.long
    E, D, F = 8, 64, 32
    g = torch.Generator(device=card).manual_seed(0)
    w = [torch.randn(s, generator=g, device=card).requires_grad_()
         for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    x = torch.empty((0, D), device=card, requires_grad=True)
    y, aux, dropped = moe.moe_ffn_sort_mesh(
        x, *w, top_k=2, mesh=make_debug_mesh((1, 1)), n_tokens=64)
    grads = torch.autograd.grad((y * 2).sum() + aux, [x] + w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk"] == 0
    assert y.shape == (0, D) and y.is_cuda
    assert float(aux.detach()) == 0.0 and int(dropped) == 0
    assert grads[0].shape == (0, D)
    for gw, ww in zip(grads[1:], w):
        assert gw.shape == ww.shape and gw.is_cuda
        assert not bool(gw.any())
