"""NequIP's default `msg_impl="pjit"` on a mesh: the port's
`models/nequip.py` forward and train step on 4 gloo ranks, each holding
its "edges" slice of the batch (and its "nodes" slice where the rules
split the nodes), against the JAX package's
`jax.jit(nq.make_train_step(cfg), in_shardings=...)` with the dry-run
cell's shardings (`launch/specs._gnn_cell`) on 4 host devices, from
JAX's init.

Cases: 2 x 2 with the nodes whole (the molecule cell's rules), 2 x 2
with the nodes over "data" (the minibatch_lg cell's rules, with raw node
features, energy weights and a node mask as the sampler's batch has
them), and 1 x 4. nequip smoke, float32, N = 64 nodes, E = 304 edges
with a quarter of them masked.

Tolerances (float32 on the CPU, tests/test_torch_nequip_mesh.py's): the
energies rtol 2e-4, atol 2e-5, also against the port's one-device
forward; the loss rtol 1e-5, the gradient norm rtol 1e-4, every param
within 5e-4 after one AdamW step. An AdamW step moves each param by
about lr whatever its gradient, so each gradient leaf is also held
through the first moment after the step ((1 - b1) x the clipped
gradient) within 1e-4 x its largest magnitude: a gradient summed twice
over the edge shards fails there. The ranks' params are bitwise equal
after the step.
"""

import json

import numpy as np
import pytest

from _torch_mesh import nest, run_jax, spawn

N, E = 64, 304
CASES = [
    dict(name="2x2_nodes_whole", mesh=[2, 2], rules={}),
    dict(name="2x2_nodes_data", mesh=[2, 2], rules={"nodes": ["data"]},
         d_feat=6),
    dict(name="1x4", mesh=[1, 4], rules={}),
]
IDS = [c["name"] for c in CASES]

_JAX = r"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import nequip as nq
from repro.models.sharding import named_sharding, rules_ctx
from repro.optim import adamw_init
job = dict(np.load(JOB))
cases = json.loads(str(job["cases"]))
cfg = get_config("nequip", "smoke")
flat = lambda t: {jax.tree_util.keystr(p): np.asarray(x)
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
node = ("positions", "node_feat", "species", "graph_id", "node_mask")
out = {}
for i, c in enumerate(cases):
    d_feat = c.get("d_feat", 0)
    params = nq.init_params(cfg, jax.random.key(i), d_feat)
    out.update({f"init{i}" + k: v for k, v in flat(params).items()})
    pre = f"b{i}_"
    batch = {k[len(pre):]: jnp.asarray(v) for k, v in job.items()
             if k.startswith(pre)}
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = {k: tuple(v) if isinstance(v, list) else v
             for k, v in c["rules"].items()}
    with rules_ctx(rules, mesh=mesh):
        psh = nq.param_shardings(cfg, mesh, d_feat)
        bsh = {k: named_sharding(mesh, "nodes", *(None,) * (v.ndim - 1))
               if k in node else named_sharding(mesh, "edges")
               if k.startswith("edge_") else NamedSharding(mesh, P())
               for k, v in batch.items()}
        osh = {"mu": psh, "nu": psh, "count": NamedSharding(mesh, P())}
        e = jax.jit(lambda p, b: nq.forward(cfg, p, b),
                    in_shardings=(psh, bsh))(params, batch)
        step = jax.jit(nq.make_train_step(cfg), in_shardings=(psh, osh, bsh))
        p2, o2, m = step(params, adamw_init(params), batch)
    out[f"e{i}"] = np.asarray(e)
    out.update({f"p{i}" + k: v for k, v in flat(p2).items()})
    out.update({f"mu{i}" + k: v for k, v in flat(o2["mu"]).items()})
    out[f"loss{i}"] = np.asarray(m["loss"])
    out[f"gn{i}"] = np.asarray(m["grad_norm"])
np.savez(OUT, **out)
"""


def _batch(i, case):
    rng = np.random.default_rng(10 + i)
    mask = np.ones(E, np.float32)
    mask[rng.choice(E, E // 4, replace=False)] = 0.0
    b = dict(positions=(rng.standard_normal((N, 3)) * 2).astype(np.float32),
             edge_src=rng.integers(0, N, E).astype(np.int32),
             edge_dst=rng.integers(0, N, E).astype(np.int32),
             edge_mask=mask)
    if case.get("d_feat"):
        # minibatch_lg's layout: a graph per seed node, the rest in an
        # ignore bucket of weight 0, padding nodes masked
        b["node_feat"] = rng.standard_normal(
            (N, case["d_feat"])).astype(np.float32)
        b["graph_id"] = np.minimum(np.arange(N), 4).astype(np.int32)
        b["energy_target"] = rng.standard_normal(5).astype(np.float32)
        b["energy_weight"] = np.asarray([1, 1, 1, 1, 0], np.float32)
        b["node_mask"] = (np.arange(N) < N - 8).astype(np.float32)
    else:
        b["species"] = rng.integers(0, 8, N).astype(np.int32)
        b["graph_id"] = (np.arange(N) >= 40).astype(np.int32)
        b["energy_target"] = np.asarray([1.5, -2.0], np.float32)
    return b


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nequip_pjit")
    job = {"cases": json.dumps(CASES)}
    batches = [_batch(i, c) for i, c in enumerate(CASES)]
    for i, b in enumerate(batches):
        job.update({f"b{i}_{k}": v for k, v in b.items()})
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, **job)
    run_jax(_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = {"cases": CASES}
    for i, b in enumerate(batches):
        tjob[f"params{i}"] = nest(want, f"init{i}")
        tjob[f"batch{i}"] = b
    return batches, want, spawn("task_nequip_pjit", tjob, tmp)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_pjit_forward_matches_jax_and_one_device(results, i):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import nequip_params_from_numpy
    from repro_torch.models import nequip

    batches, want, got = results
    for o in got:
        np.testing.assert_allclose(o[i]["energy"], want[f"e{i}"], rtol=2e-4,
                                   atol=2e-5)
        assert o[i]["energy"].tobytes() == got[0][i]["energy"].tobytes()
        assert o[i]["n_edges"] == E // 4
    cfg = get_config("nequip", "smoke")
    p = nequip_params_from_numpy(cfg, nest(want, f"init{i}"),
                                 CASES[i].get("d_feat", 0), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batches[i].items()}
    e1 = nequip.forward(cfg, p, b).numpy()
    np.testing.assert_allclose(got[0][i]["energy"], e1, rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_pjit_train_step_matches_jax(results, i):
    _, want, got = results
    for o in got:
        np.testing.assert_allclose(o[i]["loss"], want[f"loss{i}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o[i]["gnorm"], want[f"gn{i}"], rtol=1e-4)
        for k, v in o[i]["params"].items():
            assert np.abs(v - want[f"p{i}" + k]).max() < 5e-4, k
        # each gradient leaf, through the first moment after the step
        # (exactly 0 where the reference's is: the l=1 and l=2 skips of
        # the first layer read zero features, and the last layer's l=1
        # and l=2 outputs reach no energy)
        for k, v in o[i]["mu"].items():
            w = want[f"mu{i}" + k]
            assert np.abs(v - w).max() <= 1e-4 * float(np.abs(w).max()), k
    # the ranks hold the same params after the step
    for o in got[1:]:
        for k, v in o[i]["params"].items():
            assert v.tobytes() == got[0][i]["params"][k].tobytes(), k


def test_pjit_collectives_are_whole_aggregates_and_gathered_nodes(results):
    """A forward all-reduces one whole (N, C, 9) float32 aggregate a layer
    over the edge shards; a step adds the backward's (the packed node
    features' cotangent, a layer) and the three radial weights' gradients;
    node arrays split over "nodes" are gathered whole, once a forward."""
    from repro_torch.configs import get_config
    from repro_torch.models.nequip import N_PATHS, NODE_KEYS, RADIAL_HIDDEN

    batches, _, got = results
    cfg = get_config("nequip", "smoke")
    L, C = cfg.n_layers, cfg.d_hidden
    agg = L * N * C * 9 * 4
    radial = L * (cfg.n_rbf * RADIAL_HIDDEN + RADIAL_HIDDEN
                  + RADIAL_HIDDEN * N_PATHS * C) * 4
    for i, c in enumerate(CASES):
        gathered = sum(v.nbytes for k, v in batches[i].items()
                       if c["rules"].get("nodes") and k in NODE_KEYS)
        for o in got:
            assert o[i]["fwd_traffic"] == {"all_gather": gathered,
                                           "all_reduce": agg,
                                           "reduce_scatter": 0}, c["name"]
            assert o[i]["step_traffic"] == {
                "all_gather": gathered, "all_reduce": 2 * agg + radial,
                "reduce_scatter": 0}, c["name"]


def test_a_mesh_of_one_rank_is_the_one_device_forward():
    """With no mesh, or on a mesh whose axes are all of size 1 (no
    process group), the forward is the one-device program bitwise; rules
    that shard "layers" are refused."""
    import torch

    from repro_torch.common import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import nequip
    from repro_torch.models import sharding as sh

    cfg = get_config("nequip", "smoke")
    p = nequip.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(0, CASES[0]).items()}
    e0 = nequip.forward(cfg, p, b)
    mesh = Mesh((1, 1), ("data", "model"))
    with sh.rules_ctx({"nodes": ("data",)}, mesh=mesh):
        e1 = nequip.forward(cfg, p, b)
        loss0, g0 = nequip.value_and_grad(cfg, p, b)
    assert e0.numpy().tobytes() == e1.numpy().tobytes()
    loss1, g1 = nequip.value_and_grad(cfg, p, b)
    assert float(loss0) == float(loss1)
    for a, c in zip(tu.tree_leaves(g0), tu.tree_leaves(g1)):
        assert a.numpy().tobytes() == c.numpy().tobytes()
    with sh.rules_ctx({"layers": ("model",)}, mesh=mesh), \
            pytest.raises(NotImplementedError, match="layers"):
        nequip.forward(cfg, p, b)


def test_a_sharded_mesh_without_a_process_group_raises():
    """No sharded function falls back to the one-device program: edges
    over 4 ranks with no process group raise."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import nequip
    from repro_torch.models import sharding as sh

    cfg = get_config("nequip", "smoke")
    p = nequip.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(2, CASES[2]).items()}
    mesh = Mesh((1, 4), ("data", "model"))
    with sh.rules_ctx({}, mesh=mesh):
        local = {k: sh.named_sharding(mesh, "edges").shard(v)
                 if k.startswith("edge_") else v for k, v in b.items()}
        with pytest.raises(RuntimeError, match="process group"):
            nequip.forward(cfg, p, local)
