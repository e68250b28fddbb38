"""The port's recsys models with their tables split along "table_rows"
(repro_torch.models.recsys under an installed mesh: each rank holds its
slice of every field's padded table, the batch's ids gathered, looked up
in the rank's row range, and reduce-scattered back to the batch rows; the
wide and FM first-order bag the embedding_bag op over the rank's slices
and a zero row that other ranks' ids read) for
wide-deep, deepfm, dlrm and din `smoke()` on a 2 x 2 mesh of 4 gloo
ranks, against the JAX package's jitted train and serve steps with its
param and batch shardings on 4 host devices, from JAX's init, and
against the port's one-rank steps (its fused tables).

Tolerances (float32 on the CPU), those of the LM mesh tests: the loss
within 1e-5, logits rtol 1e-5 atol 1e-6, every param within 5e-5 after
one AdamW step, the gradient norm rtol 1e-4.
"""

import json

import numpy as np
import pytest

from _torch_mesh import nest, run_jax, spawn

ARCHS = ["wide-deep", "deepfm", "dlrm-mlperf", "din"]
CASES = [dict(arch=a, mesh=[2, 2]) for a in ARCHS]
B = 8

_JAX = r"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import recsys as rs
from repro.models.sharding import rules_ctx, named_sharding
from repro.optim import adamw_init
job = dict(np.load(JOB, allow_pickle=True))
cases = json.loads(str(job["cases"]))
flat = lambda t: {jax.tree_util.keystr(p): np.asarray(x)
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
out = {}
for i, c in enumerate(cases):
    cfg = get_config(c["arch"], "smoke")
    params = rs.init_params(cfg, jax.random.key(i))
    for k, v in flat(params).items():
        out[f"init{i}{k}"] = v
    batch = {k[len(f"b{i}_"):]: jnp.asarray(v) for k, v in job.items()
             if k.startswith(f"b{i}_")}
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with rules_ctx({}, mesh=mesh):
        psh = rs.param_shardings(cfg, mesh)
        osh = {"mu": psh, "nu": psh, "count": NamedSharding(mesh, P())}
        bsh = {k: named_sharding(mesh, "batch", *([None] * (v.ndim - 1)))
               for k, v in batch.items()}
        step = jax.jit(rs.make_train_step(cfg), in_shardings=(psh, osh, bsh))
        p2, _, m = step(params, adamw_init(params), batch)
        for k, v in flat(p2).items():
            out[f"params{i}{k}"] = v
        out[f"loss{i}"] = np.asarray(m["loss"])
        out[f"gnorm{i}"] = np.asarray(m["grad_norm"])
        sb = {k: v for k, v in batch.items() if k != "label"}
        serve = jax.jit(rs.make_serve_step(cfg),
                        in_shardings=(psh, {k: bsh[k] for k in sb}))
        out[f"logits{i}"] = np.asarray(serve(params, sb))
np.savez(OUT, **out)
"""


def _batch(cfg, rng):
    sizes = cfg.table_sizes
    b = {"sparse": np.stack([rng.integers(0, n, B) for n in sizes],
                            1).astype(np.int32),
         "label": rng.integers(0, 2, B).astype(np.int32)}
    if cfg.kind == "dlrm":
        b["dense"] = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
    if cfg.kind == "din":
        L = cfg.seq_len
        b["hist_item"] = rng.integers(0, sizes[0], (B, L)).astype(np.int32)
        b["hist_cate"] = rng.integers(0, sizes[1], (B, L)).astype(np.int32)
        b["hist_mask"] = (rng.random((B, L)) < 0.7).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.configs import get_config
    tmp = tmp_path_factory.mktemp("recsys_mesh")
    rng = np.random.default_rng(7)
    job = {"cases": json.dumps(CASES)}
    batches = []
    for i, c in enumerate(CASES):
        b = _batch(get_config(c["arch"], "smoke"), rng)
        batches.append(b)
        job.update({f"b{i}_{k}": v for k, v in b.items()})
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, **job)
    run_jax(_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = {"cases": CASES}
    for i in range(len(CASES)):
        tjob[f"params{i}"] = nest(want, f"init{i}")
        tjob[f"batch{i}"] = batches[i]
    return want, spawn("task_recsys", tjob, tmp)


@pytest.mark.parametrize("i", range(len(CASES)), ids=ARCHS)
def test_row_sharded_serve_matches_jax_and_one_rank(results, i):
    want, got = results
    one = got[0][i]["single_logits"]
    for o in got:
        r = o[i]
        np.testing.assert_allclose(r["logits"], want[f"logits{i}"][r["rows"]],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["logits"], one[r["rows"]], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("i", range(len(CASES)), ids=ARCHS)
def test_row_sharded_train_step_matches_jax_and_one_rank(results, i):
    from repro_torch.configs import get_config
    from repro_torch.models import recsys as rs
    want, got = results
    for o in got:
        assert abs(o[i]["loss"] - float(want[f"loss{i}"])) < 1e-5
        np.testing.assert_allclose(o[i]["gnorm"], want[f"gnorm{i}"],
                                   rtol=1e-4)
    r = got[0][i]
    assert abs(r["single_loss"] - r["loss"]) < 1e-5
    keys = [k for k in want if k.startswith(f"params{i}")]
    assert len(keys) == len(r["params"])
    for k in keys:
        np.testing.assert_allclose(r["params"][k[len(f"params{i}"):]],
                                   want[k], atol=5e-5, rtol=0)
    # the one-rank step's fused tables, cut into the fields
    tmpl = rs.param_template(get_config(CASES[i]["arch"], "smoke"))
    for name, leaf in tmpl.items():
        one = r["single_params"][name]
        if isinstance(leaf, dict):
            at = 0
            for f in range(len(leaf)):
                n = leaf[f"t{f}"].shape[0]
                np.testing.assert_allclose(
                    one[at:at + n], r["params"][f"['{name}']['t{f}']"],
                    atol=5e-5, rtol=0)
                at += n
        else:
            np.testing.assert_allclose(one, r["params"][f"['{name}']"],
                                       atol=5e-5, rtol=0)


def test_abstract_params_and_shardings_follow_the_template():
    """abstract_params holds every leaf of param_template as a meta tensor
    and param_shardings splits each field's rows over ("data", "model")
    under the base rules, the reference's placement."""
    from repro_torch.common import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import recsys as rs
    cfg = get_config("wide-deep", "smoke")
    ab = rs.abstract_params(cfg)
    tm = rs.param_template(cfg)
    assert [tuple(a.shape) for a in tu.tree_leaves(ab)] == \
        [tuple(l.shape) for l in tu.tree_leaves(tm)]
    assert all(a.device.type == "meta" for a in tu.tree_leaves(ab))
    mesh = Mesh((4, 2), ("data", "model"), rank=5)
    s = rs.param_shardings(cfg, mesh)
    assert s["tables"]["t0"].spec == (("data", "model"), None)
    assert s["tables"]["t0"].local_shape((2048, 8)) == (256, 8)
    assert s["wide_bias"].spec == (None,)
