"""The sharded LM train step at a config's microbatch: the port's
`grads_fn` under an installed mesh on 4 gloo ranks against the JAX
package's jitted `make_train_step` on 4 host devices, on the same meshes,
from JAX's init.

The reference decides on the global batch B (m = cfg.microbatch divides
B) and its microbatch i is the global rows [i B/m, (i + 1) B/m). The
port moves the rows once and rank r steps on `microbatch_rows(B, m,
R)[r]` of each microbatch (R the batch ranks): B/(m R) rows where R
divides B/m, else the first (B/m) mod R ranks one row more, a rank
perhaps none. The "sort" MoE's one capacity and its aux loss depend on
which tokens share a microbatch, so the cases below drop pairs (each
row's second half one token) and hold each microbatch's global dropped
(token, k) pairs to JAX's: the reference's forward of that microbatch
at the initial params, jitted layer by layer, its router inputs counted
by the global capacity ("sort") or by the shard_map's even token blocks
(R of them, each at its own capacity). Where the rows do not split, the
shard_map paths take those token blocks as the reference does; where a
microbatch's tokens do not split over R, both packages raise.

Tolerances (float32 on the CPU), tests/test_torch_transformer_mesh.py's:
the loss and the aux loss within 1e-4, every param within 5e-4 after
one AdamW step, the first moments within 5e-5, the gradient norm rtol
1e-4.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_mesh import SRC, nest, run_jax, spawn

ARCTIC16 = dict(n_experts=16)
CASES = [
    dict(id="mixtral_sort_2x2_m2", arch="mixtral-8x7b",
         over=dict(microbatch=2), mesh=[2, 2]),
    dict(id="arctic16_sort_1x4_m2", arch="arctic-480b",
         over=dict(ARCTIC16, microbatch=2), mesh=[1, 4]),
    # Bm 2 rows over 4 ranks: ranks 2 and 3 hold none
    dict(id="mixtral_sort_4x1_m4_uneven", arch="mixtral-8x7b",
         over=dict(microbatch=4), mesh=[4, 1]),
    dict(id="qwen2_dense_4x1_m4_uneven", arch="qwen2-1.5b",
         over=dict(microbatch=4), mesh=[4, 1]),
    # 4 rows a rank, m 8: B_local % m != 0, B % m == 0 (one row over 2)
    dict(id="arctic16_sort_2x2_m8_local_rows_short", arch="arctic-480b",
         over=dict(ARCTIC16, microbatch=8), mesh=[2, 2]),
    dict(id="mixtral_tp_shard_map_2x2_m2", arch="mixtral-8x7b",
         over=dict(microbatch=2, moe_impl="tp_shard_map"), mesh=[2, 2]),
    dict(id="arctic16_ep_shard_map_2x2_m2", arch="arctic-480b",
         over=dict(ARCTIC16, microbatch=2, moe_impl="ep_shard_map"),
         mesh=[2, 2]),
    # rows 2 over 4 ranks; the shard_map takes 16-token blocks
    dict(id="arctic16_ep_shard_map_4x1_m4_uneven", arch="arctic-480b",
         over=dict(ARCTIC16, microbatch=4, moe_impl="ep_shard_map"),
         mesh=[4, 1]),
    # 2 rows of 31 tokens over 4 ranks: neither rows nor tokens split
    dict(id="mixtral_tp_shard_map_4x1_m4_s31_raises", arch="mixtral-8x7b",
         over=dict(microbatch=4, moe_impl="tp_shard_map"), mesh=[4, 1],
         S=31),
]
B, S = 8, 32
RUN = [c for c in CASES if c.get("S", S) == S]
RAISE = [c for c in CASES if c.get("S", S) != S]

_JAX = r"""
import dataclasses, json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import moe
from repro.models import transformer as tf
from repro.models.sharding import rules_ctx, named_sharding
from repro.optim import adamw_init
job = dict(np.load(JOB))
cases = json.loads(str(job["cases"]))
flat = lambda t: {jax.tree_util.keystr(p): np.asarray(x)
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
real = {n: getattr(moe, n) for n in
        ("moe_ffn", "moe_ffn_tp_shardmap", "moe_ffn_ep_shardmap")}
seen = []
def recorder(name):
    def fn(x, router_w, *a, **kw):
        seen.append((name, x, router_w))
        return real[name](x, router_w, *a, **kw)
    return fn
def dropped(name, x, rw, E, K, R):
    # the global capacity ("sort"), or R even token blocks each at its own
    p = jax.nn.softmax(x @ rw, -1)
    eidx = np.asarray(jax.lax.top_k(p, K)[1])
    n = 1 if name == "moe_ffn" else R
    T = x.shape[0] // n
    C = moe.capacity(T, E, K)
    return sum(int(np.maximum(np.bincount(
        eidx[b * T:(b + 1) * T].reshape(-1), minlength=E) - C, 0).sum())
        for b in range(n))
out = {}
for i, c in enumerate(cases):
    cfg = dataclasses.replace(get_config(c["arch"], "smoke"), **c["over"])
    params = tf.init_params(cfg, jax.random.key(0))
    for k, v in flat(params).items():
        out[f"init{i}{k}"] = v
    tok = jnp.asarray(job[f"tokens{i}"])
    batch = {"tokens": tok, "labels": tok}
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with rules_ctx({}, mesh=mesh):
        psh = tf.param_shardings(cfg, mesh)
        osh = {"mu": psh, "nu": psh, "count": NamedSharding(mesh, P())}
        bsh = {k: named_sharding(mesh, "batch", None) for k in batch}
        step = jax.jit(tf.make_train_step(cfg), in_shardings=(psh, osh, bsh))
        try:
            p2, o2, m = step(params, adamw_init(params), batch)
        except ValueError as e:
            out[f"raised{i}"] = np.asarray(str(e))
            continue
        for k, v in flat(p2).items():
            out[f"params{i}{k}"] = v
        for k, v in flat(o2["mu"]).items():
            out[f"mu{i}{k}"] = v
        for k in ("loss", "aux_loss", "grad_norm"):
            out[f"{k}{i}"] = np.asarray(m[k])
        if not cfg.moe:
            continue
        # each microbatch's forward at the initial params, layer by layer
        for n in real:
            setattr(moe, n, recorder(n))
        def fwd(pp, t):
            seen.clear()
            x = jnp.take(pp["embed"], t, axis=0).astype(cfg.dtype)
            pos = jnp.broadcast_to(
                jnp.arange(t.shape[1], dtype=jnp.int32)[None], t.shape)
            for l in range(cfg.n_layers):
                x = tf._layer(cfg, x, jax.tree.map(lambda a: a[l],
                                                   pp["layers"]), pos)[0]
            return [(xx, rw) for _, xx, rw in seen]
        pp = jax.device_put(params, psh)
        Bm = tok.shape[0] // cfg.microbatch
        drops = []
        for j in range(cfg.microbatch):
            ins = jax.jit(fwd)(pp, tok[j * Bm:(j + 1) * Bm])
            names = [s[0] for s in seen]
            drops.append(sum(dropped(nm, np.asarray(xx), np.asarray(rw),
                                     cfg.n_experts, cfg.moe_top_k,
                                     c["mesh"][0])
                             for nm, (xx, rw) in zip(names, ins)))
        for n in real:
            setattr(moe, n, real[n])
        out[f"drops{i}"] = np.asarray(drops)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_microbatch")
    rng = np.random.default_rng(3)
    job = {"cases": json.dumps(CASES)}
    for i, c in enumerate(CASES):
        s = c.get("S", S)
        tok = rng.integers(0, 256, (B, s)).astype(np.int32)
        tok[:, s // 2:] = tok[0, 0]       # half of each row one token
        job[f"tokens{i}"] = tok
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, **job)
    run_jax(_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = {"cases": CASES}
    for i in range(len(CASES)):
        tjob[f"params{i}"] = nest(want, f"init{i}")
        tjob[f"tokens{i}"] = job[f"tokens{i}"]
    got = spawn("task_lm_microbatch", tjob, tmp)
    return want, got


def _worst(got, want, prefix):
    keys = [k for k in want if k.startswith(prefix)]
    assert len(keys) == len(got)
    return max(float(np.abs(got[k[len(prefix):]] - want[k]).max())
               for k in keys)


def _drops_per_microbatch(got, case):
    """Each microbatch's global dropped pairs in the port's step, summed
    over its forward's layers: moe_ffn_sort_mesh's global count, or the
    shard_map ranks' own counts summed over the data ranks."""
    from repro_torch.configs import get_config

    L = get_config(case["arch"], "smoke").n_layers
    m = case["over"]["microbatch"]
    kind = "route" if "moe_impl" in case["over"] else "sort"
    per_rank = []
    for o in got:
        calls = [n for k, n in o["calls"] if k == kind]
        assert len(calls) == L * m, (kind, len(calls))
        per_rank.append([sum(calls[L * j:L * (j + 1)]) for j in range(m)])
    if kind == "sort":
        assert all(p == per_rank[0] for p in per_rank)
        return per_rank[0]
    data = [p for p, o in zip(per_rank, got) if o["coords"]["model"] == 0]
    return [sum(p[j] for p in data) for j in range(m)]


@pytest.mark.parametrize("i", [CASES.index(c) for c in RUN],
                         ids=[c["id"] for c in RUN])
def test_microbatched_mesh_step_matches_jax(results, i):
    want, got = results
    case = CASES[i]
    for o in got:            # every rank reports the same metrics
        r = o[i]
        assert abs(r["loss"] - float(want[f"loss{i}"])) < 1e-4
        assert abs(r["aux"] - float(want[f"aux_loss{i}"])) < 1e-4
        np.testing.assert_allclose(r["gnorm"], want[f"grad_norm{i}"],
                                   rtol=1e-4)
    r = got[0][i]
    assert _worst(r["params"], want, f"params{i}") < 5e-4
    assert _worst(r["mu"], want, f"mu{i}") < 5e-5
    if case["arch"] != "qwen2-1.5b":
        drops = _drops_per_microbatch([o[i] for o in got], case)
        assert drops == [int(x) for x in want[f"drops{i}"]]
        assert sum(drops) > 0


@pytest.mark.parametrize("i", [CASES.index(c) for c in RAISE],
                         ids=[c["id"] for c in RAISE])
def test_shard_map_microbatch_that_does_not_split_raises_as_jax(results, i):
    """2 rows of 31 tokens over 4 ranks: JAX's shard_map refuses the 62
    tokens, and the port's step raises ValueError naming B, m and R on
    every rank before it moves anything."""
    want, got = results
    assert "not evenly divisible" in str(want[f"raised{i}"])
    for o in got:
        msg = o[i]["raised"]
        assert "B 8" in msg and "microbatch 4" in msg and "R 4" in msg, msg


def test_microbatch_rows_layout():
    from repro_torch.models.transformer import microbatch_rows

    # R divides B/m: rank r's block of each microbatch, JAX's shard_map's
    assert microbatch_rows(16, 2, 4) == [(0, 2), (2, 2), (4, 2), (6, 2)]
    assert microbatch_rows(256, 16, 16) == [(r, 1) for r in range(16)]
    # it does not: the first (B/m) mod R ranks take one row more
    assert microbatch_rows(8, 4, 4) == [(0, 1), (1, 1), (2, 0), (2, 0)]
    assert microbatch_rows(12, 2, 4) == [(0, 2), (2, 2), (4, 1), (5, 1)]
    lay = microbatch_rows(256, 16, 32)
    assert [n for _, n in lay] == [1] * 16 + [0] * 16
    for Bg, m, R in ((8, 4, 4), (12, 2, 4), (256, 16, 32), (30, 3, 7)):
        lay = microbatch_rows(Bg, m, R)
        assert sum(n for _, n in lay) == Bg // m
        assert all(f + n == lay[r + 1][0] for r, (f, n) in
                   enumerate(lay[:-1]))


def test_the_row_move_is_counted(results):
    """The rows move once a step, one all-gather of each batch leaf over
    the batch axes: on 4 x 1 its bytes are in every rank's TRAFFIC, and
    the dry run's fake 2 x 2 group counts it at grads_fn, 2 x (B, S)
    int32 leaves, and not where the step does not microbatch."""
    _, got = results
    i = CASES.index(next(c for c in RUN if c["id"].startswith("qwen2")))
    for o in got:
        assert o[i]["traffic"]["all_gather"] >= 2 * B * S * 4
    code = r"""
    import json
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import build_cell
    dryrun.fake_process_group(4)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    out = {}
    for m in (0, 2):
        cell = build_cell("qwen2-1.5b", ShapeSpec("t", "train", seq_len=16,
                          global_batch=8), mesh, False, {"microbatch": m},
                          "smoke")
        mode, _ = dryrun.count_cell(cell, mesh, False, cell.rules)
        out[m] = [[k[0], k[1], k[2], v] for k, v in
                  mode.collective_sites.items() if "grads_fn" in k[2]]
    print("JSON" + json.dumps(out))
    """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr[-4000:]
    sites = json.loads(r.stdout.split("JSON", 1)[1])
    assert sites["0"] == []
    assert sites["2"] and all(s[0] == "all-gather" for s in sites["2"])
    # ring wire bytes of a 2-rank all-gather of (4, 16) int32, twice
    assert sum(s[3] for s in sites["2"]) == 2 * 4 * 16 * 4, sites
