"""The reference's default MoE dispatch ("sort") on a mesh:
repro_torch.models.moe.moe_ffn_sort_mesh on 4 gloo ranks against the
JAX package's moe_ffn jitted on 4 host devices with the tokens sharded
over "data", and the mixtral and arctic LM steps with moe_impl "sort" on
the mesh against JAX's jitted sharded steps.

JAX partitions the global function, so its result is moe_ffn on the
whole token set with one capacity; the port keeps the tokens where they
are and counts each expert's pairs on earlier ranks. Every input here
drops pairs (one token repeated over most rows), so which pairs drop is
held too: the global dropped-pair count exactly. Tolerances (float32 on
the CPU): outputs and aux within 1e-4 absolute; gradients of
sum(out * ct) + 0.3 * aux rtol 1e-4, atol 1e-5; router ids at tokens
whose top-3 probabilities are 1e-6 apart; the LM steps at
tests/test_torch_transformer_mesh.py's tolerances (loss 1e-4, params
5e-4, first moments 5e-5, logits rtol 1e-4 atol 1e-5) and the gradient
norm rtol 1e-4, against JAX and against the port's one-rank step.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_mesh import SRC, nest, run_jax, spawn

T, D, F, K = 64, 32, 16, 2
CASES = [("tp", (2, 2), 8), ("tp", (4, 1), 8), ("ep", (2, 2), 16),
         ("ep", (1, 4), 16)]

_JAX = r"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models import moe
from repro.models.sharding import rules_ctx
job = dict(np.load(JOB))
cases = json.loads(str(job["cases"]))
out = {}
for i, (mode, shape, E) in enumerate(cases):
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ep = mode == "ep"
    w = P("model", None, None) if ep else P(None, None, "model")
    wd = P("model", None, None) if ep else P(None, "model", None)
    shs = [NamedSharding(mesh, s) for s in (P("data", None), P(), w, w, wd)]
    args = [jax.device_put(jnp.asarray(job[f"{k}{i}"]), s) for k, s in
            zip(("x", "rw", "wg", "wu", "wd"), shs)]
    def loss(*a):
        y, aux = moe.moe_ffn(*a, top_k=2, ep=ep)
        return jnp.sum(y * job[f"ct{i}"]) + 0.3 * aux, (y, aux)
    with rules_ctx({}, mesh=mesh):
        (l, (y, aux)), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    out[f"y{i}"], out[f"aux{i}"] = np.asarray(y), np.asarray(aux)
    for j, gj in enumerate(g):
        out[f"g{i}_{j}"] = np.asarray(gj)
    p = jax.nn.softmax(args[0] @ args[1], -1)
    eidx = jax.lax.top_k(p, 2)[1]
    C = moe.capacity(p.shape[0], E, 2)
    load = jnp.bincount(eidx.reshape(-1), length=E)
    out[f"dropped{i}"] = np.asarray(jnp.sum(jnp.maximum(load - C, 0)))
    out[f"probs{i}"], out[f"eidx{i}"] = np.asarray(p), np.asarray(eidx)
np.savez(OUT, **out)
"""


def _case_inputs(i, E):
    rng = np.random.default_rng(10 + i)
    x = (rng.standard_normal((T, D)) * 0.5).astype(np.float32)
    # one token over the first 40 rows, across the first ranks' rows: its
    # two experts overflow the global capacity
    x[:40] = x[3]
    return {"x": x,
            "rw": (rng.standard_normal((D, E)) * 0.3).astype(np.float32),
            "wg": (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32),
            "wu": (rng.standard_normal((E, D, F)) * 0.2).astype(np.float32),
            "wd": (rng.standard_normal((E, F, D)) * 0.2).astype(np.float32),
            "ct": rng.standard_normal((T, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def dispatch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_sort_mesh")
    inputs = [_case_inputs(i, E) for i, (_, _, E) in enumerate(CASES)]
    job = {"cases": json.dumps([[m, list(s), E] for m, s, E in CASES])}
    for i, inp in enumerate(inputs):
        job.update({f"{k}{i}": v for k, v in inp.items()})
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, **job)
    run_jax(_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = {"c_aux": 0.3, "cases": [dict(inp, mode=m, mesh=list(s))
                                    for inp, (m, s, _) in zip(inputs,
                                                              CASES)]}
    got = spawn("task_moe_sort", tjob, tmp)
    return inputs, want, got


def _assemble(i, got):
    """The global output and gradients from the ranks' slices: rows by
    data index, weights summed over data and joined over model."""
    mode, (nd, nm), _ = CASES[i]
    y = np.zeros((T, D), np.float32)
    gx = np.zeros((T, D), np.float32)
    for o in got:
        y[o[i]["rows"]] = o[i]["y"]
        gx[o[i]["rows"]] = o[i]["grads"][0]
    grw = sum(got[d * nm][i]["grads"][1] for d in range(nd))
    ws = []
    for j in (2, 3, 4):
        per_m = [sum(got[d * nm + m][i]["grads"][j] for d in range(nd))
                 for m in range(nm)]
        axis = 0 if mode == "ep" else (2 if j < 4 else 1)
        ws.append(np.concatenate(per_m, axis))
    return y, [gx, grw] + ws


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{m}_{s[0]}x{s[1]}_E{E}" for m, s, E in CASES])
def test_sort_dispatch_matches_jax_global_moe(dispatch, i):
    import torch

    from repro_torch.models import moe

    inputs, want, got = dispatch
    y, grads = _assemble(i, got)
    np.testing.assert_allclose(y, want[f"y{i}"], rtol=0, atol=1e-4)
    for j, g in enumerate(grads):
        np.testing.assert_allclose(g, want[f"g{i}_{j}"], rtol=1e-4,
                                   atol=1e-5, err_msg=f"grad {j}")
    dropped = int(want[f"dropped{i}"])
    assert dropped > 0
    for o in got:
        assert abs(o[i]["aux"] - float(want[f"aux{i}"])) < 1e-4
        assert o[i]["dropped"] == dropped
    # the port's one-device function on the whole batch: the same pairs
    t = {k: torch.from_numpy(v) for k, v in inputs[i].items()}
    one, _ = moe.moe_ffn(t["x"], t["rw"], t["wg"], t["wu"], t["wd"],
                         top_k=K)
    np.testing.assert_allclose(y, one.numpy(), rtol=0, atol=1e-4)
    # the router's ids away from ties, on every rank's rows
    p = np.sort(want[f"probs{i}"], -1)[:, ::-1]
    clear = (p[:, 0] - p[:, 1] > 1e-6) & (p[:, 1] - p[:, 2] > 1e-6)
    assert clear.mean() > 0.3
    for o in got:
        ok = clear[o[i]["rows"]]
        np.testing.assert_array_equal(o[i]["eidx"][ok],
                                      want[f"eidx{i}"][o[i]["rows"]][ok])


LM_CASES = [
    dict(arch="mixtral-8x7b", over=dict(microbatch=0), mesh=[2, 2],
         single=True, decode=True),
    dict(arch="mixtral-8x7b", over=dict(microbatch=0), mesh=[1, 4],
         single=True, decode=True),
    dict(arch="arctic-480b", over=dict(n_experts=16, microbatch=0),
         mesh=[2, 2], single=True, decode=True),
    dict(arch="arctic-480b", over=dict(n_experts=16, microbatch=0),
         mesh=[1, 4], single=True, decode=True),
]
B, S, N_DEC = 8, 32, 4


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    from test_torch_transformer_mesh import _JAX as LM_JAX

    tmp = tmp_path_factory.mktemp("lm_sort_mesh")
    rng = np.random.default_rng(1)
    job = {"cases": json.dumps(LM_CASES)}
    for i in range(len(LM_CASES)):
        tok = rng.integers(0, 256, (B, S)).astype(np.int32)
        tok[:, S // 2:] = tok[0, 0]       # half of each row one token
        job[f"tokens{i}"] = tok
        job[f"dec{i}"] = rng.integers(0, 256, (B, N_DEC)).astype(np.int32)
    jpath, out = str(tmp / "job.npz"), str(tmp / "jax.npz")
    np.savez(jpath, **job)
    run_jax(LM_JAX.replace("JOB", repr(jpath)).replace("OUT", repr(out)))
    want = dict(np.load(out))
    tjob = {"cases": LM_CASES}
    for i in range(len(LM_CASES)):
        tjob[f"params{i}"] = nest(want, f"init{i}")
        tjob[f"tokens{i}"] = job[f"tokens{i}"]
        tjob[f"dec{i}"] = job[f"dec{i}"]
    got = spawn("task_lm", tjob, tmp)
    return want, got


def _lm_id(c):
    return f"{c['arch']}_{c['mesh'][0]}x{c['mesh'][1]}"


def _worst(got, want, prefix):
    keys = [k for k in want if k.startswith(prefix)]
    assert len(keys) == len(got)
    return max(float(np.abs(got[k[len(prefix):]] - want[k]).max())
               for k in keys)


@pytest.mark.parametrize("i", range(len(LM_CASES)),
                         ids=[_lm_id(c) for c in LM_CASES])
def test_sort_lm_train_step_matches_jax_and_one_rank(lm, i):
    want, got = lm
    for o in got:            # every rank reports the same metrics
        r = o[i]
        assert abs(r["loss"] - float(want[f"loss{i}"])) < 1e-4
        assert abs(r["aux"] - float(want[f"aux_loss{i}"])) < 1e-4
        np.testing.assert_allclose(r["gnorm"], want[f"grad_norm{i}"],
                                   rtol=1e-4)
    r = got[0][i]
    assert _worst(r["params"], want, f"params{i}") < 5e-4
    # the first moments: 0.1 x the gradient summed over the data ranks,
    # clipped by the global norm
    assert _worst(r["mu"], want, f"mu{i}") < 5e-5
    # the global function: the port's one-rank step on the whole batch
    assert abs(r["single_loss"] - r["loss"]) < 1e-4
    np.testing.assert_allclose(r["single_gnorm"], r["gnorm"], rtol=1e-4)
    worst = max(float(np.abs(r["single_params"][k] - r["params"][k]).max())
                for k in r["params"])
    assert worst < 5e-4, worst


@pytest.mark.parametrize("i", range(len(LM_CASES)),
                         ids=[_lm_id(c) for c in LM_CASES])
def test_sort_prefill_and_decode_match_jax(lm, i):
    want, got = lm
    for o in got:
        r = o[i]
        rows = r["rows"]
        np.testing.assert_allclose(r["prefill"], want[f"prefill{i}"][rows],
                                   rtol=1e-4, atol=1e-5)
        for t in range(N_DEC):
            np.testing.assert_allclose(r["decode"][t],
                                       want[f"decode{i}_{t}"][rows],
                                       rtol=1e-4, atol=1e-5)


_DRY = r"""
import json
from repro_torch.configs.shapes import shapes_for
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import build_cell
dryrun.fake_process_group(4)
mesh = make_debug_mesh((2, 2), ("data", "model"))
shape = shapes_for("lm")["train_4k"]
out = {}
for impl in ("sort", "tp_shard_map"):
    over = {"moe_impl": impl}
    rec = dryrun.run_cell("mixtral-8x7b", shape, False, mesh=mesh,
                          variant="smoke", overrides=over)
    cell = build_cell("mixtral-8x7b", shape, mesh, False, over, "smoke")
    mode, _ = dryrun.count_cell(cell, mesh, False, cell.rules)
    out[impl] = {"status": rec["status"], "over": rec["overrides"],
                 "coll": rec["collectives"], "E": cell.cfg.n_experts,
                 "layers": cell.cfg.n_layers,
                 "sites": [[k[0], k[1], k[2], v] for k, v in
                           mode.collective_sites.items()]}
print("JSON" + json.dumps(out))
"""


def test_dry_run_counts_the_sort_cell_and_its_counts_gather():
    """mixtral's train cell with moe_impl "sort" on a fake 2 x 2 group is
    ok, and its all-gathers include the MoE's (1, E) int64 counts over
    the 2 data ranks, once a layer in the forward and once in the remat;
    "sort" is the cell's default, as in the reference."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_DRY)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.split("JSON", 1)[1])
    from repro_torch.launch.specs import cell_config
    assert cell_config("mixtral-8x7b").moe_impl == "sort"
    srt, tp = out["sort"], out["tp_shard_map"]
    assert srt["status"] == "ok" and srt["over"]["moe_impl"] == "sort"
    E, L = srt["E"], srt["layers"]
    counts = [s for s in srt["sites"] if s[0] == "all-gather"
              and "moe.py:moe_ffn_sort_mesh" in s[2]]
    assert counts and all(s[1] == f"(1, {E}) x2" for s in counts), counts
    # ring wire bytes of a 2-rank all-gather of 2 x (1, E) int64: E * 8
    assert sum(s[3] for s in counts) == 2 * L * E * 8
    assert not [s for s in tp["sites"] if "moe_ffn_sort_mesh" in s[2]]
    extra = srt["coll"]["all-gather_raw"] - tp["coll"]["all-gather_raw"]
    assert extra > 0 and extra % (2 * E * 8) == 0, extra
