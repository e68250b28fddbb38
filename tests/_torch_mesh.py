"""Helpers of the mesh tests (tests/test_torch_{sharding,moe_mesh,
moe_sort_mesh,transformer_mesh,mesh_microbatch,nequip_mesh,
nequip_pjit_mesh}.py): the
JAX reference on host devices in a subprocess, and the port on gloo
ranks spawned by torch.multiprocessing, both on the same mesh shapes.

`run_jax(code, n_devices)` runs `code` with
--xla_force_host_platform_device_count; `spawn(task, job, tmp)` runs
`task(rank, mesh_world, job)` (a function of this module, by name) on 4
gloo ranks over a FileStore and returns each rank's dict of arrays. A
job is a dict of numpy arrays plus "spec" (JSON). A failing rank fails
the spawn.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4


def run_jax(code, n_devices=WORLD):
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


def _worker(rank, world, store, task, job_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        out = globals()[task](rank, job)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(task, job, tmp_path, world=WORLD):
    """[rank's output] of `task` run on `world` gloo ranks."""
    import torch.multiprocessing as tmp

    d = tmp_path / f"spawn_{task}"
    d.mkdir(exist_ok=True)
    job_path = str(d / "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    tmp.spawn(_worker, args=(world, str(d / "store"), task, job_path,
                             str(d)), nprocs=world)
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def nest(flat, prefix):
    """{"['a']['b']": x} -> {"a": {"b": x}} for keys under prefix."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        keys = [p.strip("'") for p in k[len(prefix) + 1:-1].split("][")]
        d = out
        for p in keys[:-1]:
            d = d.setdefault(p, {})
        d[keys[-1]] = v
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tree_np(tree):
    from repro_torch.common import tree as tu
    return {p: _np(x) for p, x in tu.leaf_paths(tree)}


# ---------------------------------------------------------------------------
# tasks (each runs on every rank; returns a dict of numpy arrays / values)
# ---------------------------------------------------------------------------

def task_roundtrip(rank, job):
    """shard and gather of each case's global array on its mesh."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sharding import NamedSharding

    out = {}
    meshes = {}
    for i, (shape, axes, spec) in enumerate(job["cases"]):
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = make_debug_mesh(tuple(shape), tuple(axes))
        s = NamedSharding(meshes[key], tuple(
            tuple(e) if isinstance(e, list) else e for e in spec))
        x = torch.from_numpy(job[f"x{i}"])
        loc = s.shard(x).contiguous()
        out[f"local{i}"] = loc.numpy()
        out[f"whole{i}"] = s.gather(loc).numpy()
    return out


def task_collectives(rank, job):
    """Each collective's output and its backward of a seeded cotangent,
    over each axis set of a 2 x 2 mesh."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import collectives as coll

    mesh = make_debug_mesh((2, 2), ("data", "model"))
    out = {}
    g = torch.Generator().manual_seed(100 + rank)
    for axes in (("data",), ("model",), ("data", "model"),
                 ("model", "data")):
        tag = "_".join(axes)
        for name in ("all_gather", "reduce_scatter", "copy_to",
                     "all_reduce", "pmean", "gather_replicated"):
            x = torch.randn(4, 6, generator=g, dtype=torch.float64)
            x.requires_grad_()
            fn = getattr(coll, name)
            y = fn(x, mesh, axes, 0) if name in (
                "all_gather", "reduce_scatter", "gather_replicated") \
                else fn(x, mesh, axes)
            ct = torch.randn(y.shape, generator=g, dtype=torch.float64)
            (gx,) = torch.autograd.grad(y, x, ct)
            out[f"{name}/{tag}/x"] = x.detach().numpy()
            out[f"{name}/{tag}/y"] = y.detach().numpy()
            out[f"{name}/{tag}/ct"] = ct.numpy()
            out[f"{name}/{tag}/gx"] = gx.numpy()
    out["coords"] = (mesh.coords["data"], mesh.coords["model"])
    return out


def task_reduce_scatter_paths(rank, job):
    """collectives._reduce_scatter_tensor (the path of NCCL and the fake
    group) beside the gloo path's all_reduce and slice, for each dim and
    axis set of a 2 x 2 mesh, on integer-valued float64 (exact sums),
    with the bytes each counts; and whether the group of each axis set
    runs in axis_index order."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import collectives as coll

    mesh = make_debug_mesh((2, 2), ("data", "model"))
    g = torch.Generator().manual_seed(200 + rank)
    out = {}
    for axes in (("data",), ("model",), ("data", "model"),
                 ("model", "data")):
        tag = "_".join(axes)
        out[f"ordered/{tag}"] = mesh.members(axes) == sorted(
            mesh.members(axes))
        for dim in range(3):
            x = torch.randint(-50, 50, (4, 8, 12), generator=g).double()
            coll.reset_traffic()
            one = coll._reduce_scatter_tensor(x, mesh, axes, dim)
            t_one = dict(coll.TRAFFIC)
            coll.reset_traffic()
            two = coll._reduce_scatter(x, mesh, axes, dim)
            out[f"{tag}/{dim}"] = (one.numpy(), two.numpy(), t_one,
                                   dict(coll.TRAFFIC))
    return out


def task_gather_dtypes(rank, job):
    """collectives.all_gather_group over each axis set of a 2 x 2 mesh for
    float32, bfloat16, float16 and int64 tensors (signed zeros, NaN and
    -inf among the floats), each rank's drawn from a generator seeded by
    its rank: the parts, as bytes, with the bytes counted."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import collectives as coll

    mesh = make_debug_mesh((2, 2), ("data", "model"))
    out = {"members": {}}
    for axes in (("data",), ("model",), ("data", "model")):
        tag = "_".join(axes)
        out["members"][tag] = mesh.members(axes)
        for dt in DTYPES:
            coll.reset_traffic()
            parts = coll.all_gather_group(_gather_input(rank, dt),
                                          mesh.group(axes))
            out[f"{tag}/{dt}"] = ([(str(p.dtype), tuple(p.shape),
                                    _bytes(p)) for p in parts],
                                  dict(coll.TRAFFIC))
    return out


DTYPES = ("float32", "bfloat16", "float16", "int64")


def _gather_input(rank, dt):
    """Rank `rank`'s (3, 5) tensor of dtype name `dt`."""
    g = torch.Generator().manual_seed(300 + rank)
    x = (torch.randn((3, 5), generator=g) * 100).to(getattr(torch, dt))
    if x.is_floating_point():
        x.view(-1)[:3] = torch.tensor([-0.0, float("nan"), float("-inf")])
    return x


def _bytes(x):
    return x.contiguous().reshape(-1).view(torch.uint8).numpy().copy()


def task_elastic(rank, job):
    """Save a tree sharded on a (4,) data mesh, restore it on 2 x 2 with
    job["spec"] and on 1 x 4 by the model's shardings."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sharding import NamedSharding

    m4 = make_debug_mesh((4,), ("data",))
    m22 = make_debug_mesh((2, 2), ("data", "model"))
    w = torch.from_numpy(job["w"])
    s4 = {"w": NamedSharding(m4, ("data", None))}
    loc = {"w": s4["w"].shard(w).clone()}
    save_checkpoint(job["dir"], 5, loc, shardings=s4)
    s22 = {"w": NamedSharding(m22, tuple(job["spec"]))}
    target = {"w": torch.empty(w.shape, device="meta")}
    got, _ = restore_checkpoint(job["dir"], 5, target, s22, device="cpu")
    return {"saved": loc["w"].numpy(), "restored": got["w"].numpy(),
            "coords": (m22.coords["data"], m22.coords["model"])}


def _debug_mesh(mesh_shape):
    from repro_torch.launch.mesh import make_debug_mesh
    return make_debug_mesh(tuple(mesh_shape), ("data", "model"))


def task_moe(rank, job):
    """moe_ffn_{ep,tp}_shardmap on each case's mesh (on job["device"],
    the CPU by default): this rank's output, aux, router ids and the
    gradients of sum(out * ct) + c * aux."""
    from repro_torch.models import moe
    from repro_torch.models.sharding import NamedSharding

    dev = job.get("device", "cpu")
    out = {}
    for i, case in enumerate(job["cases"]):
        mesh = _debug_mesh(case["mesh"])
        mode = case["mode"]
        T = job["x"].shape[0]
        rows = NamedSharding(mesh, ("data", None))
        if mode == "ep":
            ws = [NamedSharding(mesh, ("model", None, None))] * 3
        else:
            ws = [NamedSharding(mesh, (None, None, "model"))] * 2 + [
                NamedSharding(mesh, (None, "model", None))]
        x = rows.shard(torch.from_numpy(case.get("x", job["x"])))
        x = x.to(dev).clone()
        rw = torch.from_numpy(job["rw"]).to(dev).clone()
        w = [s.shard(torch.from_numpy(job[k])).to(dev).clone()
             for s, k in zip(ws, ("wg", "wu", "wd"))]
        leaves = [t.requires_grad_() for t in [x, rw] + w]
        fn = moe.moe_ffn_ep_shardmap if mode == "ep" \
            else moe.moe_ffn_tp_shardmap
        y, aux = fn(*leaves, top_k=2, mesh=mesh)
        ct = rows.shard(torch.from_numpy(job["ct"])).to(dev)
        loss = torch.sum(y * ct) + job["c_aux"] * aux
        grads = torch.autograd.grad(loss, leaves)
        _, _, eidx = moe.route(x.detach(), rw.detach(), 2)
        out[i] = {"y": _np(y), "aux": float(aux), "eidx": _np(eidx),
                  "grads": [_np(g) for g in grads],
                  "rows": _np(NamedSharding(mesh, ("data",)).shard(
                      torch.arange(T)))}
        del mesh
    return out


def task_moe_sort(rank, job):
    """moe_ffn_sort_mesh on each case's mesh and layout ("ep": experts
    over "model", "tp": d_ff over it): this rank's output, aux, global
    dropped pairs, router ids and the gradients of sum(out * ct) + c *
    aux."""
    from repro_torch.models import moe
    from repro_torch.models.sharding import NamedSharding

    out = {}
    for i, case in enumerate(job["cases"]):
        mesh = _debug_mesh(case["mesh"])
        if case["mode"] == "ep":
            ws = [NamedSharding(mesh, ("model", None, None))] * 3
        else:
            ws = [NamedSharding(mesh, (None, None, "model"))] * 2 + [
                NamedSharding(mesh, (None, "model", None))]
        rows = NamedSharding(mesh, ("data", None))
        x = rows.shard(torch.from_numpy(case["x"])).clone()
        rw = torch.from_numpy(case["rw"]).clone()
        w = [s.shard(torch.from_numpy(case[k])).clone()
             for s, k in zip(ws, ("wg", "wu", "wd"))]
        leaves = [t.requires_grad_() for t in [x, rw] + w]
        y, aux, dropped = moe.moe_ffn_sort_mesh(*leaves, top_k=2, mesh=mesh)
        ct = rows.shard(torch.from_numpy(case["ct"]))
        loss = torch.sum(y * ct) + job["c_aux"] * aux
        grads = torch.autograd.grad(loss, leaves)
        _, _, eidx = moe.route(x.detach(), rw.detach(), 2)
        out[i] = {"y": _np(y), "aux": float(aux), "dropped": int(dropped),
                  "eidx": _np(eidx), "grads": [_np(g) for g in grads],
                  "rows": _np(NamedSharding(mesh, ("data",)).shard(
                      torch.arange(case["x"].shape[0])))}
        del mesh
    return out


def task_lm(rank, job):
    """For each case: the sharded train step, prefill and decode steps of
    the port on the case's mesh from JAX's init, and (on the "single"
    cases) the port's one-rank step; returns the whole params after the
    step (gathered), the metrics, and this rank's logits and rows."""
    import dataclasses

    from repro_torch.common import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.convert import transformer_params_from_numpy
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    out = {}
    for i, case in enumerate(job["cases"]):
        cfg = dataclasses.replace(get_config(case["arch"], "smoke"),
                                  **case["over"])
        params = transformer_params_from_numpy(cfg, job[f"params{i}"],
                                               device="cpu")
        tok = torch.from_numpy(job[f"tokens{i}"])
        batch = {"tokens": tok, "labels": tok}
        res = {}
        if case.get("single") and rank == 0:
            p1, _, m1 = tf.make_train_step(cfg)(params, adamw_init(params),
                                                batch)
            res["single_params"] = _tree_np(p1)
            res["single_loss"] = float(m1["loss"])
            res["single_gnorm"] = float(m1["grad_norm"])
        mesh = _debug_mesh(case["mesh"])
        with sh.rules_ctx({}, mesh=mesh):
            psh = tf.param_shardings(cfg, mesh)
            pl = tu.tree_map(lambda x: x.clone(), sh.shard_tree(params,
                                                                psh))
            rows = sh.named_sharding(mesh, "batch", None)
            bl = {k: rows.shard(v) for k, v in batch.items()}
            p2, o2, m2 = tf.make_train_step(cfg)(pl, adamw_init(pl), bl)
            res["params"] = _tree_np(sh.gather_tree(p2, psh))
            res["mu"] = _tree_np(sh.gather_tree(o2["mu"], psh))
            res.update(loss=float(m2["loss"]), aux=float(m2["aux_loss"]),
                       gnorm=float(m2["grad_norm"]))
            if case.get("decode"):
                B, S = tok.shape
                n_dec = job[f"dec{i}"].shape[1]
                logits, cache = tf.make_prefill_step(cfg)(pl, bl["tokens"])
                res["prefill"] = _np(logits)
                csh = tf.cache_shardings(cfg, mesh, B, S + n_dec)
                full = tf.init_cache(cfg, B, S + n_dec, device="cpu")
                cl = {k: csh[k].shard(full[k]).clone() for k in full}
                for k in cl:
                    cl[k][:, :, :cache[k].shape[2]] = cache[k]
                dec = rows.shard(torch.from_numpy(job[f"dec{i}"]))
                step = tf.make_decode_step(cfg)
                res["decode"] = []
                for t in range(n_dec):
                    lg, cl = step(pl, cl, dec[:, t:t + 1], S + t)
                    res["decode"].append(_np(lg))
                res["rows"] = _np(sh.named_sharding(mesh, "batch").shard(
                    torch.arange(B)))
        out[i] = res
    return out


def task_lm_microbatch(rank, job):
    """For each case: the sharded train step at the case's microbatch on
    its mesh from JAX's init (the whole params and first moments after
    it, gathered; the metrics; the bytes its collectives returned), and
    the MoE's forward calls in the step's order (not the recomputation
    in the backward): ("sort", its global dropped pairs) per
    moe_ffn_sort_mesh, ("route", this rank's dropped pairs at its own
    capacity) per router call. A step that raises ValueError returns
    {"raised": its message}."""
    import dataclasses

    from repro_torch.common import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.convert import transformer_params_from_numpy
    from repro_torch.models import collectives as coll
    from repro_torch.models import moe
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    real_route, real_sort = moe.route, moe.moe_ffn_sort_mesh
    calls = []

    def forward_pass():
        # not inside the backward (remat's recomputation)
        return torch._C._current_graph_task_id() == -1

    def route(x, router_w, top_k):
        probs, gate, eidx = real_route(x, router_w, top_k)
        E = router_w.shape[-1]
        C = moe.capacity(x.shape[0], E, top_k)
        load = moe.expert_counts(eidx.reshape(-1), E)
        if forward_pass():
            calls.append(("route", int((load - C).clamp(min=0).sum())))
        return probs, gate, eidx

    def sort_mesh(*args, **kw):
        res = real_sort(*args, **kw)
        if forward_pass():
            calls.append(("sort", int(res[2])))
        return res

    out = {}
    moe.route, moe.moe_ffn_sort_mesh = route, sort_mesh
    try:
        for i, case in enumerate(job["cases"]):
            cfg = dataclasses.replace(get_config(case["arch"], "smoke"),
                                      **case["over"])
            params = transformer_params_from_numpy(cfg, job[f"params{i}"],
                                                   device="cpu")
            tok = torch.from_numpy(job[f"tokens{i}"])
            mesh = _debug_mesh(case["mesh"])
            calls.clear()
            with sh.rules_ctx({}, mesh=mesh):
                psh = tf.param_shardings(cfg, mesh)
                pl = tu.tree_map(lambda x: x.clone(),
                                 sh.shard_tree(params, psh))
                rows = sh.named_sharding(mesh, "batch", None)
                bl = {"tokens": rows.shard(tok), "labels": rows.shard(tok)}
                coll.reset_traffic()
                try:
                    p2, o2, m2 = tf.make_train_step(cfg)(
                        pl, adamw_init(pl), bl)
                except ValueError as e:
                    out[i] = {"raised": str(e)}
                    continue
                traffic = dict(coll.TRAFFIC)
                out[i] = {"params": _tree_np(sh.gather_tree(p2, psh)),
                          "mu": _tree_np(sh.gather_tree(o2["mu"], psh)),
                          "loss": float(m2["loss"]),
                          "aux": float(m2["aux_loss"]),
                          "gnorm": float(m2["grad_norm"]),
                          "traffic": traffic, "calls": list(calls),
                          "coords": dict(mesh.coords)}
    finally:
        moe.route, moe.moe_ffn_sort_mesh = real_route, real_sort
    return out


def task_nequip(rank, job):
    """forward_sharded and one sharded train step on each case's mesh
    axes, from JAX's init; the batch's edges split by owner."""
    from repro_torch.configs import get_config
    from repro_torch.convert import nequip_params_from_numpy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import nequip_sharded as nqs
    from repro_torch.optim import adamw_init

    cfg = get_config("nequip", "smoke")
    params = nequip_params_from_numpy(cfg, job["params"], device="cpu")
    out = {}
    for i, case in enumerate(job["cases"]):
        mesh = make_debug_mesh(tuple(case["shape"]), tuple(case["names"]))
        axes = tuple(case["axes"])
        batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
        batch.update({k: torch.from_numpy(v)
                      for k, v in job[f"edges{i}"].items()})
        e = nqs.forward_sharded(cfg, params, batch, mesh, axes)
        step = nqs.make_train_step_sharded(cfg, mesh, axes)
        p2, _, m = step(params, adamw_init(params), batch)
        out[i] = {"energy": _np(e), "params": _tree_np(p2),
                  "loss": float(m["loss"]), "gnorm": float(m["grad_norm"])}
    return out


def task_nequip_pjit(rank, job):
    """NequIP msg_impl "pjit" (models/nequip.py on a mesh) for each case
    under its rules on its mesh, from JAX's init: this rank's slices of
    the batch, the energies, one train step (params, first moment,
    metrics) and the bytes each collective kind returned, by call."""
    from repro_torch.configs import get_config
    from repro_torch.convert import nequip_params_from_numpy
    from repro_torch.models import collectives as coll
    from repro_torch.models import nequip as nq
    from repro_torch.models import sharding as sh
    from repro_torch.optim import adamw_init

    cfg = get_config("nequip", "smoke")
    out = {}
    for i, case in enumerate(job["cases"]):
        params = nequip_params_from_numpy(cfg, job[f"params{i}"],
                                          case.get("d_feat", 0),
                                          device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in job[f"batch{i}"].items()}
        mesh = _debug_mesh(case["mesh"])
        with sh.rules_ctx(_rules(case["rules"]), mesh=mesh):
            bsh = nq.batch_shardings(mesh, batch)
            local = {k: bsh[k].shard(v).clone() for k, v in batch.items()}
            coll.reset_traffic()
            with torch.no_grad():
                e = nq.forward(cfg, params, local)
            fwd = dict(coll.TRAFFIC)
            coll.reset_traffic()
            p2, o2, m = nq.make_train_step(cfg)(params, adamw_init(params),
                                                local)
            out[i] = {"energy": _np(e), "params": _tree_np(p2),
                      "mu": _tree_np(o2["mu"]), "loss": float(m["loss"]),
                      "gnorm": float(m["grad_norm"]), "fwd_traffic": fwd,
                      "step_traffic": dict(coll.TRAFFIC),
                      "n_edges": int(local["edge_src"].shape[0])}
    return out


def _rules(raw):
    """A rules dict from JSON (lists as tuples, null as None)."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in (raw or {}).items()}


def task_lm_rules(rank, job):
    """For each case, under its rules on its mesh: the sharded train step
    (with "train"), then prefill and N decode steps; the caches gathered
    whole, and on rank 0 the port's one-rank step, prefill and decode.
    Where the rules shard "seq_kv", also a prefill of S - 1 positions
    (which do not split) and its decode into S + N slots, and whether a
    cache of S + N - 1 slots is refused."""
    import dataclasses

    from repro_torch.common import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.convert import transformer_params_from_numpy
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    def infer(cfg, params, tok, dec, rows, mesh=None, width=None):
        B, S = tok.shape
        n_dec = dec.shape[1]
        W = width or S + n_dec
        logits, cache = tf.make_prefill_step(cfg)(params, rows.shard(tok)
                                                  if rows else tok)
        res = {"prefill": _np(logits),
               "prefill_local_len": int(cache["k"].shape[2])}
        ccsh = None
        if mesh is not None:
            psh = tf.prefill_cache_shardings(cfg, mesh, B, S)
            cache = {k: psh[k].gather(v.contiguous())
                     for k, v in cache.items()}
        res["prefill_cache"] = {k: _np(v) for k, v in cache.items()}
        full = tf.init_cache(cfg, B, W, device="cpu")
        for k in full:
            full[k][:, :, :cache[k].shape[2]] = cache[k]
        if mesh is not None:
            ccsh = tf.cache_shardings(cfg, mesh, B, W)
            full = {k: ccsh[k].shard(v).clone() for k, v in full.items()}
        step = tf.make_decode_step(cfg)
        res["decode"] = []
        for t in range(n_dec):
            d = dec[:, t:t + 1]
            lg, full = step(params, full, rows.shard(d) if rows else d, S + t)
            res["decode"].append(_np(lg))
        if mesh is not None:
            full = {k: ccsh[k].gather(v.contiguous())
                    for k, v in full.items()}
        res["cache"] = {k: _np(v) for k, v in full.items()}
        return res

    out = {}
    for i, case in enumerate(job["cases"]):
        cfg = dataclasses.replace(get_config(case["arch"], "smoke"),
                                  **case["over"])
        params = transformer_params_from_numpy(cfg, job[f"params{i}"],
                                               device="cpu")
        tok = torch.from_numpy(job[f"tokens{i}"])
        dec = torch.from_numpy(job[f"dec{i}"])
        batch = {"tokens": tok, "labels": tok}
        res = {}
        seq = bool(case.get("rules"))
        if rank == 0:
            res["single"] = infer(cfg, params, tok, dec, None)
            if seq:
                res["single_odd"] = infer(cfg, params, tok[:, :-1], dec,
                                          None, width=tok.shape[1]
                                          + dec.shape[1])
            if case.get("train"):
                p1, o1, m1 = tf.make_train_step(cfg)(
                    params, adamw_init(params), batch)
                res["single_params"] = _tree_np(p1)
                res["single_mu"] = _tree_np(o1["mu"])
                res["single_loss"] = float(m1["loss"])
                res["single_gnorm"] = float(m1["grad_norm"])
        mesh = _debug_mesh(case["mesh"])
        with sh.rules_ctx(_rules(case.get("rules")), mesh=mesh):
            psh = tf.param_shardings(cfg, mesh)
            pl = tu.tree_map(lambda x: x.clone(), sh.shard_tree(params,
                                                                psh))
            rows = sh.named_sharding(mesh, "batch", None)
            if case.get("train"):
                bl = {k: rows.shard(v) for k, v in batch.items()}
                p2, o2, m2 = tf.make_train_step(cfg)(pl, adamw_init(pl), bl)
                res["params"] = _tree_np(sh.gather_tree(p2, psh))
                # the first moment after one step: (1 - b1) x the clipped
                # gradient, leaf by leaf
                res["mu"] = _tree_np(sh.gather_tree(o2["mu"], psh))
                res.update(loss=float(m2["loss"]),
                           gnorm=float(m2["grad_norm"]))
            res.update(infer(cfg, pl, tok, dec, rows, mesh))
            if seq:
                # a prefill whose length does not split over "model", then
                # decode into a width that splits and one that does not
                W = tok.shape[1] + dec.shape[1]
                res["odd"] = infer(cfg, pl, tok[:, :-1], dec, rows, mesh,
                                   width=W)
                try:
                    tf.cache_shardings(cfg, mesh, tok.shape[0], W - 1)[
                        "k"].shard(tf.init_cache(cfg, tok.shape[0], W - 1,
                                                 device="cpu")["k"])
                    res["odd_refusal"] = ""
                except ValueError as e:
                    res["odd_refusal"] = str(e)
            res["rows"] = _np(sh.named_sharding(mesh, "batch").shard(
                torch.arange(tok.shape[0])))
        out[i] = res
    return out


def task_recsys(rank, job):
    """For each case on its mesh: one row-sharded train step of the port's
    recsys model from JAX's init (the per-field tables sliced along
    "table_rows") and the serve step; the params gathered whole, this
    rank's logits and rows; on rank 0 the port's one-rank steps."""
    from repro_torch.common import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.convert import recsys_params_from_numpy
    from repro_torch.models import recsys as rs
    from repro_torch.models import sharding as sh
    from repro_torch.optim import adamw_init

    out = {}
    for i, case in enumerate(job["cases"]):
        cfg = get_config(case["arch"], "smoke")
        raw = job[f"params{i}"]
        batch = {k: torch.from_numpy(v) for k, v in job[f"batch{i}"].items()}
        serve_b = {k: v for k, v in batch.items() if k != "label"}
        res = {}
        if rank == 0:
            p1 = recsys_params_from_numpy(cfg, raw, device="cpu")
            res["single_logits"] = _np(rs.make_serve_step(cfg)(p1, serve_b))
            q1, _, m1 = rs.make_train_step(cfg)(
                p1, adamw_init(rs.train_tree(p1)), batch)
            res["single_loss"] = float(m1["loss"])
            res["single_params"] = {
                k: _np(v.weight) if isinstance(v, rs.FusedTable) else _np(v)
                for k, v in q1.items()}
        mesh = _debug_mesh(case["mesh"])
        with sh.rules_ctx({}, mesh=mesh):
            psh = rs.param_shardings(cfg, mesh)
            whole = tu.tree_map(lambda a: torch.from_numpy(np.asarray(
                a, np.float32)), raw)
            pl = tu.tree_map(lambda x, s: s.shard(x).clone(), whole, psh)
            rows = sh.named_sharding(mesh, "batch", None)
            rows1 = sh.named_sharding(mesh, "batch")
            bl = {k: (rows if v.dim() == 2 else rows1).shard(v)
                  for k, v in batch.items()}
            res["logits"] = _np(rs.make_serve_step(cfg)(
                pl, {k: v for k, v in bl.items() if k != "label"}))
            p2, _, m2 = rs.make_train_step(cfg)(pl, adamw_init(pl), bl)
            res["params"] = _tree_np(sh.gather_tree(p2, psh))
            res.update(loss=float(m2["loss"]), gnorm=float(m2["grad_norm"]))
            res["rows"] = _np(rows1.shard(torch.arange(
                batch["sparse"].shape[0])))
        out[i] = res
    return out


def real_args(args, gen):
    """CPU tensors of the shapes and dtypes of `args` (nested tuples,
    lists and dicts of meta tensors): floats small normals, integers 0
    (a valid id, token and index everywhere)."""
    if isinstance(args, dict):
        return {k: real_args(v, gen) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(real_args(a, gen) for a in args)
    if args.is_floating_point():
        return (torch.randn(args.shape, generator=gen) * 0.02).to(args.dtype)
    return torch.zeros(args.shape, dtype=args.dtype)


def task_cell_traffic(rank, job):
    """Each case's dry-run cell (a smoke config at a small shape) run on
    real CPU tensors of this rank's slice shapes on a 2 x 2 mesh: the
    bytes the collectives returned, by kind (collectives.TRAFFIC)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import local_args
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import collectives as coll
    from repro_torch.models import sharding as sh

    mesh = _debug_mesh((2, 2))
    out = {}
    for i, case in enumerate(job["cases"]):
        shape = ShapeSpec(**case["shape"])
        cell = build_cell(case["arch"], shape, mesh, False,
                          case.get("over"), "smoke")
        args = real_args(local_args(list(cell.args),
                                    list(cell.in_shardings)),
                         torch.Generator().manual_seed(rank))
        with sh.rules_ctx(cell.rules, mesh=mesh):
            coll.reset_traffic()
            cell.fn(*args)
            out[i] = dict(coll.TRAFFIC)
    return out
