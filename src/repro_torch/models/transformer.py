"""Decoder-only transformer LM: GQA + RoPE (+ QKV bias, SWA, MoE with a
dense residual), a loop over stacked layer params with each layer
recomputed in the backward (`cfg.remat`), chunked cross-entropy so full
logits are never held for the backward. The JAX package's
`repro.models.transformer` for arctic-480b / mixtral-8x7b / qwen2-1.5b /
deepseek-67b / qwen2.5-32b.

Params are a nested dict of tensors in the JAX layout: "embed" (V, d),
"lm_head" (d, V), "final_norm" (d,), and "layers" with every leaf
stacked over the L layers ("wq" (L, d, Hq*hd), ...; MoE configurations
add "router" (L, d, E) and the experts' "moe_wg"/"moe_wu" (L, E, d, f)
and "moe_wd" (L, E, f, d)), so checkpoints and
`repro_torch.convert.transformer_params_from_numpy` carry across leaf
for leaf. The step functions are functional: (params, opt_state, batch)
-> (params, opt_state, metrics) over such dicts.

Each leaf carries its logical axes (`Leaf.axes`), and `param_shardings`
/ `cache_shardings` turn them into placements on a mesh. Without a mesh
the MoE layer is `models/moe.moe_ffn`. With a mesh installed
(`models.sharding.rules_ctx(rules, mesh)`) every function here takes and
returns this rank's slices, as `param_shardings` and `cache_shardings`
place them, and runs the reference's sharded program over
torch.distributed:

  * tensor parallelism over "model": `wq`/`bq` by heads and `wo` by rows
    (then an all-reduce), `ffn_wg`/`ffn_wu` by columns and `ffn_wd` by
    rows, `embed` and `lm_head` by vocabulary (a masked lookup and a
    vocab-parallel chunked cross-entropy); a rank's q heads read the kv
    heads h // (Hq / Hkv) of their global numbers. Where the query heads
    do not divide over the tensor-parallel ranks (qwen2-1.5b's 12 on 16),
    a rank's `wq` columns are not whole heads: the q columns are
    all-gathered, every rank runs every head's attention, and `wo`'s
    row-parallel product takes this rank's columns of its output;
  * the KV sequence over the tensor-parallel axes when the rules shard
    "seq_kv" (the reference's prefill and decode cells): prefill emits
    the cache's values whole and lays them out by their length, this
    rank's sequence slice where the length divides over those ranks and
    the whole cache on every rank where it does not, as the reference's
    jitted prefill returns it (`prefill_cache_shardings`). Decode
    attends every head over the local slice and combines the ranks
    flash-decode style (an all-reduce of the row max, then of the
    exp-sums and the weighted V, the mask in global positions); its
    cache width must divide over the ranks, and one that does not
    raises ValueError in `local_shape`, as in `jax.device_put`;
  * the batch over "data", FSDP of the "embed_w" dimension over "data"
    (`_gather_weights` all-gathers a layer's weights where they are
    used; the backward reduce-scatters their gradients);
  * the MoE by `moe_ffn_ep_shardmap` or `moe_ffn_tp_shardmap`
    (`cfg.moe_impl`), each rank routing its own tokens with its own
    capacity, or by the default "sort", `moe_ffn_sort_mesh`: the global
    function, one capacity over the batch ranks' tokens;
  * AdamW on the local slices, clipped by the global norm.

A mesh of more than one rank needs an initialized process group; no
sharded function falls back to the one-device program.
"""

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import tree as tu
from repro_torch.device import resolve_device
from repro_torch.models import collectives as coll
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding as sh
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import apply_rope, rmsnorm, swiglu
from repro_torch.models.sharding import logical, named_sharding


@dataclasses.dataclass
class Leaf:
    """Parameter leaf spec: shape, dtype name, logical sharding axes and
    init rule."""
    shape: Tuple[int, ...]
    dtype: Any
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | ones | zeros


def _dt(name):
    return getattr(torch, str(name))


def _expert_parallel(cfg) -> bool:
    # EP when the expert count can cover a 16-way model axis, else TP
    # within each expert
    return cfg.moe and cfg.n_experts % 16 == 0


def param_template(cfg):
    d, hd = cfg.d_model, cfg.hd
    L, Hq, Hkv = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
    pdt = cfg.param_dtype
    lay = {
        "ln1": Leaf((L, d), pdt, ("layers", "embed"), "ones"),
        "ln2": Leaf((L, d), pdt, ("layers", "embed"), "ones"),
        "wq": Leaf((L, d, Hq * hd), pdt, ("layers", "embed_w", "heads_w")),
        "wk": Leaf((L, d, Hkv * hd), pdt, ("layers", "embed_w", None)),
        "wv": Leaf((L, d, Hkv * hd), pdt, ("layers", "embed_w", None)),
        "wo": Leaf((L, Hq * hd, d), pdt, ("layers", "heads_w", "embed_w")),
    }
    if cfg.qkv_bias:
        lay["bq"] = Leaf((L, Hq * hd), pdt, ("layers", "heads_w"), "zeros")
        lay["bk"] = Leaf((L, Hkv * hd), pdt, ("layers", None), "zeros")
        lay["bv"] = Leaf((L, Hkv * hd), pdt, ("layers", None), "zeros")
    if cfg.moe:
        E, f = cfg.n_experts, cfg.moe_d_ff
        ep = _expert_parallel(cfg)
        eax = ("layers", "experts", "embed_w", None) if ep \
            else ("layers", None, "embed_w", "ff_w")
        dax = ("layers", "experts", None, "embed_w") if ep \
            else ("layers", None, "ff_w", "embed_w")
        lay["router"] = Leaf((L, d, E), pdt, ("layers", None, None))
        lay["moe_wg"] = Leaf((L, E, d, f), pdt, eax)
        lay["moe_wu"] = Leaf((L, E, d, f), pdt, eax)
        lay["moe_wd"] = Leaf((L, E, f, d), pdt, dax)
    if not cfg.moe or cfg.dense_residual:
        lay["ffn_wg"] = Leaf((L, d, cfg.d_ff), pdt,
                             ("layers", "embed_w", "ff_w"))
        lay["ffn_wu"] = Leaf((L, d, cfg.d_ff), pdt,
                             ("layers", "embed_w", "ff_w"))
        lay["ffn_wd"] = Leaf((L, cfg.d_ff, d), pdt,
                             ("layers", "ff_w", "embed_w"))
    # vocab-sharded over 'model'; rows replicated (row-FSDP on these two
    # tables would gather a whole lm_head per loss chunk)
    return {"embed": Leaf((cfg.vocab_size, d), pdt, ("vocab", "embed")),
            "lm_head": Leaf((d, cfg.vocab_size), pdt, ("embed", "vocab")),
            "final_norm": Leaf((d,), pdt, ("embed",), "ones"),
            "layers": lay}


def _is_leaf(x):
    return isinstance(x, Leaf)


def abstract_from_template(template):
    """Meta tensors of each Leaf's shape and dtype (no storage)."""
    return tu.tree_map(lambda l: torch.empty(l.shape, dtype=_dt(l.dtype),
                                             device="meta"), template)


def shardings_from_template(template, mesh):
    """The NamedSharding of each Leaf's logical axes on `mesh` under the
    installed rules."""
    return tu.tree_map(lambda l: named_sharding(mesh, *l.axes), template)


def abstract_params(cfg):
    return abstract_from_template(param_template(cfg))


def param_shardings(cfg, mesh):
    return shardings_from_template(param_template(cfg), mesh)


def init_from_template(template, generator=None, *, device=None,
                       shardings=None):
    """Random parameters of a template (a nested dict of Leafs) by the JAX
    package's rules (normal * fan_in ** -0.5 with fan_in the leaf's
    second-to-last dim, ones for norms, zeros for biases), drawn leaf by
    leaf in flatten order from `generator` (default: one seeded 0 on
    `device`), placed on `device` (None: the card). The draws cannot
    equal jax.random's: tests take their params from JAX through
    `convert`.

    With `shardings` (a tree of NamedShardings, `param_shardings`) each
    leaf is drawn whole and only this rank's slice is kept, so every
    rank of a mesh holds its slice of one and the same init, one whole
    leaf at a time."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    gdev = generator.device
    places = [None] * len(tu.tree_leaves(template)) if shardings is None \
        else tu.tree_leaves(shardings)
    leaves = []
    for leaf, place in zip(tu.tree_leaves(template), places):
        dt = _dt(leaf.dtype)
        shape = leaf.shape if place is None else place.local_shape(
            leaf.shape)
        if leaf.init == "ones":
            x = torch.ones(shape, dtype=dt, device=dev)
        elif leaf.init == "zeros":
            x = torch.zeros(shape, dtype=dt, device=dev)
        else:
            fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 \
                else leaf.shape[-1]
            x = torch.randn(leaf.shape, generator=generator, device=gdev)
            x = x.mul_(fan_in ** -0.5)
            if place is not None:
                x = place.shard(x)
            x = x.to(device=dev, dtype=dt, copy=place is not None)
        leaves.append(x)
    return tu.tree_unflatten_like(template, leaves)


def init_params(cfg, generator=None, *, device=None, shardings=None):
    """init_from_template over param_template(cfg)."""
    return init_from_template(param_template(cfg), generator, device=device,
                              shardings=shardings)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

# replicated over the tensor-parallel axes but read there only for this
# rank's own q heads: their gradients are partial sums over those axes
_PARTIAL_OVER_TP = ("wk", "wv", "bk", "bv")

# the logical axes of each layer weight where it is used (the reference's
# _gather_weights): the "embed_w" (FSDP) dimension whole, "model" kept
_USE_AXES = {
    "wq": ("embed", "heads_w"), "wk": ("embed", None),
    "wv": ("embed", None), "wo": ("heads_w", "embed"),
    "ffn_wg": ("embed", "ff_w"), "ffn_wu": ("embed", "ff_w"),
    "ffn_wd": ("ff_w", "embed"),
}


@dataclasses.dataclass
class _Plan:
    """How the installed mesh and rules split the LM on this rank: the
    tensor-parallel axes `tp` (those of "heads_w", which "ff_w", "vocab"
    and "heads" must share), the batch axes, this rank's index and the
    axes' sizes, and the params' shardings."""
    mesh: Any
    tp: Tuple[str, ...]
    batch: Tuple[str, ...]
    nm: int
    mi: int
    nd: int
    shardings: dict
    seq: Tuple[str, ...] = ()      # the axes of "seq_kv": () or tp
    even: bool = True              # n_heads divides over tp
    rows: Optional[int] = None     # the call's global batch rows, where
                                   # set (grads_fn's microbatches)


def _seq_parts(plan):
    """How many slices the KV sequence is cut into on this mesh."""
    return 1 if plan is None or not plan.seq else plan.nm


def _own_cols(plan, t):
    """This rank's tensor-parallel slice of t's last dimension."""
    c = t.shape[-1] // plan.nm
    return t.narrow(-1, plan.mi * c, c)


def _mesh_plan(cfg):
    """The _Plan of the installed mesh, or None without one."""
    mesh = sh.current_mesh()
    if mesh is None:
        return None
    tp = sh.spec_axes(sh.spec("heads_w")[0])
    for name in ("ff_w", "vocab", "heads", "ff_act") + (
            ("experts",) if cfg.moe and _expert_parallel(cfg) else ()):
        if sh.spec_axes(sh.spec(name)[0]) != tp:
            raise NotImplementedError(
                f"rules put {name!r} on {sh.spec(name)[0]} and heads_w on "
                f"{tp}: the sharded LM splits them over one set of axes")
    for name in ("seq", "kv_heads", "head_dim", "embed", "layers"):
        if sh.spec(name)[0] is not None:
            raise NotImplementedError(f"rules shard {name!r}")
    seq = sh.spec_axes(sh.spec("seq_kv")[0])
    if seq and seq != tp:
        raise NotImplementedError(
            f"rules put 'seq_kv' on {seq} and heads_w on {tp}: the sharded "
            f"LM splits the KV sequence over the tensor-parallel axes")
    batch = sh.spec_axes(sh.spec("batch")[0])
    nm = mesh.axis_size(tp)
    return _Plan(mesh, tp, batch, nm, mesh.axis_index(tp),
                 mesh.axis_size(batch), param_shardings(cfg, mesh),
                 seq=seq if nm > 1 else (), even=cfg.n_heads % nm == 0)


def _global_rows(plan, B):
    """The global batch rows of a call that holds B rows on this rank."""
    if plan is None:
        return B
    return B * plan.nd if plan.rows is None else plan.rows


def microbatch_rows(B, m, R):
    """Each batch rank's rows of a microbatch, [(first, count)] by rank
    (pod-major over the batch axes), offsets within the microbatch:
    microbatch i of a global batch of B rows is the global rows
    [i B/m, (i + 1) B/m). Where R divides B/m, rank r takes B/(m R) rows
    from r B/(m R); else the first (B/m) mod R ranks take one row more
    than the others, and a rank may take none."""
    n, extra = divmod(B // m, R)
    return [(r * n + min(r, extra), n + (r < extra)) for r in range(R)]


def _shard_map_moe(cfg, mesh):
    """Whether the MoE runs the reference's shard_map branch here."""
    return (cfg.moe and cfg.moe_impl in ("ep_shard_map", "tp_shard_map")
            and mesh is not None and "model" in mesh.shape)


def _enter(plan, x):
    """Into the tensor-parallel region: identity, the backward sums."""
    return x if plan is None else coll.copy_to(x, plan.mesh, plan.tp)


def _exit(plan, x):
    """Out of it: the ranks' partial sums added (backward: identity)."""
    return x if plan is None else coll.all_reduce(x, plan.mesh, plan.tp)


def _use_axes(cfg, name):
    ep = cfg.moe and _expert_parallel(cfg)
    if name in ("moe_wg", "moe_wu"):
        return ("experts", "embed", None) if ep else (None, "embed", "ff_w")
    if name == "moe_wd":
        return ("experts", None, "embed") if ep else (None, "ff_w", "embed")
    return _USE_AXES.get(name)


def _gather_weights(cfg, lp, plan):
    """FSDP: each layer weight all-gathered, where it is used, over the
    mesh axes of the dimensions its storage splits and its use does not
    (the "embed_w" rows over "data"); the "model" shards stay. The
    backward reduce-scatters the gradients."""
    if plan is None:
        return lp
    g = dict(lp)
    for k, w in lp.items():
        use = _use_axes(cfg, k)
        if use is None:
            continue
        have = plan.shardings["layers"][k].spec[1:]
        want = sh.spec(*use)
        for dim, (h, u) in enumerate(zip(have, want)):
            if h == u:
                continue
            if u is not None:
                raise NotImplementedError(f"{k}: storage {have}, use {want}")
            w = coll.all_gather(w, plan.mesh, sh.spec_axes(h), dim)
        g[k] = w
    return g


def _local_kv(cfg, plan, k, v, hq_local):
    """The kv heads a rank's q heads read: global q head h reads kv head
    h // (Hq / Hkv). Contiguous kv heads when the rank's heads cover
    whole groups, else one kv head per q head."""
    if plan is None or plan.nm == 1:
        return k, v
    rep = cfg.n_heads // cfg.n_kv_heads
    first = plan.mi * hq_local
    if hq_local % rep == 0:
        lo = first // rep
        return (k[:, :, lo:lo + hq_local // rep],
                v[:, :, lo:lo + hq_local // rep])
    idx = torch.arange(first, first + hq_local, device=k.device) // rep
    return k[:, :, idx], v[:, :, idx]


def _complete_grads(grads, plan):
    """Each gradient summed over the mesh axes its computation is split
    on and its backward has not summed yet: the batch axes (less those a
    reduce-scatter summed, the leaf's own storage axes) and, for the
    leaves in _PARTIAL_OVER_TP, the tensor-parallel axes."""
    paths = tu.leaf_paths(grads)
    leaves = [g for _, g in paths]
    by_axes = {}
    for i, ((path, g), s) in enumerate(zip(paths, tu.tree_leaves(
            plan.shardings))):
        have = {a for e in s.spec for a in sh.spec_axes(e)}
        axes = set(plan.batch) - have
        if path.split("'")[-2] in _PARTIAL_OVER_TP:
            axes |= set(plan.tp) - have
        axes = tuple(a for a in plan.mesh.axis_names if a in axes)
        by_axes.setdefault((axes, g.dtype), []).append(i)
    for (axes, _), idx in by_axes.items():
        if axes:
            for i, t in zip(idx, coll.all_reduce_many(
                    [leaves[i] for i in idx], plan.mesh, axes)):
                leaves[i] = t
    return tu.tree_unflatten_like(grads, leaves)


def _global_norm(grads, plan):
    """The norm of the whole gradient: each leaf's float32 sum of squares
    summed over the axes its storage splits (not over those it is
    replicated on)."""
    by_axes = {}
    for g, s in zip(tu.tree_leaves(grads), tu.tree_leaves(plan.shardings)):
        axes = s.sharded_axes()
        sq = torch.sum(torch.square(g.float()))
        by_axes[axes] = sq if axes not in by_axes else by_axes[axes] + sq
    total = None
    for axes, sq in sorted(by_axes.items()):
        sq = coll.all_reduce_many([sq], plan.mesh, axes)[0]
        total = sq if total is None else total + sq
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _qkv(cfg, h, lp):
    cd = h.dtype
    q = h @ lp["wq"].to(cd)
    k = h @ lp["wk"].to(cd)
    v = h @ lp["wv"].to(cd)
    if cfg.qkv_bias:
        q, k, v = (q + lp["bq"].to(cd), k + lp["bk"].to(cd),
                   v + lp["bv"].to(cd))
    return q, k, v


def _moe_dispatch(cfg, flat, lp, plan, n_tokens):
    """The MoE on flat (T, d) tokens, `n_tokens` over all batch ranks: the
    reference's shard_map branch (EP or TP over "model" by cfg.moe_impl,
    the batch axes from the rules) when a mesh with a "model" axis is
    installed and moe_impl asks for it; on any other mesh its default,
    `moe_ffn_sort_mesh` (the global function, its capacity global) over
    the plan's batch and tensor-parallel axes; with no mesh the
    one-device `moe_ffn`."""
    mesh = None if plan is None else plan.mesh
    if _shard_map_moe(cfg, mesh):
        rules = sh.current_rules() or {}
        batch = rules.get("batch", ("data",))
        batch_axes = tuple(batch) if batch else ()  # () = replicated batch
        ep_ok = _expert_parallel(cfg) and cfg.moe_impl == "ep_shard_map"
        if ep_ok != _expert_parallel(cfg):
            raise ValueError(
                f"moe_impl {cfg.moe_impl!r} with {cfg.n_experts} experts: "
                f"the params are laid out for expert parallelism")
        fn = (moe_lib.moe_ffn_ep_shardmap if ep_ok
              else moe_lib.moe_ffn_tp_shardmap)

        def call(x):
            return fn(x, lp["router"], lp["moe_wg"], lp["moe_wu"],
                      lp["moe_wd"], top_k=cfg.moe_top_k, mesh=mesh,
                      batch_axes=batch_axes)
        if plan.rows is None or plan.rows % plan.nd == 0:
            return call(flat)
        return _reblocked(plan, flat, n_tokens, call)
    if mesh is not None:
        out, aux, _ = moe_lib.moe_ffn_sort_mesh(
            flat, lp["router"], lp["moe_wg"], lp["moe_wu"], lp["moe_wd"],
            top_k=cfg.moe_top_k, mesh=mesh, batch_axes=plan.batch,
            model_axis=plan.tp, n_tokens=n_tokens)
        return out, aux
    return moe_lib.moe_ffn(flat, lp["router"], lp["moe_wg"], lp["moe_wu"],
                           lp["moe_wd"], top_k=cfg.moe_top_k)


def _reblocked(plan, flat, n_tokens, call):
    """`call` on the reference shard_map's block of a microbatch whose
    rows do not split evenly over the batch ranks: the microbatch's
    n_tokens flat tokens in global order, rank r's the r-th of nd equal
    blocks (grads_fn has checked that nd divides n_tokens). The ranks'
    tokens are all-gathered (each padded to the most a rank holds),
    `call` runs on this rank's block, and the blocks' outputs are
    all-gathered for this rank's own tokens: (out (T_local, d), aux)."""
    mesh, axes, nd = plan.mesh, plan.batch, plan.nd
    per = n_tokens // plan.rows                         # tokens a row
    lay = microbatch_rows(plan.rows, 1, nd)
    most = lay[0][1] * per
    pad = flat.new_zeros((most - flat.shape[0],) + tuple(flat.shape[1:]))
    every = coll.all_gather(torch.cat([flat, pad]), mesh, axes, 0)
    order = torch.cat([torch.arange(q * most, q * most + n * per,
                                    device=flat.device)
                       for q, (_, n) in enumerate(lay)])
    t, r = n_tokens // nd, mesh.axis_index(axes)
    out, aux = call(every[order[r * t:(r + 1) * t]])
    first, n = lay[r]
    out = coll.all_gather(out, mesh, axes, 0)
    return out[first * per:(first + n) * per], aux


def _ffn(cfg, h2, lp, plan=None):
    """The layer's FFN on h2 (..., S, d): the MoE over the flattened
    tokens plus, without MoE or with a dense residual, the dense SwiGLU.
    Returns (out of h2's shape, the MoE aux loss or 0.0)."""
    aux = torch.zeros((), dtype=torch.float32, device=h2.device)
    out = 0.
    if cfg.moe:
        n_tokens = _global_rows(plan, h2.shape[0]) * h2.shape[1]
        mo, aux = _moe_dispatch(cfg, h2.reshape(-1, h2.shape[-1]), lp, plan,
                                n_tokens)
        out = out + mo.reshape(h2.shape)
    if not cfg.moe or cfg.dense_residual:
        out = out + _exit(plan, swiglu(_enter(plan, h2), lp["ffn_wg"],
                                       lp["ffn_wu"], lp["ffn_wd"]))
    return out, aux


def _layer(cfg, x, lp, positions, plan=None):
    """One transformer layer (train/prefill). x: (B, S, d). Returns (x,
    (k, v), aux), k/v cut to the last window for SWA configurations."""
    B, S, d = x.shape
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    Bg = _global_rows(plan, B)
    # the global shapes are checked where the rows split evenly
    split = plan is None or Bg % plan.nd == 0
    even = plan is None or plan.even
    lp = _gather_weights(cfg, lp, plan)
    h = _enter(plan, rmsnorm(x, lp["ln1"]))
    q, k, v = _qkv(cfg, h, lp)
    if not even:        # every head's q columns on every rank
        q = coll.all_gather(q, plan.mesh, plan.tp, q.dim() - 1)
    Hq = q.shape[-1] // hd
    q = apply_rope(q.reshape(B, S, Hq, hd), positions, cfg.rope_theta)
    if even:
        q = logical(q, "batch", "seq", "heads", "head_dim",
                    shape=(Bg, S, cfg.n_heads, hd) if split else None)
    k = apply_rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, hd)
    kv = _local_kv(cfg, plan, k, v, Hq) if even else (k, v)
    attn = attention(q, *kv, causal=True, window=cfg.sliding_window)
    attn = attn.reshape(B, S, Hq * hd)
    if even:
        logical(attn.view(B, S, Hq, hd), "batch", "seq", "heads",
                "head_dim", shape=(Bg, S, cfg.n_heads, hd) if split else None)
    else:               # this rank's columns for wo's rows
        attn = _own_cols(plan, attn)
    x = x + _exit(plan, attn @ lp["wo"].to(x.dtype))
    out, aux = _ffn(cfg, rmsnorm(x, lp["ln2"]), lp, plan)
    x = x + out
    if cfg.sliding_window and S > cfg.sliding_window:
        k = k[:, -cfg.sliding_window:]
        v = v[:, -cfg.sliding_window:]
    ns, T = _seq_parts(plan), k.shape[1]
    seq = "seq_kv" if T % ns == 0 else None
    if ns > 1 and seq:  # this rank's slice of the emitted cache
        n = T // ns
        k = k.narrow(1, plan.mi * n, n)
        v = v.narrow(1, plan.mi * n, n)
    k = logical(k, "batch", seq, "kv_heads", "head_dim",
                shape=(Bg, T) + tuple(k.shape[2:]) if split else None)
    v = logical(v, "batch", seq, "kv_heads", "head_dim",
                shape=(Bg, T) + tuple(v.shape[2:]) if split else None)
    return (logical(x, "batch", "seq", "embed",
                    shape=(Bg, S, d) if split else None), (k, v), aux)


def _layer_slices(params, cd):
    """Per-layer dicts of views into the stacked leaves, the matmul
    weights and biases cast to the compute dtype `cd` once for all
    layers (the cast is elementwise, so each slice holds the values the
    reference's per-use `astype` gives; the norms' gains stay as stored,
    as rmsnorm reads them in float32). `unbind` makes one backward node
    per leaf, which stacks the L gradients once."""
    names = sorted(params["layers"])
    cols = [torch.unbind(params["layers"][n] if n in ("ln1", "ln2")
                         else params["layers"][n].to(cd), 0)
            for n in names]
    return [dict(zip(names, row)) for row in zip(*cols)]


def _embed(cfg, params, tokens, plan):
    """The token embeddings in cfg.dtype; on a mesh a vocab-parallel
    lookup: each rank reads the tokens of its vocabulary slice, zeros
    elsewhere, summed over the tensor-parallel axes."""
    cd = _dt(cfg.dtype)
    if plan is None:
        return params["embed"][tokens.long()].to(cd)
    table = params["embed"]
    v_local = table.shape[0]
    local = tokens.long() - plan.mi * v_local
    mine = (local >= 0) & (local < v_local)
    x = table[local.clamp(0, v_local - 1)].to(cd)
    return _exit(plan, torch.where(mine[..., None], x, 0))


def forward(cfg, params, tokens, *, return_kv=False, rows=None):
    """tokens: (B, S) -> (hidden (B, S, d), (k, v) stacked (L, B, S', Hkv,
    hd) or None, the mean over layers of the MoE aux loss (0.0 without
    MoE)). With cfg.remat and grad enabled, each layer is recomputed in
    the backward. On a mesh: this rank's batch rows and param slices;
    `rows` is the global batch rows where the ranks may hold unequal
    parts of it (grads_fn's microbatches; default B x the batch ranks)."""
    plan = _mesh_plan(cfg)
    if plan is not None and rows is not None:
        plan = dataclasses.replace(plan, rows=rows)
    B, S = tokens.shape
    cd = _dt(cfg.dtype)
    x = _embed(cfg, params, tokens, plan)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    names = sorted(params["layers"])
    ks, vs, auxs = [], [], []
    for lp in _layer_slices(params, cd):
        if cfg.remat and torch.is_grad_enabled():
            def body(x, *ws):
                return _layer(cfg, x, dict(zip(names, ws)), positions, plan)
            x, (k, v), aux = checkpoint(body, x, *(lp[n] for n in names),
                                        use_reentrant=False)
        else:
            x, (k, v), aux = _layer(cfg, x, lp, positions, plan)
        auxs.append(aux)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rmsnorm(x, params["final_norm"])
    kv = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    return x, kv, torch.stack(auxs).mean()


def _chunk_xent(hc, yc, lm_head):
    logits = (hc @ lm_head.to(hc.dtype)).float()          # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, yc.long()[..., None])[..., 0]
    return torch.sum(lse - ll)


def _chunk_xent_vp(hc, yc, lm_head, plan):
    """_chunk_xent with the vocabulary split over the tensor-parallel
    axes: the max and the sum of exponentials, and the label's logit,
    taken over every rank's slice."""
    logits = (hc @ lm_head.to(hc.dtype)).float()          # (B, c, V_l)
    m = coll.all_reduce_max(logits.detach().amax(-1), plan.mesh, plan.tp)
    se = _exit(plan, torch.exp(logits - m[..., None]).sum(-1))
    lse = torch.log(se) + m
    v_local = logits.shape[-1]
    local = yc.long() - plan.mi * v_local
    mine = (local >= 0) & (local < v_local)
    ll = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    ll = _exit(plan, torch.where(mine, ll, 0.0))
    return torch.sum(lse - ll)


def lm_loss(cfg, hidden, lm_head, labels, rows=None):
    """Mean softmax cross-entropy, chunked over the sequence: logits exist
    one (B, chunk, V) slab at a time (chunk = S when S does not divide by
    cfg.logits_chunk), in the hidden dtype and then float32, and each
    chunk is recomputed in the backward. The sum is divided by `rows`
    (default B) x S. On a mesh: over this rank's rows, the vocabulary
    split over the tensor-parallel axes."""
    plan = _mesh_plan(cfg)
    B, S, d = hidden.shape
    chunk = cfg.logits_chunk or S
    if S % chunk:
        chunk = S
    if plan is None:
        fn = _chunk_xent
    else:
        hidden = _enter(plan, hidden)

        def fn(hc, yc, w):
            return _chunk_xent_vp(hc, yc, w, plan)
    acc = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // chunk):
        hc = hidden[:, i * chunk:(i + 1) * chunk]
        yc = labels[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            acc = acc + checkpoint(fn, hc, yc, lm_head, use_reentrant=False)
        else:
            acc = acc + fn(hc, yc, lm_head)
    return acc / ((B if rows is None else rows) * S)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _loss(cfg, params, batch, rows=None):
    hidden, _, aux = forward(cfg, params, batch["tokens"], rows=rows)
    plan = _mesh_plan(cfg)
    if plan is None:
        loss = lm_loss(cfg, hidden, params["lm_head"], batch["labels"])
    else:
        # the global mean: each rank's rows' sum over the global count,
        # summed over the batch axes (a rank may hold no rows)
        B = batch["tokens"].shape[0]
        loss = coll.all_reduce(lm_loss(
            cfg, hidden, params["lm_head"], batch["labels"],
            rows=B * plan.nd if rows is None else rows), plan.mesh,
            plan.batch)
    return loss + 0.01 * aux, loss, aux


def value_and_grad(cfg, params, batch, rows=None):
    """((total, loss, aux), grads): one batch's loss and its gradients
    (a tree of params' structure) by torch.autograd.grad. On a mesh,
    `rows` is the global batch rows (forward's)."""
    leaves = [p.detach().requires_grad_() for p in tu.tree_leaves(params)]
    with torch.enable_grad():
        tot, loss, aux = _loss(cfg, tu.tree_unflatten_like(params, leaves),
                               batch, rows)
        grads = torch.autograd.grad(tot, leaves)
    return ((tot.detach(), loss.detach(), aux.detach()),
            tu.tree_unflatten_like(params, list(grads)))


def grads_fn(cfg, params, batch):
    """value_and_grad, or with cfg.microbatch m dividing the global batch
    of B rows the mean over m microbatches, as the reference's scan:
    microbatch i is the global rows [i B/m, (i + 1) B/m), its gradients
    summed in cfg.grad_accum_dtype from zero in microbatch order, then
    scaled by 1/m.

    Under an installed mesh B is this rank's rows times R, the size of
    the batch axes: the decision is the reference's, on the global
    batch. The rows move once a step (each batch leaf all-gathered over
    the batch axes), and rank r steps on `microbatch_rows(B, m, R)[r]`
    of each microbatch: B/(m R) rows from r B/(m R) where R divides B/m,
    else the first (B/m) mod R ranks one row more, a rank perhaps none.
    Every mean is the global one. Where the rows do not split, the
    shard_map MoE takes the reference's even token blocks, and raises
    ValueError, as the reference's shard_map does, where R does not
    divide a microbatch's tokens."""
    m = cfg.microbatch
    plan = _mesh_plan(cfg)
    R = 1 if plan is None else plan.nd
    B = batch["tokens"].shape[0] * R
    if not m or B % m:
        return value_and_grad(cfg, params, batch)
    Bm = B // m
    first, n = 0, Bm // R
    if plan is not None and m > 1:
        S = batch["tokens"].shape[1]
        if Bm % R and (Bm * S) % R and _shard_map_moe(cfg, plan.mesh):
            raise ValueError(
                f"{cfg.moe_impl}: microbatch {m} of the global batch B {B} "
                f"leaves {Bm} rows of {S} tokens, which do not split over "
                f"the R {R} ranks of the batch axes {plan.batch}")
        batch = {k: coll.gather_parts(v, plan.mesh, plan.batch)
                 for k, v in batch.items()}
        first, n = microbatch_rows(B, m, R)[
            plan.mesh.axis_index(plan.batch)]
    acc_dt = _dt(cfg.grad_accum_dtype)
    acc_g = tu.tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                              device=p.device), params)
    acc_m = None
    for i in range(m):
        mb = {k: v[i * Bm + first:i * Bm + first + n]
              for k, v in batch.items()}
        vals, g = value_and_grad(cfg, params, mb,
                                 None if plan is None else Bm)
        for a, b in zip(tu.tree_leaves(acc_g), tu.tree_leaves(g)):
            a.add_(b.to(a.dtype))
        del g
        acc_m = vals if acc_m is None \
            else tuple(x + y for x, y in zip(acc_m, vals))
    scale = 1.0 / m
    return (tuple(x * scale for x in acc_m),
            tu.tree_map(lambda x: x * scale, acc_g))


def make_train_step(cfg, schedule=None, train_cfg=None):
    """fn(params, opt_state, batch {"tokens", "labels"}) -> (params,
    opt_state, {"loss", "aux_loss", "lr", "grad_norm"}): gradients by
    grads_fn, lr = schedule(opt_state["count"]), then the port's
    adamw_update with the train config's settings.

    Under an installed mesh the step takes and returns this rank's slices
    (`param_shardings` places params and both moments, "batch" the
    batch): grads_fn microbatches the global batch (rank r's rows of
    microbatch i are `microbatch_rows`'s, moved there by one all-gather
    of the batch), each gradient is summed over the axes its computation
    is split on (`_complete_grads`), clipped by the norm of the whole
    gradient, and AdamW updates the local slices."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_update
    tc = train_cfg or TrainConfig()
    sched = schedule or (lambda step: tc.lr)

    def train_step(params, opt_state, batch):
        plan = _mesh_plan(cfg)
        (tot, loss, aux), grads = grads_fn(cfg, params, batch)
        gnorm = None
        if plan is not None:
            grads = _complete_grads(grads, plan)
            gnorm = _global_norm(grads, plan)
        lr = sched(opt_state["count"])
        params, opt_state, stats = adamw_update(
            grads, opt_state, params, lr=lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
            weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
            global_norm=gnorm)
        return params, opt_state, {"loss": loss, "aux_loss": aux, "lr": lr,
                                   **stats}

    return train_step


def cache_template(cfg, batch, seq_len):
    """KV cache specs. SWA archs keep a ring buffer of `window` slots."""
    W = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.hd)
    axes = ("layers", "batch", "seq_kv", "kv_heads", "head_dim")
    return {"k": Leaf(shape, cfg.dtype, axes), "v": Leaf(shape, cfg.dtype,
                                                         axes)}


def abstract_cache(cfg, batch, seq_len):
    return abstract_from_template(cache_template(cfg, batch, seq_len))


def cache_shardings(cfg, mesh, batch, seq_len):
    return shardings_from_template(cache_template(cfg, batch, seq_len),
                                   mesh)


def prefill_cache_shardings(cfg, mesh, batch, seq_len):
    """The placement of make_prefill_step's cache of `seq_len` positions:
    `cache_shardings`, with the KV sequence whole where the installed
    rules split it over ranks that do not divide its length (what the
    reference's jitted prefill returns)."""
    rules = sh.current_rules() or sh.BASE_RULES
    W = cache_template(cfg, batch, seq_len)["k"].shape[2]
    axes = sh.spec_axes(sh.spec("seq_kv")[0])
    if W % mesh.axis_size(axes) == 0:
        return cache_shardings(cfg, mesh, batch, seq_len)
    with sh.rules_ctx(dict(rules, seq_kv=None), mesh=sh.current_mesh()):
        return cache_shardings(cfg, mesh, batch, seq_len)


def init_cache(cfg, batch, seq_len, device=None):
    """Zero KV cache {"k", "v"} of (L, batch, W, Hkv, hd) in cfg.dtype; SWA
    configurations keep a ring of W = min(seq_len, window) slots."""
    dev = resolve_device(device)
    return {n: torch.zeros(l.shape, dtype=_dt(l.dtype), device=dev)
            for n, l in cache_template(cfg, batch, seq_len).items()}


def _logits(plan, x, lm_head):
    """x (..., d) @ lm_head in x's dtype, as float32; on a mesh the
    vocabulary slices of every tensor-parallel rank side by side."""
    logits = (x @ lm_head.to(x.dtype)).float()
    if plan is None:
        return logits
    return coll.gather_parts(logits, plan.mesh, plan.tp, logits.dim() - 1)


def make_prefill_step(cfg):
    """fn(params, tokens (B, S)) -> (last-position logits (B, V) float32,
    cache {"k", "v"} of (L, B, S', Hkv, hd), S' the window for SWA). On a
    mesh: this rank's batch rows, their logits over the whole vocabulary,
    and the cache as `prefill_cache_shardings` places it."""

    @torch.no_grad()
    def prefill(params, tokens):
        hidden, (k, v), _ = forward(cfg, params, tokens, return_kv=True)
        return _logits(_mesh_plan(cfg), hidden[:, -1],
                       params["lm_head"]), {"k": k, "v": v}
    return prefill


def make_decode_step(cfg):
    """fn(params, cache, tokens (B, 1), pos) -> (logits (B, V) float32,
    new cache). `pos` is the write position (the cache holds `pos` valid
    entries): slot pos % W under SWA, else min(pos, W - 1). The MoE runs
    on the batch's B tokens (capacity(B, E, K) slots an expert). On a
    mesh, as make_prefill_step; with "seq_kv" sharded each rank holds and
    updates its sequence slice of the cache."""

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        plan = _mesh_plan(cfg)
        pos = int(pos)
        B = tokens.shape[0]
        cd = _dt(cfg.dtype)
        hd, Hkv = cfg.hd, cfg.n_kv_heads
        x = _embed(cfg, params, tokens, plan)                  # (B, 1, d)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        # on a mesh whose rules shard "seq_kv", this rank holds cache
        # slots lo .. lo + W_l - 1 of W
        W_l = cache["k"].shape[2]
        ns = _seq_parts(plan)
        W, lo = W_l * ns, (plan.mi * W_l if ns > 1 else 0)
        slot = pos % W if cfg.sliding_window else min(pos, W - 1)
        onehot = (torch.arange(lo, lo + W_l, device=x.device)
                  == slot)[None, :, None, None]
        cache_len = min(pos + 1, W)
        # all heads on every rank: the sequence split, or uneven heads
        every = plan is not None and (ns > 1 or not plan.even)
        nk, nv = [], []
        for lp, kc, vc in zip(_layer_slices(params, cd), cache["k"],
                              cache["v"]):
            lp = _gather_weights(cfg, lp, plan)
            h = _enter(plan, rmsnorm(x, lp["ln1"]))
            q, k, v = _qkv(cfg, h, lp)
            if every:
                q = coll.gather_parts(q, plan.mesh, plan.tp, q.dim() - 1)
            Hq = q.shape[-1] // hd
            q = apply_rope(q.reshape(B, 1, Hq, hd), positions,
                           cfg.rope_theta)
            k = apply_rope(k.reshape(B, 1, Hkv, hd), positions,
                           cfg.rope_theta)
            v = v.reshape(B, 1, Hkv, hd)
            kc = torch.where(onehot, k.to(kc.dtype), kc)
            vc = torch.where(onehot, v.to(vc.dtype), vc)
            if ns > 1:
                out = decode_attention(q, kc, vc, cache_len, kv_start=lo,
                                       combine=(plan.mesh, plan.seq))
            elif every:
                out = decode_attention(q, kc, vc, cache_len)
            else:
                out = decode_attention(q, *_local_kv(cfg, plan, kc, vc, Hq),
                                       cache_len)
            out = out.reshape(B, 1, Hq * hd)
            if every:
                out = _own_cols(plan, out)
            x = x + _exit(plan, out @ lp["wo"].to(cd))
            x = x + _ffn(cfg, rmsnorm(x, lp["ln2"]), lp, plan)[0]
            nk.append(kc)
            nv.append(vc)
        x = rmsnorm(x, params["final_norm"])
        return _logits(plan, x[:, 0], params["lm_head"]), {
            "k": torch.stack(nk), "v": torch.stack(nv)}

    return decode
