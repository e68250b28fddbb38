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

The MoE layer is `models/moe.moe_ffn`, the dispatch JAX takes when no
mesh is set. Not here yet: the sharded dispatches and the sharding
annotations (`logical`, `_gather_weights`, `param_shardings`), which
wait for the mesh.
"""

import dataclasses
from typing import Any, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import tree as tu
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import apply_rope, rmsnorm, swiglu


@dataclasses.dataclass
class Leaf:
    """Parameter leaf spec: shape, dtype name and init rule."""
    shape: Tuple[int, ...]
    dtype: Any
    init: str = "normal"  # normal | ones | zeros


def _dt(name):
    return getattr(torch, str(name))


def param_template(cfg):
    d, hd = cfg.d_model, cfg.hd
    L, Hq, Hkv = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
    pdt = cfg.param_dtype
    lay = {
        "ln1": Leaf((L, d), pdt, "ones"),
        "ln2": Leaf((L, d), pdt, "ones"),
        "wq": Leaf((L, d, Hq * hd), pdt),
        "wk": Leaf((L, d, Hkv * hd), pdt),
        "wv": Leaf((L, d, Hkv * hd), pdt),
        "wo": Leaf((L, Hq * hd, d), pdt),
    }
    if cfg.qkv_bias:
        lay["bq"] = Leaf((L, Hq * hd), pdt, "zeros")
        lay["bk"] = Leaf((L, Hkv * hd), pdt, "zeros")
        lay["bv"] = Leaf((L, Hkv * hd), pdt, "zeros")
    if cfg.moe:
        E, f = cfg.n_experts, cfg.moe_d_ff
        lay["router"] = Leaf((L, d, E), pdt)
        lay["moe_wg"] = Leaf((L, E, d, f), pdt)
        lay["moe_wu"] = Leaf((L, E, d, f), pdt)
        lay["moe_wd"] = Leaf((L, E, f, d), pdt)
    if not cfg.moe or cfg.dense_residual:
        lay["ffn_wg"] = Leaf((L, d, cfg.d_ff), pdt)
        lay["ffn_wu"] = Leaf((L, d, cfg.d_ff), pdt)
        lay["ffn_wd"] = Leaf((L, cfg.d_ff, d), pdt)
    return {"embed": Leaf((cfg.vocab_size, d), pdt),
            "lm_head": Leaf((d, cfg.vocab_size), pdt),
            "final_norm": Leaf((d,), pdt, "ones"),
            "layers": lay}


def init_from_template(template, generator=None, *, device=None):
    """Random parameters of a template (a nested dict of Leafs) by the JAX
    package's rules (normal * fan_in ** -0.5 with fan_in the leaf's
    second-to-last dim, ones for norms, zeros for biases), drawn leaf by
    leaf in flatten order from `generator` (default: one seeded 0 on
    `device`), placed on `device` (None: the card). The draws cannot
    equal jax.random's: tests take their params from JAX through
    `convert`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    gdev = generator.device
    leaves = []
    for leaf in tu.tree_leaves(template):
        dt = _dt(leaf.dtype)
        if leaf.init == "ones":
            x = torch.ones(leaf.shape, dtype=dt, device=dev)
        elif leaf.init == "zeros":
            x = torch.zeros(leaf.shape, dtype=dt, device=dev)
        else:
            fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 \
                else leaf.shape[-1]
            x = torch.randn(leaf.shape, generator=generator, device=gdev)
            x = x.mul_(fan_in ** -0.5).to(device=dev, dtype=dt)
        leaves.append(x)
    return tu.tree_unflatten_like(template, leaves)


def init_params(cfg, generator=None, *, device=None):
    """init_from_template over param_template(cfg)."""
    return init_from_template(param_template(cfg), generator, device=device)


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


def _ffn(cfg, h2, lp):
    """The layer's FFN on h2 (..., d): the MoE over the flattened tokens
    plus, without MoE or with a dense residual, the dense SwiGLU.
    Returns (out of h2's shape, the MoE aux loss or 0.0)."""
    aux = torch.zeros((), dtype=torch.float32, device=h2.device)
    out = 0.
    if cfg.moe:
        mo, aux = moe_lib.moe_ffn(
            h2.reshape(-1, h2.shape[-1]), lp["router"], lp["moe_wg"],
            lp["moe_wu"], lp["moe_wd"], top_k=cfg.moe_top_k)
        out = out + mo.reshape(h2.shape)
    if not cfg.moe or cfg.dense_residual:
        out = out + swiglu(h2, lp["ffn_wg"], lp["ffn_wu"], lp["ffn_wd"])
    return out, aux


def _layer(cfg, x, lp, positions):
    """One transformer layer (train/prefill). x: (B, S, d). Returns (x,
    (k, v), aux), k/v cut to the last window for SWA configurations."""
    B, S, d = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h = rmsnorm(x, lp["ln1"])
    q, k, v = _qkv(cfg, h, lp)
    q = apply_rope(q.reshape(B, S, Hq, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, hd)
    attn = attention(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn.reshape(B, S, Hq * hd) @ lp["wo"].to(x.dtype)
    out, aux = _ffn(cfg, rmsnorm(x, lp["ln2"]), lp)
    x = x + out
    if cfg.sliding_window and S > cfg.sliding_window:
        k = k[:, -cfg.sliding_window:]
        v = v[:, -cfg.sliding_window:]
    return x, (k, v), aux


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


def forward(cfg, params, tokens, *, return_kv=False):
    """tokens: (B, S) -> (hidden (B, S, d), (k, v) stacked (L, B, S', Hkv,
    hd) or None, the mean over layers of the MoE aux loss (0.0 without
    MoE)). With cfg.remat and grad enabled, each layer is recomputed in
    the backward."""
    B, S = tokens.shape
    cd = _dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(cd)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    names = sorted(params["layers"])
    ks, vs, auxs = [], [], []
    for lp in _layer_slices(params, cd):
        if cfg.remat and torch.is_grad_enabled():
            def body(x, *ws):
                return _layer(cfg, x, dict(zip(names, ws)), positions)
            x, (k, v), aux = checkpoint(body, x, *(lp[n] for n in names),
                                        use_reentrant=False)
        else:
            x, (k, v), aux = _layer(cfg, x, lp, positions)
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


def lm_loss(cfg, hidden, lm_head, labels):
    """Mean softmax cross-entropy, chunked over the sequence: logits exist
    one (B, chunk, V) slab at a time (chunk = S when S does not divide by
    cfg.logits_chunk), in the hidden dtype and then float32, and each
    chunk is recomputed in the backward."""
    B, S, d = hidden.shape
    chunk = cfg.logits_chunk or S
    if S % chunk:
        chunk = S
    acc = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // chunk):
        hc = hidden[:, i * chunk:(i + 1) * chunk]
        yc = labels[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            acc = acc + checkpoint(_chunk_xent, hc, yc, lm_head,
                                   use_reentrant=False)
        else:
            acc = acc + _chunk_xent(hc, yc, lm_head)
    return acc / (B * S)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _loss(cfg, params, batch):
    hidden, _, aux = forward(cfg, params, batch["tokens"])
    loss = lm_loss(cfg, hidden, params["lm_head"], batch["labels"])
    return loss + 0.01 * aux, loss, aux


def value_and_grad(cfg, params, batch):
    """((total, loss, aux), grads): one batch's loss and its gradients
    (a tree of params' structure) by torch.autograd.grad."""
    leaves = [p.detach().requires_grad_() for p in tu.tree_leaves(params)]
    with torch.enable_grad():
        tot, loss, aux = _loss(cfg, tu.tree_unflatten_like(params, leaves),
                               batch)
        grads = torch.autograd.grad(tot, leaves)
    return ((tot.detach(), loss.detach(), aux.detach()),
            tu.tree_unflatten_like(params, list(grads)))


def grads_fn(cfg, params, batch):
    """value_and_grad, or with cfg.microbatch m (dividing the batch) the
    mean over m microbatches: gradients summed in cfg.grad_accum_dtype
    from zero in microbatch order, then scaled by 1/m."""
    m = cfg.microbatch
    B = batch["tokens"].shape[0]
    if not m or B % m:
        return value_and_grad(cfg, params, batch)
    acc_dt = _dt(cfg.grad_accum_dtype)
    acc_g = tu.tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                              device=p.device), params)
    acc_m = None
    for i in range(m):
        mb = {k: v.reshape(m, B // m, *v.shape[1:])[i]
              for k, v in batch.items()}
        vals, g = value_and_grad(cfg, params, mb)
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
    adamw_update with the train config's settings."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_update
    tc = train_cfg or TrainConfig()
    sched = schedule or (lambda step: tc.lr)

    def train_step(params, opt_state, batch):
        (tot, loss, aux), grads = grads_fn(cfg, params, batch)
        lr = sched(opt_state["count"])
        params, opt_state, stats = adamw_update(
            grads, opt_state, params, lr=lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
            weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
        return params, opt_state, {"loss": loss, "aux_loss": aux, "lr": lr,
                                   **stats}

    return train_step


def init_cache(cfg, batch, seq_len, device=None):
    """Zero KV cache {"k", "v"} of (L, batch, W, Hkv, hd) in cfg.dtype; SWA
    configurations keep a ring of W = min(seq_len, window) slots."""
    W = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {n: torch.zeros(shape, dtype=_dt(cfg.dtype), device=dev)
            for n in ("k", "v")}


def make_prefill_step(cfg):
    """fn(params, tokens (B, S)) -> (last-position logits (B, V) float32,
    cache {"k", "v"} of (L, B, S', Hkv, hd), S' the window for SWA)."""

    @torch.no_grad()
    def prefill(params, tokens):
        hidden, (k, v), _ = forward(cfg, params, tokens, return_kv=True)
        last = hidden[:, -1]
        logits = last @ params["lm_head"].to(last.dtype)
        return logits.float(), {"k": k, "v": v}
    return prefill


def make_decode_step(cfg):
    """fn(params, cache, tokens (B, 1), pos) -> (logits (B, V) float32,
    new cache). `pos` is the write position (the cache holds `pos` valid
    entries): slot pos % W under SWA, else min(pos, W - 1). The MoE runs
    on the batch's B tokens (capacity(B, E, K) slots an expert)."""

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        pos = int(pos)
        B = tokens.shape[0]
        cd = _dt(cfg.dtype)
        hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        x = params["embed"][tokens.long()].to(cd)              # (B, 1, d)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        W = cache["k"].shape[2]
        slot = pos % W if cfg.sliding_window else min(pos, W - 1)
        onehot = (torch.arange(W, device=x.device) == slot)[None, :, None,
                                                           None]
        cache_len = min(pos + 1, W)
        nk, nv = [], []
        for lp, kc, vc in zip(_layer_slices(params, cd), cache["k"],
                              cache["v"]):
            h = rmsnorm(x, lp["ln1"])
            q, k, v = _qkv(cfg, h, lp)
            q = apply_rope(q.reshape(B, 1, Hq, hd), positions,
                           cfg.rope_theta)
            k = apply_rope(k.reshape(B, 1, Hkv, hd), positions,
                           cfg.rope_theta)
            v = v.reshape(B, 1, Hkv, hd)
            kc = torch.where(onehot, k.to(kc.dtype), kc)
            vc = torch.where(onehot, v.to(vc.dtype), vc)
            out = decode_attention(q, kc, vc, cache_len)
            x = x + out.reshape(B, 1, Hq * hd) @ lp["wo"].to(cd)
            x = x + _ffn(cfg, rmsnorm(x, lp["ln2"]), lp)[0]
            nk.append(kc)
            nv.append(vc)
        x = rmsnorm(x, params["final_norm"])
        logits = x @ params["lm_head"].to(cd)
        return logits[:, 0].float(), {"k": torch.stack(nk),
                                      "v": torch.stack(nv)}

    return decode
