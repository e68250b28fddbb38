"""Mixture-of-experts FFN with sort-based capacity dispatch (GShard-style
token dropping): the JAX package's `repro.models.moe.moe_ffn`, the path
it takes when no mesh is set. The sharded dispatches
(`moe_ffn_ep_shardmap`, `moe_ffn_tp_shardmap`) wait for the mesh.

Active-FLOP faithful: expert compute is E x C x (3 d f) ~= tokens * top_k *
capacity_factor * ffn_flops — never the dense all-experts product.

The router's top-k is the port's one top-k (`topk_desc_index_asc`: the
topk kernel on the card, its plain version on the CPU), which keeps
`lax.top_k`'s rule: of two equal probabilities the lower expert index
wins. The gates are the selected probabilities gathered by those
indices, so their gradient reaches `probs` as JAX's top_k VJP sends it.
"""

import torch
import torch.nn.functional as F

from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.device import resolve_device

CAPACITY_FACTOR = 1.25


def capacity(n_tokens, n_experts, top_k, factor=CAPACITY_FACTOR):
    """Slots per expert: int(factor * T * K / E) rounded up to 8, at
    least 8."""
    c = int(factor * n_tokens * top_k / n_experts)
    return max(8, -(-c // 8) * 8)


def route(x, router_w, top_k):
    """(probs (T, E) float32, gates (T, K) renormalised, expert ids (T, K)
    int64): logits in x's dtype, softmax in float32, the top-k by (prob
    desc, expert asc)."""
    logits = x @ router_w.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    _, eidx = topk_desc_index_asc(probs.detach(), top_k)
    gate = probs.gather(-1, eidx)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    return probs, gate, eidx


def dispatch_plan(eidx, n_experts, cap):
    """The sort-based dispatch of the (token, k) pairs: a stable argsort of
    the flat expert ids, each pair's rank within its expert, and its slot
    dest = e * cap + rank, or the overflow slot E * cap past capacity (the
    earliest pairs in (token, k) order are kept). Returns (sort_idx,
    dest, valid, token_id), each (T * K,) in sorted order."""
    T, K = eidx.shape
    flat_e = eidx.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    # a scatter, not bincount, which reads the ids' max back to the host
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                    # exclusive
    ranks = torch.arange(T * K, device=eidx.device) - starts[sorted_e]
    valid = ranks < cap
    dest = torch.where(valid, sorted_e * cap + ranks, n_experts * cap)
    return sort_idx, dest, valid, sort_idx // K


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k, device=None):
    """x: (T, d); router_w (d, E); expert weights w_gate, w_up (E, d, f) and
    w_down (E, f, d). Returns (out (T, d) in x's dtype, the Switch aux
    loss E * sum_e mean_prob_e * mean_load_e).

    Tensors stay where they are; numpy inputs are placed on `device`
    (None: the card) first. Differentiable in x and every weight."""
    if not isinstance(x, torch.Tensor):
        dev = resolve_device(device)
        x, router_w, w_gate, w_up, w_down = (
            torch.as_tensor(a, device=dev)
            for a in (x, router_w, w_gate, w_up, w_down))
    if top_k > 2:
        # the combine adds each token's K terms onto 0 by index_add_; two
        # adds commute bitwise, more would add in another order than the
        # reference's scatter. Every configuration here is top-2.
        raise ValueError(f"top_k={top_k}: the combine is exact for top_k "
                         f"<= 2 only")
    T, d = x.shape
    E = router_w.shape[-1]
    C = capacity(T, E, top_k)
    dt = x.dtype

    probs, gate, eidx = route(x, router_w, top_k)
    me = probs.mean(0)                                            # (E,)
    ce = F.one_hot(eidx, E).float().sum(1).mean(0)
    aux = E * torch.sum(me * ce)

    sort_idx, dest, valid, token_id = dispatch_plan(eidx, E, C)
    gathered = torch.where(valid[:, None], x[token_id], 0)
    # each kept slot gets one addend; the overflow slot collects zeros
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device) \
        .index_add(0, dest, gathered)
    expert_in = buf[:-1].reshape(E, C, d)

    h = torch.bmm(expert_in, w_gate.to(dt))
    u = torch.bmm(expert_in, w_up.to(dt))
    h = F.silu(h.float()).to(dt) * u
    eo = torch.bmm(h, w_down.to(dt))                              # (E, C, d)

    rows = torch.cat([eo.reshape(E * C, d),
                      torch.zeros((1, d), dtype=dt, device=x.device)])
    back = rows[dest] * gate.reshape(-1)[sort_idx][:, None].to(dt)
    out = torch.zeros((T, d), dtype=dt, device=x.device) \
        .index_add(0, token_id, back)
    return out, aux
