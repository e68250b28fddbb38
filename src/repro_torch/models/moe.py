"""Mixture-of-experts FFN with sort-based capacity dispatch (GShard-style
token dropping): the JAX package's `repro.models.moe`. `moe_ffn` is the
path it takes when no mesh is set; `moe_ffn_ep_shardmap` (experts split
over the model axis) and `moe_ffn_tp_shardmap` (every expert's d_ff
split over it) are its sharded dispatches over a `launch.mesh.Mesh`:
each rank routes its own tokens with its own capacity, and one
all-reduce of (T_local, d) over the model axis combines the ranks.
`moe_ffn_sort_mesh` is the reference's default ("sort") on a mesh: the
global `moe_ffn` over all ranks' tokens, with one global capacity, in
either layout.

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
from repro_torch.models import collectives as coll

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


def expert_counts(flat_e, n_experts):
    """(n_experts,) pairs per expert of the flat ids: a scatter, not
    bincount, which reads the ids' max back to the host."""
    return torch.zeros(n_experts, dtype=flat_e.dtype,
                       device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def dispatch_plan(eidx, n_experts, cap, offset=None, slots=None):
    """The sort-based dispatch of the (token, k) pairs: a stable argsort of
    the flat expert ids, each pair's rank within its expert, and its slot
    dest = e * cap + rank, or the overflow slot E * cap past capacity (the
    earliest pairs in (token, k) order are kept). Returns (sort_idx,
    dest, valid, token_id), each (T * K,) in sorted order.

    offset (n_experts,): the pairs of each expert that come before these
    (other ranks' tokens in the global order). A pair is kept iff its
    rank plus its expert's offset is below cap; its slot is e * slots +
    rank (overflow E * slots), where `slots` (default cap) may be any
    bound on the kept ranks: at most min(cap, T) of an expert are kept
    here, as a token picks an expert once."""
    T, K = eidx.shape
    slots = cap if slots is None else slots
    flat_e = eidx.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = expert_counts(flat_e, n_experts)
    starts = torch.cumsum(counts, 0) - counts                    # exclusive
    ranks = torch.arange(T * K, device=eidx.device) - starts[sorted_e]
    valid = ranks < cap if offset is None \
        else ranks + offset[sorted_e] < cap
    dest = torch.where(valid, sorted_e * slots + ranks, n_experts * slots)
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
    _check_top_k(top_k)
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


# ---------------------------------------------------------------------------
# the sharded dispatches: tokens never move. Activations are replicated
# over the model axis, so every (data, model) rank dispatches ITS tokens
# to ITS experts (EP) or to its d_ff slice of every expert (TP) locally,
# and one all-reduce of (T_local, d) over the model axis combines them.
# ---------------------------------------------------------------------------

def moe_ffn_ep_shardmap(x, router_w, w_gate, w_up, w_down, *, top_k,
                        mesh, batch_axes=("data",), model_axis="model"):
    """x: this rank's (T_local, d) tokens; router_w (d, E) whole; this
    rank's experts' weights (E / n_model, d, f) and (E / n_model, f, d).
    The reference's function up to per-shard capacity dropping."""
    return _moe_shardmap(x, router_w, w_gate, w_up, w_down, top_k=top_k,
                         mesh=mesh, batch_axes=batch_axes,
                         model_axis=model_axis, mode="ep")


def moe_ffn_tp_shardmap(x, router_w, w_gate, w_up, w_down, *, top_k,
                        mesh, batch_axes=("data",), model_axis="model"):
    """Few experts (mixtral's 8): every rank holds all experts with the
    d_ff axis split, (E, d, f / n_model) and (E, f / n_model, d); the
    down-projection's partial sums ride the one all-reduce EP uses."""
    return _moe_shardmap(x, router_w, w_gate, w_up, w_down, top_k=top_k,
                         mesh=mesh, batch_axes=batch_axes,
                         model_axis=model_axis, mode="tp")


def moe_ffn_sort_mesh(x, router_w, w_gate, w_up, w_down, *, top_k,
                      mesh, batch_axes=("data",), model_axis="model",
                      n_tokens=None):
    """The reference's default dispatch ("sort") on a mesh: `moe_ffn` of
    the global token set, whose rows are the batch ranks' tokens in mesh
    order (pod-major over ("pod", "data")), with one capacity C =
    capacity(n_tokens, E, K). n_tokens is the global token count (default
    T_local x n_batch_ranks; the ranks may hold unequal parts of it, or
    none). Tokens never move: a pair is kept iff its rank within its
    expert, counting the pairs of that expert on earlier batch ranks (one
    all-gather of each rank's (E,) counts), is below C. A rank keeps at
    most min(C, T_local) pairs of an expert, so its experts run on that
    many slots each. The params' layout picks the experts' split: (E /
    n_model, d, f) weights are EP, (E, d, f / n_model) TP; one all-reduce
    over the model axes combines, as in the shard_map paths.

    x: this rank's (T_local, d) tokens (the same on every model rank).
    Returns (out (T_local, d), the aux loss E * sum(mean(p) * mean(f))
    over the global batch, each token weighing alike, the global dropped
    (token, k) pairs as a 0-dim int64 tensor, the same on every rank)."""
    _check_top_k(top_k)
    E = router_w.shape[-1]
    mode = "tp" if w_gate.shape[0] == E else "ep"
    E_loc = _check_layout(mode, E, mesh.axis_size(model_axis), w_gate)
    T_l, d = x.shape
    T = T_l * mesh.axis_size(batch_axes) if n_tokens is None else n_tokens
    C = capacity(T, E, top_k)

    probs, gate, eidx = route(x, router_w, top_k)
    load = F.one_hot(eidx, E).float().sum(1)
    # the global batch's sums, one collective for both
    sums = coll.all_reduce(torch.cat([probs.sum(0), load.sum(0)]), mesh,
                           batch_axes) / T
    aux = E * torch.sum(sums[:E] * sums[E:])

    counts = expert_counts(eidx.reshape(-1), E)
    every = coll.gather_parts(counts[None], mesh, batch_axes)   # (nb, E)
    offset = every[:mesh.axis_index(batch_axes)].sum(0)
    dropped = (every.sum(0) - C).clamp(min=0).sum()
    slots = min(C, T_l)
    plan = _local_plan(eidx, mode, E, E_loc, C, mesh, model_axis, offset,
                       slots)
    out = _experts_combine(x, gate, plan, w_gate, w_up, w_down, E_loc,
                           slots, mesh, model_axis)
    return out, aux, dropped


def _check_top_k(top_k):
    # the combine adds each token's K terms onto 0 by index_add_; two adds
    # commute bitwise, more would add in another order than the
    # reference's scatter. Every configuration here is top-2.
    if top_k > 2:
        raise ValueError(f"top_k={top_k}: the combine is exact for top_k "
                         f"<= 2 only")


def _check_layout(mode, E, nm, w_gate):
    """This rank's expert count, E / nm (ep) or E (tp), checked against
    its weights."""
    if mode == "ep":
        assert E % nm == 0, (E, nm)
    E_loc = w_gate.shape[0]
    if E_loc != (E // nm if mode == "ep" else E):
        raise ValueError(f"{mode}: {E_loc} experts on a rank of {nm}, "
                         f"{E} in all")
    return E_loc


def _local_plan(eidx, mode, E, E_loc, C, mesh, model_axis, offset=None,
                slots=None):
    """dispatch_plan of this rank's pairs over its E_loc experts (offset:
    each of the E experts' pairs on earlier ranks, or None; slots: an
    expert's slots here, default C)."""
    slots = C if slots is None else slots
    if mode != "ep":
        return dispatch_plan(eidx, E, C, offset, slots)
    # keep the (token, k) pairs this model rank's experts own; the others
    # sort into bucket E_loc, past every kept slot
    lo = mesh.axis_index(model_axis) * E_loc
    local_e = eidx - lo
    mine = (local_e >= 0) & (local_e < E_loc)
    flat_e = torch.where(mine, local_e, E_loc)
    if offset is not None:
        offset = torch.cat([offset[lo:lo + E_loc], offset.new_zeros(1)])
    sort_idx, dest, valid, token_id = dispatch_plan(flat_e, E_loc + 1, C,
                                                    offset, slots)
    valid = valid & (flat_e.reshape(-1)[sort_idx] < E_loc)
    dest = torch.where(valid, dest, E_loc * slots)
    return sort_idx, dest, valid, token_id


def _experts_combine(x, gate, plan, w_gate, w_up, w_down, E_loc, slots,
                     mesh, model_axis):
    """The kept pairs through this rank's experts (or d_ff slices) in
    `slots` slots an expert, gated back onto their tokens, summed over
    the model axes. The tokens and gates enter the expert region by
    copy_to, whose backward sums the ranks' parts."""
    sort_idx, dest, valid, token_id = plan
    T_l, d = x.shape
    dt = x.dtype
    x_in = coll.copy_to(x, mesh, model_axis)
    gate_in = coll.copy_to(gate, mesh, model_axis)
    gathered = torch.where(valid[:, None], x_in[token_id], 0)
    buf = torch.zeros((E_loc * slots + 1, d), dtype=dt, device=x.device) \
        .index_add(0, dest, gathered)
    ein = buf[:-1].reshape(E_loc, slots, d)
    h = torch.bmm(ein, w_gate.to(dt))
    u = torch.bmm(ein, w_up.to(dt))
    h = F.silu(h.float()).to(dt) * u
    eo = torch.bmm(h, w_down.to(dt))

    rows = torch.cat([eo.reshape(E_loc * slots, d),
                      torch.zeros((1, d), dtype=dt, device=x.device)])
    back = rows[dest] * gate_in.reshape(-1)[sort_idx][:, None].to(dt)
    out = torch.zeros((T_l, d), dtype=dt, device=x.device) \
        .index_add(0, token_id, back)
    # ep: the expert ranks' outputs; tp: the d_ff partial sums
    return coll.all_reduce(out, mesh, model_axis)


def _moe_shardmap(x, router_w, w_gate, w_up, w_down, *, top_k, mesh,
                  batch_axes, model_axis, mode):
    """Returns (this rank's out (T_local, d), the aux loss averaged over
    the last batch axis). The routing runs on every model rank alike, so
    the router's gradient is whole there."""
    _check_top_k(top_k)
    E = router_w.shape[-1]
    E_loc = _check_layout(mode, E, mesh.axis_size(model_axis), w_gate)
    C = capacity(x.shape[0], E, top_k)

    probs, gate, eidx = route(x, router_w, top_k)
    me = probs.mean(0)
    ce = F.one_hot(eidx, E).float().sum(1).mean(0)
    aux = E * torch.sum(me * ce)
    if batch_axes:
        aux = coll.pmean(aux, mesh, batch_axes[-1])

    plan = _local_plan(eidx, mode, E, E_loc, C, mesh, model_axis)
    return _experts_combine(x, gate, plan, w_gate, w_up, w_down, E_loc, C,
                            mesh, model_axis), aux
