"""AdamW / SGD over trees of tensors (nested dicts), functional: an
update returns new params and a new state and leaves its inputs alone.

The arithmetic is the JAX package's `repro.optim.adam`, operation for
operation in float32: the bias corrections c = 1 - b ** float32(count),
step = (mu / c1) / (sqrt(nu / c2) + eps), and b2 = 0.95 by default.
`torch.optim.AdamW` is another function (b2 0.999, eps placed
elsewhere), so it is not used.
"""

import torch

from repro_torch.common import tree as tu


def adamw_init(params, dtype=None):
    """{"mu", "nu"} zeros shaped like `params`, "count" int32 of shape ()
    on the params' device."""
    leaves = tu.tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {
        "mu": tu.tree_zeros_like(params, dtype),
        "nu": tu.tree_zeros_like(params, dtype),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _clip(grads, grad_clip, gnorm=None):
    if gnorm is None:
        gnorm = tu.global_norm(grads)
    if grad_clip:
        scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
        grads = tu.tree_scale(grads, scale)
    return grads, gnorm


def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0, grad_clip=0.0, global_norm=None):
    """Returns (new_params, new_state, {"grad_norm"}). `lr` may be a
    float or a float32 tensor of shape (). `global_norm`, when given, is
    the gradient's norm to clip by (a sharded step passes the norm of the
    whole gradient, of which `grads` holds this rank's slices)."""
    grads, gnorm = _clip(grads, grad_clip, global_norm)
    count = state["count"] + 1
    cf = count.float()
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf

    def upd(g, mu, nu, p):
        g32 = g.float()
        mu32 = mu.float() * b1 + (1 - b1) * g32
        nu32 = nu.float() * b2 + (1 - b2) * g32 * g32
        step = (mu32 / c1) / (torch.sqrt(nu32 / c2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        newp = p.float() - lr * step
        return newp.to(p.dtype), mu32.to(mu.dtype), nu32.to(nu.dtype)

    flat_p = tu.tree_leaves(params)
    out = [upd(g, mu, nu, p) for g, mu, nu, p in zip(
        tu.tree_leaves(grads), tu.tree_leaves(state["mu"]),
        tu.tree_leaves(state["nu"]), flat_p)]
    new_p = tu.tree_unflatten_like(params, [o[0] for o in out])
    new_mu = tu.tree_unflatten_like(params, [o[1] for o in out])
    new_nu = tu.tree_unflatten_like(params, [o[2] for o in out])
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}, \
        {"grad_norm": gnorm}


def sgd_init(params, **_):
    leaves = tu.tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"count": torch.zeros((), dtype=torch.int32, device=dev)}


def sgd_update(grads, state, params, *, lr, grad_clip=0.0, **_):
    grads, gnorm = _clip(grads, grad_clip)
    new_p = tu.tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                        params, grads)
    return new_p, {"count": state["count"] + 1}, {"grad_norm": gnorm}
