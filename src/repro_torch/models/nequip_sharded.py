"""Owner-sharded NequIP message passing: the JAX package's
`repro.models.nequip_sharded` over a `launch.mesh.Mesh`.

With edges sorted by destination owner, each rank owns a contiguous node
range plus exactly the edges that point into it:

  - one all-gather of the node features (h0, h1, h2 packed into one
    (n_loc, C, 9) tensor) per layer; its backward is a reduce-scatter,
  - the senders' features are read from the gathered copy,
  - segment_sum lands in the rank's own (n_loc, ...) range: no reduce.

After the layers every rank gathers h0 and runs the readout alike.

Batch format (built by `shard_edges_by_owner`): node arrays (N, ...)
whole on every rank, edge arrays (n_shards, E_loc), row s for rank s
(its index over `axes`).
"""

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import tree as tu
from repro_torch.models import collectives as coll
from repro_torch.models import nequip as nq


def shard_edges_by_owner(src, dst, edge_mask, n_nodes, n_shards):
    """Host-side: partition edges by dst owner (contiguous node ranges),
    pad each shard to a common E_loc. Returns (src, dst, mask) with shape
    (n_shards, E_loc)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    mask = np.asarray(edge_mask) > 0
    n_loc = -(-n_nodes // n_shards)
    owner = np.where(mask, dst // n_loc, n_shards - 1)
    e_loc = 0
    for s in range(n_shards):
        e_loc = max(e_loc, int(((owner == s) & mask).sum()))
    e_loc = max(8, -(-e_loc // 8) * 8)
    out_s = np.zeros((n_shards, e_loc), np.int32)
    out_d = np.zeros((n_shards, e_loc), np.int32)
    out_m = np.zeros((n_shards, e_loc), np.float32)
    for s in range(n_shards):
        sel = (owner == s) & mask
        n = int(sel.sum())
        out_s[s, :n] = src[sel]
        out_d[s, :n] = dst[sel]
        out_m[s, :n] = 1.0
    return out_s, out_d, out_m


def forward_sharded(cfg, params, batch, mesh, axes=("data", "model")):
    """Owner-sharded forward on this rank (every rank of `axes` calls it):
    per-graph energies (G,), the same on every rank."""
    n_shards = mesh.axis_size(axes)
    si = mesh.axis_index(axes)
    pos = batch["positions"]
    N = pos.shape[0]
    n_loc = -(-N // n_shards)
    N_pad = n_loc * n_shards
    cd = getattr(torch, cfg.dtype)
    lo, hi = min(N, si * n_loc), min(N, (si + 1) * n_loc)

    if "node_feat" in batch:
        feat = batch["node_feat"][lo:hi]
    else:
        species = batch["species"][lo:hi].long()
        feat = (species[:, None] == torch.arange(
            cfg.n_species, device=pos.device)).to(pos.dtype)
    h0 = (feat @ params["embed"]).to(cd)                    # (hi - lo, C)
    C = h0.shape[-1]
    h0 = F.pad(h0, (0, 0, 0, n_loc - (hi - lo)))
    pos_p = F.pad(pos, (0, 0, 0, N_pad - N))

    src = batch["edge_src_sharded"][si].long()
    edst = batch["edge_dst_sharded"][si].long()
    dst_local = (edst - si * n_loc).clamp(0, n_loc - 1)
    emask = batch["edge_mask_sharded"][si].to(pos.dtype)
    em = emask.to(cd)

    rel = (pos_p[edst] - pos_p[src]).float()
    dist = torch.sqrt(torch.sum(rel * rel, -1) + 1e-12)
    rhat = rel / dist[:, None]
    y0 = torch.ones_like(dist, dtype=cd)
    y1 = rhat.to(cd)
    y2m = nq.symtr(torch.einsum("ei,ej->eij", rhat, rhat)).to(cd)
    rbf = (nq.bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)
           * emask.float()[:, None]).to(cd)

    h1 = torch.zeros((n_loc, C, 3), dtype=cd, device=pos.device)
    h2 = torch.zeros((n_loc, C, 5), dtype=cd, device=pos.device)
    lay = params["layers"]
    names = sorted(lay)
    for row in zip(*(torch.unbind(lay[n], 0) for n in names)):
        lp = {n: w.to(cd) for n, w in zip(names, row)}
        # ONE all-gather per layer (backward: a reduce-scatter)
        g = coll.all_gather(torch.cat([h0[..., None], h1, h2], -1), mesh,
                            axes, 0)                        # (N_pad, C, 9)
        rw = F.silu(rbf @ lp["radial_w1"] + lp["radial_b1"])
        rw = (rw @ lp["radial_w2"]).reshape(-1, nq.N_PATHS, C) \
            * em[:, None, None]
        gs = g[src]
        m0, m1, m2 = nq.tensor_product(gs[..., 0], gs[..., 1:4],
                                       nq.from5(gs[..., 4:9]), y0, y1, y2m,
                                       rw)
        # dst is LOCAL: segment_sum lands in (n_loc, ...), no reduce
        a0 = nq.segment_sum(m0, dst_local, n_loc)
        a1 = nq.segment_sum(m1, dst_local, n_loc)
        a2 = nq.segment_sum(nq.to5(m2), dst_local, n_loc)
        n0 = a0 @ lp["self0"] + h0 @ lp["skip0"]
        n1 = torch.einsum("nci,cd->ndi", a1, lp["self1"]) + torch.einsum(
            "nci,cd->ndi", h1, lp["skip1"])
        n2 = torch.einsum("nck,cd->ndk", a2, lp["self2"]) + torch.einsum(
            "nck,cd->ndk", h2, lp["skip2"])
        gates = torch.sigmoid(
            (n0 @ lp["gate_w"] + lp["gate_b"]).float()).to(cd)
        g1, g2 = gates[:, :C], gates[:, C:]
        h0 = F.silu(n0.float()).to(cd)
        h1 = n1 * g1[..., None]
        h2 = n2 * g2[..., None]

    # the replicated readout over every node (backward: this rank's rows)
    h0 = coll.gather_replicated(h0, mesh, axes, 0)[:N].float()
    node_e = F.silu(h0 @ params["readout_w"]) @ params["readout_w2"]
    if "node_mask" in batch:
        node_e = node_e * batch["node_mask"][:, None].to(node_e.dtype)
    return nq.segment_sum(node_e[:, 0], batch["graph_id"],
                          batch["energy_target"].shape[0])


# computed alike on every rank from the gathered h0: whole gradients
_REPLICATED = ("readout_w", "readout_w2")


def loss_sharded(cfg, params, batch, mesh, axes=("data", "model")):
    """The mean squared energy error of forward_sharded (weighted by
    `energy_weight` where the batch has one), the same on every rank."""
    e = forward_sharded(cfg, params, batch, mesh, axes)
    err = torch.square(e - batch["energy_target"])
    if "energy_weight" in batch:
        w = batch["energy_weight"]
        return torch.sum(err * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(err)


def value_and_grad_sharded(cfg, params, batch, mesh, axes=("data",
                                                             "model")):
    """(loss, gradients of the whole batch) on this rank: the embedding's
    and the layers' gradients are partial sums over the ranks (each
    rank's nodes and edges) and are all-reduced over `axes`; the
    readout's are whole. Every rank returns the same."""
    paths = [p for p, _ in tu.leaf_paths(params)]
    leaves = [p.detach().requires_grad_() for p in tu.tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_sharded(cfg, tu.tree_unflatten_like(params, leaves),
                            batch, mesh, axes)
        grads = list(torch.autograd.grad(loss, leaves))
    part = [i for i, p in enumerate(paths)
            if not any(f"[{r!r}]" == p for r in _REPLICATED)]
    for i, g in zip(part, coll.all_reduce_many([grads[i] for i in part],
                                               mesh, axes)):
        grads[i] = g
    return loss.detach(), tu.tree_unflatten_like(params, grads)


def make_train_step_sharded(cfg, mesh, axes=("data", "model"),
                            train_cfg=None):
    """fn(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}) on this rank: params and optimizer state replicated,
    the edges owner-sharded; the gradients of value_and_grad_sharded,
    then the port's adamw_update at the train config's lr and
    grad_clip."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_update
    tc = train_cfg or TrainConfig()

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad_sharded(cfg, params, batch, mesh, axes)
        params, opt_state, stats = adamw_update(
            grads, opt_state, params, lr=tc.lr, grad_clip=tc.grad_clip)
        return params, opt_state, {"loss": loss, **stats}

    return train_step
