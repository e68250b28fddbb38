"""NequIP — E(3)-equivariant interatomic potential [arXiv:2101.03164]: the
JAX package's `repro.models.nequip`, the single-device forward (the
owner-sharded one is `models.nequip_sharded`).

Irreps are kept in *Cartesian* form — l=0 scalars (N, C), l=1 vectors
(N, C, 3), l=2 traceless-symmetric matrices stored in an orthonormal
5-component basis (N, C, 5) and reconstructed to 3x3 on edges. Every
tensor-product path (l1 x l2 -> l3, all 15 with l<=2) is a manifestly
SO(3)-covariant bilinear map (dot / cross / matrix action / epsilon
contraction / symmetric-traceless projection), equal to the
Clebsch-Gordan formulation up to a per-path scale that the learned
radial weights absorb.

Message passing gathers sender features onto the edge list and sums the
messages at the receivers with `segment_sum`, which drops ids outside
[0, num_segments) as `jax.ops.segment_sum` does. A species outside
[0, n_species) embeds as a zero row, as `jax.nn.one_hot` gives it.

On a mesh (`models.sharding.rules_ctx(rules, mesh)`) `forward`,
`value_and_grad` and `make_train_step` are the reference's
`msg_impl="pjit"` step, the global function over edge shards: the
batch's edge arrays are this rank's "edges" slice, its node arrays this
rank's "nodes" slice (whole where the rules leave "nodes" whole), and
every tensor inside the step is whole:

  * node arrays split over "nodes" are gathered whole
    (`collectives.gather_replicated`);
  * each rank computes the geometry and messages of its own edges and
    `segment_sum`s them into a whole (N, C, 9) partial (h0, h1 and h2's
    5 components side by side), which `collectives.all_reduce` sums over
    the edge axes; the node-wise work (self-interaction, skip, gates,
    readout) then runs alike on every rank;
  * what enters the edge work replicated (the positions, the packed node
    features before the gather at `src`, the radial weights) goes
    through `collectives.copy_to`, whose backward sums the ranks'
    cotangents: every gradient is then whole and alike on every rank,
    and AdamW steps the replicated params alike.

A mesh of more than one rank needs an initialized process group. The
params are replicated ("layers" sharded raises NotImplementedError).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import tree as tu
from repro_torch.models import collectives as coll
from repro_torch.models import sharding as sh
from repro_torch.models.sharding import logical
from repro_torch.models.transformer import (Leaf, abstract_from_template,
                                            init_from_template,
                                            shardings_from_template)

# ---------------------------------------------------------------------------
# l=2 basis: 5 orthonormal traceless-symmetric 3x3 matrices (Frobenius o.n.)
# ---------------------------------------------------------------------------


def _l2_basis():
    B = np.zeros((5, 3, 3))
    s = 1 / np.sqrt(2)
    B[0, 0, 1] = B[0, 1, 0] = s                      # xy
    B[1, 1, 2] = B[1, 2, 1] = s                      # yz
    B[2, 0, 2] = B[2, 2, 0] = s                      # xz
    B[3, 0, 0], B[3, 1, 1] = s, -s                   # xx - yy
    B[4, 0, 0] = B[4, 1, 1] = -1 / np.sqrt(6)        # 2zz - xx - yy
    B[4, 2, 2] = 2 / np.sqrt(6)
    return B


L2_BASIS = torch.from_numpy(_l2_basis().astype(np.float32))   # (5, 3, 3)

EPS3 = torch.from_numpy(np.array(
    [[[int((i - j) * (j - k) * (k - i) / 2) for k in range(3)]
      for j in range(3)] for i in range(3)], dtype=np.float32))

# path list: (l1, l2, l3) for feature l1 x filter(SH) l2 -> message l3
PATHS = [(0, 0, 0), (0, 1, 1), (0, 2, 2),
         (1, 0, 1), (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 2, 1), (1, 2, 2),
         (2, 0, 2), (2, 1, 1), (2, 1, 2), (2, 2, 0), (2, 2, 1), (2, 2, 2)]
N_PATHS = len(PATHS)
RADIAL_HIDDEN = 64


def _const(t, like):
    return t.to(device=like.device, dtype=like.dtype)


def to5(M):
    """(..., 3, 3) symmetric-traceless -> (..., 5)."""
    return torch.einsum("...ij,kij->...k", M, _const(L2_BASIS, M))


def from5(f):
    """(..., 5) -> (..., 3, 3)."""
    return torch.einsum("...k,kij->...ij", f, _const(L2_BASIS, f))


def symtr(A):
    """Symmetric traceless projection of (..., 3, 3)."""
    S = 0.5 * (A + A.transpose(-1, -2))
    tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return S - tr * torch.eye(3, dtype=A.dtype, device=A.device) / 3.0


def tensor_product(h0, h1, h2m, y0, y1, y2m, w):
    """Per-edge weighted tensor products.

    h0: (E, C); h1: (E, C, 3); h2m: (E, C, 3, 3) — sender features (gathered)
    y0: (E,);  y1: (E, 3);   y2m: (E, 3, 3)     — edge spherical harmonics
    w:  (E, n_paths, C)                          — radial weights
    Returns messages (m0 (E,C), m1 (E,C,3), m2 (E,C,3,3)), each the sum
    over its paths in PATHS order.
    """
    out = {0: 0., 1: 0., 2: 0.}
    eps3 = _const(EPS3, h0)
    for p, (l1, l2, l3) in enumerate(PATHS):
        wp = w[:, p, :]                                    # (E, C)
        if (l1, l2) == (0, 0):
            r = h0 * y0[:, None]
        elif (l1, l2) == (0, 1):
            r = h0[..., None] * y1[:, None, :]
        elif (l1, l2) == (0, 2):
            r = h0[..., None, None] * y2m[:, None]
        elif (l1, l2) == (1, 0):
            r = h1 * y0[:, None, None]
        elif (l1, l2) == (1, 1):
            if l3 == 0:
                r = torch.einsum("eci,ei->ec", h1, y1)
            elif l3 == 1:
                r = torch.linalg.cross(h1, y1[:, None, :].expand_as(h1))
            else:
                r = symtr(torch.einsum("eci,ej->ecij", h1, y1))
        elif (l1, l2) == (1, 2):
            if l3 == 1:
                r = torch.einsum("eij,ecj->eci", y2m, h1)
            else:  # epsilon contraction: bilinear 1x2 -> 2
                r = symtr(torch.einsum("ikl,eck,elj->ecij", eps3, h1, y2m))
        elif (l1, l2) == (2, 0):
            r = h2m * y0[:, None, None, None]
        elif (l1, l2) == (2, 1):
            if l3 == 1:
                r = torch.einsum("ecij,ej->eci", h2m, y1)
            else:
                r = symtr(torch.einsum("ikl,ek,eclj->ecij", eps3, y1, h2m))
        else:  # (2, 2)
            mn = torch.einsum("ecik,ekj->ecij", h2m, y2m)
            if l3 == 0:
                r = torch.einsum("ecij,eij->ec", h2m, y2m)
            elif l3 == 1:
                r = torch.einsum("ijk,ecjk->eci", eps3, mn)
            else:
                r = symtr(mn)
        if l3 == 0:
            out[0] = out[0] + wp * r
        elif l3 == 1:
            out[1] = out[1] + wp[..., None] * r
        else:
            out[2] = out[2] + wp[..., None, None] * r
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# radial basis + cutoff
# ---------------------------------------------------------------------------

def bessel_rbf(r, n_rbf, cutoff):
    """sqrt(2/rc) sin(n pi r / rc) / r, n = 1..n_rbf, with p=6 envelope."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rb = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * r[..., None] / cutoff) / r[..., None]
    x = torch.clamp(r / cutoff, 0, 1)
    p = 6.0
    env = (1 - (p + 1) * (p + 2) / 2 * x ** p + p * (p + 2) * x ** (p + 1)
           - p * (p + 1) / 2 * x ** (p + 2))
    return rb * env[..., None]


def segment_sum(data, ids, num_segments):
    """(num_segments, ...) sums of data's rows by segment id; ids outside
    [0, num_segments) are dropped, as jax.ops.segment_sum drops them.
    On the card the adds land in any order."""
    ids = ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, torch.where(keep, ids, num_segments),
                         data)[:num_segments]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def param_template(cfg, d_feat=0):
    C, L = cfg.d_hidden, cfg.n_layers
    pdt = cfg.param_dtype
    f_in = d_feat if d_feat else cfg.n_species
    lay3 = ("layers", None, None)
    return {
        "embed": Leaf((f_in, C), pdt, (None, None)),
        "layers": {
            "radial_w1": Leaf((L, cfg.n_rbf, RADIAL_HIDDEN), pdt, lay3),
            "radial_b1": Leaf((L, RADIAL_HIDDEN), pdt, ("layers", None),
                              "zeros"),
            "radial_w2": Leaf((L, RADIAL_HIDDEN, N_PATHS * C), pdt, lay3),
            "self0": Leaf((L, C, C), pdt, lay3),
            "self1": Leaf((L, C, C), pdt, lay3),
            "self2": Leaf((L, C, C), pdt, lay3),
            "skip0": Leaf((L, C, C), pdt, lay3),
            "skip1": Leaf((L, C, C), pdt, lay3),
            "skip2": Leaf((L, C, C), pdt, lay3),
            "gate_w": Leaf((L, C, 2 * C), pdt, lay3),
            "gate_b": Leaf((L, 2 * C), pdt, ("layers", None), "zeros"),
        },
        "readout_w": Leaf((C, 16), pdt, (None, None)),
        "readout_w2": Leaf((16, 1), pdt, (None, None)),
    }


def abstract_params(cfg, d_feat=0):
    return abstract_from_template(param_template(cfg, d_feat))


def param_shardings(cfg, mesh, d_feat=0):
    return shardings_from_template(param_template(cfg, d_feat), mesh)


def init_params(cfg, generator=None, d_feat=0, *, device=None):
    """Random parameters by the JAX package's rules (normal * fan_in **
    -0.5, zeros for biases) on `device` (None: the card); d_feat > 0
    embeds raw node features of that width in place of the species
    one-hot."""
    return init_from_template(param_template(cfg, d_feat), generator,
                              device=device)


# the batch's node arrays: this rank's "nodes" slice on a mesh
NODE_KEYS = ("positions", "node_feat", "species", "graph_id", "node_mask")


def batch_shardings(mesh, batch):
    """The placement of each array of `batch` under the installed rules,
    as the reference's dry-run cell places it: node arrays split along
    "nodes", edge arrays along "edges", the per-graph ones replicated."""
    out = {}
    for k, v in batch.items():
        if k in NODE_KEYS:
            out[k] = sh.named_sharding(mesh, "nodes",
                                       *(None,) * (v.ndim - 1))
        elif k.startswith("edge_"):
            out[k] = sh.named_sharding(mesh, "edges")
        else:
            out[k] = sh.NamedSharding(mesh, ())
    return out


class _Plan:
    """The installed mesh (None without one) and the axes its rules split
    the edges and the nodes over; without a mesh every method is the
    identity."""

    def __init__(self):
        self.mesh = sh.current_mesh()
        self.edges = self.nodes = ()
        if self.mesh is not None:
            if sh.spec("layers")[0] is not None:
                raise NotImplementedError(
                    "rules shard 'layers': the sharded NequIP step keeps "
                    "its params whole")
            self.edges = sh.spec_axes(sh.spec("edges")[0])
            self.nodes = sh.spec_axes(sh.spec("nodes")[0])

    def edge_parts(self):
        return 1 if self.mesh is None else self.mesh.axis_size(self.edges)

    def whole(self, x):
        """A node array gathered whole over the "nodes" axes."""
        return coll.gather_replicated(x, self.mesh, self.nodes, 0)

    def enter(self, x):
        """Into the edge work: identity, the backward sums over edges."""
        return coll.copy_to(x, self.mesh, self.edges)

    def exit(self, x):
        """Out of it: the edge shards' partial sums added."""
        return coll.all_reduce(x, self.mesh, self.edges)


def forward(cfg, params, batch):
    """batch: positions (N,3), node_feat (N,F)|species (N,), edge_src/dst (E,),
    edge_mask (E,), graph_id (N,), energy_target (G,) (its length is the
    number of graphs), optional node_mask (N,). Returns per-graph energy
    (G,). On a mesh: the edge arrays this rank's "edges" slice, the node
    arrays its "nodes" slice; the energies whole on every rank."""
    plan = _Plan()
    batch = {k: plan.whole(v) if k in NODE_KEYS else v
             for k, v in batch.items()}
    pos = batch["positions"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch["edge_mask"].to(pos.dtype)
    N = pos.shape[0]

    cd = getattr(torch, cfg.dtype)
    if "node_feat" in batch:
        feat = batch["node_feat"]
    else:
        species = batch["species"].long()
        feat = (species[:, None] == torch.arange(
            cfg.n_species, device=pos.device)).to(pos.dtype)
    h0 = (feat @ params["embed"]).to(cd)                  # (N, C)
    C = h0.shape[-1]
    h1 = torch.zeros((N, C, 3), dtype=cd, device=pos.device)
    h2 = torch.zeros((N, C, 5), dtype=cd, device=pos.device)

    # --- edge geometry (shared across layers; computed in f32, stored cd) ---
    pe = plan.enter(pos)
    rel = pe[dst] - pe[src]                               # (E, 3)
    rel = logical(rel, "edges", None,
                  shape=(rel.shape[0] * plan.edge_parts(), 3))
    dist = torch.sqrt(torch.sum(rel * rel, -1) + 1e-12)
    rhat = rel / dist[:, None]
    y0 = torch.ones_like(dist, dtype=cd)
    y1 = rhat.to(cd)
    y2m = symtr(torch.einsum("ei,ej->eij", rhat, rhat)).to(cd)
    rbf = (bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)
           * emask[:, None]).to(cd)
    em = emask[:, None, None].to(cd)

    lay = {n: plan.enter(w) if n.startswith("radial") else w
           for n, w in params["layers"].items()}
    names = sorted(lay)
    for row in zip(*(torch.unbind(lay[n], 0) for n in names)):
        lp = {n: w.to(cd) for n, w in zip(names, row)}
        # radial weights per edge
        rw = F.silu(rbf @ lp["radial_w1"] + lp["radial_b1"])
        rw = (rw @ lp["radial_w2"]).reshape(-1, N_PATHS, C) * em
        # gather sender features (h0, h1, h2 packed (N, C, 9)) to edges
        e = plan.enter(torch.cat([h0[..., None], h1, h2], -1))[src]
        m0, m1, m2 = tensor_product(e[..., 0], e[..., 1:4],
                                    from5(e[..., 4:]), y0, y1, y2m, rw)
        # scatter to receivers, the edge shards' partials summed
        a = plan.exit(segment_sum(torch.cat([m0[..., None], m1, to5(m2)],
                                            -1), dst, N))
        a0, a1, a2 = a[..., 0], a[..., 1:4], a[..., 4:]
        # self-interaction + skip
        n0 = a0 @ lp["self0"] + h0 @ lp["skip0"]
        n1 = torch.einsum("nci,cd->ndi", a1, lp["self1"]) + torch.einsum(
            "nci,cd->ndi", h1, lp["skip1"])
        n2 = torch.einsum("nck,cd->ndk", a2, lp["self2"]) + torch.einsum(
            "nck,cd->ndk", h2, lp["skip2"])
        # gate nonlinearity (f32 sigmoid for stability, output back to cd)
        gates = torch.sigmoid(
            (n0 @ lp["gate_w"] + lp["gate_b"]).float()).to(cd)
        g1, g2 = gates[:, :C], gates[:, C:]
        h0 = F.silu(n0.float()).to(cd)
        h1 = n1 * g1[..., None]
        h2 = n2 * g2[..., None]

    h0 = h0.float()
    node_e = F.silu(h0 @ params["readout_w"]) @ params["readout_w2"]  # (N,1)
    if "node_mask" in batch:
        node_e = node_e * batch["node_mask"][:, None].to(node_e.dtype)
    return segment_sum(node_e[:, 0], batch["graph_id"],
                       batch["energy_target"].shape[0])


def loss_fn(cfg, params, batch):
    """Mean squared energy error, weighted by `energy_weight` where the
    batch has one (sum(err * w) / max(sum(w), 1))."""
    e = forward(cfg, params, batch)
    err = torch.square(e - batch["energy_target"])
    if "energy_weight" in batch:
        w = batch["energy_weight"]
        return torch.sum(err * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(err)


def value_and_grad(cfg, params, batch):
    """(loss, grads): the loss and its gradients (a tree of params'
    structure) by torch.autograd.grad; on a mesh both whole and alike on
    every rank."""
    leaves = [p.detach().requires_grad_() for p in tu.tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(cfg, tu.tree_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tu.tree_unflatten_like(params, list(grads))


def make_train_step(cfg, train_cfg=None):
    """fn(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}): the loss's gradients, then the port's adamw_update at
    the train config's lr and grad_clip (AdamW's other settings at their
    defaults, as the reference passes them). On a mesh: the batch's
    slices as `forward` takes them; the params, their gradients and the
    optimizer state whole and alike on every rank."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_update
    tc = train_cfg or TrainConfig()

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(cfg, params, batch)
        params, opt_state, stats = adamw_update(
            grads, opt_state, params, lr=tc.lr, grad_clip=tc.grad_clip)
        return params, opt_state, {"loss": loss, **stats}

    return train_step
