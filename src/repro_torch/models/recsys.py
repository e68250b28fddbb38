"""RecSys models in PyTorch: dlrm-mlperf, deepfm, wide-deep and din, a
port of repro.models.recsys with its parameter names and shapes.

A config's embedding tables are stored as one fused (sum of padded
rows, d) tensor, and its dim-1 wide tables as another, with an int32 row
offset per field (`FusedTable`, the layout of PyTorch's recsys stacks):
`params["tables"]["t3"]` is a view of field 3's rows, so the device holds
each table once. Every sum of per-field lookups in the JAX module (the
wide branch, the user and candidate towers, the CluSD guide) is one
`embedding_bag` over a fused table with idx = offsets[fields] + ids: the
embedding_bag kernel on the card. It adds the fields in ascending order
into a float32 accumulator that starts at 0.0, which is the JAX Python
`sum` of lookups bit for bit.

`make_retrieval_step` scores users against candidates two-tower style;
repro_torch.core.retrieval runs CluSD's cluster selection over the same
towers. `make_train_step` is the JAX module's functional AdamW step over
`train_tree(params)`, the params with each FusedTable as its one fused
weight leaf (Adam is elementwise, so this is the JAX update of every
per-field table; only the global norm sums its squares in another
order). Gradients reach the tables through the lookups' indexing and the
embedding_bag op's autograd Function (its backward an index_add_).
"""

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import ops as bag_ops


def dense_init(shape, generator=None, scale=None, dtype=torch.float32):
    """N(0, 1) * scale (default fan_in ** -0.5), the rule of the JAX
    package's models.layers.dense_init; drawn on the generator's device
    (the draws differ from jax.random's)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    dev = generator.device if generator is not None else None
    return (torch.randn(shape, generator=generator, device=dev)
            * scale).to(dtype)


@dataclasses.dataclass
class Leaf:
    """Parameter leaf spec: shape + dtype + logical sharding axes."""
    shape: Tuple[int, ...]
    dtype: Any
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | ones | zeros


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

def embedding_lookup(table, idx):
    """table: (rows, d); idx: integer (...,) -> (..., d)."""
    return table[idx.long()]


def embedding_bag(table, idx, weights=None, combine="sum"):
    """Fixed-hotness bag: idx (..., hot) -> (..., d). The unweighted "sum"
    bag is the embedding_bag kernel (its plain version on the CPU); the
    weighted, "mean" and "max" bags stay plain."""
    if combine == "sum" and weights is None:
        flat = idx.reshape(-1, idx.shape[-1]).to(torch.int32).contiguous()
        out = bag_ops.embedding_bag(table, flat)
        return out.reshape(*idx.shape[:-1], table.shape[1])
    emb = table[idx.long()]                                # (..., hot, d)
    if weights is not None:
        emb = emb * weights[..., None]
    if combine == "sum":
        return emb.sum(-2)
    if combine == "mean":
        return emb.mean(-2)
    if combine == "max":
        return emb.amax(-2)
    raise ValueError(combine)


def embedding_bag_ragged(table, flat_idx, segment_ids, n_bags, weights=None):
    """Ragged bag (EmbeddingBag semantics): gather, then a segment sum;
    segment ids outside [0, n_bags) are dropped, as segment_sum drops
    them. Plain: on the CPU index_add_ adds in index order, on CUDA its
    atomics add a bag's rows in no fixed order."""
    emb = table[flat_idx.long()]                           # (nnz, d)
    if weights is not None:
        emb = emb * weights[:, None]
    seg = segment_ids.long()
    seg = torch.where((seg >= 0) & (seg < n_bags), seg, n_bags)
    out = torch.zeros((n_bags + 1, table.shape[1]), dtype=emb.dtype,
                      device=emb.device)
    return out.index_add_(0, seg, emb)[:n_bags]


class FusedTable(nn.Module):
    """Per-field tables stored as one (sum of rows, d) tensor. `self["t3"]`
    is field 3's (rows_3, d) view and `offsets[3]` its first row (int32).
    `lookup` and `bag` take (B, n) ids of the fields lo .. lo + n - 1."""

    def __init__(self, weight, rows, *, requires_grad=False, offsets=None):
        super().__init__()
        self.rows = tuple(int(r) for r in rows)
        if sum(self.rows) != weight.shape[0]:
            raise ValueError(f"fields of {sum(self.rows)} rows in all, table "
                             f"of {weight.shape[0]}")
        if weight.shape[0] >= 2 ** 31:
            raise ValueError("a fused table takes int32 row indices")
        self.starts = tuple(int(s) for s in
                            np.cumsum((0,) + self.rows[:-1]))
        self.weight = nn.Parameter(weight, requires_grad=requires_grad)
        if offsets is None:
            offsets = torch.tensor(self.starts, dtype=torch.int32,
                                   device=weight.device)
        self.register_buffer("offsets", offsets)

    def with_weight(self, weight, requires_grad=False):
        """The same fields over another fused weight (its offsets shared)."""
        return FusedTable(weight, self.rows, requires_grad=requires_grad,
                          offsets=self.offsets)

    def __getitem__(self, name):
        i = int(name[1:])
        return self.weight[self.starts[i]:self.starts[i] + self.rows[i]]

    def moved(self, device):
        """This table on `device`: shared where it already is, else copied."""
        return FusedTable(self.weight.detach().to(device), self.rows)

    def _rows(self, ids, lo):
        n = ids.shape[-1]
        return ids.to(torch.int32) + self.offsets[lo:lo + n]

    def lookup(self, ids, lo=0):
        """(B, n) ids -> (B, n, d): one gather over the fused table."""
        return embedding_lookup(self.weight, self._rows(ids, lo))

    def bag(self, ids, lo=0):
        """(B, n) ids -> (B, d): the fields' rows summed in ascending field
        order, one embedding_bag over the fused table."""
        return embedding_bag(self.weight, self._rows(ids, lo))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _mlp_leaves(name, dims_in, dims, pdt, prefix):
    out = {}
    d = dims_in
    for i, h in enumerate(dims):
        out[f"{prefix}_w{i}"] = Leaf((d, h), pdt, (None, None))
        out[f"{prefix}_b{i}"] = Leaf((h,), pdt, (None,), init="zeros")
        d = h
    return out, d


def _padded_rows(rows, mult=512):
    """Tables are padded to a shardable row count (512 = lcm of every mesh
    factor used for 'table_rows'); indices never reach the pad rows."""
    return max(mult, ((rows + mult - 1) // mult) * mult)


def param_template(cfg):
    pdt = cfg.param_dtype
    t = {"tables": {f"t{i}": Leaf((_padded_rows(rows), cfg.embed_dim), pdt,
                                  ("table_rows", None))
                    for i, rows in enumerate(cfg.table_sizes)}}
    if cfg.kind in ("wide_deep", "deepfm"):
        # dim-1 tables for the wide / first-order-FM branch
        t["wide"] = {f"t{i}": Leaf((_padded_rows(rows), 1), pdt,
                                   ("table_rows", None))
                     for i, rows in enumerate(cfg.table_sizes)}
        t["wide_bias"] = Leaf((1,), pdt, (None,), init="zeros")

    if cfg.kind == "dlrm":
        bot, d = _mlp_leaves("bot", cfg.n_dense, cfg.bot_mlp, pdt, "bot")
        t.update(bot)
        n_f = cfg.n_sparse + 1
        n_int = n_f * (n_f - 1) // 2
        top_in = n_int + cfg.embed_dim
        top, _ = _mlp_leaves("top", top_in, cfg.top_mlp, pdt, "top")
        t.update(top)
    elif cfg.kind in ("deepfm", "wide_deep"):
        deep_in = cfg.n_sparse * cfg.embed_dim
        deep, d = _mlp_leaves("deep", deep_in, cfg.mlp, pdt, "deep")
        t.update(deep)
        t["deep_out_w"] = Leaf((d, 1), pdt, (None, None))
        t["deep_out_b"] = Leaf((1,), pdt, (None,), init="zeros")
    elif cfg.kind == "din":
        # behavior = concat(item, cate) embeddings
        be = 2 * cfg.embed_dim
        attn_in = 4 * be
        attn, d = _mlp_leaves("attn", attn_in, cfg.attn_mlp, pdt, "attn")
        t.update(attn)
        t["attn_out_w"] = Leaf((d, 1), pdt, (None, None))
        t["attn_out_b"] = Leaf((1,), pdt, (None,), init="zeros")
        # final mlp over [user_emb..., pooled, target]
        user_dim = (len(cfg.table_sizes) - 2) * cfg.embed_dim
        mlp_in = user_dim + 2 * be
        deep, d = _mlp_leaves("deep", mlp_in, cfg.mlp, pdt, "deep")
        t.update(deep)
        t["deep_out_w"] = Leaf((d, 1), pdt, (None, None))
        t["deep_out_b"] = Leaf((1,), pdt, (None,), init="zeros")
    else:
        raise ValueError(cfg.kind)
    return t


def _torch_dtype(name):
    return getattr(torch, str(name))


def init_params(cfg, generator=None, *, device=None):
    """Random parameters by the JAX package's rules (normal * fan_in **
    -0.5, zeros for biases), drawn from `generator` on its own device
    (a CUDA generator fills the 2.86 GB wide-deep tables on the card),
    then placed on `device`. The draws cannot equal jax.random's: tests
    take their parameters from JAX through
    repro_torch.convert.recsys_params_from_numpy."""
    dev = resolve_device(device)
    gdev = generator.device if generator is not None else torch.device("cpu")
    params = {}
    for name, leaf in param_template(cfg).items():
        if isinstance(leaf, dict):
            leaves = [leaf[f"t{i}"] for i in range(len(leaf))]
            rows = [lf.shape[0] for lf in leaves]
            w = torch.empty((sum(rows), leaves[0].shape[1]),
                            dtype=_torch_dtype(leaves[0].dtype), device=gdev)
            fused = FusedTable(w, rows)
            for i, r in enumerate(rows):
                fused[f"t{i}"].normal_(generator=generator).mul_(r ** -0.5)
            params[name] = fused.moved(dev)
        elif leaf.init == "zeros":
            params[name] = torch.zeros(leaf.shape,
                                       dtype=_torch_dtype(leaf.dtype),
                                       device=dev)
        else:
            fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 \
                else leaf.shape[-1]
            params[name] = dense_init(leaf.shape, generator,
                                      scale=fan_in ** -0.5,
                                      dtype=_torch_dtype(leaf.dtype)).to(dev)
    return params


def _mlp_apply(params, prefix, x, act=torch.relu, final_act=True):
    i = 0
    while f"{prefix}_w{i}" in params:
        x = x @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}"]
        last = f"{prefix}_w{i+1}" not in params
        if (not last) or final_act:
            x = act(x)
        i += 1
    return x


def _params(params):
    return params.params if isinstance(params, RecsysModel) else params


# ---------------------------------------------------------------------------
# forward per kind — returns logits (B,)
# ---------------------------------------------------------------------------

def forward(cfg, params, batch):
    params = _params(params)
    if cfg.kind == "din":
        return _din_forward(cfg, params, batch)
    sparse = batch["sparse"]                    # (B, n_sparse) int32
    B = sparse.shape[0]
    embs = params["tables"].lookup(sparse)      # (B, F, d)

    if cfg.kind == "dlrm":
        dense = batch["dense"]                  # (B, n_dense)
        dv = _mlp_apply(params, "bot", dense)   # (B, d)
        x = torch.cat([dv[:, None, :], embs], dim=1)          # (B, F+1, d)
        z = torch.bmm(x, x.transpose(1, 2))
        f = x.shape[1]
        iu, ju = torch.triu_indices(f, f, 1, device=x.device)
        inter = z[:, iu, ju]                    # (B, F(F-1)/2)
        top_in = torch.cat([inter, dv], dim=-1)
        return _mlp_apply(params, "top", top_in, final_act=False)[:, 0]
    if cfg.kind not in ("deepfm", "wide_deep"):
        raise ValueError(cfg.kind)
    # the wide branch / first-order FM: one bag over the fused wide table
    wide = params["wide"].bag(sparse)[:, 0] + params["wide_bias"][0]
    deep = _mlp_apply(params, "deep", embs.reshape(B, -1))
    deep = (deep @ params["deep_out_w"] + params["deep_out_b"])[:, 0]
    if cfg.kind == "wide_deep":
        return wide + deep
    # FM 2nd order
    s = embs.sum(1)
    fm2 = 0.5 * (s * s - (embs * embs).sum(1)).sum(-1)
    return wide + fm2 + deep


def _din_forward(cfg, params, batch):
    """tables: t0=item, t1=cate, t2..=user profile fields."""
    tables = params["tables"]
    hist_item = batch["hist_item"]              # (B, L)
    hist_cate = batch["hist_cate"]              # (B, L)
    hist_mask = batch["hist_mask"]              # (B, L)
    B = hist_item.shape[0]
    e_hist = torch.cat(
        [embedding_lookup(tables["t0"], hist_item),
         embedding_lookup(tables["t1"], hist_cate)], dim=-1)   # (B, L, 2d)
    tgt = batch["sparse"]              # (B, n_sparse): item, cate, user...
    e_tgt = torch.cat(
        [embedding_lookup(tables["t0"], tgt[:, 0]),
         embedding_lookup(tables["t1"], tgt[:, 1])], dim=-1)   # (B, 2d)
    # local activation unit
    t = e_tgt[:, None, :].expand_as(e_hist)
    af = torch.cat([e_hist, t, e_hist - t, e_hist * t], dim=-1)
    a = _mlp_apply(params, "attn", af, act=torch.sigmoid)
    a = (a @ params["attn_out_w"] + params["attn_out_b"])[..., 0]  # (B, L)
    a = torch.where(hist_mask > 0, a, -1e30)
    w = torch.softmax(a, dim=-1)
    pooled = torch.einsum("bl,bld->bd", w, e_hist)                 # (B, 2d)
    user = tables.lookup(tgt[:, 2:], lo=2).reshape(B, -1)
    x = torch.cat([user, pooled, e_tgt], dim=-1)
    deep = _mlp_apply(params, "deep", x)
    return (deep @ params["deep_out_w"] + params["deep_out_b"])[:, 0]


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def train_tree(params):
    """The tree an optimizer updates: `params` with each FusedTable as its
    fused weight tensor (leaves "tables", "wide", "wide_bias", the MLP
    leaves)."""
    return {k: v.weight.detach() if isinstance(v, FusedTable) else v
            for k, v in _params(params).items()}


def _from_tree(params, tree):
    """`params` with the leaves of `tree` (train_tree's layout)."""
    return {k: v.with_weight(tree[k]) if isinstance(v, FusedTable)
            else tree[k] for k, v in _params(params).items()}


def train_loss_and_grads(cfg, params, batch):
    """(loss, grads) of one batch, grads in train_tree's layout: the JAX
    module's logistic loss mean(max(z, 0) - z*y + log1p(exp(-|z|))) and
    its value_and_grad."""
    params = _params(params)
    live = {k: v.with_weight(v.weight.detach(), requires_grad=True)
            if isinstance(v, FusedTable) else v.detach().requires_grad_()
            for k, v in params.items()}
    leaves = {k: v.weight if isinstance(v, FusedTable) else v
              for k, v in live.items()}
    with torch.enable_grad():
        logit = forward(cfg, live, batch)
        y = batch["label"].float()
        loss = torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                          - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def make_train_step(cfg, train_cfg=None):
    """A functional step (params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}): the logistic loss, then adamw_update with the
    train config's lr and grad_clip and no weight decay, as the JAX
    module passes none. opt_state is `adamw_init(train_tree(params))`;
    the returned params hold new tensors (FusedTables over new fused
    weights)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_update
    tc = train_cfg or TrainConfig()

    def train_step(params, opt_state, batch):
        loss, grads = train_loss_and_grads(cfg, params, batch)
        tree, opt_state, stats = adamw_update(
            grads, opt_state, train_tree(params), lr=tc.lr,
            grad_clip=tc.grad_clip)
        return _from_tree(params, tree), opt_state, {"loss": loss, **stats}

    return train_step


def make_serve_step(cfg):
    def serve(params, batch):
        return torch.sigmoid(forward(cfg, params, batch))
    return serve


# ---------------------------------------------------------------------------
# retrieval (two-tower): 1 query vs n_candidates — CluSD's host surface
# ---------------------------------------------------------------------------

def user_tower(cfg, params, batch):
    """(B, d) user/query vector."""
    params = _params(params)
    if cfg.kind == "dlrm":
        return _mlp_apply(params, "bot", batch["dense"])
    tables = params["tables"]
    if cfg.kind == "din":
        user = tables.bag(batch["sparse"][:, 2:], lo=2)
        hist = embedding_lookup(tables["t0"], batch["hist_item"])
        masked = hist * batch["hist_mask"][..., None]
        # jnp.mean over L, which divides by L and not by the mask count:
        # a sum in ascending l from 0.0, times the float32 reciprocal of
        # L (XLA turns the division by a constant into that product)
        acc = torch.zeros_like(masked[:, 0])
        for l in range(masked.shape[1]):
            acc = acc + masked[:, l]
        inv_l = torch.ones((), dtype=acc.dtype) / masked.shape[1]
        return user + acc * inv_l.to(acc.device)
    # deepfm / wide_deep: pooled user-field embeddings
    n_user = len(cfg.table_sizes) // 2
    return tables.bag(batch["sparse"][:, :n_user])


def candidate_tower(cfg, params, cand_sparse):
    """cand_sparse: (n_cand, n_item_fields) -> (n_cand, d)."""
    return _params(params)["tables"].bag(cand_sparse)


def make_retrieval_step(cfg, k=100):
    def retrieve(params, batch, cand_sparse):
        u = user_tower(cfg, params, batch)                # (B, d)
        v = candidate_tower(cfg, params, cand_sparse)     # (n_cand, d)
        scores, ids = topk_desc_index_asc(u @ v.T, k)
        return scores, ids.int()
    return retrieve


def as_batch(batch, device):
    """A batch of numpy arrays (RecsysStream's) as tensors on `device`:
    integer arrays as int32, the rest as float32."""
    out = {}
    for key, v in batch.items():
        v = np.asarray(v)
        dt = torch.int32 if np.issubdtype(v.dtype, np.integer) \
            else torch.float32
        out[key] = torch.as_tensor(v).to(device=device, dtype=dt)
    return out


class RecsysModel(nn.Module):
    """A recsys model's parameters on one device (None: the card), with the
    JAX module's step functions as methods. Tensors of `params` already
    on that device are shared, the rest copied."""

    def __init__(self, cfg, params, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tables = params["tables"].moved(dev)
        self.wide = params["wide"].moved(dev) if "wide" in params else None
        self.dense = nn.ParameterDict({
            k: nn.Parameter(v.detach().to(dev), requires_grad=False)
            for k, v in params.items() if k not in ("tables", "wide")})

    @property
    def device(self):
        return self.tables.weight.device

    @property
    def params(self):
        """The JAX params tree's names: "tables", "wide", MLP leaves."""
        out = dict(self.dense.items())
        out["tables"] = self.tables
        if self.wide is not None:
            out["wide"] = self.wide
        return out

    def forward(self, batch):
        return forward(self.cfg, self.params, batch)

    def user_tower(self, batch):
        return user_tower(self.cfg, self.params, batch)

    def candidate_tower(self, cand_sparse):
        return candidate_tower(self.cfg, self.params, cand_sparse)
