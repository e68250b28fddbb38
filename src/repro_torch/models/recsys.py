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

On a mesh (`models.sharding.rules_ctx(rules, mesh)` installed) the
params are the JAX tree of per-field padded tables, each rank holding
its slice of every field's rows along "table_rows" ("data", "model"),
as `param_shardings` places them; the batch splits along "batch". The
lookups are the standard model-parallel ones: the batch's ids gathered
over the batch axes, each rank looks them up in its own row range
(zeros for ids of other ranks' rows; the wide and first-order FM bag
is the embedding_bag kernel over the rank's wide slices and one zero
row that the other ranks' ids read), and a reduce-scatter over the
table_rows axes sums the partial rows back to the batch rows (then
gathered over the table_rows axes that are not batch axes, where every
rank holds its data shard's rows alike). The backward of that
reduce-scatter is an all-gather of the cotangents.
"""

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.common import tree as tu
from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models import collectives as coll
from repro_torch.models import sharding as sh


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


def abstract_params(cfg):
    """Meta tensors of every leaf of param_template (the reference's tree
    of per-field padded tables): shapes and dtypes, no storage."""
    return tu.tree_map(lambda l: torch.empty(
        l.shape, dtype=_torch_dtype(l.dtype), device="meta"),
        param_template(cfg))


def param_shardings(cfg, mesh):
    """The NamedSharding of every leaf of param_template on `mesh` under
    the installed rules: each field's table rows along "table_rows"."""
    return tu.tree_map(lambda l: sh.named_sharding(mesh, *l.axes),
                       param_template(cfg))


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
    """Logits (B,) of the batch; on a mesh, of this rank's batch rows
    from its slices of the per-field tables."""
    plan = _row_plan()
    if plan is not None:
        return _forward_rows(cfg, params, batch, plan)
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
    return _wide_deep_head(cfg, params, embs, params["wide"].bag(sparse))


def _wide_deep_head(cfg, params, embs, wide):
    """deepfm / wide_deep logits from the (B, F, d) field embeddings and
    the (B, 1) wide bag."""
    B = embs.shape[0]
    wide = wide[:, 0] + params["wide_bias"][0]
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
    user = tables.lookup(tgt[:, 2:], lo=2).reshape(B, -1)
    return _din_head(params, e_hist, e_tgt, user, hist_mask)


def _din_head(params, e_hist, e_tgt, user, hist_mask):
    """din logits from the behaviour (B, L, 2d), target (B, 2d) and user
    (B, (F - 2) d) embeddings."""
    # local activation unit
    t = e_tgt[:, None, :].expand_as(e_hist)
    af = torch.cat([e_hist, t, e_hist - t, e_hist * t], dim=-1)
    a = _mlp_apply(params, "attn", af, act=torch.sigmoid)
    a = (a @ params["attn_out_w"] + params["attn_out_b"])[..., 0]  # (B, L)
    a = torch.where(hist_mask > 0, a, -1e30)
    w = torch.softmax(a, dim=-1)
    pooled = torch.einsum("bl,bld->bd", w, e_hist)                 # (B, 2d)
    x = torch.cat([user, pooled, e_tgt], dim=-1)
    deep = _mlp_apply(params, "deep", x)
    return (deep @ params["deep_out_w"] + params["deep_out_b"])[:, 0]


# ---------------------------------------------------------------------------
# the mesh: tables split along "table_rows"
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RowPlan:
    """The installed mesh's split of the recsys model on this rank: the
    table_rows axes `rows` (the batch axes first), the batch axes, the
    rows axes that are not batch axes (`rest`), and this rank's index
    over `rows`."""
    mesh: Any
    rows: Tuple[str, ...]
    batch: Tuple[str, ...]
    rest: Tuple[str, ...]
    ri: int


def _row_plan():
    """The _RowPlan of the installed mesh, or None without one."""
    mesh = sh.current_mesh()
    if mesh is None:
        return None
    rows = sh.spec_axes(sh.spec("table_rows")[0])
    batch = sh.spec_axes(sh.spec("batch")[0])
    if rows[:len(batch)] != batch:
        raise NotImplementedError(
            f"rules put table_rows on {rows} and batch on {batch}: the "
            f"row-sharded lookup needs the batch axes first among them")
    return _RowPlan(mesh, rows, batch, rows[len(batch):],
                    mesh.axis_index(rows))


def _local_rows(table_l, ids, plan):
    """Rows of the global `ids` that fall in this rank's slice `table_l`
    of a field's table, zeros for the others: (..., d)."""
    n = table_l.shape[0]
    local = ids.long() - plan.ri * n
    mine = (local >= 0) & (local < n)
    return torch.where(mine[..., None], table_l[local.clamp(0, n - 1)], 0)


def _local_wide_bag(wide, ids, plan):
    """The wide bag (B_g, 1) of this rank's rows: the embedding_bag kernel
    over its wide slices side by side and one zero row after them; an id
    in its field's slice reads its row there, any other id the zero
    row."""
    tabs = [wide[f"t{i}"] for i in range(ids.shape[1])]
    sizes = [t.shape[0] for t in tabs]
    n = torch.tensor(sizes, device=ids.device)
    off = torch.cumsum(n, 0) - n
    local = ids.long() - plan.ri * n
    mine = (local >= 0) & (local < n)
    idx = torch.where(mine, local + off, sum(sizes)).to(torch.int32)
    table = torch.cat(tabs + [tabs[0].new_zeros((1, tabs[0].shape[1]))], 0)
    return bag_ops.embedding_bag(table, idx.contiguous())


def _to_batch_rows(x, plan):
    """(B_g, c) partial rows of every rank -> (B_l, c) sums for this
    rank's batch rows: a reduce-scatter over the table_rows axes, then
    a gather over those that are not batch axes (whose ranks hold their
    data shard's rows alike; backward: this rank's slice)."""
    x = coll.reduce_scatter(x, plan.mesh, plan.rows, 0)
    return coll.gather_replicated(x, plan.mesh, plan.rest, 0)


def _forward_rows(cfg, params, batch, plan):
    """forward on a mesh: params the per-field table slices and MLP
    leaves, batch this rank's rows."""
    sparse = batch["sparse"]
    B, F = sparse.shape
    tables = params["tables"]
    if cfg.kind == "din":
        L = batch["hist_item"].shape[1]
        ids = coll.gather_parts(torch.cat(
            [sparse, batch["hist_item"], batch["hist_cate"]], 1).to(
                torch.int32), plan.mesh, plan.batch, 0)
        tgt, hi, hc = ids[:, :F], ids[:, F:F + L], ids[:, F + L:]
        Bg = ids.shape[0]
        parts = [torch.cat([_local_rows(tables["t0"], hi, plan),
                            _local_rows(tables["t1"], hc, plan)], -1),
                 torch.cat([_local_rows(tables["t0"], tgt[:, 0], plan),
                            _local_rows(tables["t1"], tgt[:, 1], plan)], -1),
                 torch.stack([_local_rows(tables[f"t{i}"], tgt[:, i], plan)
                              for i in range(2, F)], 1)]
        x = _to_batch_rows(torch.cat([p.reshape(Bg, -1) for p in parts], 1),
                           plan)
        d = tables["t0"].shape[1]
        e_hist = x[:, :L * 2 * d].reshape(B, L, 2 * d)
        e_tgt = x[:, L * 2 * d:(L + 1) * 2 * d]
        user = x[:, (L + 1) * 2 * d:]
        return _din_head(params, e_hist, e_tgt, user, batch["hist_mask"])
    ids = coll.gather_parts(sparse.to(torch.int32), plan.mesh, plan.batch, 0)
    Bg = ids.shape[0]
    embs = torch.stack([_local_rows(tables[f"t{i}"], ids[:, i], plan)
                        for i in range(F)], 1)               # (B_g, F, d)
    d = embs.shape[-1]
    cols = [embs.reshape(Bg, F * d)]
    if "wide" in params:
        cols.append(_local_wide_bag(params["wide"], ids, plan).to(
            embs.dtype))
    x = _to_batch_rows(torch.cat(cols, 1), plan)
    embs = x[:, :F * d].reshape(B, F, d)
    if cfg.kind == "dlrm":
        dv = _mlp_apply(params, "bot", batch["dense"])
        x = torch.cat([dv[:, None, :], embs], dim=1)
        z = torch.bmm(x, x.transpose(1, 2))
        f = x.shape[1]
        iu, ju = torch.triu_indices(f, f, 1, device=x.device)
        top_in = torch.cat([z[:, iu, ju], dv], dim=-1)
        return _mlp_apply(params, "top", top_in, final_act=False)[:, 0]
    return _wide_deep_head(cfg, params, embs, x[:, F * d:])


def _is_table(path):
    return path.startswith("['tables']") or path.startswith("['wide']")


def _rows_loss_and_grads(cfg, params, batch, plan):
    """(loss, grads, grad_norm) of this rank's slices: the loss the mean
    over the batch axes; the MLP gradients summed over the batch axes
    (the tables' are whole from the lookups' backward); the norm of the
    whole gradient, the tables' squares summed over the rows axes."""
    paths = [p for p, _ in tu.leaf_paths(params)]
    leaves = [p.detach().requires_grad_() for p in tu.tree_leaves(params)]
    with torch.enable_grad():
        logit = forward(cfg, tu.tree_unflatten_like(params, leaves), batch)
        y = batch["label"].float()
        loss = torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                          - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))
        loss = coll.pmean(loss, plan.mesh, plan.batch)
        grads = list(torch.autograd.grad(loss, leaves))
    dense = [i for i, p in enumerate(paths) if not _is_table(p)]
    for i, g in zip(dense, coll.all_reduce_many(
            [grads[i] for i in dense], plan.mesh, plan.batch)):
        grads[i] = g
    sq_t = sum(torch.sum(torch.square(g.float()))
               for p, g in zip(paths, grads) if _is_table(p))
    sq_d = sum(torch.sum(torch.square(grads[i].float())) for i in dense)
    sq_t = coll.all_reduce_many([sq_t], plan.mesh, plan.rows)[0]
    return (loss.detach(), tu.tree_unflatten_like(params, grads),
            torch.sqrt(sq_t + sq_d))


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
    weights).

    On a mesh the step takes and returns this rank's slices: params and
    both moments as `param_shardings` places them (a tree of per-field
    tables), the batch's rows along "batch"; the gradients are clipped
    by the norm of the whole gradient."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_update
    tc = train_cfg or TrainConfig()

    def train_step(params, opt_state, batch):
        plan = _row_plan()
        if plan is not None:
            loss, grads, gnorm = _rows_loss_and_grads(cfg, params, batch,
                                                      plan)
            params, opt_state, stats = adamw_update(
                grads, opt_state, params, lr=tc.lr, grad_clip=tc.grad_clip,
                global_norm=gnorm)
            return params, opt_state, {"loss": loss, **stats}
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
