"""Trees of tensors: nested dicts whose leaves are tensors (or numpy
arrays, or scalars), the port's counterpart of the JAX package's pytree
helpers in `repro.common.tree` that the optimizers and checkpoints use.

Also the rest of `repro.common.tree`: tree_add, clip_by_global_norm,
param_count, param_bytes and cast_tree.

Leaves are visited in JAX's order: a dict's keys sorted at every level.
A leaf's path is JAX's `keystr` of its dict keys, e.g. "['opt']['mu']['b']"
(`leaf_paths`), which is what the npz checkpoints record.
"""

import torch


def _is_node(x):
    return isinstance(x, dict)


def leaf_paths(tree, prefix=""):
    """[(keystr path, leaf)] in JAX's flatten order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaf_paths(tree[k], f"{prefix}[{k!r}]"))
    return out


def tree_leaves(tree):
    return [leaf for _, leaf in leaf_paths(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure); returns a tree of that structure."""
    if not _is_node(tree):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def tree_unflatten_like(tree, leaves):
    """A tree of `tree`'s structure holding `leaves` (in flatten order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def global_norm(tree):
    """sqrt of the sum over leaves (in flatten order) of each leaf's
    float32 sum of squares: a float32 tensor of shape ()."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def clip_by_global_norm(tree, max_norm):
    """(tree scaled by min(1, max_norm / (norm + 1e-12)), norm), the
    reference's clip in float32."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_scale(tree, scale), norm


def param_count(tree):
    return sum(int(x.numel()) for x in tree_leaves(tree))


def param_bytes(tree):
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def cast_tree(tree, dtype):
    """Floating leaves cast to `dtype`; the others as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
