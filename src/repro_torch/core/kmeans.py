"""K-means clustering of dense document embeddings (FAISS-IVF analogue)
with capacity-balanced padded member lists: clusters are materialized as
(N, cap) padded doc-id tables.

`kmeans` runs Lloyd's on the device with chunked matmul distances and
deterministic centroid sums, so one seed builds one index on every run;
`build_cluster_table` is a host-side numpy copy of the JAX package's
greedy overflow reassignment; `neighbor_graph` is the centroid top-m
graph under the (sim desc, index asc) rule.
"""

import numpy as np
import torch

from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.device import resolve_device

# rows of X per distance chunk: bounds the (rows, N) distance buffer
_ASSIGN_ELEMS = 1 << 27


def _assign(X, C):
    """Nearest centroid by L2 (argmin of x2 + c2 - 2 X C^T), in row chunks.
    X (D, dim), C (N, dim) -> (D,) int64."""
    c2 = (C * C).sum(1)
    rows = max(1, _ASSIGN_ELEMS // max(1, C.shape[0]))
    out = torch.empty(X.shape[0], dtype=torch.long, device=X.device)
    for lo in range(0, X.shape[0], rows):
        Xc = X[lo:lo + rows]
        x2 = (Xc * Xc).sum(1, keepdim=True)
        d2 = x2 + c2[None, :] - 2.0 * (Xc @ C.T)
        out[lo:lo + rows] = d2.argmin(1)
    return out


def _cluster_sums(X, assign, n_clusters):
    """Per-cluster row sums of X as one-hot (N, rows) @ (rows, dim)
    products in float64, in row chunks: the same bits on every run, where
    CUDA index_add_ adds in whatever order its atomics land. X (D, dim),
    assign (D,) int64 -> (N, dim) float64."""
    sums = torch.zeros(n_clusters, X.shape[1], dtype=torch.float64,
                       device=X.device)
    rows = max(1, _ASSIGN_ELEMS // max(1, n_clusters))
    for lo in range(0, X.shape[0], rows):
        a = assign[lo:lo + rows]
        onehot = torch.zeros(a.shape[0], n_clusters, dtype=torch.float64,
                             device=X.device).scatter_(1, a[:, None], 1.0)
        sums += onehot.T @ X[lo:lo + rows].double()
    return sums


def kmeans(X, n_clusters, iters=15, *, init=None, generator=None,
           device=None):
    """Lloyd's algorithm. X: (D, dim). Returns (centroids (N, dim) float32,
    assignments (D,) int64), on `device`.

    init: explicit (N, dim) initial centroids (tests hand it JAX's);
    otherwise N distinct rows drawn with `generator`. Empty clusters are
    reseeded from rows drawn with `generator` each iteration.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    D = X.shape[0]
    if init is None:
        idx = torch.randperm(D, generator=generator)[:n_clusters]
        C = X[idx.to(dev)]
    else:
        C = torch.as_tensor(init, dtype=torch.float32).to(dev).clone()
    for _ in range(iters):
        assign = _assign(X, C)
        sums = _cluster_sums(X, assign, n_clusters)
        counts = torch.bincount(assign, minlength=n_clusters)
        new_c = (sums / counts.clamp(min=1)[:, None]).float()
        empty = counts == 0
        if bool(empty.any()):
            reseed = torch.randint(0, D, (n_clusters,), generator=generator)
            new_c = torch.where(empty[:, None], X[reseed.to(dev)], new_c)
        C = new_c
    return C, _assign(X, C)


def build_cluster_table(assign, n_clusters, cap, X=None, centroids=None,
                        chunk_rows=8192):
    """Padded (N, cap) doc-id table; overflow docs are reassigned, in doc
    order, to their nearest cluster with free space (host-side greedy).
    A numpy copy of the JAX package's function; preferences of overflow
    docs are computed `chunk_rows` at a time.

    Returns numpy (cluster_docs int32 (N, cap) padded with -1,
    doc_cluster int32 (D,)).
    """
    assign = np.asarray(assign).astype(np.int64)
    D = assign.shape[0]
    # members in doc order: the first `cap` docs of each cluster stay
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=n_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(D, np.int64)
    rank[order] = np.arange(D) - starts[assign[order]]
    stays = rank < cap
    members = [list(order[starts[c]:starts[c] + min(counts[c], cap)])
               for c in range(n_clusters)]
    overflow = np.flatnonzero(~stays)
    if len(overflow):
        if X is None or centroids is None:
            free = [c for c in range(n_clusters) if len(members[c]) < cap]
            fi = 0
            for d in overflow:
                while len(members[free[fi]]) >= cap:
                    fi = (fi + 1) % len(free)
                members[free[fi]].append(int(d))
                assign[d] = free[fi]
        else:
            C = np.asarray(centroids, np.float32)
            c2 = (C * C).sum(1)[None]
            fill = np.asarray([len(m) for m in members])
            for lo in range(0, len(overflow), chunk_rows):
                ids = overflow[lo:lo + chunk_rows]
                Xo = np.asarray(X[ids], np.float32)
                d2 = (Xo * Xo).sum(1)[:, None] + c2 - 2 * Xo @ C.T
                pref = np.argsort(d2, axis=1)
                for i, d in enumerate(ids):
                    for c in pref[i]:
                        if fill[c] < cap:
                            members[c].append(int(d))
                            fill[c] += 1
                            assign[d] = c
                            break
                    else:
                        raise RuntimeError("total capacity exceeded")
    table = np.full((n_clusters, cap), -1, np.int32)
    for c in range(n_clusters):
        table[c, :len(members[c])] = members[c]
    return table, assign.astype(np.int32)


def neighbor_graph(centroids, m):
    """Top-m inner-product neighbor lists among centroids: (N, m) int32 ids
    and float32 sims."""
    sims = centroids @ centroids.T
    sims = sims - 2e9 * torch.eye(sims.shape[0], dtype=sims.dtype,
                                  device=sims.device)          # no self
    vals, ids = topk_desc_index_asc(sims, m)
    return ids.int(), vals
