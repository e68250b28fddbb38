"""K-means clustering of dense document embeddings (FAISS-IVF analogue)
with capacity-balanced padded member lists: clusters are materialized as
(N, cap) padded doc-id tables.

`kmeans` runs Lloyd's on the device with chunked matmul distances and
deterministic centroid sums, so one seed builds one index on every run;
`kmeans_shards` is its streaming form for corpora that never sit on the
device whole (one shard at a time, sums and counts added on the host);
`lloyd_refine` is the update path's deterministic host refinement;
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
        del d2              # before the next chunk's three (rows, N) buffers
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
        del onehot          # before the next chunk's: one (rows, N) at once
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


def _gather_rows(shards, offsets, idx):
    """Rows of the global indices idx from a list of (D_i, dim) shards."""
    first = np.asarray(shards[0][:1])
    out = np.empty((len(idx), first.shape[1]), first.dtype)
    sid = np.searchsorted(offsets, idx, side="right") - 1
    for i, (s, g) in enumerate(zip(sid, idx)):
        out[i] = shards[s][g - offsets[s]]
    return out


def _shard_on(shard, dev):
    """One shard's rows as a float32 tensor on dev (a host copy first: a
    read-only np.memmap cannot back a tensor)."""
    return torch.from_numpy(np.array(shard, np.float32)).to(dev)


def kmeans_shards(shards, n_clusters, iters=15, *, init_idx=None,
                  generator=None, device=None):
    """Streaming Lloyd's over embedding shards, for corpora that never sit
    on the device at once. `shards` is a sequence of (D_i, dim) host
    arrays (RowSlice views of an np.memmap are fine); one shard is on the
    device at a time, and its per-cluster sums and counts come back to
    the host and add, in shard order, into float32 host arrays, as the
    JAX package's `kmeans_shards` adds them.

    init_idx: the N global row indices of the initial centroids (tests
    hand it JAX's `jax.random.choice` draw); otherwise N distinct rows
    drawn with `generator`. Empty clusters are reseeded from rows drawn
    with `generator`. Returns (centroids (N, dim) float32, assignments
    (D,) int64), on `device`.
    """
    dev = resolve_device(device)
    sizes = [int(s.shape[0]) for s in shards]
    D = sum(sizes)
    offsets = np.cumsum([0] + sizes)
    dim = int(shards[0].shape[1])
    if init_idx is None:
        init_idx = torch.randperm(D, generator=generator)[:n_clusters].numpy()
    init = np.sort(np.asarray(init_idx, np.int64))
    if len(init) != n_clusters:
        raise ValueError(f"init_idx holds {len(init)} rows, not {n_clusters}")
    C = torch.from_numpy(
        _gather_rows(shards, offsets, init).astype(np.float32)).to(dev)
    for _ in range(iters):
        sums = np.zeros((n_clusters, dim), np.float32)
        counts = np.zeros((n_clusters,), np.float32)
        for s in shards:
            Xs = _shard_on(s, dev)
            a = _assign(Xs, C)
            sums += _cluster_sums(Xs, a, n_clusters).float().cpu().numpy()
            counts += torch.bincount(a, minlength=n_clusters).float() \
                .cpu().numpy()
            del Xs, a
        new_c = sums / np.maximum(counts, 1.0)[:, None]
        empty = counts < 0.5
        if empty.any():
            reseed_idx = torch.randint(0, D, (n_clusters,),
                                       generator=generator).numpy()
            reseed = _gather_rows(shards, offsets, reseed_idx)
            new_c = np.where(empty[:, None], reseed, new_c)
        C = torch.from_numpy(new_c.astype(np.float32)).to(dev)
    assign = torch.cat([_assign(_shard_on(s, dev), C) for s in shards])
    return C, assign


def lloyd_refine(X, centroids, iters=4):
    """Deterministic local Lloyd's refinement from a centroid init — no
    random reseeding, pure host numpy, statement for statement the JAX
    package's: the re-clustering primitive of the index update path
    (repro_torch.index.update). Empty clusters keep their previous
    centroid.

    X: (n, dim) member vectors; centroids: (k, dim) init.
    Returns (refined centroids (k, dim) f32, assignments (n,) int64).
    """
    X = np.asarray(X, np.float32)
    C = np.asarray(centroids, np.float32).copy()
    x2 = (X * X).sum(axis=1)[:, None]

    def assign_to(C):
        d2 = x2 + (C * C).sum(axis=1)[None, :] - 2.0 * X @ C.T
        return np.argmin(d2, axis=1)

    assign = assign_to(C)
    for _ in range(int(iters)):
        for c in range(C.shape[0]):
            sel = assign == c
            if sel.any():
                C[c] = X[sel].mean(axis=0)
        assign = assign_to(C)
    return C, assign


def gather_rows_chunked(X, idx, chunk_rows=8192):
    """X[idx] as float32 in reads of at most chunk_rows rows: X only needs
    row indexing (an np.memmap is never read whole)."""
    idx = np.asarray(idx, np.int64)
    out = np.empty((len(idx), int(X.shape[1])), np.float32)
    for lo in range(0, len(idx), chunk_rows):
        sel = idx[lo:lo + chunk_rows]
        out[lo:lo + len(sel)] = np.asarray(X[sel], np.float32)
    return out


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
