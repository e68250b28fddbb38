"""Selector supervision at corpus scale (paper §2.3), a port of the JAX
package's `repro.train.labels`: a candidate cluster is POSITIVE iff it
holds at least one of the query's top-`top_dense` full dense retrieval
results.

Two label paths:

  * `make_labels(cfg, index, ...)`: `full_dense_topk` over a
    materialized `index.embeddings` matrix (the topk kernel on the card);
    the parity oracle.
  * `make_labels_streaming(cfg, index, store, ...)`: the same
    supervision against a built on-disk index. The full-dense top-k is a
    running merge over cluster blocks streamed through a host
    ClusterStore, at most `chunk_clusters` blocks per fetch; the
    embedding matrix is never materialized.

Exactness. Each chunk is scored on the index's device: `q @ blocks.T`,
or the cluster_score kernel with `use_kernel`. The running merge ranks by
(score desc, doc id asc) as the JAX package's np.lexsort does (-0.0 and
+0.0 equal), as two stable sorts on the device (by doc id, then by the
negated score with its zero made +0.0); padded and tombstoned slots are
masked out of it. On the CPU the chunk products are bitwise the columns
of the full product, so streamed labels are bitwise the in-RAM ones. On
the card cuBLAS may pick another algorithm for a (B, U*cap) chunk than
for the (B, n_docs) matrix, so the two agree at isolated ranks (a score
gap above 1e-5) and not bit for bit; TF32 must stay off.

Generated labels can be spilled to a reusable on-disk `LabelCache` keyed
by index artifact checksums + label config + query fingerprint, the JAX
package's key for the same directory and queries, so an entry written
by either package is a hit in the other.
"""

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import clusd as clusd_lib
from repro_torch.core import sparse as sparse_lib
from repro_torch.device import resolve_device
from repro_torch.index.builder import _np

_PAD_ID = np.int64(1) << 62      # sorts after every real doc id on ties


@dataclasses.dataclass(frozen=True)
class LabelConfig:
    """What a label set depends on (besides the index + query set)."""

    top_dense: int = 10          # paper: top-10 full dense results
    stage1: str = "overlap"      # stage-1 candidate ordering
    chunk_clusters: int = 64     # cluster blocks per streamed fetch
    use_kernel: bool = False     # route chunk scoring via cluster_score


@dataclasses.dataclass
class LabelGenStats:
    n_fetches: int = 0
    blocks_read: int = 0
    bytes_read: int = 0
    stream_wall_s: float = 0.0   # fetch + score + merge time only
    wall_s: float = 0.0          # whole label pass incl. stage-1 features

    def add(self, n_blocks, n_bytes, wall_s):
        self.n_fetches += 1
        self.blocks_read += int(n_blocks)
        self.bytes_read += int(n_bytes)
        self.stream_wall_s += float(wall_s)


@dataclasses.dataclass
class LabelSet:
    """One query set's supervision (host arrays): stage-1 candidates and
    features, the label per candidate, and the full-dense top-k ids the
    labels came from (reused by calibration's recall@budget)."""

    cand: np.ndarray         # (B, n) int32 stage-1 candidate cluster ids
    feats: np.ndarray        # (B, n, F) float32 LSTM input features
    labels: np.ndarray       # (B, n) float32 in {0, 1}
    dense_ids: np.ndarray    # (B, top_dense) int32 full-dense top-k doc ids
    stats: Optional[LabelGenStats] = None

    @property
    def n_queries(self):
        return int(self.cand.shape[0])

    @property
    def pos_rate(self):
        return float(np.asarray(self.labels).mean())


def _on(x, dtype, dev):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    if not (isinstance(x, np.ndarray) and x.flags.writeable):
        x = np.array(x)                  # a read-only view (mmap) or a list
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev,
                                                         dtype=dtype)


# ---------------------------------------------------------------------------
# in-RAM path (the parity oracle)
# ---------------------------------------------------------------------------

def make_labels(cfg, index, q_dense, q_terms, q_weights, top_dense=10,
                stage1="overlap"):
    """Returns (cand (B, n), feats (B, n, F), labels (B, n)) as tensors on
    the index's device. Needs `index.embeddings` (D, dim) on that device;
    for built on-disk indexes use `make_labels_streaming`."""
    dev = index.device
    cand, feats, _, _ = _stage1(cfg, index, q_dense, q_terms, q_weights,
                                stage1)
    dense_ids, _ = clusd_lib.full_dense_topk(
        index.embeddings, _on(q_dense, torch.float32, dev), top_dense)
    labels = _labels_from_dense(index, cand, dense_ids)
    return cand, feats, labels


def _stage1(cfg, index, q_dense, q_terms, q_weights, stage1):
    dev = index.device
    qd = _on(q_dense, torch.float32, dev)
    sparse_ids, sparse_scores = sparse_lib.sparse_retrieve_topk(
        index.sparse_index, _on(q_terms, torch.int32, dev),
        _on(q_weights, torch.float32, dev), cfg.k_sparse)
    s1 = clusd_lib.stage1_candidates(cfg, index, qd, sparse_ids,
                                     sparse_scores, stage1=stage1)
    return s1["cand"], s1["feats"], sparse_ids, sparse_scores


def stage1_for_queries(cfg, index, q_dense, q_terms, q_weights,
                       stage1="overlap"):
    """Stage-1 candidates + features for a query set, as host arrays.
    Re-running stage 1 at another `cfg.expand_depth` changes only (cand,
    feats): the full-dense ids of a LabelSet stay valid."""
    cand, feats, _, _ = _stage1(cfg, index, q_dense, q_terms, q_weights,
                                stage1)
    return _np(cand), _np(feats)


def relabel_for_config(cfg, index, q_dense, q_terms, q_weights, dense_ids, *,
                       stage1="overlap") -> LabelSet:
    """A LabelSet for a new candidate-generation config (e.g. another
    `expand_depth`) from an existing full-dense top-k: a stage-1 re-run,
    no dense pass."""
    cand, feats, _, _ = _stage1(cfg, index, q_dense, q_terms, q_weights,
                                stage1)
    dense_ids = np.asarray(dense_ids)
    labels = _labels_from_dense(index, cand,
                                _on(dense_ids, torch.int64, index.device))
    return LabelSet(cand=_np(cand), feats=_np(feats), labels=_np(labels),
                    dense_ids=dense_ids)


def _labels_from_dense(index, cand, dense_ids):
    pos_clusters = index.doc_cluster[dense_ids.long()]         # (B, k)
    labels = (cand[:, :, None] == pos_clusters[:, None, :]).any(dim=-1)
    return labels.float()


# ---------------------------------------------------------------------------
# streaming full-dense top-k over a ClusterStore
# ---------------------------------------------------------------------------

def _chunk_scores(q, vecs, use_kernel):
    """(B, dim) x (U, cap, dim) -> (B, U*cap) float32 dot scores on q's
    device."""
    U, cap, dim = vecs.shape
    B = q.shape[0]
    if use_kernel:
        from repro_torch.kernels.cluster_score import cluster_score
        sel = torch.arange(U, dtype=torch.int32, device=q.device)
        sel = sel[None, :].expand(B, U).contiguous()
        return cluster_score(q, vecs, sel).reshape(B, U * cap)
    return q @ vecs.reshape(U * cap, dim).T


def _merge_topk(best_s, best_i, new_s, new_i, k):
    """Running (score desc, id asc) top-k merge, np.lexsort((i, -s))'s
    order: a stable sort by id, then a stable sort by the negated score
    with -0.0 made +0.0 (the lexsort compares them equal)."""
    s = torch.cat([best_s, new_s], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    by_id = torch.argsort(i, dim=1, stable=True)
    key = -s.gather(1, by_id)
    key = torch.where(key == 0, torch.zeros_like(key), key)
    order = by_id.gather(1, torch.argsort(key, dim=1, stable=True))[:, :k]
    return s.gather(1, order), i.gather(1, order)


def streaming_full_dense_topk(store, q_dense, k, *, chunk_clusters=64,
                              use_kernel=False, stats: LabelGenStats = None,
                              device=None):
    """Exact full-dense top-k computed by streaming cluster blocks.

    Every `fetch_blocks` call asks for at most `chunk_clusters` cluster
    ids; a running per-query top-k merge on `device` (None: the CUDA
    card) keeps only (B, k) candidates resident. Returns (ids (B, k) int32, scores (B, k) float32) as host
    arrays: `full_dense_topk` over the matrix the store decodes to
    (exact floats for v1 blocks, PQ reconstructions for v2), at the
    tolerance of the module docstring."""
    device = resolve_device(device)
    q = _on(q_dense, torch.float32, device)
    B = q.shape[0]
    N = int(store.cluster_docs.shape[0])
    chunk_clusters = max(1, int(chunk_clusters))
    best_s = torch.full((B, k), -torch.inf, dtype=torch.float32,
                        device=device)
    best_i = torch.full((B, k), int(_PAD_ID), dtype=torch.int64,
                        device=device)
    block_bytes = int(getattr(store, "block_bytes", 0))
    for lo in range(0, N, chunk_clusters):
        ids = np.arange(lo, min(lo + chunk_clusters, N), dtype=np.int64)
        t0 = time.perf_counter()
        vecs, docs, valid = store.fetch_blocks(ids)
        vecs = _on(vecs, torch.float32, device)
        flat_docs = _on(docs, torch.int64, device).reshape(-1)
        flat_valid = _on(valid, torch.bool, device).reshape(-1)
        scores = _chunk_scores(q, vecs, use_kernel)          # (B, U*cap)
        # mask padded / tombstoned slots out of the merge entirely
        scores = torch.where(flat_valid[None, :], scores, -torch.inf)
        ids_row = torch.where(flat_valid, flat_docs, int(_PAD_ID))
        best_s, best_i = _merge_topk(
            best_s, best_i, scores, ids_row[None, :].expand(B, -1), k)
        if stats is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stats.add(len(ids), len(ids) * block_bytes,
                      time.perf_counter() - t0)
    best_i, best_s = _np(best_i), _np(best_s)
    if np.any(best_i >= _PAD_ID):
        raise ValueError(f"corpus holds fewer than k={k} live documents")
    return best_i.astype(np.int32), best_s


def make_labels_streaming(cfg, index, store, q_dense, q_terms, q_weights, *,
                          label_cfg: LabelConfig = LabelConfig(),
                          metrics=None, device=None):
    """Index-backed `make_labels`: the same `(cand, feats, labels)` with
    the full-dense pass streamed through `store` (bounded reads, no
    materialized embedding matrix). Stage I and the scoring run on
    `device` (None: the CUDA card; the index is copied there if it lies
    elsewhere). Returns a LabelSet. `metrics`
    (repro_torch.obs.MetricsRegistry) gets the pass recorded under
    `labels.*`."""
    dev = resolve_device(device)
    if index.device != dev:
        index = index.to(dev)
    stats = LabelGenStats()
    t0 = time.perf_counter()
    cand, feats, _, _ = _stage1(cfg, index, q_dense, q_terms, q_weights,
                                label_cfg.stage1)
    dense_ids, _ = streaming_full_dense_topk(
        store, q_dense, label_cfg.top_dense,
        chunk_clusters=label_cfg.chunk_clusters,
        use_kernel=label_cfg.use_kernel, stats=stats, device=dev)
    labels = _labels_from_dense(index, cand,
                                _on(dense_ids, torch.int64, index.device))
    ls = LabelSet(cand=_np(cand), feats=_np(feats), labels=_np(labels),
                  dense_ids=dense_ids, stats=stats)
    stats.wall_s = time.perf_counter() - t0
    if metrics is not None:
        record_label_metrics(metrics, ls)
    return ls


def record_label_metrics(registry, ls: LabelSet):
    """Fold one label pass into `labels.*` metrics: fetch/byte counters
    (cumulative across passes) and a queries-per-second gauge for the
    most recent pass."""
    st = ls.stats
    if st is None:
        return
    registry.counter("labels.passes").inc()
    registry.counter("labels.queries").inc(ls.n_queries)
    registry.counter("labels.n_fetches").inc(st.n_fetches)
    registry.counter("labels.blocks_read").inc(st.blocks_read)
    registry.counter("labels.bytes_read").inc(st.bytes_read)
    registry.counter("labels.stream_ms").inc(round(st.stream_wall_s * 1e3, 3))
    registry.counter("labels.wall_ms").inc(round(st.wall_s * 1e3, 3))
    if st.wall_s > 0:
        registry.gauge("labels.queries_per_s").set(
            round(ls.n_queries / st.wall_s, 2))


# ---------------------------------------------------------------------------
# reusable on-disk label cache
# ---------------------------------------------------------------------------

def query_fingerprint(q_dense, q_terms, q_weights):
    h = hashlib.sha256()
    for a in (q_dense, q_terms, q_weights):
        a = np.ascontiguousarray(_np(a))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# config fields the labels depend on: sparse retrieval + stage-1
# candidate ordering + features. Selector-side fields (theta,
# max_selected, pos_weight, lr, ...) are left out: a selector publish
# bumps the generation without touching the corpus.
_LABEL_CFG_FIELDS = ("n_docs", "dim", "n_clusters", "vocab", "max_postings",
                     "k_sparse", "bins", "n_candidates", "n_neighbors",
                     "u_bins", "expand_depth")


def label_cache_key(manifest, cfg, label_cfg: LabelConfig, q_fingerprint):
    """Cache key: per-artifact content hashes (every non-selector file)
    + the label-relevant config + label config + the query-set
    fingerprint; the JAX package's key for the same inputs."""
    ident = {
        "format_version": manifest["format_version"],
        "geometry": manifest["geometry"],
        "files": {rel: e["sha256"]
                  for rel, e in (manifest.get("files") or {}).items()
                  if not rel.startswith("lstm")},   # selector never feeds labels
        "config": {f: getattr(cfg, f) for f in _LABEL_CFG_FIELDS},
        "label_config": dataclasses.asdict(label_cfg),
        "queries": q_fingerprint,
    }
    blob = json.dumps(ident, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


class LabelCache:
    """Directory of spilled LabelSets, one `<key>.npz` + `<key>.json` pair
    per (index generation, label config, query set). Writes are atomic
    (tmp + os.replace), so a crashed run never leaves a torn entry."""

    def __init__(self, cache_dir):
        self.dir = os.path.abspath(cache_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _paths(self, key):
        return (os.path.join(self.dir, f"{key}.npz"),
                os.path.join(self.dir, f"{key}.json"))

    def load(self, key) -> Optional[LabelSet]:
        npz, meta = self._paths(key)
        if not (os.path.isfile(npz) and os.path.isfile(meta)):
            return None
        with np.load(npz) as z:
            return LabelSet(cand=z["cand"], feats=z["feats"],
                            labels=z["labels"], dense_ids=z["dense_ids"])

    def save(self, key, ls: LabelSet, extra: Any = None):
        npz, meta = self._paths(key)
        tmp = npz + ".tmp"
        with open(tmp, "wb") as f:      # file handle: savez must not append
            np.savez(f, cand=ls.cand, feats=ls.feats, labels=ls.labels,
                     dense_ids=ls.dense_ids)
        os.replace(tmp, npz)
        info = {"n_queries": ls.n_queries, "pos_rate": ls.pos_rate,
                "extra": extra or {}}
        if ls.stats is not None:
            info["gen_stats"] = dataclasses.asdict(ls.stats)
        tmp = meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump(info, f, indent=1, sort_keys=True)
        os.replace(tmp, meta)
        return npz

    def get_or_build(self, key, build_fn, extra=None, metrics=None):
        """Returns (LabelSet, cache_hit). `metrics` counts the outcome
        under `labels.cache_hits` / `labels.cache_misses`."""
        ls = self.load(key)
        if ls is not None:
            if metrics is not None:
                metrics.counter("labels.cache_hits").inc()
            return ls, True
        ls = build_fn()
        self.save(key, ls, extra=extra)
        if metrics is not None:
            metrics.counter("labels.cache_misses").inc()
        return ls, False
