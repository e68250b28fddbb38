"""CluSD end-to-end: index build + the online selection stages (paper
§2.1 steps 1-2).

Index artifacts (device tensors unless noted):
  centroids (N, dim) · cluster_docs (N, cap) · doc_cluster (D,)
  neighbor_ids/sims (N, m) · sparse inverted index · LSTM selector

Online (batched over queries):
  1. sparse retrieval -> top-k ids/scores
  2. Stage I: P/Q overlap features -> multikey sort -> top-n candidates
     Stage II: LSTM over the candidate sequence -> f(C_i) >= theta ->
     selected clusters (static budget max_selected, mask-padded)
  3. score the selected cluster blocks -> fusion (repro_torch.engine;
     `retrieve` runs all three over the index's device store)
"""

import copy
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import bins as bins_lib
from repro_torch.core import features as feat_lib
from repro_torch.core import fusion as fusion_lib
from repro_torch.core import kmeans as km
from repro_torch.core import stage1 as stage1_lib
from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.core.sparse import SparseIndex
from repro_torch.device import resolve_device


@dataclasses.dataclass
class CluSDIndex:
    centroids: torch.Tensor      # (N, dim) float32
    cluster_docs: torch.Tensor   # (N, cap) int32, -1 pad
    doc_cluster: torch.Tensor    # (D,) int32
    neighbor_ids: torch.Tensor   # (N, m) int32
    neighbor_sims: torch.Tensor  # (N, m) float32
    embeddings: Any              # (D, dim) or None (on disk / quantized)
    sparse_index: SparseIndex
    selector: Any = None         # core.lstm SELECTORS module, or None
    quantizer: Any = None        # optional PQ (core/quant.py)
    bin_ids: Any = None          # (k_sparse,) rank -> bin id
    # the device stores `retrieve` and `score_selected` built: kind ->
    # (source, cluster_docs, store); see _device_store
    _stores: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def n_docs(self):
        return int(self.doc_cluster.shape[0])

    @property
    def n_clusters(self):
        return int(self.centroids.shape[0])

    @property
    def device(self):
        return self.centroids.device

    def to(self, device):
        """This index on `device`: tensors already there are shared, the
        rest copied; the selector is always a copy (Module.to would move
        the caller's in place)."""
        def mv(x):
            return x.to(device) if isinstance(x, torch.Tensor) else x
        sel = None if self.selector is None \
            else copy.deepcopy(self.selector).to(device)
        pq = self.quantizer
        if pq is not None:
            pq = dataclasses.replace(pq, codebooks=mv(pq.codebooks),
                                     codes=mv(pq.codes),
                                     rotation=mv(pq.rotation))
        return dataclasses.replace(
            self, centroids=mv(self.centroids),
            cluster_docs=mv(self.cluster_docs),
            doc_cluster=mv(self.doc_cluster),
            neighbor_ids=mv(self.neighbor_ids),
            neighbor_sims=mv(self.neighbor_sims),
            embeddings=mv(self.embeddings),
            sparse_index=self.sparse_index.to(device), selector=sel,
            quantizer=pq, bin_ids=mv(self.bin_ids))


def build_index(cfg, embeddings, doc_terms, doc_weights, *, kmeans_iters=15,
                generator=None, device=None) -> CluSDIndex:
    """k-means clusters, the capacity-balanced cluster table, the centroid
    neighbor graph, the sparse inverted index and the rank-bin table.
    `embeddings` (D, dim) is a host array; it stays out of the index
    (embeddings=None): serving reads blocks through a store."""
    dev = resolve_device(device)
    emb = np.asarray(embeddings, np.float32)
    centroids, assign = km.kmeans(emb, cfg.n_clusters, kmeans_iters,
                                  generator=generator, device=dev)
    cluster_docs, doc_cluster = km.build_cluster_table(
        assign.cpu().numpy(), cfg.n_clusters, cfg.cluster_cap, emb,
        centroids.cpu().numpy())
    m = min(cfg.n_neighbors, cfg.n_clusters - 1)
    nb_ids, nb_sims = km.neighbor_graph(centroids, m)
    sp = SparseIndex.build(doc_terms, doc_weights, cfg.vocab,
                           cfg.max_postings, device=dev)
    return CluSDIndex(
        centroids=centroids, cluster_docs=torch.from_numpy(cluster_docs).to(dev),
        doc_cluster=torch.from_numpy(doc_cluster).to(dev),
        neighbor_ids=nb_ids, neighbor_sims=nb_sims, embeddings=None,
        sparse_index=sp,
        bin_ids=bins_lib.rank_bin_ids(cfg.bins, cfg.k_sparse, device=dev))


def stage1_candidates(cfg, index, q_dense, sparse_ids, sparse_scores, *,
                      stage1="overlap"):
    """Step 1: sparse-overlap features -> ordered candidate clusters.
    Returns {"cand", "feats", "qc_sim", "P", "Q"}."""
    qc_sim = q_dense @ index.centroids.T                     # (B, N)
    P, Q = bins_lib.overlap_features(
        sparse_ids, fusion_lib.minmax_norm(sparse_scores), index.doc_cluster,
        index.n_clusters, index.bin_ids, cfg.v_bins)
    if stage1 == "overlap":
        cand = stage1_lib.sort_by_overlap(P, qc_sim, cfg.n_candidates)
    else:
        cand = stage1_lib.sort_by_dist(qc_sim, cfg.n_candidates)
    if cfg.expand_depth > 0 and cfg.n_candidates_total > cfg.n_candidates:
        cand = stage1_lib.expand_candidates(
            cand, index.neighbor_ids, index.neighbor_sims, qc_sim,
            cfg.expand_depth, cfg.n_candidates_total)
    feats = feat_lib.candidate_features(
        cand, qc_sim, P, Q, index.neighbor_ids, index.neighbor_sims,
        cfg.u_bins)
    return {"cand": cand, "feats": feats, "qc_sim": qc_sim, "P": P, "Q": Q}


def full_dense_topk(embeddings, q_dense, k):
    """Exhaustive dense retrieval: the top-k of q_dense @ embeddings.T
    under the lax.top_k rule (the topk kernel on the card). Returns (ids
    (B, k) int32, scores (B, k))."""
    scores = q_dense.float() @ embeddings.float().T
    s, i = topk_desc_index_asc(scores, k)
    return i.int(), s


def _selector_module(selector, selector_params, index, device):
    """The Stage-II selector module ("lstm", "rnn" or "mlp"): one made
    from `selector_params` (the JAX package's param dict of that
    selector, as arrays) when given, else the index's, which must be of
    that kind. None when neither is given (the untrained stage-1 order,
    whatever the name, as in the JAX package); an unknown name raises
    KeyError, as the JAX `SELECTORS[selector]` lookup does."""
    from repro_torch.core.lstm import SELECTORS
    if selector_params is None:
        module = index.selector
        if module is not None and not isinstance(module, SELECTORS[selector]):
            raise TypeError(f"selector {selector!r} asked for, but the "
                            f"index's selector is a {type(module).__name__}")
        return module
    from repro_torch.convert import selector_from_numpy
    return selector_from_numpy(selector_params, selector=selector,
                               device=device)


def stage2_select(cfg, index, cand, feats, *, selector="lstm", theta=None,
                  selector_params=None):
    """Step 2: selector probabilities -> thresholded, budgeted selection.
    `theta` overrides cfg.theta; `selector_params` overrides the index's
    selector. Returns {"probs", "sel_ids", "sel_mask"}."""
    theta = cfg.theta if theta is None else theta
    B, n = cand.shape
    module = _selector_module(selector, selector_params, index, cand.device)
    if module is None:
        # untrained: stage-1 order only — take the first max_selected
        probs = torch.linspace(1.0, 0.5, n, device=cand.device)[None].repeat(B, 1)
    else:
        probs = module(feats)
    picked = probs >= theta                                  # (B, n)
    # static budget: top max_selected by prob among picked; unpicked
    # entries sort last via -inf and the mask is the picked bit carried
    # through the permutation
    masked = torch.where(picked, probs, -torch.inf)
    _, top_i = topk_desc_index_asc(masked, min(cfg.max_selected, n))
    sel_mask = picked.gather(1, top_i)
    sel_ids = cand.gather(1, top_i)
    return {"probs": probs, "sel_ids": sel_ids, "sel_mask": sel_mask}


def select_clusters(cfg, index, q_dense, sparse_ids, sparse_scores, *,
                    selector="lstm", stage1="overlap", theta=None,
                    selector_params=None):
    """Steps 1-2: Stage-I candidates and features, then the Stage-II
    selection. Returns the union of both stages' dicts."""
    s1 = stage1_candidates(cfg, index, q_dense, sparse_ids, sparse_scores,
                           stage1=stage1)
    s2 = stage2_select(cfg, index, s1["cand"], s1["feats"],
                       selector=selector, theta=theta,
                       selector_params=selector_params)
    return {**s1, **s2}


def _device_store(index, embeddings=None):
    """The device store that `retrieve` (embeddings None: PQStore when the
    index carries a quantizer, else InMemoryStore) and `score_selected`
    (InMemoryStore over `embeddings`) score through. Each builds a block
    table (6.4 GB at the full widths), so it is built once per index and
    reused while the index keeps the same embeddings or quantizer and
    cluster table (the JAX stores are views and build nothing)."""
    from repro_torch.engine import stores as stores_lib
    if embeddings is None and index.quantizer is not None:
        kind, src = "pq", index.quantizer
    else:
        kind = "memory"
        src = embeddings if embeddings is not None else index.embeddings
    hit = index._stores.get(kind)
    if hit is not None and hit[0] is src and hit[1] is index.cluster_docs:
        return hit[2]
    store = stores_lib.PQStore(src, index.cluster_docs) if kind == "pq" \
        else stores_lib.InMemoryStore(src, index.cluster_docs)
    index._stores[kind] = (src, index.cluster_docs, store)
    return store


def score_selected(index, q_dense, sel_ids, sel_mask, embeddings=None):
    """Step-3 dense scoring of explicit selections through an
    InMemoryStore over `embeddings` (default: the index's). Returns
    (doc_ids (B, S*cap) int32, scores with -inf at invalid, valid)."""
    from repro_torch.engine import pipeline as pipe_lib
    emb = embeddings if embeddings is not None else index.embeddings
    return pipe_lib.score_selected(_device_store(index, emb), q_dense,
                                   sel_ids, sel_mask)


def retrieve(cfg, index, q_dense, q_terms, q_weights, *, selector="lstm",
             stage1="overlap", theta=None, selector_params=None, k=None):
    """The full CluSD pipeline over the index's default device store
    (PQStore when it carries a quantizer, else InMemoryStore), built once
    per index. Returns (ids, scores, diag) as engine.pipeline.retrieve."""
    from repro_torch.engine import pipeline as pipe_lib
    return pipe_lib.retrieve(
        cfg, index, _device_store(index), q_dense, q_terms, q_weights,
        selector=selector, stage1=stage1, theta=theta,
        selector_params=selector_params, k=k)
