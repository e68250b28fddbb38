"""Sparse lexical retrieval over a padded inverted index: per-term posting
lists are impact-ordered and truncated to a static budget; scoring is a
gather of the query terms' postings and a scatter-add into a (B, D)
score buffer, then a top-k under the (score desc, index asc) rule.

Documents/queries are bags of (term_id, weight); the exact rank score is
L(q) . L(d) = sum over shared terms of qw * dw.

On CUDA the scatter-add is atomic, so the up-to-Tq contributions a doc
collects are summed in no fixed order and scores differ from the CPU's
in the last bits; ids are compared away from near-ties.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SparseIndex:
    postings_docs: torch.Tensor     # (V, P) int32, -1 padded, impact-ordered
    postings_weights: torch.Tensor  # (V, P) float32
    n_docs: int
    truncated_postings: int = 0

    @staticmethod
    def build_arrays(doc_terms, doc_weights, vocab, max_postings):
        """numpy (postings_docs, postings_weights, truncated): the same
        arrays as the JAX package's per-doc loop, built with one lexsort.

        Each term's list is ordered by (weight desc, doc desc) — the order
        of `sorted([(w, d), ...], reverse=True)` — and cut to max_postings.
        """
        doc_terms = np.asarray(doc_terms)
        doc_weights = np.asarray(doc_weights, np.float32)
        D, T = doc_terms.shape
        docs = np.repeat(np.arange(D, dtype=np.int64), T)
        terms = doc_terms.reshape(-1).astype(np.int64)
        weights = doc_weights.reshape(-1)
        keep = (terms >= 0) & (weights > 0)
        docs, terms, weights = docs[keep], terms[keep], weights[keep]
        order = np.lexsort((-docs, -weights, terms))
        docs, terms, weights = docs[order], terms[order], weights[order]
        counts = np.bincount(terms, minlength=vocab)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(terms)) - starts[terms]
        fits = rank < max_postings
        pd = np.full((vocab, max_postings), -1, np.int32)
        pw = np.zeros((vocab, max_postings), np.float32)
        pd[terms[fits], rank[fits]] = docs[fits]
        pw[terms[fits], rank[fits]] = weights[fits]
        truncated = int(np.maximum(counts - max_postings, 0).sum())
        return pd, pw, truncated

    @classmethod
    def build(cls, doc_terms, doc_weights, vocab, max_postings, *,
              device=None):
        """doc_terms: (D, T) int32 term ids (-1 pad); doc_weights: (D, T)."""
        dev = resolve_device(device)
        pd, pw, truncated = cls.build_arrays(doc_terms, doc_weights, vocab,
                                             max_postings)
        return cls(torch.from_numpy(pd).to(dev), torch.from_numpy(pw).to(dev),
                   int(np.asarray(doc_terms).shape[0]), truncated)

    def to(self, device):
        return dataclasses.replace(
            self, postings_docs=self.postings_docs.to(device),
            postings_weights=self.postings_weights.to(device))


def sparse_retrieve(index: SparseIndex, q_terms, q_weights, k):
    """q_terms: (B, Tq) int32 (-1 pad); q_weights: (B, Tq).

    Returns (top-k doc ids (B, k) int32, top-k scores (B, k), full scores
    (B, D)).
    """
    B = q_terms.shape[0]
    D = index.n_docs
    qt = q_terms.clamp(min=0).long()
    qmask = (q_terms >= 0) & (q_weights > 0)
    docs = index.postings_docs[qt]                         # (B, Tq, P)
    ws = index.postings_weights[qt]                        # (B, Tq, P)
    contrib = torch.where(qmask[..., None], ws * q_weights[..., None], 0.0)
    dmask = docs >= 0
    flat_docs = torch.where(dmask, docs, D).reshape(B, -1).long()
    flat_contrib = torch.where(dmask, contrib, 0.0).reshape(B, -1)
    scores = torch.zeros((B, D + 1), dtype=torch.float32, device=q_terms.device)
    scores.scatter_add_(1, flat_docs, flat_contrib)        # overflow row D
    scores = scores[:, :D]
    top_scores, top_ids = topk_desc_index_asc(scores, k)
    return top_ids.int(), top_scores, scores


def sparse_retrieve_topk(index: SparseIndex, q_terms, q_weights, k):
    ids, scores, _ = sparse_retrieve(index, q_terms, q_weights, k)
    return ids, scores
