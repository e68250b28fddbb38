"""Sparse lexical retrieval over a padded inverted index: per-term posting
lists are impact-ordered and truncated to a static budget; scoring is a
gather of the query terms' postings and a scatter-add into a (B, D)
score buffer, then a top-k under the (score desc, index asc) rule.

Documents/queries are bags of (term_id, weight); the exact rank score is
L(q) . L(d) = sum over shared terms of qw * dw.

A doc's contributions are summed in index order over the flattened
(Tq, P) postings, as the JAX package's segment_sum sums them. The
scatter-add runs in layers: one per query-term column t, ascending, and
within a column one per occurrence rank r of the doc in that posting
list (a list holds a doc twice when the doc holds the term twice). No
layer adds twice to one doc, so CUDA's atomic adds meet no collision
(but in the discarded overflow row D) and the card's scores are bitwise
the CPU's and the reference's.
"""

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.fusion import topk_desc_index_asc
from repro_torch.device import resolve_device

# posting lists per pass of SparseIndex.occurrence_ranks (bounds its
# (rows, P) int64 sort buffers)
_RANK_ROWS = 4096


@dataclasses.dataclass
class SparseIndex:
    postings_docs: torch.Tensor     # (V, P) int32, -1 padded, impact-ordered
    postings_weights: torch.Tensor  # (V, P) float32
    n_docs: int
    truncated_postings: int = 0
    # (rank (V, P) int8 or None, layers R): see occurrence_ranks()
    _ranks: Any = dataclasses.field(default=None, init=False, repr=False,
                                    compare=False)

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

    def assume_distinct(self):
        """Take the lists as holding each doc at most once (an index of
        docs that hold each term once, as SPLADE's doc vectors do)
        without the pass that counts it: one scatter layer a query term.
        Returns self."""
        self._ranks = (None, 1)
        return self

    def occurrence_ranks(self):
        """(rank, R): rank[t, p] counts the slots before p in term t's list
        that hold the same doc, and R is one more than the largest rank
        (1 when no list holds a doc twice; rank is then None). Computed
        once per index, on its device, _RANK_ROWS lists at a time."""
        if self._ranks is None:
            docs = self.postings_docs
            V, P = docs.shape
            rank = torch.zeros((V, P), dtype=torch.int8, device=docs.device)
            pos = torch.arange(P, device=docs.device)
            for lo in range(0, V, _RANK_ROWS):
                d = docs[lo:lo + _RANK_ROWS]
                sd, order = torch.sort(d, dim=1, stable=True)
                new_run = torch.ones_like(sd, dtype=torch.bool)
                new_run[:, 1:] = sd[:, 1:] != sd[:, :-1]
                start = torch.where(new_run, pos, 0).cummax(1).values
                r = torch.empty_like(order).scatter_(1, order, pos - start)
                r = torch.where(d >= 0, r, 0)
                if r.numel() and int(r.max()) > 127:
                    raise ValueError("a posting list holds a doc more than "
                                     "128 times")
                rank[lo:lo + _RANK_ROWS] = r.to(torch.int8)
            R = int(rank.max()) + 1 if rank.numel() else 1
            self._ranks = (rank if R > 1 else None, R)
        return self._ranks


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
    docs = torch.where(dmask, docs, D).long()              # overflow row D
    contrib = torch.where(dmask, contrib, 0.0)
    rank, R = index.occurrence_ranks()
    rk = None if rank is None else rank[qt]                # (B, Tq, P)
    scores = torch.zeros((B, D + 1), dtype=torch.float32, device=q_terms.device)
    for t in range(docs.shape[1]):
        for r in range(R):
            at = docs[:, t] if rk is None \
                else torch.where(rk[:, t] == r, docs[:, t], D)
            scores.scatter_add_(1, at, contrib[:, t])
    scores = scores[:, :D]
    top_scores, top_ids = topk_desc_index_asc(scores, k)
    return top_ids.int(), top_scores, scores


def sparse_retrieve_topk(index: SparseIndex, q_terms, q_weights, k):
    ids, scores, _ = sparse_retrieve(index, q_terms, q_weights, k)
    return ids, scores
