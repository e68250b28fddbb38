"""Synthetic MS MARCO-like corpus with *correlated* sparse and dense
relevance: documents live in latent topics; each topic owns a term
distribution, so sparse (lexical) top-k overlaps dense embedding clusters.
Queries are generated from a source document (its id is the relevance
label), enabling MRR@10 / Recall@k without external data.

A numpy copy of the JAX package's generator, loop for loop: the same
seed gives the same corpus and queries, returned as numpy arrays.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass
class Corpus:
    embeddings: np.ndarray     # (D, dim) float32, L2-normalized
    doc_terms: np.ndarray      # (D, T) int32, -1 pad
    doc_weights: np.ndarray    # (D, T) f32
    topic_of: np.ndarray       # (D,)
    vocab: int


@dataclasses.dataclass
class QuerySet:
    q_dense: np.ndarray        # (B, dim) float32
    q_terms: np.ndarray        # (B, Tq) int32
    q_weights: np.ndarray      # (B, Tq) float32
    rel_doc: np.ndarray        # (B,) ground-truth relevant doc id
    topic_of: np.ndarray       # (B,)


def synth_corpus(seed, n_docs, dim, vocab, n_topics=None, doc_terms=16,
                 terms_per_topic=64, topic_noise=0.55, bg_frac=0.25):
    rng = np.random.default_rng(seed)
    n_topics = n_topics or max(8, n_docs // 64)
    centers = rng.standard_normal((n_topics, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    topic = rng.integers(0, n_topics, n_docs)
    emb = centers[topic] + topic_noise * rng.standard_normal(
        (n_docs, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)

    topic_terms = rng.integers(0, vocab, (n_topics, terms_per_topic))
    dt = np.full((n_docs, doc_terms), -1, np.int32)
    dw = np.zeros((n_docs, doc_terms), np.float32)
    n_bg = max(1, int(doc_terms * bg_frac))
    n_tp = doc_terms - n_bg
    for d in range(n_docs):
        tt = rng.choice(topic_terms[topic[d]], n_tp, replace=False)
        bg = rng.integers(0, vocab, n_bg)
        terms = np.concatenate([tt, bg])
        w = rng.lognormal(0.0, 0.5, doc_terms).astype(np.float32)
        dt[d], dw[d] = terms, w
    return Corpus(emb, dt, dw, topic, vocab)


def synth_queries(seed, corpus: Corpus, n_queries, q_terms=8,
                  dense_noise=0.35, term_noise_frac=0.25):
    rng = np.random.default_rng(seed)
    D, dim = corpus.embeddings.shape
    src = rng.integers(0, D, n_queries)
    emb = np.asarray(corpus.embeddings)
    qd = emb[src] + dense_noise * rng.standard_normal(
        (n_queries, dim)).astype(np.float32)
    qd /= np.linalg.norm(qd, axis=1, keepdims=True)

    qt = np.full((n_queries, q_terms), -1, np.int32)
    qw = np.zeros((n_queries, q_terms), np.float32)
    n_noise = max(0, int(q_terms * term_noise_frac))
    n_doc = q_terms - n_noise
    for i, d in enumerate(src):
        dterms = corpus.doc_terms[d]
        dterms = dterms[dterms >= 0]
        pick = rng.choice(dterms, min(n_doc, len(dterms)), replace=False)
        noise = rng.integers(0, corpus.vocab, n_noise)
        terms = np.concatenate([pick, noise])[:q_terms]
        qt[i, :len(terms)] = terms
        qw[i, :len(terms)] = rng.lognormal(0.0, 0.4, len(terms))
    return QuerySet(qd, qt, qw, src, corpus.topic_of[src])


# ---------------------------------------------------------------------------
# metrics (MS MARCO-style single relevant doc)
# ---------------------------------------------------------------------------

def mrr_at(ids, rel_doc, k=10):
    """ids: (B, K) result doc ids; rel_doc: (B,)."""
    ids = np.asarray(ids)[:, :k]
    rel = np.asarray(rel_doc)[:, None]
    hit = ids == rel
    ranks = np.argmax(hit, axis=1) + 1.0
    rr = np.where(hit.any(axis=1), 1.0 / ranks, 0.0)
    return float(rr.mean())


def recall_at(ids, rel_doc, k=1000):
    ids = np.asarray(ids)[:, :k]
    rel = np.asarray(rel_doc)[:, None]
    return float((ids == rel).any(axis=1).mean())
