"""Shared helpers of the port's parity tests: build state with the JAX
package at smoke widths and carry it across to repro_torch as numpy."""

import numpy as np
import torch

# The suite runs test files in parallel worker processes: a small torch
# intra-op pool keeps these CPU tests from oversubscribing the cores that
# timing-sensitive tests in the other workers share.
torch.set_num_threads(2)


def as_tensor(x):
    """A torch tensor over a writable copy of x (numpy or jax array)."""
    return torch.from_numpy(np.array(x))


def jax_smoke_state(seed=0, *, with_selector=True, **cfg_overrides):
    """(jax cfg, jax CluSDIndex, corpus) at clusd_msmarco.smoke() widths,
    with lstm_init params when `with_selector`."""
    import dataclasses

    import jax

    from repro.configs import get_config
    from repro.core import clusd as cl
    from repro.core.features import feature_dim
    from repro.core.lstm import lstm_init
    from repro.data import synth_corpus

    cfg = get_config("clusd-msmarco", "smoke")
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    corpus = synth_corpus(seed, cfg.n_docs, cfg.dim, cfg.vocab)
    index = cl.build_index(cfg, jax.random.key(seed), corpus.embeddings,
                           corpus.doc_terms, corpus.doc_weights)
    if with_selector:
        index.lstm_params = lstm_init(jax.random.key(seed + 1),
                                      feature_dim(cfg), cfg.lstm_hidden)
    return cfg, index, corpus


def index_arrays(index):
    """A JAX CluSDIndex's fields as numpy, in repro_torch.convert's keys."""
    out = {k: np.asarray(getattr(index, k))
           for k in ("centroids", "cluster_docs", "doc_cluster",
                     "neighbor_ids", "neighbor_sims", "bin_ids")}
    out["sparse_postings_docs"] = np.asarray(index.sparse_index.postings_docs)
    out["sparse_postings_weights"] = np.asarray(
        index.sparse_index.postings_weights)
    out["n_docs"] = index.sparse_index.n_docs
    if index.lstm_params is not None:
        out["lstm_params"] = {k: np.asarray(v)
                              for k, v in index.lstm_params.items()}
    return out


def torch_cfg(jax_cfg):
    """The port's CluSDConfig with the same field values."""
    import dataclasses

    from repro_torch.configs import CluSDConfig
    return CluSDConfig(**dataclasses.asdict(jax_cfg))


def isolated_ranks(scores, tol=1e-5):
    """(B, k) bool: ranks whose score is more than `tol` from both
    neighbours' (the last rank has an unseen neighbour and is left out).
    Ids at these ranks must agree across implementations."""
    s = np.asarray(scores, np.float64)
    gap_next = np.abs(s[:, :-1] - s[:, 1:])
    ok = np.zeros(s.shape, bool)
    ok[:, :-1] = gap_next > tol
    ok[:, 1:-1] &= gap_next[:, :-1] > tol
    return ok
