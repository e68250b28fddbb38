"""Quickstart on the PyTorch port: CluSD end to end (the card by default,
`--device cpu` to run on the CPU).

Builds a synthetic corpus with correlated sparse/dense relevance, clusters
the embeddings, trains the Stage-II LSTM selector the way the paper does
(positives = clusters holding top-10 full-dense results), then answers
queries with selective fusion and compares against full retrieval.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import selector_from_numpy
from repro_torch.core import clusd as cl
from repro_torch.core import sparse as sparse_lib
from repro_torch.core import train_lstm as tl
from repro_torch.data import mrr_at, recall_at, synth_corpus, synth_queries
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("clusd-msmarco", "smoke")
    print(f"corpus: {cfg.n_docs} docs, dim={cfg.dim}, N={cfg.n_clusters} "
          f"clusters (cap {cfg.cluster_cap}) on {dev}")
    corpus = synth_corpus(0, cfg.n_docs, cfg.dim, cfg.vocab)
    index = cl.build_index(cfg, corpus.embeddings, corpus.doc_terms,
                           corpus.doc_weights,
                           generator=torch.Generator().manual_seed(0),
                           device=dev)
    index.embeddings = torch.from_numpy(corpus.embeddings).to(dev)

    # --- train the Stage-II LSTM (paper §2.3) ---
    train_q = synth_queries(1, corpus, cfg.train_queries)
    _, feats, labels = tl.make_labels(cfg, index, train_q.q_dense,
                                      train_q.q_terms, train_q.q_weights)
    params, hist = tl.train_selector(
        cfg, torch.Generator().manual_seed(2), feats, labels, epochs=30,
        batch_size=32, lr=0.01, device=dev)
    index.selector = selector_from_numpy(
        {k: v.detach().cpu().numpy() for k, v in params.items()},
        device=dev)
    print(f"LSTM: BCE {hist[0]:.4f} -> {hist[-1]:.4f}")

    # --- retrieve through the engine pipeline over an explicit store ---
    # (cl.retrieve is the same call over the index's default store; swap
    #  in a DiskStore or PQStore unchanged)
    from repro_torch import engine as eng
    from repro_torch.engine import pipeline as pipe_lib
    qs = synth_queries(9, corpus, 64)
    qd = torch.from_numpy(qs.q_dense).to(dev)
    qt = torch.from_numpy(qs.q_terms).to(dev)
    qw = torch.from_numpy(qs.q_weights).to(dev)
    store = eng.InMemoryStore(index.embeddings, index.cluster_docs)
    with torch.no_grad():
        ids, scores, diag = pipe_lib.retrieve(cfg, index, store, qd, qt, qw)
    dense_ids, _ = cl.full_dense_topk(index.embeddings, qd, 64)
    sparse_ids, _ = sparse_lib.sparse_retrieve_topk(
        index.sparse_index, qt, qw, cfg.k_sparse)
    ids, dense_ids, sparse_ids = (np.asarray(x.cpu())
                                  for x in (ids, dense_ids, sparse_ids))

    print(f"\n{'retriever':24s} {'MRR@10':>8s} {'R@64':>7s} {'%corpus':>8s}")
    print(f"{'dense only':24s} {mrr_at(dense_ids, qs.rel_doc):8.4f} "
          f"{recall_at(dense_ids, qs.rel_doc, 64):7.4f} {'100.0':>8s}")
    print(f"{'sparse only':24s} {mrr_at(sparse_ids, qs.rel_doc):8.4f} "
          f"{recall_at(sparse_ids, qs.rel_doc, 64):7.4f} {'0.0':>8s}")
    pct = 100 * float(diag["frac_docs_scanned"].mean())
    print(f"{'S + CluSD':24s} {mrr_at(ids, qs.rel_doc):8.4f} "
          f"{recall_at(ids, qs.rel_doc, 64):7.4f} {pct:8.2f}")
    print(f"\navg clusters selected: "
          f"{float(diag['n_selected'].float().mean()):.1f} of "
          f"{cfg.n_clusters}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
