"""Offline index build CLI: cluster, pack, and serialize once — then serve
from the built directory without rebuilding, and mutate it later with
`repro_torch.launch.update_index` (incremental deltas). Runs on the CUDA
card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.build_index --out /tmp/idx \
      --docs 20000 --clusters 256 --shards 8 --train-queries 512

  # format v2: PQ code shards (4-16x smaller embedding store), built from
  # an np.memmap staged corpus with bounded-chunk reads (corpus > RAM path)
  PYTHONPATH=src python -m repro_torch.launch.build_index --out /tmp/idx_pq \
      --format-version 2 --pq-nsub 8 --memmap --chunk-docs 4096

Key flags (the full list with defaults is below / `--help`):
  --format-version {1,2}  1 = float32 block shards; 2 = PQ code shards +
                          CSR postings (served via the ADC kernels)
  --memmap                stage the synthetic corpus through an np.memmap
                          and build from it — the corpus>RAM path (LSTM
                          label generation still uses in-RAM embeddings)
  --chunk-docs N          bound every embedding read to N rows (0 = one
                          k-means shard per read)
  --pq-nsub N             PQ subspaces (v1: optional side artifacts;
                          v2: the code shards; defaults to 8 under v2)
  --device DEV            torch device (default: the CUDA card)

Pipeline (repro_torch/index/builder.py): sharded Lloyd's k-means over
embedding shards -> capacity-balanced cluster table -> neighbor graph ->
sparse inverted index -> optional LSTM selector training (`make_labels`
over the in-RAM embeddings, then `train_selector`) -> optional PQ
codebooks -> per-shard cluster-block (v1) or code-block (v2) files +
versioned, checksummed, generation-0 manifest that carries the
synthetic-corpus recipe under `extra`. The k-means seed rows, the
selector's initial params and the PQ sample are drawn from
torch.Generators seeded from --seed (the JAX CLI draws from jax.random,
so the two builds differ; either package reads the other's directory).
"""

import argparse
import dataclasses
import math
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import index as index_lib
from repro_torch.configs import get_config
from repro_torch.core import train_lstm as tl
from repro_torch.data import synth_corpus, synth_queries


def build_cfg(args):
    k_sparse = max(32, min(512, args.docs // 4))
    bins = tuple(b for b in (10, 25, 50, 100, 200) if b < k_sparse) + (k_sparse,)
    return dataclasses.replace(
        get_config("clusd-msmarco", "smoke"),
        n_docs=args.docs, dim=args.dim, n_clusters=args.clusters,
        vocab=args.vocab, k_sparse=k_sparse, bins=bins,
        n_candidates=min(32, args.clusters), max_selected=16,
        k_final=min(256, args.docs),
        train_queries=args.train_queries, epochs=args.epochs)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Build a persistent CluSD index offline (cluster, "
                    "pack, serialize + checksummed manifest).",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="index output directory")
    ap.add_argument("--docs", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--clusters", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--shards", type=int, default=4,
                    help="block shard files (and k-means embedding shards)")
    ap.add_argument("--train-queries", type=int, default=512,
                    help="0 skips LSTM selector training")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--pq-nsub", type=int, default=0,
                    help="train PQ codebooks with this many subspaces "
                         "(v1: extra pq/ artifacts; v2: the code shards; "
                         "defaults to 8 under --format-version 2)")
    ap.add_argument("--format-version", type=int, default=1, choices=(1, 2),
                    help="1 = float32 block shards, 2 = PQ code shards")
    ap.add_argument("--memmap", action="store_true",
                    help="stage embeddings through an np.memmap and build "
                         "from it (the corpus>RAM path; LSTM label "
                         "generation still uses in-RAM embeddings)")
    ap.add_argument("--chunk-docs", type=int, default=0,
                    help="bound every embedding read to this many rows "
                         "(0 = per-shard granularity)")
    ap.add_argument("--kmeans-iters", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device for clustering, labels, training and "
                         "PQ (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.convert import selector_from_numpy
    from repro_torch.core import quant as quant_lib
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)

    cfg = build_cfg(args)
    t0 = time.perf_counter()
    print(f"corpus: {cfg.n_docs} docs x {cfg.dim} dim; device {dev} ...",
          flush=True)
    corpus = synth_corpus(args.seed, cfg.n_docs, cfg.dim, cfg.vocab)
    emb = np.asarray(corpus.embeddings)
    staged = None
    if args.memmap:
        staged = os.path.join(tempfile.mkdtemp(), "embeddings.bin")
        np.asarray(emb, np.float32).tofile(staged)
        emb = np.memmap(staged, dtype=np.float32, mode="r", shape=emb.shape)
        print(f"staged embeddings -> np.memmap {staged}", flush=True)

    shard_docs = math.ceil(cfg.n_docs / max(1, args.shards))
    if args.chunk_docs > 0:
        shard_docs = min(shard_docs, args.chunk_docs)
    print(f"clustering: {cfg.n_clusters} clusters over "
          f"{args.shards} embedding shard(s) ...", flush=True)
    index = index_lib.build_index_offline(
        cfg, emb, corpus.doc_terms, corpus.doc_weights,
        shard_docs=shard_docs, kmeans_iters=args.kmeans_iters,
        generator=torch.Generator().manual_seed(args.seed), device=dev)

    if args.train_queries > 0:
        print(f"training LSTM selector on {args.train_queries} queries ...",
              flush=True)
        # labels need full dense retrieval — offline-only embedding use
        index.embeddings = torch.from_numpy(
            np.asarray(corpus.embeddings, np.float32)).to(dev)
        tq = synth_queries(args.seed + 1, corpus, args.train_queries)
        _, feats, labels = tl.make_labels(cfg, index, tq.q_dense, tq.q_terms,
                                          tq.q_weights)
        params, hist = tl.train_selector(
            cfg, torch.Generator().manual_seed(args.seed + 2), feats, labels,
            device=dev)
        index.selector = selector_from_numpy(
            {k: v.cpu().numpy() for k, v in params.items()}, device=dev)
        print(f"  loss {hist[0]:.4f} -> {hist[-1]:.4f}", flush=True)
        index.embeddings = None

    chunk_docs = args.chunk_docs or index_lib.builder.DEFAULT_CHUNK_DOCS
    pq_nsub = args.pq_nsub or (8 if args.format_version == 2 else 0)
    if pq_nsub > 0:
        print(f"training PQ codebooks (nsub={pq_nsub}) ...", flush=True)
        # streaming train/encode: bounded-chunk reads off the (possibly
        # memmap) source, so the v2 path never materializes the matrix
        index.quantizer = quant_lib.train_pq_stream(
            emb, pq_nsub, chunk_docs=chunk_docs,
            generator=torch.Generator().manual_seed(args.seed + 3),
            device=dev)

    manifest = index_lib.write_index(
        args.out, cfg, index, emb, n_shards=args.shards,
        format_version=args.format_version, chunk_docs=chunk_docs,
        extra={"corpus": {"kind": "synthetic", "seed": args.seed,
                          "n_docs": cfg.n_docs, "dim": cfg.dim,
                          "vocab": cfg.vocab}})
    if staged is not None:
        del emb
        os.remove(staged)
        os.rmdir(os.path.dirname(staged))
    wall = time.perf_counter() - t0
    g = manifest["geometry"]
    print(f"wrote {args.out} (format v{manifest['format_version']}): "
          f"{manifest['total_bytes'] / 2**20:.1f} MiB, "
          f"{len(manifest['block_shards'])} block shard(s), "
          f"N={g['n_clusters']} cap={g['cap']} dim={g['dim']}, "
          f"lstm={'yes' if manifest['lstm'] else 'no'}, "
          f"pq={'yes' if manifest['pq'] else 'no'}, "
          f"build {wall:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
