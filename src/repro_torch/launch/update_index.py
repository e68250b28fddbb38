"""Incremental index update CLI: apply an upsert/delete delta to a built
index as a new atomic generation, optionally hot-reloading a serving
engine across the commit and parity-checking the result. Runs on the
CUDA card unless `--device cpu` is given.

  # apply a localized synthetic delta (5% upserts / 2% deletes of a
  # 20k-doc index), serving 8 queries before AND after the commit through
  # one engine that hot-reloads between them, then parity-check against
  # a compacted (from-scratch serialized) copy:
  PYTHONPATH=src python -m repro_torch.launch.update_index \
      --index-dir /tmp/idx --upserts 1000 --deletes 400 --serve-queries 8 \
      --check-parity

  # fold tombstones + generations back into a clean layout:
  PYTHONPATH=src python -m repro_torch.launch.update_index \
      --index-dir /tmp/idx --compact

The synthetic delta is **shard-localized**, the way a production updater
batches churn: upserted docs are placed near centroids of a small prefix
of target shards (replacements pull existing docs toward their own
centroid; appends spawn near centroids with free capacity), and every
candidate is pre-checked against the full centroid table so its nearest
cluster really falls inside the target shards. Deletes are free
(tombstones — zero shard bytes rewritten), so they are sampled anywhere.
`synth_delta` gives the JAX package's delta for the same directory and
seed.

Works on both on-disk formats: v1 float-block indexes re-pack only the
touched shards; v2 PQ indexes re-encode touched shards against the
EXISTING codebooks. A delta stamped for the wrong format version is
rejected up front (IndexFormatError), and so is an int8 v1 index.

--check-parity compacts a copy of the updated index (which by the
repro_torch.index.update invariant equals a from-scratch serialization
of the same logical state) and verifies both serve identical top-k ids.
"""

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch import index as index_lib
from repro_torch.index import update as update_lib

# a candidate's nearest-centroid test is decided by the float64 screen
# when the in-range and out-of-range minima of its squared distances lie
# this far apart: the float32 elementwise sums the JAX package compares
# are each within about 3e-6 of the exact value for rows of norm <= 1 at
# dim <= 1024 (a squared difference's rounding plus a pairwise sum's)
_SCREEN_MARGIN = 1e-4


def _nearest_in_range(centroids, c64, c2, v, hi_cluster):
    """int(np.argmin(((centroids - v) ** 2).sum(axis=1))) < hi_cluster,
    the JAX package's test, decided by a float64 matvec where its margin
    is clear and by that float32 expression itself otherwise."""
    if hi_cluster >= len(centroids):
        return True
    d2 = c2 - 2.0 * (c64 @ v.astype(np.float64))
    lo_min, hi_min = d2[:hi_cluster].min(), d2[hi_cluster:].min()
    if abs(lo_min - hi_min) > _SCREEN_MARGIN:
        return bool(lo_min < hi_min)
    return int(np.argmin(((centroids - v) ** 2).sum(axis=1))) < hi_cluster


def synth_delta(reader, n_upserts, n_deletes, *, seed=0, append_frac=0.3,
                target_shards=None, doc_terms=16, noise=0.15):
    """Build a shard-localized synthetic IndexDelta against a built index.

    Upsert vectors are drawn near centroids of the first `target_shards`
    shards (default: the smallest prefix with enough free capacity), with
    per-cluster placement capped by live headroom and each candidate's
    nearest centroid verified to stay inside the target range. Pure
    numpy, draw for draw the JAX package's: the same directory and seed
    give the same delta. Returns (delta, info)."""
    rng = np.random.default_rng(seed)
    geom = reader.geometry
    D, dim, cap = geom["n_docs"], geom["dim"], geom["cap"]
    vocab = reader.config().vocab
    centroids = np.asarray(reader.array("centroids"), np.float32)
    c64 = centroids.astype(np.float64)
    c2 = (c64 * c64).sum(axis=1)
    masked = reader.masked_cluster_docs()
    fill = (masked >= 0).sum(axis=1)
    free = cap - fill
    ranges = [(s["cluster_lo"], s["cluster_hi"])
              for s in reader.manifest["block_shards"]]

    n_app = int(round(n_upserts * append_frac))
    n_rep = n_upserts - n_app
    if target_shards is None:
        # smallest shard prefix whose free capacity covers the appends (and
        # whose live docs cover the replacements) with 2x headroom
        target_shards = 1
        while target_shards < len(ranges):
            hi = ranges[target_shards - 1][1]
            if (free[:hi].sum() >= 2 * n_app
                    and fill[:hi].sum() >= 2 * n_rep):
                break
            target_shards += 1
    hi_cluster = ranges[target_shards - 1][1]

    def spawn_near(c):
        """Unit vector near centroid c, perturbed by a `noise` fraction of
        the centroid's norm, resampled until its true nearest centroid
        stays in the target shard range. Returns None if it will not stay
        put."""
        scale = noise * max(float(np.linalg.norm(centroids[c])), 1e-9)
        for _ in range(8):
            g = rng.standard_normal(dim).astype(np.float32)
            v = centroids[c] + scale * g / max(float(np.linalg.norm(g)),
                                               1e-9)
            v /= max(float(np.linalg.norm(v)), 1e-9)
            if _nearest_in_range(centroids, c64, c2, v, hi_cluster):
                return v
        return None

    # replacements: live docs of target clusters get an "edited" vector
    # near their own centroid (verified to stay inside the target shards)
    live_docs = masked[:hi_cluster]
    live_docs = live_docs[live_docs >= 0]
    if n_rep > len(live_docs):
        raise ValueError(f"not enough live docs in {target_shards} target "
                         f"shard(s) for {n_rep} replacements")
    rep_ids = rng.choice(live_docs, n_rep, replace=False).astype(np.int64)
    doc_cluster = np.asarray(reader.array("doc_cluster"))
    vecs, ids = [], []
    headroom = free.astype(np.int64).copy()
    for d in rep_ids:
        v = spawn_near(int(doc_cluster[d]))
        if v is not None:
            vecs.append(v)
            ids.append(int(d))
    n_rep_made = len(ids)
    # appends: spawn near target centroids with free capacity
    next_id = D
    order = np.argsort(-headroom[:hi_cluster], kind="stable")
    oi = 0
    made = 0
    attempts = 0
    while made < n_app and attempts < 16 * n_app:
        attempts += 1
        c = int(order[oi % len(order)])
        oi += 1
        if headroom[c] <= 0:
            continue
        v = spawn_near(c)
        if v is None:
            continue
        headroom[c] -= 1
        vecs.append(v)
        ids.append(next_id)
        next_id += 1
        made += 1

    terms = rng.integers(0, vocab, (len(ids), doc_terms)).astype(np.int32)
    weights = rng.lognormal(0.0, 0.5, (len(ids), doc_terms)).astype(
        np.float32)
    del_pool = np.setdiff1d(np.flatnonzero(doc_cluster >= 0),
                            np.asarray(ids, np.int64))
    delete_ids = rng.choice(del_pool, min(n_deletes, len(del_pool)),
                            replace=False).astype(np.int64)
    delta = index_lib.IndexDelta(
        upsert_ids=np.asarray(ids, np.int64),
        upsert_embeddings=np.asarray(vecs, np.float32),
        upsert_terms=terms, upsert_weights=weights, delete_ids=delete_ids)
    return delta, {"target_shards": target_shards,
                   "n_replacements": n_rep_made, "n_appends": made,
                   "n_deletes": int(len(delete_ids))}


def _synthetic_queries(reader, n_queries):
    """Regenerate evaluation queries from the index's synthetic-corpus
    recipe (the original generation-0 corpus is enough: queries are just
    vectors + terms)."""
    from repro_torch.data import recipe_corpus, synth_queries
    meta = reader.manifest.get("extra", {}).get("corpus")
    if meta is None or meta.get("kind") != "synthetic":
        raise SystemExit("index lacks synthetic-corpus metadata; cannot "
                         "generate queries (--serve-queries/--check-parity "
                         "need it)")
    return synth_queries(9, recipe_corpus(meta), n_queries)


def _serve(engine, qs, n, batch):
    out = []
    for lo in range(0, n, batch):
        ids, _ = engine.retrieve(qs.q_dense[lo:lo + batch],
                                 qs.q_terms[lo:lo + batch],
                                 qs.q_weights[lo:lo + batch])
        out.append(ids.cpu().numpy())
    return np.concatenate(out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Apply an incremental upsert/delete delta to a built "
                    "index (new atomic generation), hot-reload a serving "
                    "engine across it, compact, and parity-check.",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--index-dir", required=True,
                    help="built index (repro_torch.index.write_index, or "
                         "either package's build)")
    ap.add_argument("--upserts", type=int, default=0,
                    help="synthetic upserts to apply (replacements + "
                         "appends, shard-localized)")
    ap.add_argument("--deletes", type=int, default=0,
                    help="synthetic deletes (tombstoned: zero shard-byte "
                         "rewrites)")
    ap.add_argument("--append-frac", type=float, default=0.3,
                    help="fraction of upserts that append new doc ids "
                         "(rest replace existing docs in place)")
    ap.add_argument("--target-shards", type=int, default=None,
                    help="localize upserts to this many shards (default: "
                         "smallest prefix with enough capacity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", default="size",
                    choices=("none", "size", "full"),
                    help="integrity check level when opening the index")
    ap.add_argument("--serve-queries", type=int, default=0,
                    help="serve N queries through ONE engine before and "
                         "after the delta commit, hot-swapping generations "
                         "with engine.reload_index() in between (no "
                         "restart, cache invalidated)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--check-parity", action="store_true",
                    help="compact a COPY of the updated index (equals a "
                         "from-scratch serialization of the same logical "
                         "state) and require identical served top-k ids")
    ap.add_argument("--compact", action="store_true",
                    help="after any delta: fold tombstones + generations "
                         "into a clean single-generation layout, in place")
    ap.add_argument("--recluster-overflow", type=float, default=0.5,
                    help="re-cluster a shard locally when this fraction of "
                         "its targeted upserts overflowed their nearest "
                         "cluster")
    ap.add_argument("--recluster-min-overflow", type=int, default=4,
                    help="...and at least this many overflowed")
    ap.add_argument("--lloyd-iters", type=int, default=4,
                    help="local Lloyd's iterations for shard re-clustering")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export per-phase spans of the delta commit / "
                         "compaction (and any serve batches) after the run "
                         "(.jsonl span lines or Chrome trace JSON)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the serving engine's metrics registry "
                         "(.prom/.txt = Prometheus text, else JSON)")
    ap.add_argument("--device", default=None,
                    help="torch device for serving, upsert encoding and "
                         "the neighbor graph (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.obs import (MetricsRegistry, Tracer, write_metrics,
                                 write_trace)
    dev = resolve_device(args.device)
    tracer = Tracer(sample_rate=1.0) if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics_out else None

    reader = index_lib.IndexReader.open(args.index_dir, verify=args.verify)
    print(f"index: {reader.index_dir} (format v{reader.format_version}, "
          f"generation {reader.generation}, "
          f"{reader.geometry['n_docs']} docs, "
          f"{len(reader.manifest['block_shards'])} shard(s)); device {dev}")

    engine, qs, pre_ids = None, None, None
    if args.serve_queries > 0:
        qs = _synthetic_queries(reader, args.serve_queries)
        engine = reader.engine(max_batch=args.batch, metrics=metrics,
                               tracer=tracer, device=dev)
        pre_ids = _serve(engine, qs, args.serve_queries, args.batch)
        print(f"served {args.serve_queries} queries on generation "
              f"{reader.generation}")

    report = None
    if args.upserts or args.deletes:
        delta, info = synth_delta(
            reader, args.upserts, args.deletes, seed=args.seed,
            append_frac=args.append_frac, target_shards=args.target_shards)
        report = update_lib.write_index_delta(
            args.index_dir, delta, verify="none",
            recluster_overflow=args.recluster_overflow,
            recluster_min_overflow=args.recluster_min_overflow,
            lloyd_iters=args.lloyd_iters, tracer=tracer, device=dev)
        print(f"committed generation {report['generation']}: "
              f"{report['n_upserts']} upserts "
              f"({report['n_replaced']} replace, "
              f"{report['n_appended']} append; "
              f"{info['target_shards']} target shard(s)), "
              f"{report['n_deletes']} deletes -> "
              f"{len(report['shards_rewritten'])}/{report['n_shards']} "
              f"shards rewritten "
              f"({report['bytes_rewritten_frac']:.0%} of shard bytes), "
              f"reclustered {report['reclustered_shards']}, "
              f"{report['wall_s']:.2f}s")

    if engine is not None:
        gen = engine.reload_index()
        post_ids = _serve(engine, qs, args.serve_queries, args.batch)
        st = engine.stats()
        engine.close()
        assert post_ids.shape == pre_ids.shape
        print(f"hot-reloaded to generation {gen}: served "
              f"{args.serve_queries} more queries, 0 failed requests, "
              f"cache cleared {st['cache']['clears']}x "
              f"(reloads={st['reloads']})")

    rc = 0
    if args.check_parity:
        # the copy sits beside the index: it is as large as the index
        tmp = tempfile.mkdtemp(
            dir=os.path.dirname(os.path.abspath(args.index_dir)))
        copy_dir = os.path.join(tmp, "compacted")
        shutil.copytree(args.index_dir, copy_dir)
        update_lib.compact_index(copy_dir, device=dev)
        if qs is None:
            qs = _synthetic_queries(reader, args.batch)
        nq = int(np.asarray(qs.q_dense).shape[0])
        reader.refresh()
        with reader.engine(max_batch=args.batch, device=dev) as live_eng:
            live_ids = _serve(live_eng, qs, nq, args.batch)
        with index_lib.IndexReader.open(copy_dir).engine(
                max_batch=args.batch, device=dev) as comp_eng:
            comp_ids = _serve(comp_eng, qs, nq, args.batch)
        if np.array_equal(live_ids, comp_ids):
            print(f"parity OK: updated index == compacted (from-scratch "
                  f"serialized) index on {nq} queries")
        else:
            bad = int((live_ids != comp_ids).any(axis=1).sum())
            print(f"PARITY FAIL: {bad}/{nq} queries differ between the "
                  f"incrementally-updated index and its compaction")
            rc = 1
        shutil.rmtree(tmp, ignore_errors=True)

    if args.compact:
        t0 = time.perf_counter()
        manifest = update_lib.compact_index(args.index_dir, tracer=tracer,
                                            device=dev)
        print(f"compacted -> generation {manifest['generation']} "
              f"({manifest['total_bytes'] / 2**20:.1f} MiB, "
              f"{time.perf_counter() - t0:.2f}s)")

    if metrics is not None:
        write_metrics(metrics, args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if tracer is not None:
        write_trace(tracer, args.trace_out)
        print(f"trace -> {args.trace_out} ({tracer.started} trace(s))")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
