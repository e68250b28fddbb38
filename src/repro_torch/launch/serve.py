"""CluSD serving driver on the port's RetrievalEngine (repro_torch.engine).
Runs on the CUDA card unless `--device cpu` is given.

Builds the index over a synthetic corpus, trains the Stage-II LSTM, then
serves batched queries through `RetrievalEngine` — one select/score/fuse
pipeline (engine/pipeline.py) behind a pluggable ClusterStore backend:

  * default: the device InMemoryStore; request batches are padded to
    power-of-two buckets, as the JAX engine pads them for its compiles.
  * --ondisk: DiskStore backend with a bounded LRU block cache and a
    background thread prefetching Stage-I candidate blocks while Stage-II
    LSTM selection runs; reports I/O ops/bytes and cache hit rate.

Reports latency percentiles and quality vs the full-retrieval oracle.

With --index-dir, the build step is skipped entirely: the engine serves a
persistent index built by either package's build_index — the manifest
is validated (at the --verify level: none/size/full), arrays are
mmapped, and cluster blocks are read from the per-shard files through a
`ShardedDiskStore` (v1 float blocks, the cluster_score kernel) or
`ShardedPQStore` (v2 PQ code shards, scored by the ADC kernels). Indexes
mutated by `repro_torch.launch.update_index` serve their newest
generation; deleted docs are tombstone-masked at fetch.

--check-parity replays the queries through the in-memory pipeline and
exits non-zero on mismatch: exact top-k ids for v1 indexes; for v2 (PQ)
indexes — approximate by construction — parity is an MRR@10 delta bound,
tunable with --parity-mrr-tol (default 0.02).

--trace-out exports per-batch stage-span traces (stage1 -> stage2_select
-> cache/disk fetch -> fused_score_topk; `.jsonl` span lines or Chrome
trace JSON for Perfetto), sampled at --trace-sample-rate; --metrics-out
dumps the engine metrics registry (JSON or Prometheus text by suffix).

Live observability (with --index-dir): --metrics-port P starts an HTTP
exporter over the serving engine/router BEFORE the first batch — GET
/metrics (Prometheus text), /metrics.json, /slo, /healthz (503 while the
SLO state is PAGE or any shard has lost every replica); P=0 binds an
ephemeral port (printed). --slo-config PATH loads declarative SLO
objectives (JSON {"objectives": [...]}) into an SLOMonitor judging the
run — without it --metrics-port uses the default objective set.
--explain-out PATH.jsonl emits sampled per-query explain records
(candidate provenance, selector probs vs theta/budget, fusion
contributions, per-host attribution on the router path) at
--explain-sample-rate. --serve-seconds S keeps replaying the query set
until the deadline so the endpoints stay live under sustained traffic.

--hosts N (with --index-dir) serves through the multi-host scatter-gather
tier (engine/router.py) instead of a single engine: a ShardRouter runs
sparse retrieval + Stage I/II and scatters the selected clusters to N
hosts in this process, each owning a balanced subset of the index block
shards behind its own store + cache and scoring on the device; per-host
partial top-k lists merge under the exact (score desc, doc id asc) rule
and fuse with the sparse side — bitwise-identical results to the
single-host engine under interp fusion. --replication R places each
shard on R hosts (replica failover); --host-timeout-ms bounds each
scatter leg; --kill-host I kills host I after the first batch (fault
injection: with R >= 2 serving must continue with zero failed requests).
--check-parity on this path replays the queries through a single-host
engine and exits non-zero on any id mismatch. Router traces add
scatter/gather/merge spans and each host's spans on its own lane.

--fusion overrides the final-list fusion method (interp = paper min-max
interpolation, rrf = weighted reciprocal-rank fusion); --expand-depth N
deepens Stage-I candidates through the cluster neighbor graph (N extra
n_candidates blocks of clusters considered per query at the same
selection budget). Both default to the served config (a calibrated
publish may have set them); depth 0 + interp is the classic pipeline.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --docs 20000 \
      --queries 256 [--ondisk] [--cache-blocks 512] [--no-prefetch] \
      [--fusion interp|rrf] [--expand-depth N] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --index-dir /tmp/idx \
      --queries 64 [--verify full] [--check-parity [--parity-mrr-tol T]] \
      [--trace-out trace.jsonl] [--metrics-out metrics.json]
  PYTHONPATH=src python -m repro_torch.launch.serve --index-dir /tmp/idx \
      --hosts 3 --replication 2 [--host-timeout-ms 10000] [--kill-host 0] \
      --check-parity [--trace-out trace.jsonl]
"""

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.data import mrr_at, recall_at, synth_queries
from repro_torch.launch.train_selector import _synthetic_corpus


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _apply_hybrid_flags(cfg, args):
    """Overlay --fusion / --expand-depth on the served config (None =
    keep what the config/manifest says, e.g. a calibrated publish)."""
    changes = {}
    if args.fusion is not None:
        changes["fusion"] = args.fusion
    if args.expand_depth is not None:
        changes["expand_depth"] = args.expand_depth
    return dataclasses.replace(cfg, **changes) if changes else cfg


def _write_obs(args, engine):
    """Export --metrics-out / --trace-out from a served engine or router."""
    from repro_torch.obs import write_metrics, write_trace
    if args.metrics_out:
        engine.stats()          # folds cache/io counters into gauges
        write_metrics(engine.metrics, args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        write_trace(engine.tracer, args.trace_out)
        print(f"trace -> {args.trace_out} "
              f"({engine.tracer.started} trace(s) at "
              f"sample rate {engine.tracer.sample_rate})")


def _make_explain(args):
    """--explain-out: a sampled per-query ExplainLogger for the engine or
    router (None when the flag is absent)."""
    if not getattr(args, "explain_out", None):
        return None
    from repro_torch.obs import ExplainLogger
    return ExplainLogger(args.explain_out,
                         sample_rate=args.explain_sample_rate)


def _start_exporter(args, target):
    """--metrics-port / --slo-config: attach an SLOMonitor and start the
    live HTTP endpoint over the serving target. Returns (exporter, slo),
    either of which may be None."""
    from repro_torch.obs import MetricsExporter, SLOMonitor, default_objectives
    slo = None
    if getattr(args, "slo_config", None):
        slo = SLOMonitor.from_config(target.metrics, args.slo_config)
    elif args.metrics_port is not None:
        slo = SLOMonitor(target.metrics, default_objectives())
    exp = None
    if args.metrics_port is not None:
        exp = MetricsExporter(target, port=args.metrics_port,
                              slo=slo).start()
        print(f"metrics endpoint: http://127.0.0.1:{exp.port}/metrics "
              f"(also /metrics.json /slo /healthz)", flush=True)
    return exp, slo


def _finish_obs(args, exporter, slo, explain):
    """Tear down the live observability attachments, reporting state."""
    if slo is not None:
        slo.evaluate()
        print(f"SLO state: {slo.state} "
              f"(pages={slo.verdict()['pages']}, "
              f"warns={slo.verdict()['warns']})")
    if exporter is not None:
        exporter.stop()
    if explain is not None:
        explain.close()
        st = explain.stats()
        print(f"explain -> {st['path']} ({st['n_records']} record(s), "
              f"{st['n_sampled']}/{st['n_sampled'] + st['n_skipped']} "
              f"batches sampled)")


def _sustain(args, serve_pass, slo=None):
    """--serve-seconds: keep replaying the query set until the deadline
    (keeps the metrics endpoints live under sustained traffic)."""
    if not args.serve_seconds:
        return
    deadline = time.monotonic() + args.serve_seconds
    passes = 0
    while time.monotonic() < deadline:
        serve_pass(deadline)
        passes += 1
        if slo is not None:
            slo.evaluate()
    print(f"sustained serving: {passes} extra pass(es) over "
          f"{args.serve_seconds:.0f}s window")


def _batches(args, test_q):
    for i in range(0, args.queries, args.batch):
        yield (test_q.q_dense[i:i + args.batch],
               test_q.q_terms[i:i + args.batch],
               test_q.q_weights[i:i + args.batch])


def _replay(args, target, test_q):
    def run(deadline):
        for q3 in _batches(args, test_q):
            target.retrieve(*q3)
            if time.monotonic() >= deadline:
                return
    return run


def serve_from_router(args, reader, cfg, index, test_q, dev):
    """Serve through the multi-host scatter-gather tier (--hosts N)."""
    from repro_torch import index as index_lib
    from repro_torch.engine import ShardRouter

    trace_rate = args.trace_sample_rate if args.trace_out else None
    with ShardRouter.local(
            reader, n_hosts=args.hosts, replication=args.replication,
            cfg=cfg, index=index, max_batch=args.batch,
            cache_capacity=args.cache_blocks,
            host_timeout=args.host_timeout_ms / 1e3,
            trace_sample_rate=trace_rate,
            explain=_make_explain(args), device=dev) as router:
        # the endpoints come up before the first batch, so a scraper
        # polling /metrics gets 200 while serving warms up
        exporter, slo = _start_exporter(args, router)
        all_ids = []
        for bi, q3 in enumerate(_batches(args, test_q)):
            ids, _ = router.retrieve(*q3)
            all_ids.append(_np(ids))
            if args.kill_host is not None and bi == 0:
                router.hosts[args.kill_host].kill()
                print(f"injected failure: host {args.kill_host} killed "
                      f"after batch 0 (replication {args.replication})",
                      flush=True)
        ids = np.concatenate(all_ids)
        _sustain(args, _replay(args, router, test_q), slo)
        st = router.stats()
        print(f"router: {st['hosts']} hosts x replication "
              f"{st['replication']} over {st['n_shards']} shards, "
              f"generation {st['generation']}")
        print(f"served {args.queries} queries: "
              f"MRR@10={mrr_at(ids, test_q.rel_doc):.4f}, "
              f"failed={st['failed_requests']} "
              f"degraded={st['degraded_requests']} "
              f"failovers={st['failovers']} retries={st['retries']} "
              f"missing_shards={st['missing_shards']}")
        _write_obs(args, router)
        _finish_obs(args, exporter, slo, router.explain)

        ok = True
        if args.check_parity:
            # reference: a fresh single-host engine over the same index —
            # results must match exactly (same pipeline, v1 and v2 alike)
            ref_reader = index_lib.IndexReader.open(args.index_dir,
                                                    verify="none")
            with ref_reader.engine(max_batch=args.batch, prefetch=False,
                                   device=dev) as eng:
                ref_ids = np.concatenate([_np(eng.retrieve(*q3)[0])
                                          for q3 in _batches(args, test_q)])
            if not np.array_equal(ids, ref_ids):
                bad = int((ids != ref_ids).any(axis=1).sum())
                print(f"PARITY FAIL: {bad}/{args.queries} queries differ "
                      f"from the single-host engine")
                ok = False
            else:
                print(f"parity OK: {args.hosts}-host scatter-gather matches "
                      f"the single-host engine exactly")
        if st["failed_requests"]:
            print(f"FAIL: {st['failed_requests']} failed request(s)")
            ok = False
    return 0 if ok else 1


def serve_from_index(args, dev):
    """Serve a persistent index built by either package's build_index."""
    from repro_torch import index as index_lib
    from repro_torch.engine import InMemoryStore
    from repro_torch.engine import pipeline as pipe_lib

    t0 = time.perf_counter()
    reader = index_lib.IndexReader.open(args.index_dir, verify=args.verify)
    cfg, index = reader.load_index(device=dev)
    cfg = _apply_hybrid_flags(cfg, args)
    open_ms = (time.perf_counter() - t0) * 1e3
    meta = reader.manifest.get("extra", {}).get("corpus")
    if meta is None or meta.get("kind") != "synthetic":
        raise SystemExit("index lacks synthetic-corpus metadata; cannot "
                         "regenerate queries for quality evaluation")
    corpus = _synthetic_corpus(meta["seed"], meta["n_docs"], meta["dim"],
                               meta["vocab"])
    test_q = synth_queries(9, corpus, args.queries)

    if args.hosts:
        return serve_from_router(args, reader, cfg, index, test_q, dev)

    trace_rate = args.trace_sample_rate if args.trace_out else None
    with reader.engine(cfg=cfg, index=index, max_batch=args.batch,
                       cache_capacity=args.cache_blocks,
                       prefetch=not args.no_prefetch,
                       trace_sample_rate=trace_rate,
                       explain=_make_explain(args), device=dev) as engine:
        exporter, slo = _start_exporter(args, engine)
        batches = list(_batches(args, test_q))
        t1 = time.perf_counter()
        first_ids, _ = engine.retrieve(*batches[0])
        first_ms = (time.perf_counter() - t1) * 1e3
        all_ids = [_np(first_ids)]
        for q3 in batches[1:]:
            all_ids.append(_np(engine.retrieve(*q3)[0]))
        _sustain(args, _replay(args, engine, test_q), slo)
        _finish_obs(args, exporter, slo, engine.explain)
    ids = np.concatenate(all_ids)
    st = engine.stats()
    io, cache = st.get("io", {}), st.get("cache", {})
    print(f"index: {reader.index_dir} "
          f"(format v{reader.format_version}, "
          f"{reader.manifest['total_bytes'] / 2**20:.1f} MiB, "
          f"{len(reader.manifest['block_shards'])} shard(s), "
          f"verify={args.verify}); device {dev}")
    print(f"cold open {open_ms:.0f} ms, first batch {first_ms:.0f} ms "
          f"(its stages' first use)")
    print(f"served {args.queries} queries: "
          f"MRR@10={mrr_at(ids, test_q.rel_doc):.4f}, "
          f"{io.get('n_ops', 0)} I/O ops, "
          f"{io.get('bytes', 0) / 2**20:.1f} MiB read, "
          f"cache hit rate {cache.get('hit_rate', 0.0):.2f}")
    _write_obs(args, engine)

    if args.check_parity:
        if reader.generation > 0:
            print("PARITY UNAVAILABLE: this index has been incrementally "
                  f"updated (generation {reader.generation}); the "
                  "synthetic-corpus recipe no longer reproduces its "
                  "documents, so the in-memory baseline would be stale. "
                  "Use repro_torch.launch.update_index --check-parity "
                  "(compares against a compacted copy) instead.")
            return 1
        mem = InMemoryStore(torch.from_numpy(corpus.embeddings).to(dev),
                            index.cluster_docs)
        n = args.queries
        ref_ids, _, _ = pipe_lib.retrieve(
            cfg, index, mem,
            torch.as_tensor(test_q.q_dense[:n], dtype=torch.float32).to(dev),
            torch.as_tensor(test_q.q_terms[:n], dtype=torch.int32).to(dev),
            torch.as_tensor(test_q.q_weights[:n],
                            dtype=torch.float32).to(dev))
        ref_ids = _np(ref_ids)
        if reader.is_pq:
            # PQ serving is approximate by construction: parity is a
            # bounded MRR@10 delta vs the float32 in-memory backend
            ref_mrr = mrr_at(ref_ids, test_q.rel_doc[:n])
            got_mrr = mrr_at(ids, test_q.rel_doc[:n])
            if abs(ref_mrr - got_mrr) > args.parity_mrr_tol:
                print(f"PARITY FAIL: PQ MRR@10 {got_mrr:.4f} vs in-memory "
                      f"{ref_mrr:.4f} (tol {args.parity_mrr_tol})")
                return 1
            print(f"parity OK: PQ MRR@10 {got_mrr:.4f} within "
                  f"{args.parity_mrr_tol} of in-memory {ref_mrr:.4f}")
        elif not np.array_equal(ids, ref_ids):
            bad = int((ids != ref_ids).any(axis=1).sum())
            print(f"PARITY FAIL: {bad}/{n} queries differ from "
                  f"the in-memory pipeline")
            return 1
        else:
            print("parity OK: sharded on-disk serving matches the "
                  "in-memory pipeline exactly")
    return 0


def serve_built(args, dev):
    """Build a synthetic corpus, index and selector, then serve them."""
    from repro_torch.configs import clusd_msmarco
    from repro_torch.convert import selector_from_numpy
    from repro_torch.core import clusd as cl
    from repro_torch.core import disk as dk
    from repro_torch.core import train_lstm as tl
    from repro_torch.engine import DiskStore, RetrievalEngine

    cfg = dataclasses.replace(
        clusd_msmarco.smoke(),
        n_docs=args.docs, dim=args.dim, n_clusters=args.clusters,
        vocab=2048, k_sparse=512, bins=(10, 25, 50, 100, 200, 512),
        n_candidates=32, max_selected=16, k_final=256,
        train_queries=512, epochs=args.epochs)
    cfg = _apply_hybrid_flags(cfg, args)

    print(f"building corpus + index on {dev} ...", flush=True)
    corpus = _synthetic_corpus(0, cfg.n_docs, cfg.dim, cfg.vocab)
    index = cl.build_index(cfg, corpus.embeddings, corpus.doc_terms,
                           corpus.doc_weights,
                           generator=torch.Generator().manual_seed(0),
                           device=dev)
    index.embeddings = torch.from_numpy(corpus.embeddings).to(dev)
    train_q = synth_queries(1, corpus, cfg.train_queries)
    _, feats, labels = tl.make_labels(cfg, index, train_q.q_dense,
                                      train_q.q_terms, train_q.q_weights)
    params, hist = tl.train_selector(
        cfg, torch.Generator().manual_seed(2), feats, labels, device=dev)
    index.selector = selector_from_numpy(
        {k: _np(v) for k, v in params.items()}, device=dev)
    print(f"LSTM trained: loss {hist[0]:.4f} -> {hist[-1]:.4f}", flush=True)

    test_q = synth_queries(9, corpus, args.queries)
    engine = RetrievalEngine(
        cfg, index, max_batch=args.batch,
        trace_sample_rate=args.trace_sample_rate if args.trace_out else None,
        device=dev)
    ids = np.concatenate([_np(engine.retrieve(*q3)[0])
                          for q3 in _batches(args, test_q)])
    st = engine.stats()
    lat = np.asarray([b.ms / b.size for b in engine.serve_stats.batches
                      if not b.compiled])

    oracle_ids, _ = cl.full_dense_topk(
        index.embeddings,
        torch.as_tensor(test_q.q_dense, dtype=torch.float32).to(dev), 64)
    print(f"CluSD   MRR@10={mrr_at(ids, test_q.rel_doc):.4f} "
          f"R@{cfg.k_final}={recall_at(ids, test_q.rel_doc, cfg.k_final):.4f}")
    print(f"oracle-dense MRR@10={mrr_at(_np(oracle_ids), test_q.rel_doc):.4f}")
    if len(lat):
        print(f"serve latency/query: mean={lat.mean():.2f}ms "
              f"p99={np.percentile(lat, 99):.2f}ms "
              f"(buckets: {st['compiled_buckets']})")
    _write_obs(args, engine)

    if args.ondisk:
        tmp = tempfile.mkdtemp()
        blocks = dk.DiskClusterStore.pack(os.path.join(tmp, "blocks.bin"),
                                          corpus.embeddings,
                                          _np(index.cluster_docs))
        nq = min(64, args.queries)
        with RetrievalEngine(cfg, index,
                             store=DiskStore(blocks, index.cluster_docs),
                             max_batch=args.batch,
                             cache_capacity=args.cache_blocks,
                             prefetch=not args.no_prefetch,
                             device=dev) as deng:
            t0 = time.perf_counter()
            ids_d, _ = deng.retrieve(test_q.q_dense[:nq], test_q.q_terms[:nq],
                                     test_q.q_weights[:nq])
            wall = time.perf_counter() - t0
        # stats after close(): the prefetch worker has drained, so I/O and
        # cache numbers are final
        ds = deng.stats()
        io, cache = ds["io"], ds.get("cache", {})
        qps = ds["qps_steady"]
        qps_str = f"{qps:.1f} QPS steady" if qps else \
            f"{nq / wall:.1f} QPS incl. first batches"
        print(f"on-disk engine: {io['n_ops']} block reads, "
              f"{io['bytes'] / 2**20:.1f} MiB, model {io['model_ms']:.1f} ms, "
              f"cache hit rate {cache.get('hit_rate', 0.0):.2f}, "
              f"{qps_str}, "
              f"MRR@10={mrr_at(_np(ids_d), test_q.rel_doc[:nq]):.4f}")
    return 0


def main(argv=None):
    # the module docstring is the --help epilog
    ap = argparse.ArgumentParser(
        description="Serve CluSD retrieval through the port's "
                    "RetrievalEngine (in-memory, on-disk, or a persistent "
                    "built index).",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--docs", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--clusters", type=int, default=256)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--ondisk", action="store_true")
    ap.add_argument("--fusion", default=None, choices=("interp", "rrf"),
                    help="final-list fusion method override (default: the "
                         "served config's; interp = paper min-max "
                         "interpolation, rrf = weighted reciprocal-rank)")
    ap.add_argument("--expand-depth", type=int, default=None,
                    help="Stage-I neighbor-graph expansion depth override "
                         "(0 = off; widens candidates to n_candidates * "
                         "(1 + depth) at the same selection budget)")
    ap.add_argument("--cache-blocks", type=int, default=512)
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--hosts", type=int, default=0,
                    help="with --index-dir: serve through the multi-host "
                         "scatter-gather router over N hosts in this "
                         "process (0 = single-host engine)")
    ap.add_argument("--replication", type=int, default=1,
                    help="replicas per index shard across the host fleet "
                         "(R >= 2 survives any R-1 host failures)")
    ap.add_argument("--host-timeout-ms", type=float, default=10000.0,
                    help="per-host scatter-leg timeout before the router "
                         "retries / fails over to a replica")
    ap.add_argument("--kill-host", type=int, default=None, metavar="I",
                    help="fault injection: kill host I after the first "
                         "batch (with --replication >= 2 serving must "
                         "continue with zero failed requests)")
    ap.add_argument("--index-dir", default=None,
                    help="serve a built index (either package's "
                         "build_index) instead of rebuilding in memory")
    ap.add_argument("--verify", default="size",
                    choices=("none", "size", "full"),
                    help="built-index integrity check level at open")
    ap.add_argument("--check-parity", action="store_true",
                    help="with --index-dir: compare against the in-memory "
                         "pipeline, exit non-zero on mismatch (exact ids "
                         "for v1; MRR@10 tolerance for PQ/v2 indexes)")
    ap.add_argument("--parity-mrr-tol", type=float, default=0.02,
                    help="allowed MRR@10 delta for PQ-index parity")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export per-batch stage-span traces after serving "
                         "(.jsonl = one span per line, anything else = "
                         "Chrome trace JSON)")
    ap.add_argument("--trace-sample-rate", type=float, default=1.0,
                    help="fraction of batches traced when --trace-out is "
                         "set (deterministic: 0.25 = every 4th batch)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the engine metrics registry after serving "
                         "(.prom/.txt = Prometheus text, else JSON)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="with --index-dir: serve live /metrics, "
                         "/metrics.json, /slo, and /healthz over HTTP on "
                         "port P while serving runs (0 = ephemeral port, "
                         "printed at startup)")
    ap.add_argument("--slo-config", default=None, metavar="PATH",
                    help="JSON SLO objectives ({\"objectives\": [...]}) "
                         "judging the run via an SLOMonitor; default "
                         "objectives are used when --metrics-port is set "
                         "without this")
    ap.add_argument("--explain-out", default=None, metavar="PATH",
                    help="with --index-dir: write sampled per-query "
                         "explain records (JSONL)")
    ap.add_argument("--explain-sample-rate", type=float, default=1.0,
                    help="fraction of batches explained when --explain-out "
                         "is set (deterministic accumulator sampling)")
    ap.add_argument("--serve-seconds", type=float, default=0.0, metavar="S",
                    help="after the scored pass, keep replaying the query "
                         "set for S more seconds so the live endpoints "
                         "can be scraped under sustained traffic")
    ap.add_argument("--device", default=None,
                    help="torch device for the index, the router and its "
                         "hosts (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    if args.index_dir:
        return serve_from_index(args, dev)
    return serve_built(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
