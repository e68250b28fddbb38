"""Selector training CLI: stream labels off a built index, train the
Stage-II LSTM, calibrate theta/budget on held-out queries, and publish
the result as a new index generation that a live engine hot-reloads.
Runs on the CUDA card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.train_selector \
      --index-dir /tmp/idx --train-queries 512 --holdout-queries 128 \
      --epochs 40 --target-recall 0.9 --publish --serve-check 8

Pipeline (src/repro_torch/train/):
  1. LABELS  — exact full-dense top-k streamed through the index's own
     ShardedDiskStore/ShardedPQStore, at most --chunk-clusters blocks per
     read and scored on the device, no materialized embedding matrix;
     spilled to a reusable label cache (--label-cache, default
     <index-dir>.labels) keyed by index artifacts + label config + query
     set (the JAX package's key: either package's entries are hits).
  2. TRAIN   — candidate sequences bucketed to power-of-two lengths,
     steps on the lstm_sequence kernel forward (--use-kernel; its
     backward through the plain version), periodic checkpoints
     (--ckpt-every / --ckpt-dir) with deterministic mid-epoch --resume.
  3. CALIBRATE — sweep --thetas x --budgets on the held-out label set
     with the probabilities the engine serves (the lstm_sequence kernel
     on the card); pick the cheapest point hitting --target-recall (or
     the best recall within --target-budget). With --expand-depths the
     sweep gains a stage-1 expansion-depth axis: the selector is
     retrained on the expanded candidate sequences (labels rebuilt from
     the cached full-dense ids — no re-streaming) and the operating
     point is re-picked at the baseline's budget.
  4. PUBLISH (--publish) — weights + calibrated theta/budget commit as an
     atomic generation (zero corpus bytes rewritten); --serve-check N
     serves N queries on a live engine before AND after the commit,
     hot-swaps via RetrievalEngine.reload_selector(), and parity-checks
     the hot-reloaded engine against a fresh engine on the new
     generation (exact top-k ids; exit non-zero on mismatch).

Key flags (full list below / --help):
  --pos-weight {auto,<float>}  BCE positive-class weight; "auto" derives
                               it from the observed label positive rate,
                               default keeps the index config's value
  --no-bucket                  disable sequence-length bucketing
  --use-kernel {auto,0,1}      lstm_sequence kernel in the train step
                               (auto = on a CUDA device)
  --expand-depths 0,1,2        stage-1 expansion depths to sweep; the
                               best (depth, theta) at the baseline
                               budget publishes as config.expand_depth
  --fusion {interp,rrf}        fusion method to publish into the config
                               (default: keep the index config's value)
  --device DEV                 torch device (default: the CUDA card)

The initial params and the labels' queries are drawn from --seed: the
params from a torch.Generator (not jax.random), the queries by the
JAX package's numpy generator, so the label sets equal the JAX CLI's.
"""

import argparse
import dataclasses
import functools
import json
import time

import numpy as np
import torch

from repro_torch import index as index_lib
from repro_torch import train as train_lib
from repro_torch.data import synth_corpus, synth_queries


def _parse_pos_weight(s):
    if s is None:
        return None, False
    if s == "auto":
        return None, True
    return float(s), False


def _parse_use_kernel(s):
    return "auto" if s == "auto" else bool(int(s))


def _floats(s):
    return [float(x) for x in s.split(",") if x]


def _ints(s):
    return [int(x) for x in s.split(",") if x]


@functools.lru_cache(maxsize=1)
def _synthetic_corpus(seed, n_docs, dim, vocab):
    """The corpus of a directory's recipe; the last one is kept, so that
    main() run again in one process (a --resume after a run) does not
    regenerate it (about 40 s at 2^20 docs)."""
    return synth_corpus(seed, n_docs, dim, vocab)


def _corpus_queries(reader, args):
    meta = reader.manifest.get("extra", {}).get("corpus")
    if meta is None or meta.get("kind") != "synthetic":
        raise SystemExit("index lacks synthetic-corpus metadata; cannot "
                         "regenerate training/holdout queries")
    corpus = _synthetic_corpus(meta["seed"], meta["n_docs"], meta["dim"],
                               meta["vocab"])
    train_q = synth_queries(args.seed + 21, corpus, args.train_queries)
    hold_q = synth_queries(args.seed + 22, corpus, args.holdout_queries)
    return corpus, train_q, hold_q


def _labels(reader, cfg, index, store, qs, label_cfg, cache, tag,
            metrics=None):
    key = train_lib.label_cache_key(
        reader.manifest, cfg, label_cfg,
        train_lib.query_fingerprint(qs.q_dense, qs.q_terms, qs.q_weights))
    ls, hit = cache.get_or_build(
        key, lambda: train_lib.make_labels_streaming(
            cfg, index, store, qs.q_dense, qs.q_terms, qs.q_weights,
            label_cfg=label_cfg, metrics=metrics, device=index.device),
        extra={"tag": tag, "generation": reader.generation},
        metrics=metrics)
    src = "cache hit" if hit else (
        f"streamed {ls.stats.blocks_read} blocks / "
        f"{ls.stats.bytes_read / 2**20:.1f} MiB in "
        f"{ls.stats.wall_s:.1f}s")
    print(f"labels[{tag}]: {ls.n_queries} queries, "
          f"pos_rate={ls.pos_rate:.4f} ({src})", flush=True)
    return ls


def _serve_ids(engine, qs, n, batch):
    out = []
    for lo in range(0, n, batch):
        ids, _ = engine.retrieve(qs.q_dense[lo:lo + batch],
                                 qs.q_terms[lo:lo + batch],
                                 qs.q_weights[lo:lo + batch])
        out.append(ids.cpu().numpy())
    return np.concatenate(out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train, calibrate, and publish a Stage-II selector "
                    "against a built CluSD index (streaming labels, "
                    "bucketed training, atomic generation publish).",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--index-dir", required=True,
                    help="built index (repro_torch.launch.build_index, or "
                         "either package's build)")
    ap.add_argument("--train-queries", type=int, default=512)
    ap.add_argument("--holdout-queries", type=int, default=128,
                    help="held-out queries for threshold calibration")
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: the index config's epochs")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--top-dense", type=int, default=10,
                    help="full-dense top-k that defines a positive cluster")
    ap.add_argument("--chunk-clusters", type=int, default=64,
                    help="cluster blocks per streamed label-gen read")
    ap.add_argument("--label-cache", default=None,
                    help="label cache dir (default <index-dir>.labels)")
    ap.add_argument("--pos-weight", default=None,
                    help="BCE positive weight: float, or 'auto' to derive "
                         "from the label positive rate (default: index "
                         "config value)")
    ap.add_argument("--no-bucket", action="store_true",
                    help="disable power-of-two sequence-length bucketing")
    ap.add_argument("--use-kernel", default="auto",
                    help="lstm_sequence kernel in the train step: "
                         "auto|0|1 (auto = on a CUDA device)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir (default <index-dir>.selector-ckpt)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps (0 = end only)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--thetas", type=_floats,
                    default="0.01,0.02,0.05,0.1,0.2,0.3,0.5,0.7",
                    help="comma list of thresholds to sweep")
    ap.add_argument("--budgets", type=_ints, default=None,
                    help="comma list of cluster budgets (default: powers "
                         "of two up to n_candidates)")
    ap.add_argument("--target-recall", type=float, default=None,
                    help="calibrate to the cheapest point with recall@k "
                         ">= this (default 0.9 when no --target-budget)")
    ap.add_argument("--target-budget", type=int, default=None,
                    help="calibrate to the best recall within this many "
                         "selected clusters")
    ap.add_argument("--expand-depths", type=_ints, default=None,
                    metavar="D0,D1,..",
                    help="stage-1 neighbor-graph expansion depths to sweep "
                         "(retrains the selector on expanded candidates; "
                         "best depth publishes as config.expand_depth)")
    ap.add_argument("--fusion", default=None, choices=("interp", "rrf"),
                    help="fusion method to publish into the index config "
                         "(default: keep the current value)")
    ap.add_argument("--publish", action="store_true",
                    help="commit weights + calibrated thresholds as a new "
                         "index generation")
    ap.add_argument("--serve-check", type=int, default=0,
                    help="with --publish: serve N queries on a live "
                         "engine across the commit (hot reload_selector) "
                         "and parity-check vs a fresh engine")
    ap.add_argument("--verify", default="size",
                    choices=("none", "size", "full"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export one train_selector trace with labels / "
                         "train / calibrate / publish phase spans (.jsonl "
                         "span lines or Chrome trace JSON)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump labels.* / train.* (and serve-check) "
                         "metrics (.prom/.txt = Prometheus text, else "
                         "JSON)")
    ap.add_argument("--device", default=None,
                    help="torch device for labels, training, calibration "
                         "and serving (default: the CUDA card)")
    args = ap.parse_args(argv)
    if isinstance(args.thetas, str):        # default not routed through type=
        args.thetas = _floats(args.thetas)
    if args.target_recall is not None and args.target_budget is not None:
        ap.error("--target-recall and --target-budget are mutually "
                 "exclusive calibration targets")

    from repro_torch.device import resolve_device
    from repro_torch.obs import (NOOP_TRACE, MetricsRegistry, Tracer,
                                 write_metrics, write_trace)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    tracer = Tracer(sample_rate=1.0) if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics_out else None
    tr = tracer.trace("train_selector") if tracer is not None else NOOP_TRACE

    def _finish_obs():
        tr.finish()
        if metrics is not None:
            write_metrics(metrics, args.metrics_out)
            print(f"metrics -> {args.metrics_out}")
        if tracer is not None:
            write_trace(tracer, args.trace_out)
            print(f"trace -> {args.trace_out}")

    t0 = time.perf_counter()
    reader = index_lib.IndexReader.open(args.index_dir, verify=args.verify)
    cfg, index = reader.load_index(device=dev)
    pos_override, pos_auto = _parse_pos_weight(args.pos_weight)
    if pos_auto:
        cfg = dataclasses.replace(cfg, pos_weight=None)
    store = reader.open_store(cluster_docs=index.cluster_docs)
    print(f"index: {reader.index_dir} (format v{reader.format_version}, "
          f"generation {reader.generation}, N={cfg.n_clusters}, "
          f"n_docs={cfg.n_docs}); device {dev}", flush=True)
    corpus, train_q, hold_q = _corpus_queries(reader, args)

    # -- 1. labels (streamed, cached) --------------------------------------
    label_cfg = train_lib.LabelConfig(top_dense=args.top_dense,
                                      chunk_clusters=args.chunk_clusters)
    cache = train_lib.LabelCache(args.label_cache
                                 or args.index_dir.rstrip("/") + ".labels")
    with tr.span("labels", n_train=args.train_queries,
                 n_holdout=args.holdout_queries):
        train_ls = _labels(reader, cfg, index, store, train_q, label_cfg,
                           cache, "train", metrics=metrics)
        hold_ls = _labels(reader, cfg, index, store, hold_q, label_cfg,
                          cache, "holdout", metrics=metrics)

    # -- 2. train ----------------------------------------------------------
    tcfg = train_lib.SelectorTrainConfig(
        epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
        pos_weight=pos_override, bucket=not args.no_bucket,
        use_kernel=_parse_use_kernel(args.use_kernel), seed=args.seed,
        ckpt_dir=args.ckpt_dir
        or args.index_dir.rstrip("/") + ".selector-ckpt",
        ckpt_every_steps=args.ckpt_every)
    trainer = train_lib.SelectorTrainer(cfg, tcfg, device=dev)
    t1 = time.perf_counter()
    with tr.span("train"):
        params, hist = trainer.fit(
            torch.Generator().manual_seed(args.seed + 2), train_ls.feats,
            train_ls.labels, resume=args.resume,
            log_every=max(1, (args.epochs or cfg.epochs) // 5),
            metrics=metrics)
    train_wall = time.perf_counter() - t1
    loss_str = (f"loss {hist[0]:.4f} -> {hist[-1]:.4f}" if hist
                else "no steps left (resumed a finished run)")
    print(f"trained: {loss_str} in {train_wall:.1f}s "
          f"(pos_weight={trainer.pos_weight:.2f}, "
          f"buckets={sorted(trainer._steps)})", flush=True)

    # -- 3. calibrate ------------------------------------------------------
    budgets = args.budgets or [b for b in (4, 8, 16, 32, 64)
                               if b <= cfg.n_candidates]
    # calibrate against SERVING numerics: the engine's Stage II runs the
    # lstm_sequence kernel on the card (the plain version on the CPU),
    # so the swept probabilities must come from it too
    with tr.span("calibrate", n_thetas=len(set(args.thetas + [cfg.theta])),
                 n_budgets=len(budgets)):
        probs = train_lib.selector_probs(params, hold_ls.feats,
                                         use_kernel=on_card, device=dev)
        table = train_lib.calibration_table(
            hold_ls, probs, index.doc_cluster,
            thetas=sorted(set(args.thetas + [cfg.theta])), budgets=budgets,
            block_bytes=int(getattr(store, "block_bytes", 0)))
        target_recall = args.target_recall
        if target_recall is None and args.target_budget is None:
            target_recall = 0.9
        op = train_lib.choose_operating_point(
            table, target_recall=target_recall,
            target_budget=args.target_budget)
    print(f"calibrated: theta={op['theta']} budget={op['budget']} -> "
          f"recall@{args.top_dense}={op['recall']:.4f} "
          f"avg_selected={op['avg_selected']} "
          f"(target_met={op['target_met']})", flush=True)

    # -- 3b. hybrid expansion sweep (--expand-depths) ----------------------
    hybrid = None
    pub_params, pub_op, pub_table = params, op, table
    pub_depth = None
    if args.expand_depths:
        depths = sorted({max(0, d) for d in args.expand_depths
                         if cfg.n_candidates * (1 + max(0, d))
                         <= cfg.n_clusters})
        dropped = sorted(set(args.expand_depths) - set(depths))
        if dropped:
            print(f"expand-depths {dropped} dropped: expanded candidate "
                  f"count would exceed n_clusters={cfg.n_clusters}")
        dmax = max(depths)
        cfg_h = dataclasses.replace(cfg, expand_depth=dmax)
        with tr.span("hybrid", n_depths=len(depths), max_depth=dmax):
            ls_h = train_lib.relabel_for_config(
                cfg_h, index, train_q.q_dense, train_q.q_terms,
                train_q.q_weights, train_ls.dense_ids,
                stage1=label_cfg.stage1)
            trainer_h = train_lib.SelectorTrainer(
                cfg_h, dataclasses.replace(
                    tcfg, ckpt_dir=tcfg.ckpt_dir + ".hybrid"), device=dev)
            params_h, hist_h = trainer_h.fit(
                torch.Generator().manual_seed(args.seed + 3), ls_h.feats,
                ls_h.labels,
                log_every=max(1, (args.epochs or cfg.epochs) // 5),
                metrics=metrics)
            sweep = train_lib.expansion_sweep(
                cfg, index, params_h, hold_q.q_dense, hold_q.q_terms,
                hold_q.q_weights, hold_ls.dense_ids, depths=depths,
                thetas=sorted(set(args.thetas + [cfg.theta])),
                budgets=budgets,
                block_bytes=int(getattr(store, "block_bytes", 0)),
                stage1=label_cfg.stage1, use_kernel=on_card)
        rows_h = [r for d in sweep for r in d["rows"]]
        hop = train_lib.choose_operating_point(
            rows_h, target_budget=args.target_budget or op["budget"])
        ceil = {d["depth"]: d["stage1_ceiling"] for d in sweep}
        hybrid = {
            "depth": hop["depth"], "theta": hop["theta"],
            "budget": hop["budget"], "recall": hop["recall"],
            "avg_selected": hop["avg_selected"],
            "stage1_ceiling": ceil[hop["depth"]],
            "baseline_recall": op["recall"],
            "final_loss": round(hist_h[-1], 6) if hist_h else None,
            "sweep": [{"depth": d["depth"],
                       "n_candidates": d["n_candidates"],
                       "stage1_ceiling": d["stage1_ceiling"]}
                      for d in sweep],
        }
        pub_params, pub_op, pub_table = params_h, dict(hop), rows_h
        pub_depth = hop["depth"]
        print(f"hybrid: depth={hop['depth']} theta={hop['theta']} "
              f"budget={hop['budget']} -> "
              f"recall@{args.top_dense}={hop['recall']:.4f} "
              f"(stage1_ceiling={ceil[hop['depth']]:.4f}, "
              f"baseline={op['recall']:.4f})", flush=True)

    if not args.publish:
        _finish_obs()
        print(json.dumps({"operating_point": op, "hybrid": hybrid,
                          "wall_s": round(time.perf_counter() - t0, 1)}))
        return 0

    # -- 4. publish + live hot-reload check --------------------------------
    n_check = min(args.serve_check, args.holdout_queries)
    engine = None
    if n_check:
        engine = reader.engine(max_batch=max(8, n_check), metrics=metrics,
                               tracer=tracer, device=dev)
        _serve_ids(engine, hold_q, n_check, engine.max_batch)  # pre-commit

    with tr.span("publish"):
        report = train_lib.publish_selector(
            args.index_dir, pub_params, theta=pub_op["theta"],
            budget=pub_op["budget"], calibration=pub_table,
            label_config=dataclasses.asdict(label_cfg),
            train_meta={"n_train_queries": train_ls.n_queries,
                        "n_holdout_queries": hold_ls.n_queries,
                        "epochs": args.epochs or cfg.epochs,
                        "pos_weight": trainer.pos_weight,
                        "final_loss": round(hist[-1], 6) if hist else None,
                        "train_wall_s": round(train_wall, 3),
                        "hybrid": hybrid},
            expand_depth=pub_depth, fusion=args.fusion,
            verify=args.verify)
    print(f"published generation {report['generation']} "
          f"(+{report['bytes_added']} bytes, {report['wall_s']}s)",
          flush=True)

    if n_check:
        gen = engine.reload_selector()
        assert gen == report["generation"], (gen, report)
        got = _serve_ids(engine, hold_q, n_check, engine.max_batch)
        engine.close()
        fresh_reader = index_lib.IndexReader.open(args.index_dir,
                                                  verify=args.verify)
        with fresh_reader.engine(max_batch=max(8, n_check),
                                 device=dev) as fresh:
            want = _serve_ids(fresh, hold_q, n_check, fresh.max_batch)
        if not np.array_equal(got, want):
            bad = int((got != want).any(axis=1).sum())
            print(f"PARITY FAIL: {bad}/{n_check} queries differ between "
                  f"the hot-reloaded engine and a fresh engine on "
                  f"generation {gen}")
            _finish_obs()
            return 1
        print(f"serve check OK: {n_check} queries, hot reload_selector == "
              f"fresh engine on generation {gen} "
              f"(selector_reloads={engine.stats()['selector_reloads']})")
    _finish_obs()
    print(json.dumps({"operating_point": op, "hybrid": hybrid,
                      "publish": report,
                      "wall_s": round(time.perf_counter() - t0, 1)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
