"""End-to-end training driver of the port (LM, recsys and GNN archs;
select one with --arch). Runs on the CUDA card unless `--device cpu` is given.

Runs inside the fault-tolerant restartable loop: periodic async
checkpoints (the JAX package's npz layout, so either package resumes the
other's), simulated-failure injection for drills, straggler monitoring.
A restart skips the batches the restored steps consumed, so the data
order is the uninterrupted run's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --variant smoke --steps 100 --batch 8 --seq 128 [--fail-at 37] \\
      [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.common.metrics import MetricLogger
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.graphs import synth_molecules
from repro_torch.data.pipeline import Prefetcher, lm_synthetic_batches
from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.device import resolve_device
from repro_torch.optim import adamw_init, make_schedule
from repro_torch.runtime.fault import FailureInjector, restartable_train


def _lm(cfg, args, tc, sched, dev):
    from repro_torch.models import transformer as model
    step = model.make_train_step(cfg, sched, tc)

    def init():       # the same draws at every call
        return model.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def batches_at(start):
        it = iter(Prefetcher(lm_synthetic_batches(
            cfg.vocab_size, args.batch, args.seq, args.steps, seed=1000),
            device=dev))
        for _ in range(start):     # deterministic restart
            next(it)
        return it

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, dict(sorted(m.items()))

    return init, step_fn, batches_at


def _recsys(cfg, args, tc, dev):
    from repro_torch.models import recsys as model
    params = model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = model.make_train_step(cfg, tc)

    def batches_at(start):
        stream = RecsysStream(cfg, seed=7)

        def gen():
            for _ in range(start):
                stream.batch(args.batch)
            while True:
                yield stream.batch(args.batch)
        return iter(Prefetcher(gen(), device=dev))

    def step_fn(state, batch):          # RecsysStream: int32 and float32
        p, o, m = step(model._from_tree(params, state["params"]),
                       state["opt"], batch)
        return {"params": model.train_tree(p), "opt": o}, \
            dict(sorted(m.items()))

    return lambda: model.train_tree(params), step_fn, batches_at


def _gnn(cfg, tc, dev):
    from repro_torch.models import nequip as model
    step = model.make_train_step(cfg, tc)

    def init():       # the same draws at every call
        return model.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def batches_at(start):
        def gen():
            s = start
            while True:
                yield synth_molecules(1234 + s % 16, 8, 12, 32,
                                      n_species=cfg.n_species)
                s += 1
        return iter(Prefetcher(gen(), device=dev))

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, dict(sorted(m.items()))

    return init, step_fn, batches_at


def main(argv=None):
    # __doc__ IS the epilog: the module docstring and --help never drift
    ap = argparse.ArgumentParser(
        description="Fault-tolerant end-to-end model training driver of "
                    "the port (LM/recsys/GNN archs; the CluSD selector has "
                    "its own driver: repro_torch.launch.train_selector).",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 20, 1))
    sched = make_schedule("cosine", tc.lr, tc.warmup_steps, tc.total_steps)
    logger = MetricLogger(args.log)

    if cfg.family == "lm":
        init_params, step_fn, batches_at = _lm(cfg, args, tc, sched, dev)
    elif cfg.family == "recsys":
        init_params, step_fn, batches_at = _recsys(cfg, args, tc, dev)
    else:  # gnn
        init_params, step_fn, batches_at = _gnn(cfg, tc, dev)

    def init_state():
        params = init_params()
        return {"params": params, "opt": adamw_init(params)}

    # the driver makes the initial state itself and holds one state at a
    # time (a full-width LM's params and moments are 21 GB)
    state, history, restarts = restartable_train(
        init_state=init_state, step_fn=step_fn, batches_fn=batches_at,
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        failure_injector=FailureInjector(args.fail_at), logger=logger)
    first = [h for h in history if "loss" in h][:3]
    last = [h for h in history if "loss" in h][-3:]
    print(f"done: steps={len(history)} restarts={restarts} "
          f"loss {np.mean([h['loss'] for h in first]):.4f} -> "
          f"{np.mean([h['loss'] for h in last]):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
