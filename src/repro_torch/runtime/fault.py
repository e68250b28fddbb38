"""Fault tolerance for long-running training (the JAX package's
`repro.runtime.fault`):

  - `restartable_train`: checkpoint/restart driver. Periodic async
    checkpoints; on (simulated or real) failure the driver restores the
    latest complete checkpoint and goes on from the step after it.
  - `FailureInjector`: deterministic failure schedule for tests/examples
    (real deployments replace this with preemption signals / heartbeats).
  - `StragglerMonitor`: flags steps slower than k x rolling median.
"""

import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.device import synchronize


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.tripped = set()

    def check(self, step):
        if step in self.fail_at and step not in self.tripped:
            self.tripped.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerMonitor:
    def __init__(self, factor=3.0, window=20):
        self.times = []
        self.factor = factor
        self.window = window
        self.flagged = []

    def observe(self, step, dt):
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        if len(hist) >= 5 and dt > self.factor * med:
            self.flagged.append((step, dt, med))
            return True
        return False


def _sync_state(state):
    leaves = [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]
    if leaves:
        synchronize(leaves[0].device)


def _template(state):
    """The dtype and device of each leaf, in empty tensors: what a restore
    needs of its target, without holding the state."""
    return tree_map(lambda x: torch.empty(0, dtype=x.dtype, device=x.device)
                    if isinstance(x, torch.Tensor) else x, state)


def restartable_train(*, init_state, step_fn, batches_fn, total_steps,
                      ckpt_dir, ckpt_every=50, failure_injector=None,
                      logger=None, max_restarts=10):
    """Run `step_fn(state, batch) -> (state, metrics)` to total_steps with
    checkpoint/restart. `batches_fn(start_step)` must return an iterator
    positioned at `start_step` (deterministic data order across restarts).
    `state` is a tree of tensors (nested dicts); a restore casts each
    leaf to the initial state's dtype and device.

    `init_state` is the initial tree, or a function returning it: the
    function is called to start and again on a restart before any
    checkpoint, so the driver holds one state at a time (a caller on the
    card that drops its own references keeps one copy of a large state
    there, not two).

    Returns (state, history, restart_count)."""
    make_init = init_state if callable(init_state) else (lambda: init_state)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    monitor = StragglerMonitor()
    history = []
    restarts = 0
    template = None

    while True:
        mgr.wait()
        if latest_step(ckpt_dir) is None:
            state, start = make_init(), 0
            template = template or _template(state)
        else:
            template = template or _template(make_init())
            step0, state, _ = mgr.restore_latest(template)
            start = step0 + 1
        try:
            it = batches_fn(start)
            for step in range(start, total_steps):
                if failure_injector is not None:
                    failure_injector.check(step)
                batch = next(it)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                _sync_state(state)
                dt = time.perf_counter() - t0
                straggler = monitor.observe(step, dt)
                rec = {"step": step, "time_s": dt, "straggler": straggler,
                       **{k: float(v) for k, v in metrics.items()}}
                history.append(rec)
                if logger:
                    logger.log(**rec)
                if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
                    mgr.save(step, state, extra={"step": step})
            mgr.wait()
            return state, history, restarts
        except SimulatedFailure as e:
            restarts += 1
            if logger:
                logger.log(event="restart", error=str(e), restarts=restarts)
            if restarts > max_restarts:
                raise
            mgr.wait()
            continue
