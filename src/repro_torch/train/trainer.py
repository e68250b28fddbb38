"""Selector training: the one-shot `train_selector` and the production
`SelectorTrainer` (bucketed batches, checkpoints every N steps,
deterministic mid-epoch resume), ports of the JAX package's
`repro.train.trainer`.

Loss: class-balanced BCE over the candidate sequence, as the JAX step
computes it: probabilities clipped to [1e-6, 1 - 1e-6], weighted BCE,
the mean per row, then sum(per_row * w) / max(sum(w), 1). The positive
weight comes from `cfg.pos_weight` (default 4.0), or, when the config
sets None, from the label set's positive rate (w = (1-p)/p, clipped).
`torch.clamp` passes the whole gradient where a probability sits exactly
on a bound; `jnp.clip` splits it there (lax.max/min at a tie), so the
two gradients differ only at such exact ties.

Kernel path: with `use_kernel` ("auto" = when the device is CUDA) the
LSTM's hidden sequence runs through the lstm_sequence kernel; its
backward recomputes the plain version and takes its VJP
(repro_torch.kernels.lstm.ops), as the JAX custom VJP does. An explicit
False runs the plain version, as JAX's False runs the scan.

Parameters are dicts of tensors named as the JAX param dicts (for the
LSTM {wx, wh, b, head_w, head_b}, the selector module's state_dict).
Initial parameters are drawn from a torch.Generator, which cannot give
jax.random's draws; `init=` (and `perms=` for the one-shot trainer's
per-epoch permutations) take given values instead.

Checkpoint layout (repro_torch.checkpoint): tree {params, opt}, extra
{epoch, batch, pos_weight, selector}, leaf for leaf the JAX trainer's,
so either package resumes the other's run. The batch stream is a pure
function of (seed, epoch) (train/data.py), so restoring a mid-epoch
checkpoint and skipping the consumed batches replays the schedule:
train N steps == train k steps, resume, train N-k.
"""

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.lstm import SELECTORS
from repro_torch.device import resolve_device
from repro_torch.index.builder import _np
from repro_torch.kernels.lstm import ops as lstm_ops
from repro_torch.kernels.lstm.ref import lstm_sequence_ref
from repro_torch.obs import MetricsRegistry
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train import data as data_lib

_DERIVED_POS_WEIGHT_MAX = 100.0


def derive_pos_weight(labels, lo=1.0, hi=_DERIVED_POS_WEIGHT_MAX):
    """Class-balance weight from the observed positive rate: w = (1-p)/p,
    clipped to [lo, hi]."""
    p = float(_np(labels).mean())
    if p <= 0.0:
        return float(hi)
    return float(np.clip((1.0 - p) / p, lo, hi))


def resolve_pos_weight(cfg, labels, override=None):
    """Effective positive weight: explicit override > cfg.pos_weight >
    derived-from-labels (when the config value is None)."""
    w = override if override is not None else getattr(cfg, "pos_weight", 4.0)
    if w is None:
        return derive_pos_weight(labels)
    return float(w)


def _meta_module(selector, params):
    """A parameterless stand-in of the selector's module class (on the
    meta device), for torch.func.functional_call over `params`."""
    cls = SELECTORS[selector]
    with torch.device("meta"):
        return cls(*(int(d) for d in cls.dims(params)))


def selector_apply(params, feats, *, selector="lstm", use_kernel=False):
    """Selection probabilities (B, n) of the param dict `params` over
    feats (B, n, F). `use_kernel` routes the LSTM's hidden sequence
    through the lstm_sequence op (the kernel on CUDA tensors,
    differentiable); False runs the plain version on any device."""
    if selector == "lstm":
        x = feats.float().contiguous()
        fn = lstm_ops.lstm_sequence if use_kernel else lstm_sequence_ref
        h_seq = fn(x, params["wx"], params["wh"], params["b"])
        logits = (h_seq @ params["head_w"] + params["head_b"])[..., 0]
        return torch.sigmoid(logits)
    return torch.func.functional_call(_meta_module(selector, params),
                                      dict(params), (feats,))


def _resolve_use_kernel(use_kernel, device):
    if use_kernel == "auto":
        return torch.device(device).type == "cuda"
    return bool(use_kernel)


def init_selector_params(selector, feat_dim, hidden, generator=None,
                         device=None):
    """A fresh selector's param dict (its module's state_dict), drawn
    from `generator` on the CPU and placed on `device`."""
    mod = SELECTORS[selector](feat_dim, hidden, generator=generator)
    return {k: v.detach().to(device) for k, v in mod.state_dict().items()}


def _given_params(init, device):
    return {k: torch.as_tensor(np.array(_np(v), np.float32)).to(device)
            for k, v in init.items()}


def _bce(probs, y, pos_w):
    probs = torch.clamp(probs, 1e-6, 1 - 1e-6)
    return -(pos_w * y * torch.log(probs) + (1 - y) * torch.log(1 - probs))


def _grads(loss, params):
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    return dict(zip(names, grads))


def _with_grad(params):
    return {k: v.detach().requires_grad_() for k, v in params.items()}


# ---------------------------------------------------------------------------
# one-shot API (core.train_lstm re-exports it)
# ---------------------------------------------------------------------------

def train_selector(cfg, generator, feats, labels, selector="lstm",
                   epochs=None, lr=None, batch_size=256, log_every=0,
                   pos_weight=None, *, init=None, perms=None, device=None):
    """Train a stage-2 selector on precomputed (feats, labels), the whole
    label set in memory, no bucketing or checkpoints, on `device` (None:
    the CUDA card, where the LSTM's forward is the lstm_sequence kernel).
    Returns (params, history). `generator` (a torch.Generator, or None
    for one seeded 0) draws the initial params and each epoch's
    permutation; `init` (a param dict) and `perms` (one permutation of
    the queries per epoch) replace those draws. pos_weight None defers
    to cfg.pos_weight."""
    dev = resolve_device(device)
    use_kernel = _resolve_use_kernel("auto", dev)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    epochs = epochs or cfg.epochs
    lr = lr or cfg.lr
    feats_np = np.asarray(_np(feats), np.float32)
    labels_np = np.asarray(_np(labels), np.float32)
    params = _given_params(init, dev) if init is not None else \
        init_selector_params(selector, feats_np.shape[-1], cfg.lstm_hidden,
                             generator, dev)
    opt = adamw_init(params)
    w_pos = resolve_pos_weight(cfg, labels_np, pos_weight)
    f_all = torch.tensor(feats_np, device=dev)
    y_all = torch.tensor(labels_np, device=dev)

    def step(p, o, f, y):
        pg = _with_grad(p)
        probs = selector_apply(pg, f, selector=selector,
                               use_kernel=use_kernel)
        loss = torch.mean(_bce(probs, y, w_pos))
        p, o, _ = adamw_update(_grads(loss, pg), o, p, lr=lr,
                               weight_decay=0.0)
        return p, o, loss.detach()

    nq = feats_np.shape[0]
    history = []
    for e in range(epochs):
        perm = torch.as_tensor(np.asarray(perms[e], np.int64)) \
            if perms is not None else torch.randperm(nq, generator=generator)
        perm = perm.to(dev)
        f_sh, y_sh = f_all[perm], y_all[perm]
        losses = []
        for i in range(0, nq - batch_size + 1, batch_size) or [0]:
            fb, yb = f_sh[i:i + batch_size], y_sh[i:i + batch_size]
            params, opt, loss = step(params, opt, fb, yb)
            losses.append(float(loss))
        if nq < batch_size:
            params, opt, loss = step(params, opt, f_sh, y_sh)
            losses.append(float(loss))
        history.append(sum(losses) / max(len(losses), 1))
        if log_every and (e + 1) % log_every == 0:
            print(f"epoch {e+1}/{epochs} loss={history[-1]:.4f}", flush=True)
    return params, history


# ---------------------------------------------------------------------------
# production trainer: buckets + checkpoints + resume
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SelectorTrainConfig:
    """Knobs of the streaming trainer (None defers to the CluSDConfig)."""

    selector: str = "lstm"
    epochs: Optional[int] = None        # None -> cfg.epochs
    lr: Optional[float] = None          # None -> cfg.lr
    batch_size: int = 256
    pos_weight: Optional[float] = None  # None -> cfg.pos_weight / derived
    bucket: bool = True                 # power-of-two sequence buckets
    min_len: int = 4
    use_kernel: Union[bool, str] = "auto"   # lstm_sequence kernel forward
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every_steps: int = 0           # 0 = checkpoint only at the end
    keep_ckpts: int = 3
    max_steps: int = 0                  # stop (and checkpoint) after N
                                        # optimizer steps; 0 = unlimited


class SelectorTrainer:
    """Bucketed, checkpointed selector training over a LabelSet, on
    `device` (None: the CUDA card)."""

    def __init__(self, cfg, tcfg: SelectorTrainConfig = SelectorTrainConfig(),
                 *, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.use_kernel = _resolve_use_kernel(tcfg.use_kernel, self.device)
        self._steps = {}                    # bucket length L -> step fn
        self.pos_weight = None              # resolved by fit()

    # -- one step per bucket length -----------------------------------------

    def loss_and_grads(self, params, f, y, w, pos_w):
        """(loss, grads) of one batch: the JAX step's loss_fn and its
        value_and_grad."""
        pg = _with_grad(params)
        probs = selector_apply(pg, f, selector=self.tcfg.selector,
                               use_kernel=self.use_kernel)
        per_row = torch.mean(_bce(probs, y, pos_w), dim=1)
        loss = torch.sum(per_row * w) / torch.clamp(torch.sum(w), min=1.0)
        return loss.detach(), _grads(loss, pg)

    def _step_fn(self, L):
        fn = self._steps.get(L)
        if fn is not None:
            return fn
        lr = self.tcfg.lr or self.cfg.lr

        def step(p, o, f, y, w, pos_w):
            loss, grads = self.loss_and_grads(p, f, y, w, pos_w)
            p, o, _ = adamw_update(grads, o, p, lr=lr, weight_decay=0.0)
            return p, o, loss

        self._steps[L] = step
        return step

    # -- training ------------------------------------------------------------

    def init_params(self, generator, feat_dim):
        return init_selector_params(self.tcfg.selector, feat_dim,
                                    self.cfg.lstm_hidden, generator,
                                    self.device)

    def _tensor(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def fit(self, generator, feats, labels, *, init=None, resume=False,
            log_every=0, metrics=None):
        """Train; returns (params, history). `generator` draws the initial
        params (None: one seeded with tcfg.seed); `init` (a param dict)
        replaces that draw. With tcfg.ckpt_dir set, checkpoints land
        every ckpt_every_steps steps (and at the end); resume=True
        restores the latest checkpoint and replays the deterministic
        batch schedule from right after it.

        `metrics` (repro_torch.obs.MetricsRegistry) receives `train.steps`
        / `train.epochs` counters, a `train.step_ms` histogram, and
        `train.steps_per_s` / `train.last_loss` gauges."""
        feats = np.asarray(_np(feats), np.float32)
        labels = np.asarray(_np(labels), np.float32)
        reg = metrics if metrics is not None else MetricsRegistry()
        c_steps = reg.counter("train.steps")
        c_epochs = reg.counter("train.epochs")
        h_step = reg.histogram("train.step_ms")
        t_fit = time.perf_counter()
        tc = self.tcfg
        epochs = tc.epochs or self.cfg.epochs
        self.pos_weight = resolve_pos_weight(self.cfg, labels, tc.pos_weight)
        pos_w = torch.tensor(self.pos_weight, dtype=torch.float32,
                             device=self.device)
        if tc.bucket:
            buckets = data_lib.bucket_lengths(self.cfg, feats, labels,
                                              min_len=tc.min_len)
        else:
            buckets = np.full(feats.shape[0], feats.shape[1], np.int64)
        per_epoch = data_lib.n_batches_per_epoch(buckets, tc.batch_size)

        if init is not None:
            params = _given_params(init, self.device)
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(tc.seed)
            params = self.init_params(generator, feats.shape[-1])
        opt = adamw_init(params)
        start_epoch = start_batch = global_step = 0
        mgr = None
        if tc.ckpt_dir:
            mgr = CheckpointManager(tc.ckpt_dir, keep=tc.keep_ckpts)
            if resume:
                step0, tree, extra = mgr.restore_latest(
                    {"params": params, "opt": opt})
                if step0 is not None:
                    params, opt = tree["params"], tree["opt"]
                    global_step = int(step0)
                    start_epoch = int(extra.get("epoch", 0))
                    start_batch = int(extra.get("batch", 0))
                    if start_batch >= per_epoch:    # epoch boundary ckpt
                        start_epoch, start_batch = start_epoch + 1, 0

        def save(epoch, batch):
            if mgr is not None:
                mgr.save(global_step,
                         {"params": params, "opt": opt},
                         extra={"epoch": epoch, "batch": batch,
                                "selector": tc.selector,
                                "pos_weight": self.pos_weight})

        def finalize():
            wall = time.perf_counter() - t_fit
            done = global_step - start_step
            reg.gauge("train.steps_per_s").set(
                round(done / wall, 2) if wall > 0 else 0.0)
            if history:
                reg.gauge("train.last_loss").set(round(history[-1], 6))

        history = []
        start_step = global_step
        for e in range(start_epoch, epochs):
            losses = []
            for batch in data_lib.bucketed_batches(
                    feats, labels, buckets, batch_size=tc.batch_size,
                    seed=tc.seed, epoch=e):
                if e == start_epoch and batch.index < start_batch:
                    continue
                step = self._step_fn(batch.length)
                t_step = time.perf_counter()
                params, opt, loss = step(
                    params, opt, self._tensor(batch.feats),
                    self._tensor(batch.labels), self._tensor(batch.weights),
                    pos_w)
                global_step += 1
                losses.append(float(loss))     # device sync for this step
                c_steps.inc()
                h_step.observe((time.perf_counter() - t_step) * 1e3)
                if tc.ckpt_every_steps and \
                        global_step % tc.ckpt_every_steps == 0:
                    save(e, batch.index + 1)
                if tc.max_steps and global_step >= tc.max_steps:
                    save(e, batch.index + 1)    # resumable stop point
                    if losses:
                        history.append(sum(losses) / len(losses))
                    if mgr is not None:
                        mgr.wait()
                    finalize()
                    return params, history
            c_epochs.inc()
            if losses:
                history.append(sum(losses) / len(losses))
            if log_every and (e + 1) % log_every == 0:
                print(f"epoch {e+1}/{epochs} loss={history[-1]:.4f} "
                      f"(pos_weight={self.pos_weight:.2f})", flush=True)
        save(epochs, 0)
        if mgr is not None:
            mgr.wait()
        finalize()
        return params, history
