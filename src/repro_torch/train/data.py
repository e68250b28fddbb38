"""Bucketed training batches over stage-1 candidate sequences, a numpy
copy of the JAX package's `repro.train.data`: the same buckets and the
same batch stream, draw for draw (`np.random.default_rng([seed, epoch])`).

Each query gets an effective length (its last live candidate: nonzero
sparse overlap or a positive label), rounded up to the engine's
power-of-two bucket (`engine.server.bucket_size`). Truncation is exact
for every selector the repo ships (the LSTM and RNN are causal, the MLP
pointwise). Batches are fixed (batch_size, L, F) shapes: a short tail is
padded by repeating its last row with weight 0. The stream is a pure
function of (seed, epoch, buckets), so a mid-epoch resume replays it.
"""

import dataclasses

import numpy as np

from repro_torch.engine.server import bucket_size


@dataclasses.dataclass
class Batch:
    feats: np.ndarray     # (batch_size, L, F) float32
    labels: np.ndarray    # (batch_size, L) float32
    weights: np.ndarray   # (batch_size,) float32 — 0 marks padding rows
    length: int           # bucket (sequence) length L
    index: int            # step index within the epoch


def effective_lengths(cfg, feats, labels, *, min_len=4):
    """Per-query live prefix: covers every candidate with nonzero sparse
    overlap (the P/Q feature block) and every positive label."""
    feats = np.asarray(feats)
    labels = np.asarray(labels)
    n = feats.shape[1]
    overlap = np.abs(feats[..., 1 + cfg.u_bins:]).sum(axis=-1) > 0
    live = overlap | (labels > 0)
    any_live = live.any(axis=1)
    last = np.where(any_live, n - 1 - np.argmax(live[:, ::-1], axis=1), 0)
    return np.clip(last + 1, min(min_len, n), n).astype(np.int64)


def bucket_lengths(cfg, feats, labels, *, min_len=4):
    """Effective lengths rounded up to the engine's power-of-two buckets,
    capped at the full candidate length n."""
    n = int(np.asarray(feats).shape[1])
    eff = effective_lengths(cfg, feats, labels, min_len=min_len)
    return np.asarray([bucket_size(int(e), n) for e in eff], np.int64)


def n_batches_per_epoch(buckets, batch_size):
    lens, counts = np.unique(np.asarray(buckets), return_counts=True)
    return int(sum(-(-int(c) // int(batch_size)) for c in counts))


def bucketed_batches(feats, labels, buckets, *, batch_size, seed, epoch):
    """Yield one epoch of Batch objects, deterministic in (seed, epoch).

    Queries are shuffled within their bucket; buckets are visited in
    ascending length order. Every query appears exactly once per epoch;
    tail batches are padded to batch_size by repeating the final row with
    weight 0."""
    feats = np.asarray(feats)
    labels = np.asarray(labels)
    buckets = np.asarray(buckets)
    batch_size = max(1, int(batch_size))
    rng = np.random.default_rng([int(seed), int(epoch)])
    step = 0
    for L in sorted(int(x) for x in np.unique(buckets)):
        idx = np.flatnonzero(buckets == L)
        idx = rng.permutation(idx)
        for lo in range(0, len(idx), batch_size):
            sel = idx[lo:lo + batch_size]
            pad = batch_size - len(sel)
            w = np.ones(batch_size, np.float32)
            if pad:
                sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
                w[len(w) - pad:] = 0.0
            yield Batch(feats=feats[sel][:, :L],
                        labels=labels[sel][:, :L],
                        weights=w, length=L, index=step)
            step += 1
