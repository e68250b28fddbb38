"""Synthetic Criteo-like click stream for the recsys archs: categorical
draws follow a Zipf over each table's vocabulary (real id traffic is heavy
tailed — this is what makes mod-sharded tables imbalanced, which the
embedding tests exercise) and the label depends on a sparse logistic ground
truth so AUC is learnable.

A copy of repro.data.recsys_stream (numpy only): one seed gives the same
batches in both packages."""

import numpy as np


class RecsysStream:
    def __init__(self, cfg, seed=0, zipf_a=1.3):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        # hidden ground-truth: one weight per (field, bucket-of-64)
        self.true_w = {
            i: self.rng.standard_normal(max(rows // 64, 1)) * 0.5
            for i, rows in enumerate(cfg.table_sizes)}
        self.dense_w = self.rng.standard_normal(max(cfg.n_dense, 1)) * 0.3

    def _draw_ids(self, rows, size):
        z = self.rng.zipf(self.zipf_a, size=size)
        return np.minimum(z - 1, rows - 1).astype(np.int32)

    def batch(self, batch_size):
        cfg = self.cfg
        sparse = np.stack(
            [self._draw_ids(rows, batch_size)
             for rows in cfg.table_sizes], axis=1)
        logit = np.zeros(batch_size, np.float32)
        for i, rows in enumerate(cfg.table_sizes):
            logit += self.true_w[i][np.minimum(sparse[:, i] // 64,
                                               len(self.true_w[i]) - 1)]
        out = {"sparse": sparse}
        if cfg.n_dense:
            dense = self.rng.standard_normal(
                (batch_size, cfg.n_dense)).astype(np.float32)
            logit += dense @ self.dense_w
            out["dense"] = dense
        if cfg.kind == "din":
            L = cfg.seq_len
            out["hist_item"] = self._draw_ids(cfg.table_sizes[0],
                                              batch_size * L).reshape(-1, L)
            out["hist_cate"] = self._draw_ids(cfg.table_sizes[1],
                                              batch_size * L).reshape(-1, L)
            lens = self.rng.integers(1, L + 1, batch_size)
            out["hist_mask"] = (np.arange(L)[None] < lens[:, None]).astype(
                np.float32)
        p = 1 / (1 + np.exp(-logit))
        out["label"] = (self.rng.random(batch_size) < p).astype(np.int32)
        return out
