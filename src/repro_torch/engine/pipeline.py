"""The CluSD select/score/fuse stages that the serving engine drives over
a host (disk) store, batched over queries:

  stage1: sparse retrieval + Stage-I candidates and features
  lut:    per-query ADC lookup tables (kernel: adc_tables)
  stage2: Stage-II LSTM selection (kernel: lstm_sequence)
  host:   dedup of the batch's selected clusters, then one fetch of the
          unique blocks through the BlockCache (PQ code blocks of a
          code-backed store, float blocks of a v1 store)
  fused:  score -> mask -> fuse -> top-k, where the score is ADC over
          code blocks (mode "adc", kernel adc_score_blocks) or the dot
          product with float blocks (mode "dot", kernel cluster_score)

Each builder returns a closure over (cfg, index, ...) as passed; the
engine keys them per request bucket. PyTorch runs them eagerly.
"""

import numpy as np
import torch

from repro_torch.core import clusd as clusd_lib
from repro_torch.core import fusion as fusion_lib
from repro_torch.core import sparse as sparse_lib
from repro_torch.kernels import adc as adc_ops
from repro_torch.kernels.cluster_score import cluster_score
from repro_torch.obs import NOOP_TRACE


def build_stage1_fn(cfg, index):
    """fn(qd, qt, qw) -> (sparse_ids, sparse_scores, cand, feats)."""
    def run(qd, qt, qw):
        sid, ss = sparse_lib.sparse_retrieve_topk(
            index.sparse_index, qt, qw, cfg.k_sparse)
        s1 = clusd_lib.stage1_candidates(cfg, index, qd, sid, ss)
        return sid, ss, s1["cand"], s1["feats"]
    return run


def build_stage2_fn(cfg, index):
    """fn(cand, feats) -> (sel_ids, sel_mask, probs)."""
    def run(cand, feats):
        s2 = clusd_lib.stage2_select(cfg, index, cand, feats)
        return s2["sel_ids"], s2["sel_mask"], s2["probs"]
    return run


def build_lut_fn(codebooks, rotation, device):
    """Per-query ADC LUT build (OPQ rotation folded in).
    fn(qd) -> (B, nsub, 256) float32."""
    cb = torch.as_tensor(np.asarray(codebooks, np.float32)).to(device)
    rot = None if rotation is None else \
        torch.as_tensor(np.asarray(rotation, np.float32)).to(device)
    return lambda qd: adc_ops.adc_tables(qd, cb, rot)


def _fetch_unique(fetch, uniq, cache, trace):
    tr = trace if trace is not None else NOOP_TRACE

    def fill(cids):
        with tr.span("disk_fetch", n_blocks=len(cids)):
            return np.asarray(fetch(np.asarray(cids))[0])

    if cache is None:
        return fill(uniq)
    got = cache.get_or_fetch_many(uniq, fill)
    return np.stack([got[int(c)] for c in uniq])


def fetch_unique_blocks(store, uniq, cache=None, trace=None):
    """Float blocks for sorted unique cluster ids, through the LRU cache
    when given: (U, cap, dim) float32; only cache misses hit the store.
    `trace` wraps the store reads in nested `disk_fetch` spans."""
    return _fetch_unique(store.fetch_blocks, uniq, cache, trace)


def fetch_unique_code_blocks(store, uniq, cache=None, trace=None):
    """Raw code blocks of a code-backed store, like fetch_unique_blocks:
    (U, cap, nsub) uint8, never decoded."""
    return _fetch_unique(store.fetch_code_blocks, uniq, cache, trace)


def dedup_selected(sel_ids, sel_mask):
    """Host-side dedup of the batch's selected clusters.

    -> (uniq (U,) int64 sorted unique cluster ids — never empty: an
    all-masked selection yields a single placeholder id 0 — and pos
    (B, S) int32 positions into uniq; masked slots point at uniq[0] and
    are dropped by the validity mask later)."""
    sel = np.asarray(sel_ids)
    mask = np.asarray(sel_mask)
    if mask.any():
        uniq = np.unique(sel[mask])
    else:
        uniq = np.zeros((1,), np.int64)
    pos = np.searchsorted(uniq, np.where(mask, sel, uniq[0]))
    return uniq, pos.astype(np.int32)


def build_fused_scorer(cfg, index, *, k, mode="adc"):
    """Score -> mask -> fuse -> top-k as one function over the batch's
    unique selected blocks on the device:

      mode "adc": blocks (U, cap, nsub) uint8 PQ codes, q_or_lut the
                  (B, nsub, 256) ADC lookup table (kernel adc_score_blocks);
      mode "dot": blocks (U, cap, dim) float32, q_or_lut the (B, dim)
                  queries (kernel cluster_score, which reads each slot's
                  block in place: no (B, S, cap, dim) gather).

    Returns fn(q_or_lut, sid, ss, sel_ids, sel_mask, blocks, pos) ->
    (ids, scores); it closes over cfg and cluster_docs, so the engine
    drops it on reloads."""
    if mode not in ("adc", "dot"):
        raise ValueError(f"mode must be 'adc' or 'dot', got {mode!r}")
    n_docs, alpha = index.n_docs, cfg.alpha
    method, rrf_k = cfg.fusion, cfg.rrf_k
    cluster_docs = index.cluster_docs
    score = adc_ops.adc_score_blocks if mode == "adc" else cluster_score

    def run(q_or_lut, sid, ss, sel_ids, sel_mask, blocks, pos):
        docs = cluster_docs[sel_ids.long()]                     # (B, S, cap)
        B, S, cap = docs.shape
        valid = (docs >= 0) & sel_mask[:, :, None]
        scores3 = score(q_or_lut, blocks, pos)
        vf = valid.reshape(B, S * cap)
        dscore = torch.where(vf, scores3.reshape(B, S * cap), 0.0)
        did = torch.where(valid, docs, 0).reshape(B, S * cap).int()
        return fusion_lib.fuse_topk(sid, ss, did, dscore, vf, n_docs, alpha,
                                    k, method=method, rrf_k=rrf_k)

    return run
