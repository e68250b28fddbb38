"""The CluSD select/score/fuse pipeline, parameterised by a ClusterStore.

`retrieve(cfg, index, store, ...)` runs sparse retrieval, the Stage-I/II
selection, scoring of the selected blocks through `store` and the fused
top-k, with `score_and_fuse` and `score_selected` as its Step 3. A
device store (InMemoryStore, PQStore) scores its block table in place
with the slots' cluster ids as positions; a host store deduplicates the
batch's selection and fetches each unique block once.

The serving engine drives device stores through `retrieve` (its
`device_pipeline` span) and host (disk) stores through these stages,
batched over queries:

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


# ---------------------------------------------------------------------------
# Step 3 against any store, and the full pipeline
# ---------------------------------------------------------------------------

def _flat_docs(cluster_docs, sel_ids, sel_mask):
    docs = cluster_docs[sel_ids.long()]                         # (B, S, cap)
    B, S, cap = docs.shape
    valid = (docs >= 0) & sel_mask[:, :, None]
    return (torch.where(valid, docs, 0).reshape(B, S * cap).int(),
            valid.reshape(B, S * cap))


def score_selected(store, q_dense, sel_ids, sel_mask):
    """Device-store scoring of the selected clusters: the store scores its
    block table in place (`score_blocks`: cluster_score, or adc_tables +
    adc_score_blocks). q_dense (B, dim); sel_ids/sel_mask (B, S).
    Returns (doc_ids (B, S*cap) int32, scores with -inf at invalid,
    valid)."""
    docs_flat, valid = _flat_docs(store.cluster_docs, sel_ids, sel_mask)
    scores = store.score_blocks(q_dense, sel_ids).reshape(valid.shape)
    return docs_flat, torch.where(valid, scores, -torch.inf), valid


def score_selected_host(store, q_dense, sel_ids, sel_mask, cache=None):
    """Host-store scoring with score_selected's contract: the batch's
    selection is deduplicated, each unique float block fetched once
    (through `cache` when given), shipped to the device and scored there
    by the cluster_score kernel with each slot's position."""
    dev = q_dense.device
    uniq, pos = dedup_selected(sel_ids.cpu().numpy(), sel_mask.cpu().numpy())
    if bool(sel_mask.any()):
        blocks = torch.from_numpy(fetch_unique_blocks(store, uniq,
                                                      cache)).to(dev)
    else:
        blocks = torch.zeros((1, store.cap, store.dim), dtype=torch.float32,
                             device=dev)
    docs_flat, valid = _flat_docs(store.cluster_docs.to(dev), sel_ids,
                                  sel_mask)
    scores = cluster_score(q_dense.float().contiguous(), blocks,
                           torch.from_numpy(pos).to(dev)).reshape(valid.shape)
    return docs_flat, torch.where(valid, scores, -torch.inf), valid


def score_and_fuse(cfg, index, store, q_dense, sparse_ids, sparse_scores,
                   sel_ids, sel_mask, *, k=None, cache=None):
    """Step 3: dense-score the selected clusters via `store`, fuse with the
    sparse results. Returns (ids, scores, dmask)."""
    k = k or cfg.k_final
    if getattr(store, "is_host", False):
        did, dscore, dmask = score_selected_host(store, q_dense, sel_ids,
                                                 sel_mask, cache=cache)
    else:
        did, dscore, dmask = score_selected(store, q_dense, sel_ids, sel_mask)
    ids, scores = fusion_lib.fuse_topk(
        sparse_ids, sparse_scores, did, torch.where(dmask, dscore, 0.0),
        dmask, index.n_docs, cfg.alpha, k, method=cfg.fusion,
        rrf_k=cfg.rrf_k)
    return ids, scores, dmask


def retrieve(cfg, index, store, q_dense, q_terms, q_weights, *,
             selector="lstm", stage1="overlap", theta=None,
             selector_params=None, k=None, cache=None):
    """The full CluSD pipeline against any store. Returns (ids, scores,
    diag) with diag {"n_selected", "frac_docs_scanned", "sparse_ids",
    "sparse_scores", "cand", "probs", "sel_ids", "sel_mask"}."""
    k = k or cfg.k_final
    sparse_ids, sparse_scores = sparse_lib.sparse_retrieve_topk(
        index.sparse_index, q_terms, q_weights, cfg.k_sparse)
    sel = clusd_lib.select_clusters(cfg, index, q_dense, sparse_ids,
                                    sparse_scores, selector=selector,
                                    stage1=stage1, theta=theta,
                                    selector_params=selector_params)
    ids, scores, dmask = score_and_fuse(
        cfg, index, store, q_dense, sparse_ids, sparse_scores,
        sel["sel_ids"], sel["sel_mask"], k=k, cache=cache)
    diag = {
        "n_selected": sel["sel_mask"].sum(1),
        "frac_docs_scanned": dmask.float().mean(1) * dmask.shape[1]
        / index.n_docs,
        "sparse_ids": sparse_ids, "sparse_scores": sparse_scores,
        **{k_: sel[k_] for k_ in ("cand", "probs", "sel_ids", "sel_mask")},
    }
    return ids, scores, diag
