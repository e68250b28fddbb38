"""Threshold/budget calibration on held-out queries, a port of the JAX
package's `repro.train.calibrate`.

Serving exposes two knobs: the Stage-II probability threshold theta
(cfg.theta) and the cluster budget (cfg.max_selected). This module
sweeps (theta, budget) on a held-out LabelSet and measures

  recall@k        fraction of the query's full-dense top-k documents whose
                  cluster is selected (k = the label config's top_dense),
  avg_selected    mean clusters actually selected (= cluster-block reads),
  est_read_bytes  avg_selected x the store's per-block byte cost,

then picks an operating point for a target recall (cheapest selection
that reaches it) or a target I/O budget (best recall within it).
Selection semantics mirror `core.clusd.stage2_select` (threshold, then
top-budget by probability, ties to the lower stage-1 rank).

Calibrate on what the engine serves: the port's engine runs Stage II
through the lstm_sequence kernel on the card, so `selector_probs` takes
`use_kernel` and the calibration there passes True; the JAX engine
serves through its scan, and its calibration runs the scan.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.builder import _np
from repro_torch.train.trainer import selector_apply


def selector_probs(params, feats, *, selector="lstm", use_kernel=False,
                   batch=1024, device=None):
    """(B, n) selection probabilities as a host array, computed on
    `device` (None: the CUDA card) in batches of `batch` queries."""
    device = resolve_device(device)
    params = {k: v.to(device) if isinstance(v, torch.Tensor)
              else torch.tensor(np.asarray(v, np.float32), device=device)
              for k, v in params.items()}
    feats = np.asarray(feats, np.float32)
    out = []
    with torch.no_grad():
        for lo in range(0, feats.shape[0], batch):
            f = torch.from_numpy(np.ascontiguousarray(
                feats[lo:lo + batch])).to(device)
            out.append(selector_apply(params, f, selector=selector,
                                      use_kernel=use_kernel).cpu().numpy())
    return np.concatenate(out, axis=0)


def select_at(cand, probs, theta, budget):
    """stage2_select semantics on the host: picked = probs >= theta, then
    top-`budget` picked candidates by probability (ties -> lower stage-1
    rank). Returns (sel_ids, sel_mask) (B, budget)."""
    cand = np.asarray(cand)
    probs = np.asarray(probs)
    budget = min(int(budget), cand.shape[1])
    picked = probs >= theta
    masked = np.where(picked, probs, -np.inf)
    top_i = np.argsort(-masked, axis=1, kind="stable")[:, :budget]
    sel_mask = np.take_along_axis(picked, top_i, axis=1)
    sel_ids = np.take_along_axis(cand, top_i, axis=1)
    return sel_ids, sel_mask


def recall_at_budget(cand, probs, pos_clusters, theta, budget):
    """(recall@k, avg_selected): recall counts the full-dense top-k docs
    whose cluster made the selection, averaged per query then over
    queries."""
    sel_ids, sel_mask = select_at(cand, probs, theta, budget)
    sel = np.where(sel_mask, sel_ids, -1)
    covered = (np.asarray(pos_clusters)[:, :, None]
               == sel[:, None, :]).any(axis=-1)            # (B, k)
    return float(covered.mean()), float(sel_mask.sum(axis=1).mean())


def _rows(cand, probs, pos_clusters, thetas, budgets, block_bytes, **fields):
    rows = []
    for budget in sorted(int(b) for b in budgets):
        for theta in sorted(float(t) for t in thetas):
            rec, avg_sel = recall_at_budget(cand, probs, pos_clusters,
                                            theta, budget)
            rows.append({
                **fields,
                "theta": round(theta, 6),
                "budget": budget,
                "recall": round(rec, 4),
                "avg_selected": round(avg_sel, 2),
                "est_read_bytes": int(round(avg_sel * block_bytes)),
            })
    return rows


def calibration_table(label_set, probs, doc_cluster, *, thetas, budgets,
                      block_bytes=0):
    """Sweep rows sorted by (budget, theta). Every row: theta, budget,
    recall, avg_selected, est_read_bytes."""
    pos_clusters = _np(doc_cluster)[np.asarray(label_set.dense_ids)]
    return _rows(label_set.cand, probs, pos_clusters, thetas, budgets,
                 block_bytes)


def expansion_sweep(cfg, index, params, q_dense, q_terms, q_weights,
                    dense_ids, *, depths, thetas, budgets, block_bytes=0,
                    stage1="overlap", selector="lstm", use_kernel=False):
    """The theta x budget sweep with a stage-1 expansion-depth axis: for
    each depth the stage-1 candidates are regenerated through the
    neighbor graph and swept as `calibration_table` sweeps, each row
    with "depth" / "n_candidates" beside. `dense_ids` (from an existing
    LabelSet) does not depend on stage 1, so nothing is re-streamed.

    Returns [{"depth", "n_candidates", "stage1_ceiling", "rows"}], where
    stage1_ceiling is the recall with every candidate selected."""
    from repro_torch.train import labels as labels_lib

    dense_ids = np.asarray(dense_ids)
    pos_clusters = _np(index.doc_cluster)[dense_ids]
    out = []
    for depth in sorted({int(d) for d in depths}):
        dcfg = dataclasses.replace(cfg, expand_depth=depth)
        cand, feats = labels_lib.stage1_for_queries(
            dcfg, index, q_dense, q_terms, q_weights, stage1=stage1)
        probs = selector_probs(params, feats, selector=selector,
                               use_kernel=use_kernel, device=index.device)
        ceiling, _ = recall_at_budget(cand, probs, pos_clusters, -np.inf,
                                      cand.shape[1])
        rows = _rows(cand, probs, pos_clusters, thetas, budgets, block_bytes,
                     depth=depth, n_candidates=int(cand.shape[1]))
        out.append({"depth": depth, "n_candidates": int(cand.shape[1]),
                    "stage1_ceiling": round(ceiling, 4), "rows": rows})
    return out


def choose_operating_point(table, *, target_recall=None, target_budget=None):
    """Pick a row from a calibration table.

    target_recall: cheapest selection (min avg_selected, then min budget,
      then max theta) whose recall meets the target; falls back to the
      best-recall row (flagged "target_met": False) when nothing does.
    target_budget: best recall among rows with budget <= target (ties ->
      fewer clusters actually selected).
    Exactly one target must be given."""
    if (target_recall is None) == (target_budget is None):
        raise ValueError("pass exactly one of target_recall/target_budget")
    table = list(table)
    if not table:
        raise ValueError("empty calibration table")
    if target_recall is not None:
        ok = [r for r in table if r["recall"] >= target_recall]
        if ok:
            pick = min(ok, key=lambda r: (r["avg_selected"], r["budget"],
                                          -r["theta"]))
            return dict(pick, target_met=True)
        pick = max(table, key=lambda r: (r["recall"], -r["avg_selected"]))
        return dict(pick, target_met=False)
    ok = [r for r in table if r["budget"] <= target_budget]
    met = bool(ok)
    if not ok:                 # nothing fits: flag it, pick the cheapest
        ok = [min(table, key=lambda r: r["budget"])]
    pick = max(ok, key=lambda r: (r["recall"], -r["avg_selected"],
                                  -r["theta"]))
    return dict(pick, target_met=met)


def selection_quality(probs, labels, theta):
    """Precision / recall / avg #selected at threshold theta (label-level:
    recall over positive candidates, not the dense top-k), as float32
    tensors of shape ()."""
    probs = torch.as_tensor(_np(probs))
    labels = torch.as_tensor(_np(labels)).float()
    sel = probs >= theta
    tp = torch.sum(sel * labels)
    prec = tp / torch.clamp(sel.sum(), min=1)
    rec = tp / torch.clamp(labels.sum(), min=1)
    return {"precision": prec, "recall": rec,
            "avg_selected": sel.sum(dim=1).float().mean()}
