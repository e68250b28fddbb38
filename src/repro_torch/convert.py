"""Carry state across from numpy arrays (for instance the fields of a JAX
`CluSDIndex`, as the tests hand them over), so that both packages
compute on the same index, selector and quantizer.

  index_from_numpy(arrays)       -> repro_torch CluSDIndex
  selector_from_numpy(params, selector=) -> LSTM/RNN/MLP selector
  pq_from_numpy(codebooks, codes, rotation, nsub) -> PQ
  recsys_params_from_numpy(cfg, params) -> recsys params (fused tables)
"""

import numpy as np
import torch

from repro_torch.core.clusd import CluSDIndex
from repro_torch.core.lstm import SELECTORS
from repro_torch.core.quant import PQ
from repro_torch.core.sparse import SparseIndex
from repro_torch.device import resolve_device
from repro_torch.models import recsys as rs

_INDEX_DTYPES = {
    "centroids": np.float32,
    "cluster_docs": np.int32,
    "doc_cluster": np.int32,
    "neighbor_ids": np.int32,
    "neighbor_sims": np.float32,
    "bin_ids": np.int32,
    "sparse_postings_docs": np.int32,
    "sparse_postings_weights": np.float32,
}


def _tensor(x, dtype, dev):
    return torch.from_numpy(np.array(x, dtype=dtype, order="C")).to(dev)


def selector_from_numpy(params, *, selector="lstm", device=None):
    """A JAX selector param dict -> the port's module of that selector
    with the same weights: "lstm" {wx (F,4H), wh (H,4H), b (4H,), head_w
    (H,1), head_b (1,)}, "rnn" {wx (F,H), wh (H,H), b (H,), head_w,
    head_b} or "mlp" {w1, b1, w2, b2, head_w, head_b}. The rnn and lstm
    dicts share their key names, so `selector` names the kind; the
    shapes are checked against it."""
    dev = resolve_device(device)
    cls = SELECTORS[selector]
    sel = cls(*(int(d) for d in cls.dims(params)))
    with torch.no_grad():
        for name, p in sel.named_parameters():
            src = np.array(params[name], dtype=np.float32)
            if src.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {src.shape}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(src))
    return sel.to(dev)


def pq_from_numpy(codebooks, codes, rotation, nsub, *, device=None):
    dev = resolve_device(device)
    return PQ(codebooks=_tensor(codebooks, np.float32, dev),
              codes=_tensor(codes, np.int32, dev),
              rotation=None if rotation is None
              else _tensor(rotation, np.float32, dev),
              nsub=int(nsub))


def index_from_numpy(arrays, *, device=None):
    """arrays: {"centroids", "cluster_docs", "doc_cluster", "neighbor_ids",
    "neighbor_sims", "bin_ids", "sparse_postings_docs",
    "sparse_postings_weights"} as numpy, plus optional "n_docs",
    "embeddings", "lstm_params" (a JAX param dict) and "quantizer" (a dict
    of pq_from_numpy's arguments)."""
    dev = resolve_device(device)
    missing = [k for k in _INDEX_DTYPES if k not in arrays]
    if missing:
        raise KeyError(f"index arrays missing {missing}")
    t = {k: _tensor(arrays[k], dt, dev) for k, dt in _INDEX_DTYPES.items()}
    n_docs = int(arrays.get("n_docs", t["doc_cluster"].shape[0]))
    emb = arrays.get("embeddings")
    params = arrays.get("lstm_params")
    pq = arrays.get("quantizer")
    return CluSDIndex(
        centroids=t["centroids"], cluster_docs=t["cluster_docs"],
        doc_cluster=t["doc_cluster"], neighbor_ids=t["neighbor_ids"],
        neighbor_sims=t["neighbor_sims"],
        embeddings=None if emb is None else _tensor(emb, np.float32, dev),
        sparse_index=SparseIndex(t["sparse_postings_docs"],
                                 t["sparse_postings_weights"], n_docs),
        selector=None if params is None
        else selector_from_numpy(params, device=dev),
        quantizer=None if pq is None else pq_from_numpy(**pq, device=dev),
        bin_ids=t["bin_ids"])


def recsys_params_from_numpy(cfg, params, *, device=None):
    """A JAX recsys params tree as numpy ({"tables": {"t0": (rows, d), ...},
    "wide": {...}, "wide_bias", MLP leaves}) -> the port's params: each
    table group concatenated in field order into one FusedTable, the
    other leaves as float32 tensors. Shapes are checked against
    repro_torch.models.recsys.param_template(cfg)."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in rs.param_template(cfg).items():
        if name not in params:
            raise KeyError(f"recsys params missing {name!r}")
        if isinstance(leaf, dict):
            arrs = [np.asarray(params[name][f"t{i}"], np.float32)
                    for i in range(len(leaf))]
            for i, a in enumerate(arrs):
                if a.shape != leaf[f"t{i}"].shape:
                    raise ValueError(f"{name}/t{i}: shape {a.shape}, "
                                     f"expected {leaf[f't{i}'].shape}")
            out[name] = rs.FusedTable(
                _tensor(np.concatenate(arrs), np.float32, dev),
                [a.shape[0] for a in arrs])
        else:
            a = np.asarray(params[name], np.float32)
            if a.shape != tuple(leaf.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{tuple(leaf.shape)}")
            out[name] = _tensor(a, np.float32, dev)
    return out
