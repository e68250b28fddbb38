"""Product quantization for the embedding store (paper Tables 1, 6, 7):
nsub subspaces x 256 codes, scored via per-query ADC lookup tables
(repro_torch.kernels.adc) over raw uint8 code blocks.

  * `train_pq`: per-subspace k-means on a sample of the corpus, with an
    optional PCA rotation (OPQ-lite);
  * `train_pq_stream`: the same on a bounded sample of a corpus larger
    than RAM (an np.memmap), read and encoded in chunks;
  * `pq_encode`: nearest codebook entry per subspace, in row chunks;
  * `decode_code_blocks`: host-side reconstruction of code blocks;
  * `adc_tables`, `adc_score`, `reconstruct`: per-query LUTs, LUT scores
    of doc ids, and decoded vectors of a PQ on the device;
  * `score_selected_pq`: Step-3 scoring over a PQStore;
  * `identity_pq`: a lossless PQ of a tiny corpus, for parity tests.
"""

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import kmeans as km
from repro_torch.device import resolve_device
from repro_torch.kernels import adc as adc_ops


@dataclasses.dataclass
class PQ:
    codebooks: torch.Tensor   # (nsub, 256, dsub) float32
    codes: torch.Tensor       # (D, nsub) int32 (uint8 on disk)
    rotation: Any             # (dim, dim) float32 tensor or None
    nsub: int

    def space_bytes(self):
        return int(self.codes.shape[0]) * self.nsub


def train_pq(X, nsub, n_codes=256, iters=10, *, rotate=False,
             sample_docs=None, generator=None, device=None):
    """Train codebooks on X (D, dim), dim % nsub == 0, and encode X.

    sample_docs: train on that many rows drawn with `generator` (all rows
    when None), then encode every row. Returns a PQ whose codes cover X.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    D, dim = X.shape
    if dim % nsub:
        raise ValueError(f"dim {dim} is not a multiple of nsub {nsub}")
    train = X
    if sample_docs is not None and sample_docs < D:
        idx = torch.randperm(D, generator=generator)[:sample_docs]
        train = X[idx.sort().values.to(dev)]
    R = None
    if rotate:
        Xc = train - train.mean(0, keepdim=True)
        _, vecs = torch.linalg.eigh(Xc.T @ Xc / train.shape[0])
        R = vecs.flip(1).contiguous()          # descending eigenvalues
        train = train @ R
    dsub = dim // nsub
    Ts = train.reshape(train.shape[0], nsub, dsub)
    n_k = min(n_codes, train.shape[0])
    books = torch.zeros((nsub, n_codes, dsub), dtype=torch.float32, device=dev)
    for s in range(nsub):
        c, _ = km.kmeans(Ts[:, s].contiguous(), n_k, iters,
                         generator=generator, device=dev)
        books[s, :n_k] = c
    return PQ(books, pq_encode(books, X, R), R, nsub)


def train_pq_stream(embeddings, nsub, *, n_codes=256, iters=10,
                    rotate=False, sample_docs=1 << 16, chunk_docs=1 << 14,
                    sample_idx=None, generator=None, device=None):
    """PQ for corpora larger than RAM: codebooks trained (`train_pq`) on a
    bounded sample gathered in `chunk_docs`-row reads, then every
    document encoded chunk by chunk on `device`. `embeddings` only needs
    row indexing (np.memmap is fine); no read touches more than
    chunk_docs rows and the float matrix is never materialized.

    sample_idx: the sample's row indices (sorted here); otherwise
    min(D, sample_docs) distinct rows drawn with `generator`, which
    also seeds the codebooks' k-means. Returns a PQ whose codes (int32,
    on `device`) cover all D docs.
    """
    dev = resolve_device(device)
    D, dim = int(embeddings.shape[0]), int(embeddings.shape[1])
    if sample_idx is None:
        sample_idx = torch.randperm(D, generator=generator)[
            :min(D, sample_docs)].numpy()
    idx = np.sort(np.asarray(sample_idx, np.int64))
    sample = np.empty((len(idx), dim), np.float32)
    for lo in range(0, len(idx), chunk_docs):
        sel = idx[lo:lo + chunk_docs]
        sample[lo:lo + len(sel)] = np.asarray(embeddings[sel], np.float32)
    pq = train_pq(sample, nsub, n_codes, iters, rotate=rotate,
                  generator=generator, device=dev)
    codes = torch.empty((D, nsub), dtype=torch.int32, device=dev)
    for lo in range(0, D, chunk_docs):
        chunk = np.array(embeddings[lo:lo + chunk_docs], np.float32)
        codes[lo:lo + len(chunk)] = pq_encode(pq.codebooks, chunk,
                                              pq.rotation)
    return PQ(pq.codebooks, codes, pq.rotation, nsub)


def pq_encode(codebooks, X, rotation=None, chunk_rows=1 << 15):
    """Nearest codebook entry per subspace for each row of X (C, dim):
    argmin_k ||c_sk||^2 - 2 x_s . c_sk. Returns (C, nsub) int32 codes on
    the codebooks' device."""
    dev = codebooks.device
    X = torch.as_tensor(X, dtype=torch.float32)
    nsub, _, dsub = codebooks.shape
    c2 = (codebooks * codebooks).sum(-1)                  # (nsub, K)
    out = torch.empty((X.shape[0], nsub), dtype=torch.int32, device=dev)
    for lo in range(0, X.shape[0], chunk_rows):
        Xc = X[lo:lo + chunk_rows].to(dev)
        if rotation is not None:
            Xc = Xc @ rotation
        Xs = Xc.reshape(Xc.shape[0], nsub, dsub)
        dots = torch.einsum("csd,skd->csk", Xs, codebooks)
        out[lo:lo + chunk_rows] = (c2[None] - 2.0 * dots).argmin(-1).int()
    return out


def decode_code_blocks(codebooks, codes, rotation=None):
    """Host-side reconstruction of packed code blocks: codes (..., nsub)
    uint8/int -> float32 (..., dim). dot(q, decode(codes)) has the same
    per-subspace terms as the ADC LUT score."""
    books = np.asarray(codebooks, np.float32)            # (nsub, K, dsub)
    nsub = books.shape[0]
    codes = np.asarray(codes)
    vecs = books[np.arange(nsub), codes.astype(np.int64)]
    flat = vecs.reshape(codes.shape[:-1] + (-1,))
    if rotation is not None:
        flat = flat @ np.asarray(rotation, np.float32).T
    return flat


def adc_tables(pq: PQ, q):
    """q: (B, dim) -> LUT (B, nsub, 256), the OPQ rotation folded in (the
    adc_tables kernel on the card)."""
    return adc_ops.adc_tables(q.float(), pq.codebooks, pq.rotation)


def adc_score(pq: PQ, lut, doc_ids):
    """lut: (B, nsub, 256); doc_ids: (B, K) -> approximate scores (B, K):
    score[b, k] = sum over ascending s of lut[b, s, codes[doc_ids[b, k],
    s]], one float32 accumulator (negative ids read doc 0)."""
    codes = pq.codes[doc_ids.clamp(min=0).long()].long()   # (B, K, nsub)
    acc = torch.zeros(doc_ids.shape, dtype=torch.float32, device=lut.device)
    for s in range(pq.nsub):
        acc = acc + lut[:, s, :].float().gather(1, codes[..., s])
    return acc


def reconstruct(pq: PQ, doc_ids):
    """Decoded embeddings of the given doc ids: (K, dim)."""
    codes = pq.codes[doc_ids.long()].long()                  # (K, nsub)
    vecs = pq.codebooks[torch.arange(pq.nsub, device=codes.device)[None],
                        codes]                               # (K, nsub, dsub)
    flat = vecs.reshape(doc_ids.shape[0], -1)
    if pq.rotation is not None:
        flat = flat @ pq.rotation.T
    return flat


def score_selected_pq(index, q_dense, sel_ids, sel_mask):
    """Quantized Step-3 scoring through a PQStore over `index.quantizer`
    (the adc_tables and adc_score_blocks kernels on the card). Returns
    (doc_ids (B, S*cap) int32, scores with -inf at invalid, valid)."""
    from repro_torch.engine import pipeline as pipe_lib
    from repro_torch.engine import stores as stores_lib
    store = stores_lib.PQStore(index.quantizer, index.cluster_docs)
    return pipe_lib.score_selected(store, q_dense, sel_ids, sel_mask)


def identity_pq(embeddings, nsub=1, *, device=None):
    """Exact (lossless) PQ of a corpus of at most 256 docs: doc d's code in
    every subspace is d, and the codebook entries are the docs' own
    sub-vectors, so ADC reproduces the exact dot product. For parity
    tests and debugging, not for real indexes."""
    X = torch.from_numpy(np.array(embeddings, np.float32))
    D, dim = X.shape
    if D > 256 or dim % nsub:
        raise ValueError(f"identity PQ needs <= 256 docs and nsub | dim, got "
                         f"{D} docs, dim {dim}, nsub {nsub}")
    dsub = dim // nsub
    books = torch.zeros((nsub, 256, dsub), dtype=torch.float32)
    books[:, :D] = X.reshape(D, nsub, dsub).permute(1, 0, 2)
    codes = torch.arange(D, dtype=torch.int32)[:, None].repeat(1, nsub)
    dev = resolve_device(device)
    return PQ(books.to(dev), codes.to(dev), None, nsub)
