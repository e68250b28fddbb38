"""Product quantization for the embedding store (paper Tables 1, 6, 7):
nsub subspaces x 256 codes, scored via per-query ADC lookup tables
(repro_torch.kernels.adc) over raw uint8 code blocks.

  * `train_pq`: per-subspace k-means on a sample of the corpus, with an
    optional PCA rotation (OPQ-lite);
  * `pq_encode`: nearest codebook entry per subspace, in row chunks;
  * `decode_code_blocks`: host-side reconstruction of code blocks.
"""

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import kmeans as km
from repro_torch.device import resolve_device


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
