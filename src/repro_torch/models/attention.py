"""Attention: GQA with optional sliding window; chunked-q train/prefill
(each chunk recomputed in the backward) and single-token decode against
a KV cache. The JAX package's `repro.models.attention` in plain torch
ops: GQA as (B, S, Hkv, G, hd), masked scores filled with -1e30 and the
softmax in float32. No SDPA: its masking and numerics are another
function."""

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.sharding import logical


def _chunk_attend(q, k, v, q_start, *, causal, window):
    """q: (B, C, Hkv, G, hd); k/v: (B, S, Hkv, hd) -> (B, C, Hkv, G, hd)."""
    B, C, Hkv, G, hd = q.shape
    S = k.shape[1]
    scores = torch.einsum("bchgd,bshd->bhgcs", q, k) / (hd ** 0.5)
    qpos = q_start + torch.arange(C, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((C, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgcs,bshd->bchgd", probs, v)


def attention(q, k, v, *, causal=True, window=None, q_chunk=512):
    """q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd) -> (B, S, Hq, hd). Above
    q_chunk queries, S must divide by q_chunk; each chunk's (C, S) score
    slab is recomputed in the backward instead of stored."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    q = q.reshape(B, S, Hkv, G, hd)
    if S <= q_chunk:
        out = _chunk_attend(q, k, v, 0, causal=causal, window=window)
        return out.reshape(B, S, Hq, hd)
    assert S % q_chunk == 0, (S, q_chunk)
    outs = []
    for i in range(S // q_chunk):
        q_i = q[:, i * q_chunk:(i + 1) * q_chunk]

        def body(q_i, k, v, start=i * q_chunk):
            return _chunk_attend(q_i, k, v, start, causal=causal,
                                 window=window)
        if torch.is_grad_enabled():
            outs.append(checkpoint(body, q_i, k, v, use_reentrant=False))
        else:
            outs.append(body(q_i, k, v))
    return torch.cat(outs, dim=1).reshape(B, S, Hq, hd)


def decode_attention(q, k_cache, v_cache, cache_len, *, kv_start=0,
                     combine=None):
    """Single-token decode. q: (B, 1, Hq, hd); caches: (B, S, Hkv, hd);
    the first `cache_len` slots are valid.

    With `combine` (mesh, axes) the caches are this rank's slots
    kv_start .. kv_start + S - 1 of a sequence split over `axes`, and the
    ranks are combined flash-decode style: the row max all-reduced by
    max, then the exp-sums and the exp-weighted V in one all-reduce; the
    mask takes global positions. Every rank returns the whole result."""
    B, S, Hkv, hd = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    q = q.reshape(B, Hkv, G, hd)
    k_cache = logical(k_cache, "batch", "seq_kv", "kv_heads", "head_dim")
    v_cache = logical(v_cache, "batch", "seq_kv", "kv_heads", "head_dim")
    scores = torch.einsum("bhgd,bshd->bhgs", q, k_cache) / (hd ** 0.5)
    kpos = kv_start + torch.arange(S, device=q.device)[None, None, None, :]
    scores = torch.where(kpos < cache_len, scores.float(), -1e30)
    if combine is None:
        probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
        out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache)
        return out.reshape(B, 1, Hq, hd)
    from repro_torch.models import collectives as coll
    mesh, axes = combine
    m = coll.all_reduce_max(scores.amax(-1), mesh, axes)       # (B, Hkv, G)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    se, o = coll.all_reduce_many([p.sum(-1), o.float()], mesh, axes)
    out = (o / se[..., None]).to(v_cache.dtype)
    return out.reshape(B, 1, Hq, hd)
