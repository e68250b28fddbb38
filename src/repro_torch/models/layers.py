"""Shared layers: RMSNorm, SwiGLU, MLPs, rotary embeddings (the JAX
package's `repro.models.layers`, with its sharding annotation)."""

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.sharding import logical


def rmsnorm(x, gamma, eps=1e-6):
    """Computed in float32, returned in x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN. x: (B, S, d); w_gate/w_up: (d, f); w_down: (f, d). The
    matmuls run in x's dtype, the silu in float32."""
    h = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    h = F.silu(h.float()).to(x.dtype) * u
    h = logical(h, "batch", "seq", "ff_act")
    return h @ w_down.to(x.dtype)


def mlp(x, ws, bs, act=torch.relu, final_act=False):
    """Plain MLP over the last dim; ws/bs lists."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i + 1 < len(ws) or final_act:
            x = act(x)
    return x


def rope_freqs(head_dim, theta, device=None):
    """(head_dim/2,) float32 theta ** (-2i / head_dim): the float32
    exponent as the reference forms it, the power in float64 rounded to
    float32 on the host, so every device holds the same bits."""
    e = -np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    f = np.power(np.float64(theta), e.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(f).to(device)


def apply_rope(x, positions, theta):
    """x: (B, S, H, hd); positions: (B, S) int. Rotates the two halves of
    each head (not interleaved pairs), in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., None].float() * freqs               # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
