"""Plain PyTorch LSTM sequence (the CPU path, and what the CUDA kernel is
held to): the same math as the JAX package's scan, gates i, f, g, o."""

import torch


def lstm_sequence_ref(x, wx, wh, b):
    """x: (B, n, F) -> hidden sequence (B, n, H) float32."""
    x = x.float()
    B, n, _ = x.shape
    H = wh.shape[0]
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(n):
        gates = x[:, t] @ wx + h @ wh + b
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)
