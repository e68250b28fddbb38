"""Stage II selector (paper §2.3): an LSTM walks the n stage-1 candidates
in order and emits f(C_i) in [0, 1]; clusters with f >= theta are
visited. The hidden sequence comes from the lstm_sequence kernel
(repro_torch.kernels.lstm), which is the plain version on the CPU.

The parameters keep the JAX package's layout and gate order (i, f, g,
o): wx (F, 4H), wh (H, 4H), b (4H,), head_w (H, 1), head_b (1,).
"""

import torch
from torch import nn

from repro_torch.kernels.lstm import lstm_sequence


def _dense_init(shape, generator):
    """N(0, 1) / sqrt(fan_in), the JAX package's dense_init rule (its draws
    differ: torch.Generator is not jax.random)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    return torch.randn(shape, generator=generator) * fan_in ** -0.5


class LSTMSelector(nn.Module):
    def __init__(self, feat_dim, hidden, *, generator=None):
        super().__init__()
        H = hidden
        self.wx = nn.Parameter(_dense_init((feat_dim, 4 * H), generator))
        self.wh = nn.Parameter(_dense_init((H, 4 * H), generator))
        self.b = nn.Parameter(torch.zeros(4 * H))
        self.head_w = nn.Parameter(_dense_init((H, 1), generator))
        self.head_b = nn.Parameter(torch.zeros(1))

    @property
    def hidden(self):
        return self.wh.shape[0]

    def forward(self, feats):
        """feats: (B, n, F) -> selection probabilities (B, n)."""
        h_seq = lstm_sequence(feats.float().contiguous(), self.wx, self.wh,
                              self.b)
        logits = (h_seq @ self.head_w + self.head_b)[..., 0]
        return torch.sigmoid(logits)
