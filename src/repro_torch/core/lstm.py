"""Stage II selectors (paper §2.3 and the Table 8 ablations), each
mapping (B, n, F) candidate features to probabilities f(C_i) in [0, 1];
clusters with f >= theta are visited.

  - "lstm" (CluSD): walks the n stage-1 candidates in order. The hidden
    sequence comes from the lstm_sequence kernel (repro_torch.kernels.
    lstm), which is the plain version on the CPU. Parameters in the JAX
    package's layout and gate order (i, f, g, o): wx (F, 4H), wh (H, 4H),
    b (4H,), head_w (H, 1), head_b (1,).
  - "rnn": a vanilla tanh RNN over the same sequence, wx (F, H), wh (H, H),
    b (H,), head_w, head_b. The JAX package runs it as a plain lax.scan,
    so it stays plain torch, one step after another.
  - "mlp": pointwise, no sequence state (the XGBoost stand-in), w1 (F, H),
    b1, w2 (H, H), b2, head_w, head_b; plain matmuls.

`SELECTORS` maps each name to its module class, as the JAX package's
`SELECTORS` maps it to (init, apply); an unknown name raises KeyError.
"""

import torch
from torch import nn

from repro_torch.kernels.lstm import lstm_sequence


def _dense_init(shape, generator):
    """N(0, 1) / sqrt(fan_in), the JAX package's dense_init rule (its draws
    differ: torch.Generator is not jax.random)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    return torch.randn(shape, generator=generator) * fan_in ** -0.5


def _head(h, head_w, head_b):
    """(..., H) hidden states -> (...) probabilities."""
    return torch.sigmoid((h @ head_w + head_b)[..., 0])


class LSTMSelector(nn.Module):
    def __init__(self, feat_dim, hidden, *, generator=None):
        super().__init__()
        H = hidden
        self.wx = nn.Parameter(_dense_init((feat_dim, 4 * H), generator))
        self.wh = nn.Parameter(_dense_init((H, 4 * H), generator))
        self.b = nn.Parameter(torch.zeros(4 * H))
        self.head_w = nn.Parameter(_dense_init((H, 1), generator))
        self.head_b = nn.Parameter(torch.zeros(1))

    @staticmethod
    def dims(params):
        """(feat_dim, hidden) of a param dict of this selector."""
        return params["wx"].shape[0], params["wh"].shape[0]

    @property
    def hidden(self):
        return self.wh.shape[0]

    def forward(self, feats):
        """feats: (B, n, F) -> selection probabilities (B, n)."""
        h_seq = lstm_sequence(feats.float().contiguous(), self.wx, self.wh,
                              self.b)
        return _head(h_seq, self.head_w, self.head_b)


class RNNSelector(nn.Module):
    def __init__(self, feat_dim, hidden, *, generator=None):
        super().__init__()
        self.wx = nn.Parameter(_dense_init((feat_dim, hidden), generator))
        self.wh = nn.Parameter(_dense_init((hidden, hidden), generator))
        self.b = nn.Parameter(torch.zeros(hidden))
        self.head_w = nn.Parameter(_dense_init((hidden, 1), generator))
        self.head_b = nn.Parameter(torch.zeros(1))

    dims = staticmethod(LSTMSelector.dims)

    def forward(self, feats):
        """feats: (B, n, F) -> selection probabilities (B, n); each step
        h = tanh(x_t @ wx + h @ wh + b), in the reference's order."""
        x = feats.float()
        h = x.new_zeros((x.shape[0], self.wh.shape[0]))
        steps = []
        for t in range(x.shape[1]):
            h = torch.tanh(x[:, t] @ self.wx + h @ self.wh + self.b)
            steps.append(h)
        return _head(torch.stack(steps, 1), self.head_w, self.head_b)


class MLPSelector(nn.Module):
    def __init__(self, feat_dim, hidden, *, generator=None):
        super().__init__()
        self.w1 = nn.Parameter(_dense_init((feat_dim, hidden), generator))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(_dense_init((hidden, hidden), generator))
        self.b2 = nn.Parameter(torch.zeros(hidden))
        self.head_w = nn.Parameter(_dense_init((hidden, 1), generator))
        self.head_b = nn.Parameter(torch.zeros(1))

    @staticmethod
    def dims(params):
        return params["w1"].shape[0], params["w1"].shape[1]

    def forward(self, feats):
        """feats: (B, n, F) -> selection probabilities (B, n), each
        candidate on its own: relu, relu, then the head."""
        h = torch.relu(feats.float() @ self.w1 + self.b1)
        h = torch.relu(h @ self.w2 + self.b2)
        return _head(h, self.head_w, self.head_b)


SELECTORS = {"lstm": LSTMSelector, "rnn": RNNSelector, "mlp": MLPSelector}
