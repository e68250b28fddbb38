"""Stage II LSTM input features (paper §2.3, Fig. 1):

  - query-cluster similarity sim(q, c_i)                      (1)
  - inter-cluster AvgDist(C_i, A_j), j=1..u over candidate bins (u)
    using only the top-m centroid neighbor graph
  - overlap features P(C_i, B_j), Q(C_i, B_j), j=1..v          (2v)

Feature vector dim F = 1 + u + 2v (21 at the paper's widths).
"""

import torch


def feature_dim(cfg):
    return 1 + cfg.u_bins + 2 * cfg.v_bins


def candidate_features(cand, qc_sim, P, Q, neighbor_ids, neighbor_sims, u):
    """cand: (B, n) candidate cluster ids (stage-1 order); qc_sim: (B, N);
    P, Q: (B, N, v); neighbor_ids/sims: (N, m).
    Returns (B, n, 1 + u + 2v) float32."""
    B, n = cand.shape
    v = P.shape[2]
    cl = cand.long()
    f_sim = qc_sim.gather(1, cl)[:, :, None]                   # (B, n, 1)
    f_P = P.gather(1, cl[:, :, None].expand(B, n, v))          # (B, n, v)
    f_Q = Q.gather(1, cl[:, :, None].expand(B, n, v))
    # inter-cluster sims among candidates, masked by the m-NN graph:
    # sim[i, l] = neighbor_sims[cand_i, j] if cand_l == neighbor_ids[cand_i, j]
    nb_ids = neighbor_ids[cl]                                  # (B, n, m)
    nb_sims = neighbor_sims[cl]
    match = nb_ids[:, :, :, None] == cand[:, None, None, :]    # (B, n, m, n)
    sim_mat = torch.where(match, nb_sims[:, :, :, None], 0.0).sum(2)
    # uniform partition of the n candidates into u bins (paper: A_1..A_u)
    u_size = n // u
    sim_bins = sim_mat[:, :, :u_size * u].reshape(B, n, u, u_size)
    f_avg = sim_bins.mean(-1)                                  # (B, n, u)
    return torch.cat([f_sim, f_avg, f_P, f_Q], dim=-1).float()
