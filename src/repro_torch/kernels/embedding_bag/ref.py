"""Plain PyTorch embedding bag (the CPU path, and what the CUDA kernel is
held to): one (B, d) gather per hot position, added in ascending h into
a float32 accumulator that starts at 0.0, then cast to the table's
dtype. For a float32 table that is the JAX package's Python sum of
lookups bit for bit. `torch.sum` over h is not used: its order on the
CPU is not sequential."""

import torch


def embedding_bag_ref(table, idx):
    """table: (V, d); idx: (B, hot) integer -> (B, d) in the table's dtype."""
    B, hot = idx.shape
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for h in range(hot):
        acc = acc + table[idx[:, h].long()].float()
    return acc.to(table.dtype)
