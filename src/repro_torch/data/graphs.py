"""Synthetic graph builders matching the assigned GNN shape cells, plus 3-D
position synthesis for non-molecular graphs (NequIP needs geometry): the
JAX package's `repro.data.graphs`, host numpy, so equal seeds give equal
arrays."""

import numpy as np


def synth_graph(seed, n_nodes, n_edges, d_feat=0, pos_scale=3.0):
    """Random graph with positions and optional node features; returns a
    dict batch for models/nequip.forward (single graph, energy target from a
    smooth function of geometry so training has learnable signal)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    pos = (pos_scale * rng.standard_normal((n_nodes, 3))).astype(np.float32)
    batch = {
        "positions": pos,
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": np.ones(n_edges, np.float32),
        "graph_id": np.zeros(n_nodes, np.int32),
        "energy_target": np.asarray(
            [np.tanh(pos).sum() / n_nodes], np.float32),
    }
    if d_feat:
        batch["node_feat"] = rng.standard_normal(
            (n_nodes, d_feat)).astype(np.float32) / np.sqrt(d_feat)
    else:
        batch["species"] = rng.integers(0, 8, n_nodes).astype(np.int32)
    return batch


def synth_molecules(seed, n_graphs, n_nodes, n_edges, n_species=8,
                    cutoff=5.0):
    """Batched small molecules (the `molecule` shape): nodes within cutoff
    are connected; energy = sum of a pairwise Morse-like term (learnable)."""
    rng = np.random.default_rng(seed)
    N = n_graphs * n_nodes
    pos = np.zeros((N, 3), np.float32)
    species = rng.integers(0, n_species, N).astype(np.int32)
    esrc, edst = [], []
    energies = np.zeros(n_graphs, np.float32)
    for g in range(n_graphs):
        base = g * n_nodes
        p = 1.8 * rng.standard_normal((n_nodes, 3)).astype(np.float32)
        pos[base:base + n_nodes] = p
        d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        pairs = np.argwhere(d2 < cutoff ** 2)
        order = np.argsort(d2[pairs[:, 0], pairs[:, 1]])
        pairs = pairs[order[:n_edges]]
        for i, j in pairs:
            esrc.append(base + i)
            edst.append(base + j)
        r = np.sqrt(d2[pairs[:, 0], pairs[:, 1]])
        energies[g] = np.sum(np.exp(-r) - 0.5 * np.exp(-0.5 * r))
    E = len(esrc)
    return {
        "positions": pos,
        "species": species,
        "edge_src": np.asarray(esrc, np.int32),
        "edge_dst": np.asarray(edst, np.int32),
        "edge_mask": np.ones(E, np.float32),
        "graph_id": np.repeat(np.arange(n_graphs), n_nodes).astype(np.int32),
        "energy_target": energies,
    }
