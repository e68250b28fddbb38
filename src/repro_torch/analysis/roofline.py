"""Three-term roofline model of a dry-run cell, per rank:

  compute    = FLOPs per rank / peak FLOP/s
  memory     = HBM bytes per rank / HBM bandwidth
  collective = wire bytes per rank (ring model) / the binding link's
               bandwidth

The counterpart of the JAX package's `repro.analysis.roofline`, with the
same formulas over the port's counts (analysis.cost, per rank already)
and an H100 SXM spec (common.hw) by default.

MODEL_FLOPS is the analytic useful work: 6*N_active*D tokens for LM
training (2*N for inference) + exact-causal attention, per-edge
tensor-product work for the GNN, MLP+interaction for recsys,
guide+selected-block scoring for CluSD retrieval. The ratio MODEL_FLOPS /
(FLOPs * ranks) exposes recomputation and masked-attention waste.
"""

from repro_torch.common.hw import H100_SXM


def roofline_terms(cost, coll, n_devices, hw=H100_SXM):
    """cost: per-rank 'flops' and 'bytes accessed' (analysis.cost);
    coll: its collective dict ('wire', 'raw', per kind)."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    wire_dev = float(coll.get("wire", 0.0))
    raw_dev = float(coll.get("raw", 0.0))
    t_compute = flops_dev / hw.peak_flops_bf16
    t_memory = bytes_dev / hw.hbm_bandwidth
    t_collective = wire_dev / hw.link_bandwidth
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective,
             "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
             "coll_wire_bytes_per_device": wire_dev,
             "coll_raw_bytes_per_device": raw_dev,
             "global_flops": flops_dev * n_devices}
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["dominant"] = dom.replace("_s", "")
    bound = max(t_compute, t_memory, t_collective)
    terms["step_time_lower_bound_s"] = bound
    terms["mfu_upper_bound"] = (t_compute / bound) if bound > 0 else 0.0
    return terms


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS per cell
# ---------------------------------------------------------------------------

def _lm_attention_flops(cfg, B, S, causal_train):
    W = cfg.sliding_window
    # average effective kv length per query position
    if W and W < S:
        s_eff = W / 2 + (S - W) * W / S  # approx: ramp then constant window
    else:
        s_eff = (S + 1) / 2
    fwd = 4 * B * S * s_eff * cfg.n_heads * cfg.hd  # QK^T + PV, 2 flops/MAC
    return 3 * fwd if causal_train else fwd


def model_flops(arch_cfg, shape, clusd_cfg=None):
    fam = getattr(arch_cfg, "family", "lm")
    if fam == "retrieval":
        # CluSD serve: query-centroid sims + selected-block scoring + LSTM
        B = shape.batch or arch_cfg.serve_batch
        sel = arch_cfg.max_selected * arch_cfg.cluster_cap
        lstm = arch_cfg.n_candidates * 4 * arch_cfg.lstm_hidden * (
            arch_cfg.lstm_hidden + 1 + arch_cfg.u_bins + 2 * arch_cfg.v_bins)
        return B * (2 * arch_cfg.n_clusters * arch_cfg.dim
                    + 2 * sel * arch_cfg.dim + 2 * lstm)
    if fam == "lm":
        B, S = shape.global_batch, shape.seq_len
        N_act = arch_cfg.active_param_count()
        if shape.mode == "train":
            return 6 * N_act * B * S + _lm_attention_flops(arch_cfg, B, S, True)
        if shape.mode == "prefill":
            return 2 * N_act * B * S + _lm_attention_flops(arch_cfg, B, S, False)
        # decode: one token, cache length = S (or window)
        W = arch_cfg.sliding_window
        kv = min(S, W) if W else S
        attn = 4 * B * arch_cfg.n_heads * arch_cfg.hd * kv
        return 2 * N_act * B + attn
    if fam == "gnn":
        C = arch_cfg.d_hidden
        L = arch_cfg.n_layers
        E = shape.n_edges if not shape.batch_nodes else _sampled_edges(shape)
        N = shape.n_nodes if not shape.batch_nodes else _sampled_nodes(shape)
        if shape.n_graphs:
            E, N = shape.n_edges * shape.n_graphs, shape.n_nodes * shape.n_graphs
        # per-edge: radial MLP + 15 TP paths (~dim(l1)*dim(l2)*dim(l3) MACs)
        from repro_torch.models.nequip import N_PATHS, PATHS, RADIAL_HIDDEN
        dim = {0: 1, 1: 3, 2: 9}
        tp = sum(dim[a] * dim[b] * dim[c] for a, b, c in PATHS)
        per_edge = 2 * (arch_cfg.n_rbf * RADIAL_HIDDEN
                        + RADIAL_HIDDEN * N_PATHS * C) + 2 * tp * C
        per_node = 2 * (6 * C * C * 4.3 + 2 * C * C)  # self/skip over l dims + gate
        fwd = L * (E * per_edge + N * per_node)
        return 3 * fwd  # train
    if fam == "recsys":
        B = shape.batch
        if shape.mode == "retrieval":
            n_cand = shape.n_candidates
            d = arch_cfg.embed_dim
            guide = 2 * n_cand * 2              # wide guide (2 item fields)
            if clusd_cfg is not None:
                scanned = clusd_cfg.max_selected * clusd_cfg.cluster_cap
            else:
                scanned = n_cand
            return guide + 2 * scanned * d + 2 * B * d
        d = arch_cfg.embed_dim
        F = arch_cfg.n_sparse
        mlp = 0
        dims_chain = []
        if arch_cfg.bot_mlp:
            dims_chain.append((arch_cfg.n_dense,) + tuple(arch_cfg.bot_mlp))
        if arch_cfg.top_mlp:
            n_f = F + 1
            dims_chain.append((n_f * (n_f - 1) // 2 + d,) + tuple(arch_cfg.top_mlp))
        if arch_cfg.mlp:
            dims_chain.append((F * d,) + tuple(arch_cfg.mlp))
        for chain in dims_chain:
            for a, b in zip(chain[:-1], chain[1:]):
                mlp += 2 * a * b
        inter = 2 * (F + 1) ** 2 * d if arch_cfg.interaction == "dot" else 2 * F * d
        if arch_cfg.kind == "din":
            be = 2 * d
            attn_chain = (4 * be,) + tuple(arch_cfg.attn_mlp) + (1,)
            attn = sum(2 * a * b for a, b in zip(attn_chain[:-1], attn_chain[1:]))
            inter += arch_cfg.seq_len * attn
        per_ex = mlp + inter
        mult = 3 if shape.mode == "train" else 1
        return mult * B * per_ex
    raise ValueError(fam)


def _sampled_nodes(shape):
    n = shape.batch_nodes
    total = n
    for f in shape.fanout:
        n = n * f
        total += n
    return total


def _sampled_edges(shape):
    n = shape.batch_nodes
    total = 0
    for f in shape.fanout:
        total += n * f
        n = n * f
    return total
