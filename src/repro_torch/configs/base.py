"""The system configs: copies of repro.configs.base.CluSDConfig,
RecsysConfig, TransformerConfig, NequIPConfig and TrainConfig, with the same fields,
defaults and derived values."""

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    family: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: Optional[int] = None          # default: d_model // n_heads
    qkv_bias: bool = False
    # MoE
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False            # arctic: dense FFN beside MoE
    # attention
    sliding_window: Optional[int] = None    # SWA window (mixtral)
    rope_theta: float = 1e6
    # numerics / memory policy
    dtype: str = "bfloat16"                 # activations / compute
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"        # arctic uses bf16 to fit HBM
    remat: bool = True
    logits_chunk: int = 0                   # chunked xent (0 = off)
    microbatch: int = 0                     # grad-accumulation splits
    moe_impl: str = "sort"                  # sort | ep_shard_map
    grad_accum_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + L layers + final norm)."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        dense_ffn = 3 * d * self.d_ff
        per_layer = attn + 2 * d  # norms
        if self.moe:
            per_layer += self.n_experts * 3 * d * self.moe_d_ff \
                + d * self.n_experts
            if self.dense_residual:
                per_layer += dense_ffn
        else:
            per_layer += dense_ffn
        return self.vocab_size * d * 2 + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        inactive = self.n_layers * (self.n_experts - self.moe_top_k) * 3 \
            * d * self.moe_d_ff
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    family: str = "gnn"
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep order
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 0             # raw input node feature dim (0 = species one-hot)
    n_species: int = 32
    readout_dim: int = 1        # per-node energy head
    dtype: str = "float32"
    param_dtype: str = "float32"
    msg_impl: str = "pjit"      # pjit | owner_shard_map (the mesh's)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    family: str = "recsys"
    kind: str = "dlrm"                      # dlrm | deepfm | wide_deep | din
    n_dense: int = 0
    n_sparse: int = 26
    embed_dim: int = 128
    table_sizes: Tuple[int, ...] = ()       # rows per sparse table
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()               # deepfm/wide_deep/din deep branch
    attn_mlp: Tuple[int, ...] = ()          # din local activation unit
    seq_len: int = 0                        # din behavior sequence
    interaction: str = "dot"                # dot | fm | concat | target-attn
    multi_hot: int = 1                      # lookups per sparse feature
    dtype: str = "float32"
    param_dtype: str = "float32"
    retrieval_local_topk: bool = False      # shard-local guide top-k

    def total_rows(self) -> int:
        return sum(self.table_sizes)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    schedule: str = "cosine"
    ckpt_every: int = 100
    ckpt_dir: str = "/tmp/repro_ckpt"
    grad_compression: bool = False   # int8 error-feedback all-reduce
    microbatch: int = 0              # grad accumulation (0 = off)


@dataclasses.dataclass(frozen=True)
class CluSDConfig:
    """The paper's system. Defaults = paper's MS MARCO settings (§2, §3)."""
    name: str = "clusd"
    family: str = "retrieval"
    # corpus
    n_docs: int = 8_800_000
    dim: int = 768                   # RetroMAE/SimLM dim; RepLLaMA = 4096
    n_clusters: int = 8192           # N
    # sparse index
    vocab: int = 30522
    max_postings: int = 4096         # per-term posting budget (padded)
    doc_terms: int = 128             # avg nnz per doc (synthetic)
    # stage 1
    k_sparse: int = 1000             # sparse retrieval depth k
    bins: Tuple[int, ...] = (10, 25, 50, 100, 200, 500, 1000)  # bin edges
    n_candidates: int = 32           # n = LSTM input sequence length
    # stage 2
    lstm_hidden: int = 32
    n_neighbors: int = 128           # m: top-m centroid neighbor graph
    u_bins: int = 6                  # inter-cluster distance bins
    theta: float = 0.02              # selection threshold
    max_selected: int = 32           # static selection budget
    # fusion
    alpha: float = 0.5               # sparse weight (both fusion methods)
    k_final: int = 1000
    fusion: str = "interp"           # "interp" | "rrf" (core/fusion.py)
    rrf_k: float = 60.0              # RRF rank constant (fusion="rrf")
    # hybrid candidate generation: neighbor-graph expansion of the
    # stage-1 seeds (core/stage1.expand_candidates); 0 = off
    expand_depth: int = 0
    # training
    train_queries: int = 5000
    epochs: int = 150
    lr: float = 1e-3
    pos_weight: Optional[float] = 4.0
    dtype: str = "float32"
    impl: str = "shard_map"
    serve_batch: int = 256

    @property
    def v_bins(self) -> int:
        return len(self.bins)

    @property
    def n_candidates_total(self) -> int:
        """Stage-1 candidate width after graph expansion: each expansion
        step budgets one extra n_candidates block, capped at N."""
        return min(self.n_candidates * (1 + max(self.expand_depth, 0)),
                   self.n_clusters)

    @property
    def cluster_cap(self) -> int:
        """Padded (balanced) cluster block size."""
        return max(8, 2 ** math.ceil(
            math.log2(1.5 * self.n_docs / self.n_clusters)))
