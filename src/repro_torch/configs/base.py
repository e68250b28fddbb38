"""The system configs: copies of repro.configs.base.CluSDConfig,
RecsysConfig and TrainConfig, with the same fields, defaults and derived
values."""

import dataclasses
import math
from typing import Optional, Tuple


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
