"""The paper's own system config: CluSD on MS MARCO passages (a copy of
repro.configs.clusd_msmarco's `full()`, `ondisk()`, `repllama()` and
`smoke()`). `ondisk()` is the Table-4 setting (N = 65000, smaller
clusters for block-I/O control), `repllama()` Table 5's 4096-dim
RepLLaMA embeddings at N = 60000."""

from repro_torch.configs.base import CluSDConfig


def full() -> CluSDConfig:
    return CluSDConfig(name="clusd-msmarco")


def ondisk() -> CluSDConfig:
    return CluSDConfig(name="clusd-msmarco-ondisk", n_clusters=65000,
                       max_selected=64)


def repllama() -> CluSDConfig:
    return CluSDConfig(name="clusd-repllama", dim=4096, n_clusters=60000,
                       max_selected=64)


def smoke() -> CluSDConfig:
    return CluSDConfig(
        name="clusd-smoke",
        n_docs=4096, dim=32, n_clusters=64, vocab=512,
        max_postings=256, doc_terms=16,
        k_sparse=128, bins=(10, 25, 50, 128), n_candidates=16,
        lstm_hidden=16, n_neighbors=16, u_bins=4,
        max_selected=8, k_final=64,
        train_queries=64, epochs=10,
    )
